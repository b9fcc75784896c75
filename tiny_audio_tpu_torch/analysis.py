"""Result analysis: high-WER triage, entity error mining, model comparison.

The port's own copy of :mod:`tiny_audio_tpu.analysis` (pure Python over the
eval harness's ``results.txt``): ``high-wer`` filters samples above a WER
threshold; ``entity-errors`` mines numeric/date/money entity transcription
errors with a regex taxonomy (CARDINAL/DATE/MONEY/TIME/PERCENT/ORDINAL, the
ITN-sensitive classes the reference finds with spaCy, which the port does
not depend on); ``compare`` shows two runs' per-sample WER side by side.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional


def parse_results_file(results_path: Path) -> list[dict]:
    """Parse a results.txt file (wire format from eval/cli.py, identical to
    reference scripts/utils.py:8-42)."""
    samples = []
    content = Path(results_path).read_text()
    for block in content.split("-" * 80):
        sample_m = re.search(r"Sample (\d+) - WER: ([\d.]+)%", block)
        gt_m = re.search(r"Ground Truth: (.*)", block)
        # (.*) not (.+): empty predictions — the WER-100% failures triage
        # exists to surface — must parse too
        pred_m = re.search(r"Prediction:[ \t]*(.*)", block)
        if sample_m and gt_m and pred_m:
            gt = gt_m.group(1).strip()
            samples.append(
                {
                    "sample_num": int(sample_m.group(1)),
                    "ground_truth": gt,
                    "prediction": pred_m.group(1).strip(),
                    "wer": float(sample_m.group(2)),
                    "word_count": len(gt.split()),
                }
            )
    return samples


def find_latest_results(outputs_dir: str, model_pattern: str = "",
                        dataset: str = "") -> Optional[Path]:
    candidates = sorted(
        p for p in Path(outputs_dir).glob("*/results.txt")
        if model_pattern in p.parent.name and dataset in p.parent.name
    )
    return candidates[-1] if candidates else None


def high_wer(results_path, threshold: float = 50.0) -> list[dict]:
    """Samples at or above the WER threshold, worst first
    (reference analysis.py:91-160)."""
    rows = [
        s for s in parse_results_file(results_path) if s["wer"] >= threshold
    ]
    return sorted(rows, key=lambda s: -s["wer"])


# ---------------------------------------------------------------- entities

# Regex entity taxonomy over normalized (lowercase, spelled-out) ASR text —
# covers the ITN-sensitive classes the reference checks with spaCy
# (reference analysis.py:67-88).
_ENTITY_PATTERNS = {
    "CARDINAL": re.compile(
        r"\b(\d+|zero|one|two|three|four|five|six|seven|eight|nine|ten|"
        r"eleven|twelve|thirteen|fourteen|fifteen|sixteen|seventeen|"
        r"eighteen|nineteen|twenty|thirty|forty|fifty|sixty|seventy|"
        r"eighty|ninety|hundred|thousand|million|billion)\b"
    ),
    "ORDINAL": re.compile(
        r"\b(\d+(?:st|nd|rd|th)|first|second|third|fourth|fifth|sixth|"
        r"seventh|eighth|ninth|tenth)\b"
    ),
    "MONEY": re.compile(r"(\$\s?\d[\d,.]*|\b(dollars?|cents?|euros?|pounds?)\b)"),
    "PERCENT": re.compile(r"(\d+(?:\.\d+)?\s?%|\bpercent\b)"),
    "DATE": re.compile(
        # 'may' only with digit adjacency — the bare modal verb flooded the
        # triage with false positives on ordinary English
        r"\b(january|february|march|april|june|july|august|september|"
        r"october|november|december|monday|tuesday|wednesday|thursday|"
        r"friday|saturday|sunday|\d{4}s?|may\s+\d+|\d+\s+may)\b"
    ),
    # am/pm require a preceding number ('8 am', '8:30am') — a bare \b[ap]m\b
    # tagged the verb 'am' as a TIME entity
    "TIME": re.compile(
        r"\b(\d{1,2}:\d{2}\s*(?:[ap]\.?m\.?)?|\d{1,2}\s*[ap]\.?m\.?"
        r"|o'?clock|noon|midnight)\b"
    ),
}


def extract_entities(text: str) -> list[tuple[str, str]]:
    """[(label, span_text)] over the regex taxonomy."""
    out = []
    for label, pattern in _ENTITY_PATTERNS.items():
        for m in pattern.finditer((text or "").lower()):
            out.append((label, m.group(0).strip()))
    return out


def entity_errors(results_path) -> list[dict]:
    """Samples whose ground truth contains entities missing from the
    prediction (ITN-correctness triage, reference analysis.py:162-250)."""
    rows = []
    for s in parse_results_file(results_path):
        gt_entities = extract_entities(s["ground_truth"])
        if not gt_entities:
            continue
        pred = s["prediction"].lower()
        # word-boundary presence via lookarounds: plain substring counted
        # 'ten' inside 'often' as present, while \b...\b could never match
        # spans starting '$' or ending '%' (\b needs a word char on one
        # side — '$5' would have been flagged missing even when verbatim)
        missing = [
            (lb, sp) for lb, sp in gt_entities
            if not re.search(rf"(?<!\w){re.escape(sp)}(?!\w)", pred)
        ]
        if missing:
            rows.append({**s, "missing_entities": missing})
    return rows


def compare_models(results_a, results_b) -> dict:
    """Side-by-side per-sample WER of two runs keyed by ground truth
    (reference analysis.py:514-600)."""
    a = {s["ground_truth"]: s for s in parse_results_file(results_a)}
    b = {s["ground_truth"]: s for s in parse_results_file(results_b)}
    common = sorted(set(a) & set(b))
    rows = []
    for gt in common:
        rows.append(
            {
                "ground_truth": gt,
                "wer_a": a[gt]["wer"],
                "wer_b": b[gt]["wer"],
                "delta": a[gt]["wer"] - b[gt]["wer"],
                "prediction_a": a[gt]["prediction"],
                "prediction_b": b[gt]["prediction"],
            }
        )
    import numpy as np

    return {
        "rows": sorted(rows, key=lambda r: -abs(r["delta"])),
        "mean_wer_a": float(np.mean([r["wer_a"] for r in rows])) if rows else 0.0,
        "mean_wer_b": float(np.mean([r["wer_b"] for r in rows])) if rows else 0.0,
        "num_common": len(rows),
        "a_only": len(a) - len(common),
        "b_only": len(b) - len(common),
    }


# --------------------------------------------------------------------- CLI


def add_analysis_parser(subparsers) -> None:
    p = subparsers.add_parser("analysis", help="Analyze eval results")
    sp = p.add_subparsers(dest="analysis_cmd", required=True)

    hw = sp.add_parser("high-wer")
    hw.add_argument("results", help="path to results.txt")
    hw.add_argument("--threshold", type=float, default=50.0)
    hw.set_defaults(func=_cmd_high_wer)

    ee = sp.add_parser("entity-errors")
    ee.add_argument("results")
    ee.set_defaults(func=_cmd_entity_errors)

    cm = sp.add_parser("compare")
    cm.add_argument("results_a")
    cm.add_argument("results_b")
    cm.set_defaults(func=_cmd_compare)

    ex = sp.add_parser("extract-entities")
    ex.add_argument("results")
    ex.set_defaults(func=_cmd_extract_entities)


def _cmd_high_wer(args) -> int:
    for s in high_wer(args.results, args.threshold):
        print(f"#{s['sample_num']} WER {s['wer']:.1f}%")
        print(f"  GT:   {s['ground_truth']}")
        print(f"  PRED: {s['prediction']}")
    return 0


def _cmd_entity_errors(args) -> int:
    for s in entity_errors(args.results):
        missing = ", ".join(f"{lb}:{sp}" for lb, sp in s["missing_entities"])
        print(f"#{s['sample_num']} missing [{missing}]")
        print(f"  GT:   {s['ground_truth']}")
        print(f"  PRED: {s['prediction']}")
    return 0


def _cmd_extract_entities(args) -> int:
    counts: dict[str, int] = {}
    for s in parse_results_file(args.results):
        for label, span in extract_entities(s["ground_truth"]):
            counts[label] = counts.get(label, 0) + 1
    for label, n in sorted(counts.items(), key=lambda kv: -kv[1]):
        print(f"{label}: {n}")
    return 0


def _cmd_compare(args) -> int:
    cmp = compare_models(args.results_a, args.results_b)
    print(
        f"A mean WER {cmp['mean_wer_a']:.2f}%  vs  B mean WER "
        f"{cmp['mean_wer_b']:.2f}%  ({cmp['num_common']} common samples)"
    )
    for r in cmp["rows"][:20]:
        print(f"  dWER {r['delta']:+.1f}  GT: {r['ground_truth'][:60]}")
    return 0
