"""Offline quality benchmark: diarization DER and the aligner's median error.

    python -m tiny_audio_tpu_torch.tools.bench_quality [--device cuda]

Port of ``scripts/bench_quality.py``.  The diarizer (neural VAD -> ECAPA ->
spectral clustering -> voting, on ``--device``) runs over formant-synthesized
conversations with exact reference segments
(:func:`~tiny_audio_tpu_torch.eval.datasets._synthetic_conversation_rows`,
the ``synthetic-diarization`` rows), scored by :mod:`~tiny_audio_tpu_torch.
eval.der`; the alignment benchmark drives
:meth:`~tiny_audio_tpu_torch.alignment.ForcedAligner.align_emissions` with
synthetic emissions that carry the wav2vec2 bias the calibration offsets
remove, so it measures the trellis + backtrack + grouping + calibration
chain, not the acoustic model.  Prints a per-condition DER table, the corpus
DER, the alignment's median, p90 and max absolute error, then one JSON line.

Speaker embeddings come from the checked-in synthetic ECAPA tier (converted
speechbrain weights when attached); ``ecapa_tier`` and ``vad_trained`` in
the output say which ran.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

FRAME_S = 0.02  # wav2vec2 CTC frame (alignment.FRAME_STRIDE / 16 kHz)

_WORDS = (
    "the quick brown fox jumps over a lazy dog while seven wizards "
    "brew quartz potions under bright moonlight near the old stone "
    "bridge every morning before dawn with great care and joy"
).split()


# ------------------------------------------------------------------ alignment


def synth_alignment_case(seed: int):
    """-> (emission [T, V], text, truth_words [{word,start,end}]).

    Word character spans are placed on the 20 ms grid with pauses between
    words; the emission's activity is shifted by the wav2vec2 systematic
    bias (+60 ms starts, -30 ms ends) that the aligner's calibration offsets
    remove, and boundaries get +-1 frame of jitter and probability noise.
    """
    from tiny_audio_tpu_torch.alignment import END_OFFSET, START_OFFSET
    from tiny_audio_tpu_torch.models.wav2vec2 import CTC_LABELS

    rng = np.random.default_rng(seed)
    dictionary = {c: i for i, c in enumerate(CTC_LABELS)}
    n_words = int(rng.integers(6, 14))
    words = [str(rng.choice(_WORDS)) for _ in range(n_words)]

    truth = []
    t = float(rng.uniform(0.1, 0.5))
    for w in words:
        dur = 0.06 * len(w) + float(rng.uniform(0.05, 0.20))
        truth.append({"word": w, "start": t, "end": t + dur})
        t += dur + float(rng.uniform(0.04, 0.35))
    total_s = t + float(rng.uniform(0.1, 0.5))
    n_frames = int(np.ceil(total_s / FRAME_S))
    v = len(CTC_LABELS)

    # background: blank-dominated log-probs
    emission = np.full((n_frames, v), np.log(0.02 / (v - 1)), np.float32)
    emission[:, 0] = np.log(0.98)

    def paint(f0, f1, tok, p=0.85):
        f0, f1 = max(int(f0), 0), min(int(f1), n_frames)
        if f1 <= f0:
            f1 = f0 + 1
        emission[f0:f1, :] = np.log((1 - p) / (v - 1))
        emission[f0:f1, tok] = np.log(p)

    for wt in truth:
        # the acoustic view carries the bias the offsets remove
        a_start = wt["start"] + START_OFFSET
        a_end = wt["end"] + END_OFFSET
        chars = [c for c in wt["word"].upper() if c in dictionary]
        edges = np.linspace(a_start, a_end, len(chars) + 1) / FRAME_S
        jitter = rng.integers(-1, 2, size=len(edges))
        edges = edges + jitter
        for i, c in enumerate(chars):
            paint(edges[i], edges[i + 1], dictionary[c],
                  p=float(rng.uniform(0.7, 0.95)))

    return emission, " ".join(words), truth


def bench_alignment(n: int = 30, device="cuda") -> dict:
    """The trellis on ``device`` over ``n`` synthetic cases."""
    from tiny_audio_tpu_torch.alignment import ForcedAligner

    deltas = []
    worst = 0.0
    for seed in range(n):
        emission, text, truth = synth_alignment_case(seed)
        got = ForcedAligner.align_emissions(torch.from_numpy(emission).to(device), text, FRAME_S)
        assert len(got) == len(truth), (len(got), len(truth))
        for g, t in zip(got, truth):
            assert g["word"] == t["word"]
            deltas.append(abs(g["start"] - t["start"]))
            deltas.append(abs(g["end"] - t["end"]))
            worst = max(worst, deltas[-1], deltas[-2])
    deltas = np.asarray(deltas)
    return {
        "median_ae_ms": float(np.median(deltas) * 1000),
        "p90_ae_ms": float(np.percentile(deltas, 90) * 1000),
        "max_ae_ms": float(worst * 1000),
        "n_words": len(deltas) // 2,
    }


# ---------------------------------------------------------------- diarization


def bench_diarization(n: int = 10, seed: int = 7, device="cuda") -> dict:
    """The diarizer on ``device`` over ``n`` synthetic conversations."""
    from tiny_audio_tpu_torch.diarization import EcapaEmbedder
    from tiny_audio_tpu_torch.eval.datasets import _synthetic_conversation_rows
    from tiny_audio_tpu_torch.eval.evaluators.diarization import DiarizationEvaluator
    from tiny_audio_tpu_torch.vad import NeuralVAD

    rows = _synthetic_conversation_rows(n, seed)
    results, metrics = DiarizationEvaluator(device=device).evaluate(rows, verbose=False)

    by_cond: dict[str, list[float]] = {}
    for row, res in zip(rows, results):
        by_cond.setdefault(row["condition"], []).append(res["der"])
    metrics["per_condition_der"] = {
        k: round(100.0 * float(np.mean(v)), 1) for k, v in sorted(by_cond.items())
    }
    metrics["ecapa_tier"] = EcapaEmbedder.get(device).tier
    metrics["vad_trained"] = NeuralVAD.get(device) is not None
    return metrics


def main(argv=None) -> dict:
    from tiny_audio_tpu_torch.device import require_device

    parser = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.tools.bench_quality")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--conversations", type=int, default=10)
    parser.add_argument("--alignment-cases", type=int, default=30)
    args = parser.parse_args(argv)
    device = require_device(args.device)

    align = bench_alignment(args.alignment_cases, device=device)
    print(f"[alignment] median AE {align['median_ae_ms']:.1f} ms, "
          f"p90 {align['p90_ae_ms']:.1f} ms over {align['n_words']} words")

    diar = bench_diarization(args.conversations, device=device)
    print(f"[diarization] corpus DER {diar['corpus_der']:.1f}% "
          f"(avg {diar['avg_der']:.1f}%, ecapa_tier={diar['ecapa_tier']}, "
          f"vad_trained={diar['vad_trained']})")
    for cond, der in diar["per_condition_der"].items():
        print(f"  {cond:<22} {der:>6.1f}%")

    out = {"alignment": align, "diarization": diar, "device": str(device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
