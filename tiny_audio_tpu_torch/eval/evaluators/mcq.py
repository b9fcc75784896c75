"""MCQ (MMAU-style) evaluator: prompt building + robust choice matching.

Port of :mod:`tiny_audio_tpu.eval.evaluators.mcq`: the prompt is the
question + lettered choices + an instruction to answer with A/B/C/D;
predictions are matched to a choice by exact text, "(A)"-style letter, bare
letter, or substring; accuracy is reported overall and per category.
"""

from __future__ import annotations

import re
import string
import time
from typing import Iterable, Optional

import numpy as np


def build_mcq_prompt(question: str, choices: list[str]) -> str:
    letters = string.ascii_uppercase
    lines = [question.strip()]
    for letter, choice in zip(letters, choices):
        lines.append(f"({letter}) {choice}")
    lines.append(
        "Listen to the audio and make your choice among "
        + "/".join(letters[: len(choices)])
        + "."
    )
    return "\n".join(lines)


def resolve_gold_index(answer, choices: list[str]) -> Optional[int]:
    """Gold answer -> choice index: exact text, normalized (case/strip/
    trailing-punctuation) text, answer letter ('B'), or numeric index.
    Exact-only matching silently scored entire datasets 0 when the answer
    column stored letters or differently-cased text."""
    if answer in choices:
        return choices.index(answer)
    a = str(answer).strip()
    if a.isdigit():
        idx = int(a)
        return idx if 0 <= idx < len(choices) else None
    norm = a.lower().rstrip(".")
    for i, c in enumerate(choices):
        if norm == c.strip().lower().rstrip("."):
            return i
    if len(norm) == 1 and norm.upper() in string.ascii_uppercase[: len(choices)]:
        return string.ascii_uppercase.index(norm.upper())
    return None


def match_choice(prediction: str, choices: list[str]) -> Optional[int]:
    """Prediction -> choice index (the matching ladder below, first hit wins)."""
    pred = (prediction or "").strip()
    if not pred:
        return None
    pred_l = pred.lower()
    letters = string.ascii_uppercase[: len(choices)]

    # 1. exact choice text
    for i, c in enumerate(choices):
        if pred_l == c.strip().lower():
            return i
    # 2. "(A)" / "A)" / "A." / "A:" / a BARE letter.  The letter must be
    # the whole answer or carry answer punctuation: accepting letter+space
    # made every free-text answer starting with the article "A"/"a" map to
    # choice A before the substring rung could see the real content.
    if len(pred) == 1 and pred.upper() in letters:
        return letters.index(pred.upper())
    m = re.match(r"^\(?([A-Za-z])[\).:]", pred)
    if m and m.group(1).upper() in letters:
        return letters.index(m.group(1).upper())
    # 3. choice text as substring (longest first to avoid nesting) — BEFORE
    # the bare-letter rung, which would otherwise misread the English
    # articles "a"/"I" inside a free-text answer as choice A/I
    order = sorted(range(len(choices)), key=lambda i: -len(choices[i]))
    for i in order:
        if choices[i].strip().lower() in pred_l:
            return i
    # 3.5 distinctive-word overlap: a word appearing in exactly one choice
    # and in the prediction ("A flute is playing" -> the 'flute music'
    # choice) — only when it singles out ONE candidate
    choice_words = [
        set(re.findall(r"[a-z']+", c.lower())) for c in choices
    ]
    candidates = set()
    for i, words in enumerate(choice_words):
        others = set().union(*(w for j, w in enumerate(choice_words) if j != i))
        distinctive = words - others
        if any(re.search(rf"\b{re.escape(w)}\b", pred_l) for w in distinctive):
            candidates.add(i)
    if len(candidates) == 1:
        return candidates.pop()
    # 4. UPPERCASE letter as a standalone token ("the answer is B").  'A'
    # and 'I' are English words — only counted when followed by punctuation
    # or end-of-string (sentence-initial 'A flute...' must not hit)
    for m in re.finditer(r"\b([A-Z])\b", pred):
        t = m.group(1)
        if t not in letters:
            continue
        rest = pred[m.end():].lstrip()
        if t in ("A", "I") and rest and rest[0].isalnum():
            continue
        return letters.index(t)
    return None


class MCQEvaluator:
    def __init__(self, transcribe_fn, model_name: str = "local"):
        """``transcribe_fn(audio_dict, prompt) -> str``."""
        self.transcribe_fn = transcribe_fn
        self.model_name = model_name

    def evaluate(
        self, dataset: Iterable[dict], num_samples: Optional[int] = None,
        question_column: str = "question", choices_column: str = "choices",
        answer_column: str = "answer", category_column: str = "task",
        verbose: bool = True,
    ) -> tuple[list[dict], dict]:
        results = []
        for i, sample in enumerate(dataset):
            if num_samples and i >= num_samples:
                break
            choices = list(sample[choices_column])
            prompt = build_mcq_prompt(sample[question_column], choices)
            t0 = time.time()
            try:
                prediction = self.transcribe_fn(sample["audio"], prompt)
                error = None
            except Exception as e:
                prediction, error = "", str(e)
            pred_idx = match_choice(prediction, choices)
            gold_idx = resolve_gold_index(sample[answer_column], choices)
            if gold_idx is None:
                # an unresolvable gold answer would silently score EVERY
                # sample wrong — indistinguishable from a bad model
                raise ValueError(
                    f"cannot resolve answer {sample[answer_column]!r} "
                    f"against choices {choices!r}"
                )
            row = {
                "prediction": prediction,
                "pred_idx": pred_idx,
                "gold_idx": gold_idx,
                "correct": pred_idx is not None and pred_idx == gold_idx,
                "category": sample.get(category_column, "all"),
                "time_s": time.time() - t0,
            }
            if error:
                row["error"] = error
            results.append(row)
            if verbose and (i + 1) % 50 == 0:
                print(f"[eval] {i + 1} samples", flush=True)
        return results, self.compute_metrics(results)

    @staticmethod
    def compute_metrics(results: list[dict]) -> dict:
        if not results:
            return {"accuracy": 0.0, "num_samples": 0}
        by_cat: dict[str, list[bool]] = {}
        for r in results:
            by_cat.setdefault(r["category"], []).append(r["correct"])
        metrics = {
            "accuracy": 100.0 * float(np.mean([r["correct"] for r in results])),
            "num_samples": len(results),
            "unmatched": sum(1 for r in results if r["pred_idx"] is None),
        }
        for cat, vals in sorted(by_cat.items()):
            metrics[f"accuracy_{cat}"] = 100.0 * float(np.mean(vals))
        return metrics
