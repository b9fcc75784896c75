"""Word error rate via Levenshtein alignment (jiwer's semantics).

The port's copy of :mod:`tiny_audio_tpu.eval.wer`.  Corpus WER = total edits
/ total reference words over the whole set (not the mean of per-sample
WERs), as jiwer computes it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass
class WerCounts:
    substitutions: int = 0
    deletions: int = 0
    insertions: int = 0
    hits: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.deletions + self.insertions

    @property
    def ref_words(self) -> int:
        return self.substitutions + self.deletions + self.hits

    @property
    def wer(self) -> float:
        n = self.ref_words
        if n == 0:
            return 0.0 if self.insertions == 0 else float("inf")
        return self.errors / n

    def __add__(self, other: "WerCounts") -> "WerCounts":
        return WerCounts(
            self.substitutions + other.substitutions,
            self.deletions + other.deletions,
            self.insertions + other.insertions,
            self.hits + other.hits,
        )


def align_counts(reference: Sequence[str], hypothesis: Sequence[str]) -> WerCounts:
    """Levenshtein alignment counts between word sequences."""
    n, m = len(reference), len(hypothesis)
    # dp[i][j] = (cost, subs, dels, ins, hits) best path for ref[:i], hyp[:j]
    INF = 1 << 30
    prev = [(j, 0, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0, 0)] + [(INF, 0, 0, 0, 0)] * m
        for j in range(1, m + 1):
            match = reference[i - 1] == hypothesis[j - 1]
            # substitution / hit
            c, s, d, ins, h = prev[j - 1]
            if match:
                cand = (c, s, d, ins, h + 1)
            else:
                cand = (c + 1, s + 1, d, ins, h)
            # deletion
            c2, s2, d2, ins2, h2 = prev[j]
            if c2 + 1 < cand[0]:
                cand = (c2 + 1, s2, d2 + 1, ins2, h2)
            # insertion
            c3, s3, d3, ins3, h3 = cur[j - 1]
            if c3 + 1 < cand[0]:
                cand = (c3 + 1, s3, d3, ins3 + 1, h3)
            cur[j] = cand
        prev = cur
    _, s, d, ins, h = prev[m]
    return WerCounts(s, d, ins, h)


def wer(reference: str, hypothesis: str) -> float:
    """Per-sample WER on whitespace-tokenized strings."""
    return align_counts(reference.split(), hypothesis.split()).wer


def corpus_wer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Corpus WER: total errors / total reference words (jiwer semantics)."""
    if len(references) != len(hypotheses):
        # a silent zip-truncation here under-reports WER (a dropped
        # hypothesis should surface, not erase its reference)
        raise ValueError(
            f"{len(references)} references vs {len(hypotheses)} hypotheses"
        )
    total = WerCounts()
    for ref, hyp in zip(references, hypotheses):
        total = total + align_counts(ref.split(), hyp.split())
    return total.wer
