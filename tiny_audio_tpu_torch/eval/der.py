"""Diarization Error Rate with collar and optimal speaker mapping.

The port's copy of :mod:`tiny_audio_tpu.eval.der` (numpy and scipy only):
grid-quantized (10 ms) missed speech, false alarm and speaker confusion with
the optimal reference->hypothesis speaker mapping (Hungarian algorithm),
collar 0.25 s and the UEM of the reference's extent by default, as
``pyannote.metrics.DiarizationErrorRate`` scores them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

GRID = 0.01  # 10 ms scoring grid


def _segments_to_grid(
    segments: Sequence[dict], n_cells: int, speakers: list[str]
) -> np.ndarray:
    """[n_speakers, n_cells] bool activity matrix."""
    index = {s: i for i, s in enumerate(speakers)}
    grid = np.zeros((len(speakers), n_cells), dtype=bool)
    for seg in segments:
        a = max(int(round(seg["start"] / GRID)), 0)
        z = min(int(round(seg["end"] / GRID)), n_cells)
        if z > a:
            grid[index[seg["speaker"]], a:z] = True
    return grid


def diarization_error_rate(
    reference: Sequence[dict],
    hypothesis: Sequence[dict],
    collar: float = 0.25,
    uem: Optional[tuple[float, float]] = None,
) -> dict:
    """DER components over ``{"speaker", "start", "end"}`` segment lists.

    ``collar`` seconds on each side of every reference boundary are excluded
    from scoring (standard NIST / pyannote semantics).  ``uem`` defaults to
    the reference's extent.
    """
    if not reference:
        total_hyp = sum(s["end"] - s["start"] for s in hypothesis)
        return {
            "der": 0.0 if not hypothesis else float("inf"),
            "false_alarm": total_hyp, "missed": 0.0, "confusion": 0.0,
            "total": 0.0,
        }

    if uem is None:
        uem = (min(s["start"] for s in reference),
               max(s["end"] for s in reference))
    extent = max(
        [uem[1]] + [s["end"] for s in hypothesis] + [s["end"] for s in reference]
    )
    n_cells = int(np.ceil(extent / GRID)) + 1

    ref_speakers = sorted({s["speaker"] for s in reference})
    hyp_speakers = sorted({s["speaker"] for s in hypothesis})
    ref = _segments_to_grid(reference, n_cells, ref_speakers)
    hyp = _segments_to_grid(hypothesis, n_cells, hyp_speakers)

    # scoring mask: inside UEM, outside collars around reference boundaries
    mask = np.zeros(n_cells, dtype=bool)
    a = int(round(uem[0] / GRID))
    z = min(int(round(uem[1] / GRID)), n_cells)
    mask[a:z] = True
    half = int(round(collar / GRID))
    for seg in reference:
        for edge in (seg["start"], seg["end"]):
            c = int(round(edge / GRID))
            mask[max(c - half, 0) : c + half] = False

    ref = ref[:, mask]
    hyp = hyp[:, mask]

    # optimal speaker mapping by overlap (Hungarian)
    overlap = (ref[:, None, :] & hyp[None, :, :]).sum(axis=2).astype(np.float64)
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(-overlap)
    mapped_hyp = np.zeros_like(ref)
    for r, c in zip(rows, cols):
        mapped_hyp[r] = hyp[c]
    # unmatched hypothesis speakers need no separate accounting: their
    # speech shows up in the n_hyp - n_ref false-alarm cell counts below

    n_ref = ref.sum(axis=0)  # speakers active per cell (no-overlap data: 0/1)
    n_hyp = hyp.sum(axis=0)
    correct = (ref & mapped_hyp).sum(axis=0)

    missed = np.maximum(n_ref - n_hyp, 0).sum() * GRID
    false_alarm = np.maximum(n_hyp - n_ref, 0).sum() * GRID
    confusion = (np.minimum(n_ref, n_hyp) - correct).clip(min=0).sum() * GRID
    total = n_ref.sum() * GRID

    der = (missed + false_alarm + confusion) / total if total > 0 else 0.0
    return {
        "der": float(der),
        "missed": float(missed),
        "false_alarm": float(false_alarm),
        "confusion": float(confusion),
        "total": float(total),
    }
