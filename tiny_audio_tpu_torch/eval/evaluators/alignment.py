"""Word-timestamp alignment evaluator: LCS matching + median absolute error.

Port of :mod:`tiny_audio_tpu.eval.evaluators.alignment`: predicted and
reference word sequences are matched monotonically via LCS on normalized
text, and the metric is the **median** absolute error over the combined
start+end deltas of matched words.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np

from tiny_audio_tpu_torch.eval.normalizer import TextNormalizer


def lcs_match(
    predicted: list[str], reference: list[str]
) -> list[tuple[int, int]]:
    """Monotonic (pred_idx, ref_idx) pairs of the longest common subsequence."""
    n, m = len(predicted), len(reference)
    dp = np.zeros((n + 1, m + 1), np.int32)
    for i in range(n - 1, -1, -1):
        for j in range(m - 1, -1, -1):
            if predicted[i] == reference[j]:
                dp[i, j] = dp[i + 1, j + 1] + 1
            else:
                dp[i, j] = max(dp[i + 1, j], dp[i, j + 1])
    pairs = []
    i = j = 0
    while i < n and j < m:
        if predicted[i] == reference[j]:
            pairs.append((i, j))
            i += 1
            j += 1
        elif dp[i + 1, j] >= dp[i, j + 1]:
            i += 1
        else:
            j += 1
    return pairs


class AlignmentEvaluator:
    """Local backend: pipeline with ``return_timestamps=True``."""

    def __init__(self, align_fn=None, model_name: str = "local-aligner"):
        self.align_fn = align_fn  # (audio_dict, sample) -> list[word dicts]
        self.model_name = model_name
        self.normalizer = TextNormalizer()

    def _norm_words(self, words: list[dict]) -> list[str]:
        return [self.normalizer.normalize(w.get("word", "")) for w in words]

    def sample_deltas(
        self, predicted: list[dict], reference: list[dict]
    ) -> list[float]:
        # Words that NORMALIZE to empty (fillers like 'um', bare
        # punctuation) are excluded before LCS with an index map back to
        # the originals — '' == '' would otherwise pair an 0.3 s filler
        # with a 95 s one and poison the median error.
        def nonempty(words):
            norm = self._norm_words(words)
            idx = [i for i, w in enumerate(norm) if w]
            return [norm[i] for i in idx], idx

        pred_norm, pred_idx = nonempty(predicted)
        ref_norm, ref_idx = nonempty(reference)
        pairs = lcs_match(pred_norm, ref_norm)
        deltas = []
        for pi, ri in pairs:
            p, r = predicted[pred_idx[pi]], reference[ref_idx[ri]]
            deltas.append(abs(p["start"] - r["start"]))
            deltas.append(abs(p["end"] - r["end"]))
        return deltas

    def evaluate(
        self, dataset: Iterable[dict], num_samples: Optional[int] = None,
        verbose: bool = True,
    ) -> tuple[list[dict], dict]:
        results = []
        for i, sample in enumerate(dataset):
            if num_samples and i >= num_samples:
                break
            reference = sample.get("words") or []
            if not reference:
                continue
            t0 = time.time()
            try:
                predicted = self.align_fn(sample["audio"], sample)
                error = None
            except Exception as e:
                predicted, error = [], str(e)
            deltas = self.sample_deltas(predicted, reference)
            row = {
                "num_matched": len(deltas) // 2,
                "num_reference": len(reference),
                "deltas": deltas,
                "time_s": time.time() - t0,
            }
            if error:
                row["error"] = error
            results.append(row)
            if verbose and (i + 1) % 20 == 0:
                print(f"[eval] {i + 1} samples", flush=True)
        return results, self.compute_metrics(results)

    @staticmethod
    def compute_metrics(results: list[dict]) -> dict:
        all_deltas = [d for r in results for d in r["deltas"]]
        if not all_deltas:
            return {"median_abs_error_s": float("nan"), "num_samples": len(results)}
        matched = sum(r["num_matched"] for r in results)
        total_ref = sum(r["num_reference"] for r in results)
        return {
            "median_abs_error_s": float(np.median(all_deltas)),
            "mean_abs_error_s": float(np.mean(all_deltas)),
            "match_rate": matched / max(total_ref, 1),
            "num_samples": len(results),
            "errors": sum(1 for r in results if "error" in r),
        }


# ---------------------------------------------------------------------------
# API backends: word-timestamp extraction from vendor response JSON
# ---------------------------------------------------------------------------


def assemblyai_words(response: dict) -> list[dict]:
    """AssemblyAI ``words`` (ms) -> word dicts (s)."""
    return [
        {"word": w["text"], "start": w["start"] / 1000.0,
         "end": w["end"] / 1000.0}
        for w in (response.get("words") or [])
    ]


def deepgram_words(response: dict) -> list[dict]:
    """Deepgram ``results.channels[0].alternatives[0].words`` -> word dicts."""
    channels = (response.get("results") or {}).get("channels") or []
    alts = (channels[0].get("alternatives") or []) if channels else []
    words = alts[0].get("words", []) if alts else []
    return [
        {"word": w["word"], "start": float(w["start"]), "end": float(w["end"])}
        for w in words
    ]


def elevenlabs_words(response: dict) -> list[dict]:
    """ElevenLabs scribe ``words`` (type 'word' only; spacing/audio_event
    entries skipped) -> word dicts."""
    out = []
    for w in response.get("words") or []:
        if w.get("type", "word") != "word":
            continue
        if w.get("start") is None or w.get("end") is None:
            continue
        out.append({"word": w["text"], "start": float(w["start"]),
                    "end": float(w["end"])})
    return out


def _api_align_fn(backend: str, **client_kwargs):
    """Build an ``align_fn(audio_dict, sample)`` for an API backend."""
    from tiny_audio_tpu_torch.eval.evaluators import api

    def fn(audio, sample):
        wav = api.audio_to_wav_bytes(audio)
        if backend == "assemblyai":
            resp = api.assemblyai_transcribe(
                wav, api.require_key("ASSEMBLYAI_API_KEY"), **client_kwargs
            )
            return assemblyai_words(resp)
        if backend == "deepgram":
            resp = api.deepgram_transcribe(
                wav, api.require_key("DEEPGRAM_API_KEY"),
                smart_format=False, **client_kwargs,
            )
            return deepgram_words(resp)
        if backend == "elevenlabs":
            resp = api.elevenlabs_transcribe(
                wav, api.require_key("ELEVENLABS_API_KEY"), **client_kwargs
            )
            return elevenlabs_words(resp)
        raise ValueError(f"unknown alignment backend {backend!r}")

    return fn


ALIGNMENT_API_BACKENDS = ("assemblyai", "deepgram", "elevenlabs")


def make_alignment_evaluator(backend: str = "local", align_fn=None,
                             model_name: str | None = None) -> AlignmentEvaluator:
    """Backend dispatch: 'local' (caller supplies align_fn) or an API vendor.

    Unknown backends fail HERE, not per-sample (see
    make_diarization_evaluator)."""
    if backend == "local":
        return AlignmentEvaluator(align_fn, model_name=model_name or "local-aligner")
    if backend not in ALIGNMENT_API_BACKENDS:
        raise ValueError(
            f"unsupported alignment backend {backend!r}; "
            f"use 'local' or one of {ALIGNMENT_API_BACKENDS}"
        )
    from tiny_audio_tpu_torch.eval.evaluators import api
    from tiny_audio_tpu_torch.eval.evaluators.diarization import API_KEY_ENV

    api.require_key(API_KEY_ENV[backend])  # fail fast, not per-sample
    return AlignmentEvaluator(
        _api_align_fn(backend), model_name=model_name or f"{backend}-alignment"
    )
