"""Diarization evaluator: DER(collar=0.25) with duration-weighted corpus DER.

Port of :mod:`tiny_audio_tpu.eval.evaluators.diarization`.  Reference
segments come from the dataset rows (``speakers`` column: list of
{speaker,start,end}); hypotheses from the port's :class:`SpeakerDiarizer`
on ``device`` (local backend) or any callable producing segment lists.
"""

from __future__ import annotations

import functools
import time
from typing import Iterable, Optional

import numpy as np

from tiny_audio_tpu_torch.eval.der import diarization_error_rate


class DiarizationEvaluator:
    def __init__(self, diarize_fn=None, collar: float = 0.25,
                 model_name: str = "local-diarizer", device="cuda"):
        if diarize_fn is None:
            from tiny_audio_tpu_torch.diarization import SpeakerDiarizer

            diarize_fn = functools.partial(SpeakerDiarizer.diarize, device=device)
        self.diarize_fn = diarize_fn
        self.collar = collar
        self.model_name = model_name

    @staticmethod
    def extract_reference(sample: dict) -> list[dict]:
        segs = sample.get("speakers") or []
        # accept parallel-array form {"speakers": [...], "timestamps": [[s,e]...]}
        if segs and not isinstance(segs[0], dict):
            ts = sample.get("timestamps") or []
            if len(ts) != len(segs):
                # zip truncation would silently score against a partial
                # reference, deflating DER — surface the corrupt row
                raise ValueError(
                    f"{len(segs)} speakers vs {len(ts)} timestamps"
                )
            segs = [
                {"speaker": str(sp), "start": float(t[0]), "end": float(t[1])}
                for sp, t in zip(segs, ts)
            ]
        return segs

    def evaluate(
        self, dataset: Iterable[dict], num_samples: Optional[int] = None,
        verbose: bool = True,
    ) -> tuple[list[dict], dict]:
        results = []
        for i, sample in enumerate(dataset):
            if num_samples and i >= num_samples:
                break
            reference = self.extract_reference(sample)
            if not reference:
                continue
            audio = sample["audio"]
            t0 = time.time()
            try:
                hypothesis = self.diarize_fn(
                    np.asarray(audio["array"], np.float32),
                    sample_rate=int(audio.get("sampling_rate", 16000)),
                )
                error = None
            except Exception as e:
                hypothesis, error = [], str(e)
            metrics = diarization_error_rate(
                reference, hypothesis, collar=self.collar
            )
            metrics["time_s"] = time.time() - t0
            if error:
                metrics["error"] = error
            results.append(metrics)
            if verbose and (i + 1) % 20 == 0:
                print(f"[eval] {i + 1} samples", flush=True)

        return results, self.compute_metrics(results)

    @staticmethod
    def compute_metrics(results: list[dict]) -> dict:
        """Total-duration-weighted corpus DER."""
        if not results:
            return {"corpus_der": 0.0, "num_samples": 0}
        total = sum(r["total"] for r in results)
        err = sum(r["missed"] + r["false_alarm"] + r["confusion"] for r in results)
        return {
            "corpus_der": 100.0 * err / total if total > 0 else 0.0,
            "avg_der": 100.0 * float(np.mean([
                r["der"] for r in results if np.isfinite(r["der"])
            ])),
            "num_samples": len(results),
            "errors": sum(1 for r in results if "error" in r),
        }


# ---------------------------------------------------------------------------
# API backends: segment extraction from vendor response JSON
# ---------------------------------------------------------------------------


def assemblyai_segments(response: dict) -> list[dict]:
    """AssemblyAI ``utterances`` (ms) -> segment dicts (s)."""
    return [
        {"speaker": str(u["speaker"]), "start": u["start"] / 1000.0,
         "end": u["end"] / 1000.0}
        for u in (response.get("utterances") or [])
    ]


def deepgram_segments(response: dict) -> list[dict]:
    """Deepgram ``results.utterances`` -> segment dicts."""
    utterances = (response.get("results") or {}).get("utterances") or []
    return [
        {"speaker": f"SPEAKER_{u['speaker']}", "start": float(u["start"]),
         "end": float(u["end"])}
        for u in utterances
    ]


def elevenlabs_segments(response: dict) -> list[dict]:
    """ElevenLabs scribe word-level ``speaker_id`` -> segments by grouping
    consecutive words of the same speaker."""
    segments: list[dict] = []
    cur = None
    for word in response.get("words") or []:
        spk, start, end = (word.get("speaker_id"), word.get("start"),
                           word.get("end"))
        if spk is None or start is None or end is None:
            continue
        if cur is not None and spk == cur["speaker_id"]:
            cur["end"] = float(end)
            continue
        if cur is not None:
            segments.append({"speaker": f"SPEAKER_{cur['speaker_id']}",
                             "start": cur["start"], "end": cur["end"]})
        cur = {"speaker_id": spk, "start": float(start), "end": float(end)}
    if cur is not None:
        segments.append({"speaker": f"SPEAKER_{cur['speaker_id']}",
                         "start": cur["start"], "end": cur["end"]})
    return segments


def _api_diarize_fn(backend: str, **client_kwargs):
    """Build a ``diarize_fn(audio_array, sample_rate)`` for an API backend."""
    from tiny_audio_tpu_torch.eval.evaluators import api

    def fn(audio_array, sample_rate=16000):
        wav = api.audio_to_wav_bytes(
            {"array": audio_array, "sampling_rate": sample_rate}
        )
        if backend == "assemblyai":
            resp = api.assemblyai_transcribe(
                wav, api.require_key("ASSEMBLYAI_API_KEY"),
                speaker_labels=True, **client_kwargs,
            )
            return assemblyai_segments(resp)
        if backend == "deepgram":
            resp = api.deepgram_transcribe(
                wav, api.require_key("DEEPGRAM_API_KEY"),
                diarize=True, utterances=True, **client_kwargs,
            )
            return deepgram_segments(resp)
        if backend == "elevenlabs":
            resp = api.elevenlabs_transcribe(
                wav, api.require_key("ELEVENLABS_API_KEY"),
                diarize=True, **client_kwargs,
            )
            return elevenlabs_segments(resp)
        raise ValueError(f"unknown diarization backend {backend!r}")

    return fn


DIARIZATION_API_BACKENDS = ("assemblyai", "deepgram", "elevenlabs")
API_KEY_ENV = {
    "assemblyai": "ASSEMBLYAI_API_KEY",
    "deepgram": "DEEPGRAM_API_KEY",
    "elevenlabs": "ELEVENLABS_API_KEY",
}


def make_diarization_evaluator(backend: str = "local",
                               **kwargs) -> DiarizationEvaluator:
    """Backend dispatch: 'local' or an API vendor name (key-gated).

    ``kwargs`` go to :class:`DiarizationEvaluator` (``device`` for the local
    backend).  Unknown backends fail HERE, not per-sample: a deferred ValueError inside
    diarize_fn would be swallowed by the evaluator's per-sample error
    handling and score every sample against an empty hypothesis — a run
    that "succeeds" with ~100% DER."""
    if backend == "local":
        return DiarizationEvaluator(**kwargs)
    if backend not in DIARIZATION_API_BACKENDS:
        raise ValueError(
            f"unsupported diarization backend {backend!r}; "
            f"use 'local' or one of {DIARIZATION_API_BACKENDS}"
        )
    from tiny_audio_tpu_torch.eval.evaluators import api

    # key check EAGERLY too: a missing key raising per-sample inside
    # diarize_fn is swallowed by the eval loop — same silent-100%-DER
    # failure mode as an unknown backend
    api.require_key(API_KEY_ENV[backend])
    return DiarizationEvaluator(
        diarize_fn=_api_diarize_fn(backend),
        model_name=f"{backend}-diarization", **kwargs,
    )
