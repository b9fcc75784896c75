"""Evaluator base: per-sample loop, WER accounting, parallel workers.

Port of :mod:`tiny_audio_tpu.eval.evaluators.base`: lazy sequential or
thread-pool evaluation with per-sample WER on normalized text, corpus WER,
the TEDLIUM / inaudible skip filter, progress lines every 100 samples, and
per-sample wall-clock timing.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

import numpy as np

from tiny_audio_tpu_torch.eval.normalizer import TextNormalizer
from tiny_audio_tpu_torch.eval.wer import align_counts


@dataclass
class EvalResult:
    reference: str
    prediction: str
    wer: float  # percent
    time_s: float = 0.0
    extra: dict = field(default_factory=dict)


_SKIP_MARKERS = ("ignore_time_segment_in_scoring", "<inaudible>")


def should_skip_reference(text: str) -> bool:
    t = (text or "").strip().lower()
    return not t or any(m in t for m in _SKIP_MARKERS)


class Evaluator:
    """Subclasses implement :meth:`transcribe`."""

    def __init__(self, model_name: str = "model", num_workers: int = 1):
        self.model_name = model_name
        self.num_workers = num_workers
        self.normalizer = TextNormalizer()

    # ------------------------------------------------------------- interface

    def transcribe(self, audio: dict, sample: dict) -> str:
        raise NotImplementedError

    def extract_reference(self, sample: dict, text_column: str = "text") -> str:
        return sample.get(text_column) or sample.get("text") or ""

    # ------------------------------------------------------------------ loop

    def _eval_one(self, sample: dict, text_column: str) -> Optional[EvalResult]:
        reference = self.extract_reference(sample, text_column)
        if should_skip_reference(reference):
            return None
        audio = sample.get("audio")
        t0 = time.time()
        try:
            prediction = self.transcribe(audio, sample)
        except Exception as e:  # one failed sample scores 100% and the run goes on
            return EvalResult(
                reference=reference, prediction="", wer=100.0,
                time_s=time.time() - t0, extra={"error": str(e)},
            )
        dt = time.time() - t0
        ref_n = self.normalizer.normalize(reference)
        if not ref_n.strip():
            # Normalization emptied a raw reference ('mm-hmm', '***', '.'):
            # align_counts([], hyp) is WER=inf, which would poison
            # avg_sample_wer and the running-WER checkpoints — skip, like
            # should_skip_reference does for raw-empty text.
            return None
        hyp_n = self.normalizer.normalize(prediction)
        counts = align_counts(ref_n.split(), hyp_n.split())
        return EvalResult(
            reference=reference, prediction=prediction,
            wer=100.0 * counts.wer, time_s=dt,
            extra={"counts": counts},
        )

    def evaluate(
        self,
        dataset: Iterable[dict],
        num_samples: Optional[int] = None,
        text_column: str = "text",
        verbose: bool = True,
    ) -> tuple[list[EvalResult], dict]:
        import itertools

        # LAZY iteration (the module contract): a streaming HF dataset must
        # not be materialized up front — decoded waveforms for a full test
        # set are tens of GB.  The thread pool path submits in bounded
        # windows for the same reason.
        rows = iter(dataset)
        if num_samples:
            rows = itertools.islice(rows, num_samples)

        results: list[EvalResult] = []
        if self.num_workers > 1:
            window = max(4 * self.num_workers, 16)
            i = 0
            with ThreadPoolExecutor(self.num_workers) as pool:
                while True:
                    chunk = list(itertools.islice(rows, window))
                    if not chunk:
                        break
                    futures = [
                        pool.submit(self._eval_one, s, text_column)
                        for s in chunk
                    ]
                    for fut in futures:
                        i += 1
                        r = fut.result()
                        if r is not None:
                            results.append(r)
                        if verbose and i % 100 == 0:
                            self._checkpoint(i, results)
        else:
            for i, s in enumerate(rows, 1):
                r = self._eval_one(s, text_column)
                if r is not None:
                    results.append(r)
                if verbose and i % 100 == 0:
                    self._checkpoint(i, results)

        return results, self.compute_metrics(results)

    def _checkpoint(self, i: int, results: list[EvalResult]) -> None:
        if results:
            wers = [r.wer for r in results]
            print(f"[eval] {i} samples, running WER {np.mean(wers):.2f}%", flush=True)

    # --------------------------------------------------------------- metrics

    def compute_metrics(self, results: list[EvalResult]) -> dict:
        """Corpus WER over normalized text (total edits / total reference words).
        Per-sample alignments are reused from the eval loop; only error
        rows (no counts cached) are re-aligned."""
        if not results:
            return {"corpus_wer": 0.0, "num_samples": 0}
        total = None
        for r in results:
            c = r.extra.get("counts")
            if c is None:
                ref_n = self.normalizer.normalize(r.reference)
                hyp_n = self.normalizer.normalize(r.prediction)
                c = align_counts(ref_n.split(), hyp_n.split())
            total = c if total is None else total + c
        times = [r.time_s for r in results]
        return {
            "corpus_wer": 100.0 * total.wer,
            "avg_sample_wer": float(np.mean([r.wer for r in results])),
            "num_samples": len(results),
            "avg_time_s": float(np.mean(times)),
            "errors": sum(1 for r in results if "error" in r.extra),
        }
