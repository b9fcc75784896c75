"""Inference-endpoint handler: the serving entry contract.

Port of :mod:`tiny_audio_tpu.handler`: ``EndpointHandler(path)`` loads a
checkpoint of the JAX package's layout (:meth:`ASRModel.from_pretrained`)
into an :class:`~tiny_audio_tpu_torch.pipeline.ASRPipeline` on the card;
calling it with ``{"inputs": <bytes|array|path>, "parameters": {...}}``
returns the pipeline's result dict.  The int8 decode modes are opt-in, by
argument or environment variable.  There is no compile cache to enable:
:meth:`warmup` runs every bucket once so that the first request does not
pay for the kernels' build and the first use of each shape.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import numpy as np


class EndpointHandler:
    def __init__(self, path: str = "", pipeline=None, tp: int = 1,
                 dp: Optional[int] = None, wq_decode: bool = False,
                 w8a8_head: bool = False, w8a8_decode: bool = False,
                 device="cuda"):
        """``pipeline``: serve this pipeline instead of loading ``path``
        (on ``device``: the card unless the caller asks for ``"cpu"``).

        ``wq_decode``: weight-only int8 decode (``ASRModel.enable_wq_decode``,
        kernel #6); also ``TA_WQ_DECODE=1``.  ``w8a8_head``: the W8A8 LM head
        (``enable_w8a8_head``, kernel #5); also ``TA_W8A8_HEAD=1``.
        ``w8a8_decode``: W8A8 for every decode-step product
        (``enable_w8a8_decode``, kernel #5; supersedes both); also
        ``TA_W8A8_DECODE=1``.

        ``tp``/``dp`` > 1 (a device mesh) are not ported (ROADMAP.md Queue 1
        #13) and raise."""
        if tp > 1 or (dp or 1) > 1:
            raise NotImplementedError(
                "tp/dp > 1: multi-GPU serving is not ported to PyTorch yet "
                "(ROADMAP.md Queue 1 #13)")
        if pipeline is not None:
            self.pipe = pipeline
        else:
            from tiny_audio_tpu_torch.models.asr import ASRModel
            from tiny_audio_tpu_torch.pipeline import ASRPipeline

            self.pipe = ASRPipeline(ASRModel.from_pretrained(path, device=device))
        if wq_decode or os.environ.get("TA_WQ_DECODE") == "1":
            self.pipe.model.enable_wq_decode()
        if w8a8_head or os.environ.get("TA_W8A8_HEAD") == "1":
            self.pipe.model.enable_w8a8_head()
        if w8a8_decode or os.environ.get("TA_W8A8_DECODE") == "1":
            self.pipe.model.enable_w8a8_decode()

    def warmup(self, seconds: Optional[float] = None,
               longform: bool = True, batched: bool = False,
               log=print) -> float:
        """Run the serving shapes once at boot; returns total seconds.

        Without ``seconds``, runs the bottom and the top of every mel bucket
        (a bucket spans at most two prompt buckets) and, when ``longform``,
        the 2/4/8-chunk long-form batches; with ``batched`` (dynamic request
        batching), also ``transcribe_batch`` at each batch bucket.  With
        ``seconds``, just that one length.  Per-call wall seconds go to
        ``log``."""
        from tiny_audio_tpu_torch.ops import mel

        total = 0.0

        def _run(desc: str, fn) -> None:
            nonlocal total
            t0 = time.time()
            fn()
            dt = time.time() - t0
            total += dt
            log(f"[warmup] {desc}: {dt:.1f}s")

        if seconds is not None:
            _run(f"solo {seconds:g}s",
                 lambda: self.pipe(np.zeros(int(seconds * 16000), np.float32)))
            return total
        buckets = getattr(self.pipe.processor, "mel_buckets", (3000,))
        prev = 0
        for frames in buckets:
            lengths = sorted({(prev + 1) * mel.HOP_LENGTH, frames * mel.HOP_LENGTH})
            prev = frames
            for n in lengths:
                _run(f"solo bucket {frames}f ({n / 16000:.1f}s)",
                     lambda n=n: self.pipe(np.zeros(n, np.float32)))
                if batched:
                    for rows in self.pipe.BATCH_BUCKETS[1:]:  # 1 == solo
                        _run(f"batch bucket {frames}f x{rows} ({n / 16000:.1f}s)",
                             lambda n=n, rows=rows: self.pipe.transcribe_batch(
                                 [np.zeros(n, np.float32)] * rows))
        if longform:
            for nchunks in (2, 4, 8):
                _run(f"longform {nchunks}-chunk",
                     lambda nchunks=nchunks: self.pipe(
                         np.zeros(nchunks * 3000 * mel.HOP_LENGTH, np.float32)))
        log(f"[warmup] total: {total:.1f}s")
        return total

    def __call__(self, data: dict[str, Any]) -> dict:
        inputs = data.get("inputs")
        if inputs is None:
            return {"error": "missing 'inputs'"}
        parameters: dict = data.get("parameters") or {}
        try:
            return self.pipe(inputs, **parameters)
        except Exception as e:  # serving must not crash on one bad request
            return {"error": f"{type(e).__name__}: {e}"}
