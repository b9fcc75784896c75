"""Bench entry points of the port: ``python -m tiny_audio_tpu_torch.tools.<name>``.

- :mod:`.bench_encoder_attention`: kernel #9a's 13 softmax modes beside #1
  and SDPA at the flagship encoder's attention shape;
- :mod:`.bench_wq_head`: kernels #9b-#9d beside #5, #6 and bf16
  ``F.linear`` at the flagship's LM head.

Both run on the card unless ``--device cpu`` is passed (the plain versions,
at small shapes, for the tests).
"""

from __future__ import annotations

import time

import torch


def time_ms(fn, reps: int, device: torch.device) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after two warmup
    calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
