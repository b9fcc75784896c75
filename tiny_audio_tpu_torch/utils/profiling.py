"""Profiling & timing observability.

``trace`` captures a ``torch.profiler`` trace of a block (CPU activity, and
on the card CUDA kernels too) as a Chrome trace file that TensorBoard's
profiler plugin and ``chrome://tracing`` read.  ``StageTimer`` is a
lightweight wall-clock timer per named stage that is safe in production
code.  The timer reads the host clock only: close a stage that launches
work on the card with ``torch.cuda.synchronize()`` inside it, or the stage
measures the launches and not the work.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Iterator

from tiny_audio_tpu_torch.device import require_device


@contextlib.contextmanager
def trace(log_dir: str | Path = "outputs/traces", device="cuda") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (``<host>_<pid>.<time>.pt.trace.json``).  On a CUDA device
    it records the CPU and the CUDA activity, and waits for the card's work
    before the trace stops; it raises when there is no card.  Only
    ``device="cpu"`` records the CPU alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    device = require_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        try:
            yield
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)


class StageTimer:
    """Accumulates wall-clock per named stage; JSON-serializable summary.

    >>> timer = StageTimer()
    >>> with timer.stage("mel"): ...
    >>> with timer.stage("decode"): ...
    >>> timer.summary()  # {"mel": {...}, "decode": {...}}
    """

    def __init__(self):
        self._stats: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stats.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> dict:
        import numpy as np

        out = {}
        for name, times in self._stats.items():
            arr = np.asarray(times)
            out[name] = {
                "count": len(times),
                "total_s": float(arr.sum()),
                "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "max_s": float(arr.max()),
            }
        return out

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))
