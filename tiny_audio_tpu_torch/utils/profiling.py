"""Profiling & timing observability.

``trace`` captures a ``torch.profiler`` trace of a block (CPU activity, and
on the card CUDA kernels too) as a Chrome trace file that TensorBoard's
profiler plugin and ``chrome://tracing`` read; the program's spans show in
it.  ``StageTimer`` is a lightweight wall-clock timer per named stage that
is safe in production code.  The timer reads the host clock only: close a
stage that launches work on the card with ``torch.cuda.synchronize()``
inside it, or the stage measures the launches and not the work.

Spans (:func:`span`, :func:`sync`) mark the program's own work where it
happens: the front end, the encoder, the prefill, each decode step, each
training micro-step and update.  They are off unless :func:`enable` turns
them on; off, each call returns one shared no-op context after a single
check, and reads no clock and makes no CUDA call.  On, a span records its
name, its host start and end, its parent (the innermost span open on the
thread) and its root (the outermost: every span of one ``generate`` call or
one training micro-step shares it), and on the card two CUDA events on the
current stream, whose elapsed time :func:`drain` reads (never the hot
path).  A :func:`sync` span marks a read that blocks the host on the
device (a device-to-host copy, or a copy from pageable host memory): the
number of host reads is the number of ``sync.*`` spans.  Host times are
given on ``torch.profiler``'s clock (Unix-epoch nanoseconds), so spans and
a profiler's device events share one timeline.  Spans are kept in a ring of
the newest :data:`RING`: a server that turns them on does not grow.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

from tiny_audio_tpu_torch.device import require_device


@contextlib.contextmanager
def trace(log_dir: str | Path = "outputs/traces", device="cuda") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (``<host>_<pid>.<time>.pt.trace.json``).  On a CUDA device
    it records the CPU and the CUDA activity, and waits for the card's work
    before the trace stops; it raises when there is no card.  Only
    ``device="cpu"`` records the CPU alone.  Spans are on inside the block,
    each a ``record_function`` range of the trace."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    device = require_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        with _annotated():
            try:
                yield
            finally:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)


@contextlib.contextmanager
def _annotated() -> Iterator[None]:
    """Spans on for the block, each also a ``record_function`` range of the
    profiler's trace; as they were after it."""
    rec = _recorder if _on else None
    if rec is None:
        enable()
    was, _recorder.annotate = _recorder.annotate, True
    try:
        yield
    finally:
        _recorder.annotate = was
        if rec is None:
            disable()


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


# ------------------------------------------------------------------ spans


class _Off:
    """The one context every span call returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()
#: the spans a recorder keeps: the newest this many
RING = 65536
#: the one check a span call makes: spans on or off
_on = False
#: the recorder of the last :func:`enable` (kept after :func:`disable`, so
#: that what it holds can still be drained)
_recorder: Optional["_Recorder"] = None


class _Recorder:
    def __init__(self, cuda: bool):
        self.done: collections.deque = collections.deque(maxlen=RING)
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.cuda = cuda
        self.annotate = False
        # perf_counter_ns -> the profiler's clock (Unix-epoch ns)
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


class _Span:
    __slots__ = ("rec", "name", "rows", "timed", "id", "parent", "root", "t0", "t1",
                 "events", "annotation")

    def __init__(self, rec: _Recorder, name: str, rows: Optional[int], timed: bool):
        self.rec, self.name, self.rows = rec, name, rows
        self.timed = timed and rec.cuda
        self.events = self.annotation = None

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        self.id = next(rec.ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[-1].root if stack else self.id
        stack.append(self)
        if rec.annotate:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        if self.timed:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.rec.stack().pop()
        self.rec.done.append(self)


def span(name: str, rows: Optional[int] = None):
    """A span of the program's work named ``name`` (a context manager);
    ``rows``, the batch it works on, is kept with it when given."""
    if not _on:
        return _OFF
    return _Span(_recorder, name, rows, True)


def sync(what: str):
    """A span named ``sync.<what>`` around one read that blocks the host on
    the device; it records no device time."""
    if not _on:
        return _OFF
    return _Span(_recorder, "sync." + what, None, False)


def enable() -> None:
    """Spans on, into a new ring of the newest :data:`RING` spans.  On the
    card (CUDA initialised) each span other than a sync also records two
    CUDA events."""
    global _on, _recorder
    _recorder = _Recorder(torch.cuda.is_available() and torch.cuda.is_initialized())
    _on = True


def disable() -> None:
    """Spans off; what was recorded can still be drained."""
    global _on
    _on = False


def drain() -> list[dict]:
    """The finished spans since the last drain, oldest first, each a dict:
    ``name``, ``id``, ``parent`` and ``root`` (ids; ``parent`` None for a
    root), ``start_ns`` and ``end_ns`` on the profiler's clock (Unix-epoch
    ns), ``device_ms`` (the CUDA events' elapsed time; None for a sync and
    off the card) and ``attrs`` (``rows`` where the span was given it).
    Waits for the device to pass the spans' end events."""
    rec = _recorder
    if rec is None:
        return []
    out = []
    while rec.done:
        s = rec.done.popleft()
        device_ms = None
        if s.events is not None:
            s.events[1].synchronize()
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
                    "start_ns": s.t0 + rec.offset_ns, "end_ns": s.t1 + rec.offset_ns,
                    "device_ms": device_ms,
                    "attrs": {} if s.rows is None else {"rows": s.rows}})
    return out
