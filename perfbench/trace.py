"""The traced window: device events in memory, split into units, reduced.

``Recorder`` runs ``torch.profiler`` with CUDA activity only (kernels,
copies and sets on the device, no host operator events) and reads the
events from the profiler's results in memory: no trace file is written.
The harness launches a marker kernel (``marker``: an ``erfinv`` of one
element) on the device at the start of every unit of the traced window (a
serving lap, a training step), so each device event falls in the unit
whose marker precedes it.  Reducers here are pure functions of event lists,
so the tests drive them with synthetic events.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

#: kernel keys -> name patterns, from every ``kernel_names*.json`` beside
#: this file (a later change adds kernels in a file of its own)
NAMES = {k: re.compile(v) for path in sorted(Path(__file__).parent.glob("kernel_names*.json"))
         for k, v in json.loads(path.read_text()).items() if k != "why"}


@dataclass
class Event:
    name: str
    start: float  # seconds on the device clock
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclass
class Unit:
    """One lap or step: its events (the marker first), sorted by start."""
    events: list = field(default_factory=list)
    _found: dict = field(default_factory=dict, repr=False)

    @property
    def start(self) -> float:
        return self.events[0].start

    @property
    def end(self) -> float:
        return max(e.end for e in self.events)

    def of(self, key: str) -> list:
        """The unit's events whose name matches kernel key ``key``."""
        if key not in self._found:
            pattern = NAMES[key]
            self._found[key] = [e for e in self.events if pattern.search(e.name)]
        return self._found[key]


def split_units(events: list) -> list:
    """Device events (any order) -> units, each opened by a marker event;
    events before the first marker are dropped."""
    units: list = []
    for e in sorted(events, key=lambda e: e.start):
        if NAMES["marker"].search(e.name):
            units.append(Unit([e]))
        elif units:
            units[-1].events.append(e)
    return units


def union_s(events: list) -> float:
    """Seconds covered by at least one event."""
    total, cur_start, cur_end = 0.0, None, None
    for e in sorted(events, key=lambda e: e.start):
        if cur_end is None or e.start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = e.start, e.end
        else:
            cur_end = max(cur_end, e.end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def window_s(units: list) -> float:
    """From the first unit's marker to the end of the last unit's last event."""
    return units[-1].end - units[0].start if units else 0.0


def idle_gaps(units: list, phases) -> dict:
    """Idle seconds of the device between a unit's events, summed by label.
    ``phases(unit)`` gives ``[(start, phase name), ...]`` in order; a gap's
    label is the phase it ends in and the short name of the event before
    it."""
    gaps: dict = {}
    for unit in units:
        bounds = phases(unit)
        starts = [t for t, _ in bounds]
        end = unit.events[0].end
        for prev, e in zip(unit.events, unit.events[1:]):
            if e.start > end:
                phase = bounds[max(bisect.bisect_right(starts, e.start) - 1, 0)][1]
                label = f"{phase} after {short(prev.name)}"
                gaps[label] = gaps.get(label, 0.0) + (e.start - end)
            end = max(end, e.end)
    return gaps


def short(name: str, n: int = 96) -> str:
    """A kernel name cut to its first ``n`` characters."""
    return name if len(name) <= n else name[:n]


def top(totals: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def device_ops(units: list) -> dict:
    totals: dict = {}
    for unit in units:
        for e in unit.events:
            key = short(e.name)
            totals[key] = totals.get(key, 0.0) + e.dur
    return totals


def wrapper_counts(wrappers: dict) -> dict:
    """The launch counters of the port's kernel wrappers: ``{key: count}``
    for ``wrappers`` ``{key: (module, function)}``."""
    import importlib

    return {key: getattr(importlib.import_module(mod), fn).launches
            for key, (mod, fn) in wrappers.items()}


class Recorder:
    """``torch.profiler`` over the traced units; :meth:`events` after
    :meth:`stop` gives the device events, and ``launched`` the launches the
    counters of ``wrappers`` (as :func:`wrapper_counts` takes them) saw."""

    def __init__(self, device, wrappers=None):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.device = device
        self.wrappers = wrappers or {}
        self.launched: dict = {}
        self.marker_tensor = torch.zeros(1, dtype=torch.float32, device=device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self.launched = wrapper_counts(self.wrappers)
        self.prof.start()

    def marker(self) -> None:
        """Open a unit on the device timeline."""
        self.marker_tensor.erfinv_()

    def stop(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self.prof.stop()
        after = wrapper_counts(self.wrappers)
        self.launched = {key: after[key] - self.launched[key] for key in self.wrappers}

    def events(self) -> list:
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                start = e.start_ns() * 1e-9
                out.append(Event(e.name(), start, start + e.duration_ns() * 1e-9))
        return out
