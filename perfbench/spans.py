"""The program's own spans in a traced run, and their reductions.

The port records spans of its work (``tiny_audio_tpu_torch.utils.
profiling``: ``span``, ``sync``, ``enable``, ``disable``, ``drain``) on the
clock of ``torch.profiler``'s events.  ``run.py`` does not call this module
yet: its per-layer metrics wait on the traced run's spans-on phase (PERF.md
§7).  A traced run is to read them twice:

- spans-on units (:func:`spans_on_units`), before the window and without
  the profiler, which slows the host: the host-paced span metrics (a decode
  step's launches and its wait, host reads, post-processing) and the span
  device times (CUDA events);
- the profiled units (:class:`SpanRecorder`, spans on beside the profiler):
  launch calls inside decode steps, and the device's idle seconds put down
  to the innermost span open on the host across each gap.

A span record is the program's dict: ``name``, ``id``, ``parent``,
``root``, ``start_ns``, ``end_ns`` (Unix-epoch ns), ``device_ms`` (None off
the card and for a sync), ``attrs``.  A program without spans (an older
commit) gives none, and every reader here then finds nothing to read.
Reductions are pure functions of span records and events, so the tests
drive them with synthetic ones.
"""

from __future__ import annotations

import bisect
import re
import time

from perfbench import readers, trace
from perfbench.trace import Event

#: the CUDA runtime and driver calls that put work on a stream
LAUNCH = re.compile(r"^cuda(?:LaunchKernel|GraphLaunch|Memcpy\w*Async|MemsetAsync)|"
                    r"^cuLaunchKernel")
#: the label of idle seconds with no span open on the host
OUTSIDE = "outside spans"


def program_spans():
    """The port's span recorder module, or None where the program has none."""
    try:
        from tiny_audio_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "drain") else None


def spans_on_units(lap, n: int, sync=lambda: None) -> dict:
    """``n`` units with spans on and no profiler: ``units`` (each unit's
    span records) and ``unit_s`` (each unit's host seconds).  Nothing runs,
    and spans stay off, where ``n`` is 0 or the program has no spans."""
    program = program_spans() if n > 0 else None
    out = {"units": [], "unit_s": []}
    if program is None:
        return out
    program.enable()
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            lap.unit()
            out["unit_s"].append(time.perf_counter() - t0)
            sync()
            out["units"].append(program.drain())
    finally:
        program.disable()
        program.drain()
    return out


class SpanRecorder(trace.Recorder):
    """The traced units' recorder with the program's spans on beside the
    profiler: after :meth:`stop`, ``unit_spans`` holds each unit's span
    records (by the host time of its marker), ``stop_s`` the host time at
    the last unit's end; :meth:`launches_and_compute` reads the profiler's
    launch calls and the compute stream's device events."""

    def __init__(self, device, wrappers=None):
        super().__init__(device, wrappers)
        self.program = program_spans()
        self.marks: list = []
        self.unit_spans: list = []
        self.stop_s = 0.0

    def start(self) -> None:
        if self.program:
            self.program.enable()
        super().start()

    def marker(self) -> None:
        self.marks.append(time.time_ns() * 1e-9)
        super().marker()

    def stop(self) -> None:
        self.stop_s = time.time_ns() * 1e-9
        if self.program:
            self.program.disable()
        super().stop()
        records = self.program.drain() if self.program else []
        self.unit_spans = split_by_marks(records, self.marks) if records else []

    def launches_and_compute(self) -> tuple:
        """(the runtime and driver calls that launch work, as host events;
        the device events on the stream the markers ran on, the compute
        stream), each sorted by start."""
        from torch.autograd import DeviceType

        launches, by_stream, marker_streams = [], {}, set()
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns() * 1e-9
            if e.device_type() == DeviceType.CPU:
                if LAUNCH.search(e.name()):
                    launches.append(Event(e.name(), start, start + e.duration_ns() * 1e-9))
            elif e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                stream = e.device_resource_id()
                by_stream.setdefault(stream, []).append(
                    Event(e.name(), start, start + e.duration_ns() * 1e-9))
                if trace.NAMES["marker"].search(e.name()):
                    marker_streams.add(stream)
        compute = [e for s in marker_streams for e in by_stream[s]]
        return (sorted(launches, key=lambda e: e.start),
                sorted(compute, key=lambda e: e.start))


def split_by_marks(records: list, marks: list) -> list:
    """Span records -> one list per unit, by the host time (s) of each
    unit's start; spans before the first mark are dropped."""
    units: list = [[] for _ in marks]
    for r in records:
        i = bisect.bisect_right(marks, r["start_ns"] * 1e-9) - 1
        if i >= 0:
            units[i].append(r)
    return units


# ------------------------------------------------------------ per unit


def host_s(record: dict) -> float:
    return (record["end_ns"] - record["start_ns"]) * 1e-9


def named(unit: list, *names: str) -> list:
    return [r for r in unit if r["name"] in names]


def device_ms(unit: list, *names: str):
    """The device milliseconds of the spans ``names`` in a unit, summed;
    None where there are none or one has no device time."""
    found = named(unit, *names)
    if not found or any(r["device_ms"] is None for r in found):
        return None
    return sum(r["device_ms"] for r in found)


def decode_split_ms(unit: list):
    """(dispatch, wait): a decode step's mean host milliseconds outside its
    ``sync.finished`` read (the step's launches) and inside it; None
    without decode steps."""
    steps = named(unit, "decode_step")
    if not steps:
        return None
    waits: dict = {}
    for r in named(unit, "sync.finished"):
        waits[r["parent"]] = waits.get(r["parent"], 0.0) + host_s(r)
    wait = sum(waits.get(s["id"], 0.0) for s in steps)
    total = sum(host_s(s) for s in steps)
    return 1e3 * (total - wait) / len(steps), 1e3 * wait / len(steps)


def host_syncs(unit: list):
    """The host reads of a unit: its ``sync.*`` spans (None without spans)."""
    return sum(r["name"].startswith("sync.") for r in unit) if unit else None


def postprocess_ms(unit: list):
    """Host milliseconds of a unit's token fetch and post-processing."""
    found = named(unit, "sync.fetch", "postprocess")
    return 1e3 * sum(host_s(r) for r in found) if found else None


def decode_agreement(on_units: list, on_unit_s: list, traced: list, steps: int,
                     unit_s: float):
    """A serving cell's decode spans against ``decode_step_ms.offline``'s
    subtraction (``readers.decode_step_s`` on the ``traced`` units, with
    ``steps`` decode steps a lap): ``spans``, each spans-on lap's dispatch +
    wait + post-processing over its steps; ``same_laps``, the subtraction
    on that lap's own host seconds (``on_unit_s``); ``window``, on the
    window's (``unit_s``, the metric's); ``over_same_laps`` and
    ``over_window``, the spans' medians over those less 1.  None without
    decode spans or traced units."""
    if not traced or steps <= 0 or not on_units or len(on_unit_s) != len(on_units):
        return None
    split = [decode_split_ms(u) for u in on_units]
    post = [postprocess_ms(u) for u in on_units]
    if any(x is None for x in split + post):
        return None
    summed = [d + w + p / steps for (d, w), p in zip(split, post)]
    same = [readers.mean_ms([readers.decode_step_s(u, steps, s) for u in traced])
            for s in on_unit_s]
    window = readers.mean_ms([readers.decode_step_s(u, steps, unit_s) for u in traced])
    if window is None or any(x is None for x in same):
        return None
    return {"spans": summed, "same_laps": same, "window": window,
            "over_same_laps": median([a / b for a, b in zip(summed, same)]) - 1,
            "over_window": median(summed) / window - 1}


def median(values: list):
    """The median over units; None where a unit gives nothing."""
    if not values or any(v is None for v in values):
        return None
    s = sorted(values)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2


# --------------------------------------------- profiled units: launches, idle


def intervals(unit: list, name: str) -> list:
    """[(start s, end s)] of a unit's spans ``name``, sorted."""
    return sorted((r["start_ns"] * 1e-9, r["end_ns"] * 1e-9) for r in named(unit, name))


def count_inside(events: list, spans: list) -> int:
    """Events (sorted by start) whose start lies inside one of ``spans``
    (sorted, disjoint intervals)."""
    starts = [e.start for e in events]
    return sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a) for a, b in spans)


def launches_per_step(unit: list, launches: list):
    """Launch calls inside the unit's decode steps, per step; None without
    steps or without any recorded launch call."""
    steps = intervals(unit, "decode_step")
    if not steps or not launches:
        return None
    return count_inside(launches, steps) / len(steps)


def idle_intervals(units: list, end: float = 0.0) -> list:
    """Each traced unit's device-idle intervals [(start, end)] in seconds:
    from its marker to the next unit's (the last unit: to the later of its
    last event and ``end``), the time no device event covers."""
    out = []
    for i, unit in enumerate(units):
        stop = units[i + 1].start if i + 1 < len(units) else max(unit.end, end)
        gaps, cur = [], unit.start
        for e in sorted(unit.events, key=lambda e: e.start):
            if e.start > cur:
                gaps.append((cur, min(e.start, stop)))
            cur = max(cur, e.end)
        if stop > cur:
            gaps.append((cur, stop))
        out.append([(a, b) for a, b in gaps if b > a])
    return out


def innermost(records: list) -> list:
    """Span records (properly nested) -> [(start, end, name)] segments in
    seconds, each labelled by the innermost span open across it."""
    spans = sorted(((r["start_ns"] * 1e-9, r["end_ns"] * 1e-9, r["name"]) for r in records),
                   key=lambda s: (s[0], -s[1]))
    out: list = []
    stack: list = []
    cursor = 0.0

    def close_until(t: float) -> None:
        nonlocal cursor
        while stack and stack[-1][1] <= t:
            top = stack.pop()
            if top[1] > cursor:
                out.append((cursor, top[1], top[2]))
                cursor = top[1]

    for s in spans:
        close_until(s[0])
        if stack and s[0] > cursor:
            out.append((cursor, s[0], stack[-1][2]))
        stack.append(s)
        cursor = s[0]
    close_until(float("inf"))
    return out


def idle_by_span(gaps: list, records: list) -> dict:
    """Idle seconds (``gaps``: [(start, end)]) summed by the innermost span
    open on the host across them; the rest under :data:`OUTSIDE`."""
    segments = innermost(records)
    starts = [s[0] for s in segments]
    out: dict = {}
    for a, b in gaps:
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segments) and segments[i][0] < b:
            lo, hi = max(a, segments[i][0]), min(b, segments[i][1])
            if hi > lo:
                out[segments[i][2]] = out.get(segments[i][2], 0.0) + (hi - lo)
                covered += hi - lo
            i += 1
        if b - a > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a - covered)
    return out


def sync_offsets_ms(records: list, compute: list, name: str = "") -> list:
    """For each ``sync.*`` span (only ``name`` if given): its end less the
    end of the last compute-stream event (sorted by start) that started
    before it, in ms.  A read returns after the work it waits for, so on
    one clock no offset lies much below 0."""
    starts = [e.start for e in compute]
    ends, last = [], float("-inf")
    for e in compute:
        last = max(last, e.end)
        ends.append(last)
    out = []
    for r in records:
        if not r["name"].startswith("sync.") or (name and r["name"] != name):
            continue
        t = r["end_ns"] * 1e-9
        i = bisect.bisect_left(starts, t) - 1
        if i >= 0:
            out.append(1e3 * (t - ends[i]))
    return out
