"""What the per-layer readers share: the traced window's context and the
reductions the metrics files call.  A reader returns None where it finds
nothing to read, and the harness then leaves its metric out."""

from __future__ import annotations

from dataclasses import dataclass

from perfbench import flops


@dataclass
class Context:
    """The traced window of one run.

    ``units``: the traced laps or steps (``trace.Unit``); ``expected``: for
    each unit, the least seconds of each call of each kernel key, in launch
    order; ``model_flops``: the useful FLOPs of each unit; ``decode_steps``:
    decode steps a serving lap; ``peak_bytes``: the peak of allocated device
    memory over the window; ``unit_s``: the host seconds of a unit run
    without the profiler (the window's, before the traced units), since the
    profiler slows the host's launches and with them every host-paced span
    of the traced units."""

    kind: str
    units: list
    expected: list
    model_flops: list
    window_s: float
    busy_s: float
    peak_bytes: int
    decode_steps: int = 0
    unit_s: float = 0.0


def first_start(unit, key: str):
    events = unit.of(key)
    return events[0].start if events else None


def mean_ms(values: list):
    if not values or any(v is None for v in values):
        return None
    return 1e3 * sum(values) / len(values)


def encode_s(unit):
    t = first_start(unit, "prefill_attn")
    return None if t is None else t - unit.start


def prefill_s(unit):
    a, b = first_start(unit, "prefill_attn"), first_start(unit, "decode_attn")
    return None if a is None or b is None else b - a


def decode_step_s(unit, steps: int, unit_s: float):
    """An untraced lap's host seconds after its decode loop starts, over its
    decode steps: ``unit_s`` less the traced lap's span from its marker to
    its first #4 event (front end, encoder and prefill, paced by the
    device)."""
    t = first_start(unit, "decode_attn")
    if t is None or steps <= 0 or unit_s <= 0:
        return None
    return (unit_s - (t - unit.start)) / steps


def roofline_pct(ctx: Context, keys: tuple, expected_key: str):
    """The share of the least time in the kernels' event time over the
    window: None if a unit's events of ``keys`` do not pair with the calls
    the harness expects (the kernel left the path, or launches otherwise)."""
    least = spent = 0.0
    for unit, exp in zip(ctx.units, ctx.expected):
        calls = exp.get(expected_key)
        if not calls:
            return None
        for key in keys:
            events = unit.of(key)
            if len(events) != len(calls):
                return None
            spent += sum(e.dur for e in events)
        least += sum(calls)
    return 100.0 * least / spent if spent > 0 else None


def mfu_pct(ctx: Context):
    """A unit's model FLOPs over its untraced host seconds at the bf16 peak."""
    if ctx.unit_s <= 0 or not ctx.model_flops:
        return None
    per_unit = sum(ctx.model_flops) / len(ctx.model_flops)
    return 100.0 * per_unit / (ctx.unit_s * flops.PEAK_BF16_FLOPS)


def idle_pct(ctx: Context):
    """The share of an untraced unit's host seconds in which the device does
    not run the traced units' busy seconds a unit."""
    if ctx.unit_s <= 0 or not ctx.units:
        return None
    return 100.0 * (1.0 - ctx.busy_s / len(ctx.units) / ctx.unit_s)


def peak_gib(ctx: Context):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes > 0 else None
