"""Kernel #2 (prefill attention, no statistics): the least time of its calls
over their event time, across the traced laps."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "kernels", "%", "higher", "rtfx"


def read(ctx):
    if ctx.kind != "serve":
        return None
    return readers.roofline_pct(ctx, ("prefill_attn",), "prefill_attn")
