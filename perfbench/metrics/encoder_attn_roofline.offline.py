"""Kernel #1 (encoder attention): the least time of its calls over their
event time, across the traced laps."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "kernels", "%", "higher", "rtfx"


def read(ctx):
    if ctx.kind != "serve":
        return None
    return readers.roofline_pct(ctx, ("encoder_attn",), "encoder_attn")
