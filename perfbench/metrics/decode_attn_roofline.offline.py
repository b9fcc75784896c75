"""Kernel #4 (fused decode attention with the cache append): the least time
of its calls over their event time, across the traced laps."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "kernels", "%", "higher", "rtfx"


def read(ctx):
    if ctx.kind != "serve":
        return None
    return readers.roofline_pct(ctx, ("decode_attn",), "decode_attn")
