"""Prefill: from a lap's first #2 event to its first decode-attention (#4)
event, the mean over laps."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "prefill", "ms", "lower", "rtfx"


def read(ctx):
    if ctx.kind != "serve":
        return None
    return readers.mean_ms([readers.prefill_s(u) for u in ctx.units])
