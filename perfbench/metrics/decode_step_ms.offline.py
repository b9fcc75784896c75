"""Decode loop: an untraced lap's host time less the traced lap's span from
its marker to its first #4 event, over its decode steps (host gaps and the
lap's post-processing included); the mean over the traced laps."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "decode loop", "ms", "lower", "rtfx"


def read(ctx):
    if ctx.kind != "serve":
        return None
    return readers.mean_ms([readers.decode_step_s(u, ctx.decode_steps, ctx.unit_s)
                            for u in ctx.units])
