"""Front end, encoder, projector and splice: each lap's device time from its
first event to its first prefill-attention (#2) event, the mean over laps."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "encoder", "ms", "lower", "rtfx"


def read(ctx):
    if ctx.kind != "serve":
        return None
    return readers.mean_ms([readers.encode_s(u) for u in ctx.units])
