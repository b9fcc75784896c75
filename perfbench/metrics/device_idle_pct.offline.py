"""Device: the share of an untraced unit's host time in which no event ran,
from the traced units' busy seconds a unit (the profiler slows the host, so
the traced units' own idle share reads high)."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "device", "%", "lower", "rtfx"


def read(ctx):
    return readers.idle_pct(ctx) if ctx.kind == "serve" else None
