"""Device: the peak of allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "device", "GiB", "lower", "rtfx"


def read(ctx):
    return readers.peak_gib(ctx) if ctx.kind == "serve" else None
