"""Whole lap: the model FLOPs of the real audio and text (encoder, projector,
prefill, decode steps) of a lap over an untraced lap's host seconds at the
bf16 peak."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "whole step", "%", "higher", "rtfx"


def read(ctx):
    return readers.mfu_pct(ctx) if ctx.kind == "serve" else None
