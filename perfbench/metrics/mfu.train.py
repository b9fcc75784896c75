"""Whole optimizer step: the model FLOPs of stage 1 (encoder forward,
projector forward and backward, decoder forward and input-gradient backward,
head) over an untraced step's host seconds at the bf16 peak."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "whole step", "%", "higher", "train_step_ms"


def read(ctx):
    return readers.mfu_pct(ctx) if ctx.kind == "train" else None
