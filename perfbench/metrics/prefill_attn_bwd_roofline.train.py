"""Kernels #2b and #2c (the prefill attention's backward, dK/dV and dQ)
together: the least time of a layer's pair over the pair's event time,
across the traced steps."""
from perfbench import readers

LAYER, UNIT, BETTER, MOVES = "kernels", "%", "higher", "train_step_ms"


def read(ctx):
    if ctx.kind != "train":
        return None
    return readers.roofline_pct(ctx, ("prefill_attn_bwd_dkv", "prefill_attn_bwd_dq"),
                                "prefill_attn_bwd")
