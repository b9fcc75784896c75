"""Encoder-attention variants at the flagship encoder's attention shape.

    python -m tiny_audio_tpu_torch.tools.bench_encoder_attention
    python -m tiny_audio_tpu_torch.tools.bench_encoder_attention --device cpu \\
        --batch 2 --frames 512 --heads 4 --hg 2 --reps 1

The port's counterpart of ``scripts/bench_encoder_attention.py``: kernel
#9a (:mod:`tiny_audio_tpu_torch.ops.encoder_attention_variants`) under each
of its 13 softmax modes at ``hg`` heads per thread block (and ``fp32`` at the
other hg of the script's sweep), on q/k/v ``[32, 1536, 20 * 64]`` bf16 with
random key lengths in [T/2, T).  For each it prints the device milliseconds
per layer-call (CUDA events over ``--reps`` calls after warmup), the max
|error| on the real rows against a float64 oracle on a 4-batch slice, the
max |kernel - plain version| on that slice, and the share of its outputs
that differ from its own plain version and from the nearest other mode's
(:func:`apart`; :func:`modes_apart` tells apart, on scores of std 40, the
modes whose shifts cancel at this shape); then the yardsticks at the
same shape, kernel #1 (``encoder_attention``) and
``scaled_dot_product_attention`` with the key mask, and the fastest
variant.  It runs on the card unless ``--device cpu`` is passed (then every
variant is its plain version); a kernel that fails to build or launch fails
the run.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from tiny_audio_tpu_torch.device import require_device
from tiny_audio_tpu_torch.ops.encoder_attention import encoder_attention
from tiny_audio_tpu_torch.ops.encoder_attention_variants import (
    HEAD_DIM,
    MODES,
    SAME_FUNCTION,
    encoder_attention_fp64,
    encoder_attention_variant,
    encoder_attention_variant_plain,
)
from tiny_audio_tpu_torch.tools import time_ms

# scripts/bench_encoder_attention.py's shape, reps, oracle slice and sweep
B, T, H = 32, 1536, 20
REPS = 30
ORACLE_BATCH = 4
HG = 10
FP32_HG = (4, 20)
# kernel against plain version on the same bf16 inputs, |got - want| <= ATOL
# + RTOL |want|: both round the probabilities to bf16 at the mode's points
# and the output to bf16, with sums taken in other orders, so an output may
# round one bf16 ulp (2**-8 relative at most) the other way: RTOL is two
# such ulps, ATOL (twice the largest flip measured on the card, at |o| in
# [0.25, 0.5)) covers the small outputs.  Modes differ by about as much, so
# the tolerance alone does not tell them apart.  What does: on an H100 at
# the bench's shape a kernel's output differs from its own plain version in
# at most 0.59% of the real elements, and from the nearest plain version of
# a mode outside its SAME_FUNCTION group in at least 49.8%; so at most
# OWN_SHARE may differ from its own, and at least OTHER_SHARE from every
# mode outside its group.
ATOL, RTOL = 2.0**-8, 2.0**-7
OWN_SHARE, OTHER_SHARE = 0.02, 0.2
# SAME_FUNCTION's first group told apart: q scaled by STRESS_Q_SCALE
# (scores of std 40) takes each shift out of its window.  nomax overflows
# (NaN), shift clamps at 80, tilemax underflows the rows far below their
# group's max, and qnorm's bound every row (zeros).  Only the reciprocal
# pairs, one fp32 rounding apart, still compute one function.
STRESS_SHAPE = (2, 512, 4)  # B, T, H
STRESS_Q_SCALE = 40.0
STRESS_SAME = (("fp32", "rcp"), ("tilemax", "tilemax_rcp"))


def make_inputs(b: int, t: int, h: int, device, seed: int = 0):
    """q, k, v [b, t, h * 64] bf16 (unit normal) and a [b, t] int32 key
    mask with a random length in [t / 2, t) per row, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, t, h * HEAD_DIM), generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    lengths = torch.randint(t // 2, t, (b,), generator=gen, device=device)
    mask = (torch.arange(t, device=device)[None] < lengths[:, None]).to(torch.int32)
    return q, k, v, mask


def differ_share(got: torch.Tensor, want: torch.Tensor, real: torch.Tensor) -> float:
    """The share of the real rows' elements where ``got`` and ``want``
    differ (NaN in both counts as equal)."""
    differ = (got != want) & ~(torch.isnan(got) & torch.isnan(want))
    return float(differ[real.expand_as(differ)].float().mean())


def apart(got: torch.Tensor, mode: str, plains: dict, real: torch.Tensor, groups) -> dict:
    """Whether ``got`` is mode ``mode``'s output and no other's: the share of
    its real elements that differ from that mode's plain version (at most
    OWN_SHARE), and from the nearest plain version in ``plains`` of a mode
    outside ``mode``'s group in ``groups`` (at least OTHER_SHARE)."""
    group = next((grp for grp in groups if mode in grp), (mode,))
    shares = {m: differ_share(got, p, real) for m, p in plains.items()}
    others = {m: x for m, x in shares.items() if m not in group}
    nearest = min(others, key=others.get)
    return {"own": shares[mode], "nearest": nearest, "nearest_share": others[nearest],
            "apart": shares[mode] <= OWN_SHARE and others[nearest] >= OTHER_SHARE}


def modes_apart(device="cuda", seed: int = 0, out=print) -> dict:
    """SAME_FUNCTION's first group (the shifts that cancel on the bench's
    inputs) on inputs that take each shift out of its window: each mode's
    output against every plain version of the group.  Returns ``apart``'s
    numbers by mode."""
    device = require_device(device)
    b, t, h = STRESS_SHAPE
    q, k, v, mask = make_inputs(b, t, h, device, seed)
    q = (q.float() * STRESS_Q_SCALE).to(torch.bfloat16)
    modes = SAME_FUNCTION[0]
    plains = {m: encoder_attention_variant_plain(q, k, v, mask, h, m) for m in modes}
    real = mask.bool()[..., None]
    results = {}
    for mode in modes:
        got = encoder_attention_variant(q, k, v, mask, h, mode, 2)
        r = results[mode] = apart(got, mode, plains, real, STRESS_SAME)
        out(f"stress q x{STRESS_Q_SCALE:g} B={b} T={t} H={h} {mode:12s} differ: own plain "
            f"{r['own']:.2%}, nearest other mode {r['nearest']} {r['nearest_share']:.2%}"
            f"  nan={float(torch.isnan(got).float().mean()):.2%}"
            f"  zero={float((got == 0).float().mean()):.2%}")
    return results


def variants(h: int, hg: int = HG, fp32_hg=FP32_HG) -> list[tuple[str, int]]:
    """(mode, hg) pairs: every mode at ``hg``, ``fp32`` also at the others."""
    if h % hg:
        raise ValueError(f"hg = {hg} does not divide H = {h}")
    pairs = [(mode, hg) for mode in MODES if not (mode == "packed2" and hg % 2)]
    return pairs + [("fp32", g) for g in fp32_hg if g != hg and h % g == 0]


def run(b: int = B, t: int = T, h: int = H, device="cuda", reps: int = REPS,
        oracle_batch: int = ORACLE_BATCH, hg: int = HG, fp32_hg=FP32_HG, seed: int = 0,
        out=print) -> dict:
    """Time and check every variant and the two yardsticks; prints the
    script's lines and returns their numbers by name."""
    device = require_device(device)
    q, k, v, mask = make_inputs(b, t, h, device, seed)
    nb = min(oracle_batch, b)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out(f"shape B={b} T={t} H={h} D={HEAD_DIM}, bf16, {reps}-rep loop, device={where}")
    oracle = encoder_attention_fp64(q[:nb], k[:nb], v[:nb], mask[:nb], h)
    real = mask[:nb].bool()[..., None]

    def oracle_err(o: torch.Tensor) -> float:
        return float(torch.where(real, o[:nb].double() - oracle, 0.0).abs().max())

    plains = {m: encoder_attention_variant_plain(q[:nb], k[:nb], v[:nb], mask[:nb], h, m)
              for m in MODES}
    results = {}
    for mode, g in variants(h, hg, fp32_hg):
        name = f"loop-{mode}(hg={g})"
        call = lambda: encoder_attention_variant(q, k, v, mask, h, mode, g)  # noqa: E731
        got = call()
        ms = time_ms(call, reps, device)
        plain = plains[mode]
        diff = (got[:nb].float() - plain.float()).abs()
        a = apart(got[:nb], mode, plains, real, SAME_FUNCTION)
        results[name] = {
            "mode": mode, "hg": g, "ms": ms, "max_abs_err_fp64": oracle_err(got),
            "max_abs_err_vs_plain": float(diff.max()),
            "differ_share_vs_plain": a["own"], "nearest_other": (a["nearest"], a["nearest_share"]),
            "within": bool((diff <= ATOL + RTOL * plain.float().abs()).all()) and a["apart"],
            "finite": bool(torch.isfinite(got).all()),
            # packed2 must equal shift_post bitwise: the caller compares them
            "output": got if mode in ("packed2", "shift_post") and g == hg else None,
        }
        r = results[name]
        out(f"{name:28s} {ms:7.3f} ms/layer-call  max|err - fp64 oracle|={r['max_abs_err_fp64']:.2e}"
            f"  max|kernel - plain|={r['max_abs_err_vs_plain']:.2e}"
            f"  differ: own plain {a['own']:.2%}, nearest other mode {a['nearest']} "
            f"{a['nearest_share']:.2%}")
    del got, plain, plains

    heads = lambda x: x.reshape(b, t, h, HEAD_DIM).transpose(1, 2).contiguous()  # noqa: E731
    qh, kh, vh = heads(q), heads(k), heads(v)
    key_mask = mask.bool()[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_mask)  # noqa: E731
    shipped = lambda: encoder_attention(q, k, v, mask, h)  # noqa: E731
    yard = {}
    for name, call, to_packed in (
            ("encoder_attention (#1)", shipped, lambda o: o),
            ("sdpa (key mask)", sdpa, lambda o: o.transpose(1, 2).reshape(b, t, h * HEAD_DIM))):
        yard[name] = {"ms": time_ms(call, reps, device),
                      "max_abs_err_fp64": oracle_err(to_packed(call()))}
        out(f"{name:28s} {yard[name]['ms']:7.3f} ms/layer-call  "
            f"max|err - fp64 oracle|={yard[name]['max_abs_err_fp64']:.2e}")
    best = min(results, key=lambda n: results[n]["ms"])
    out(f"fastest: {best} at {results[best]['ms']:.3f} ms "
        f"(#1 {yard['encoder_attention (#1)']['ms']:.3f} ms, sdpa {yard['sdpa (key mask)']['ms']:.3f} ms)")
    return {"variants": results, "yardsticks": yard, "fastest": best,
            "inputs": (q, k, v, mask)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--frames", type=int, default=T, help="T, a multiple of 256")
    p.add_argument("--heads", type=int, default=H)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--hg", type=int, default=HG, help="heads per thread block")
    p.add_argument("--fp32-hg", default=",".join(map(str, FP32_HG)),
                   help="more hg values for mode fp32, comma-separated")
    p.add_argument("--oracle-batch", type=int, default=ORACLE_BATCH)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    fp32_hg = tuple(int(x) for x in a.fp32_hg.split(",") if x)
    return run(a.batch, a.frames, a.heads, a.device, a.reps, a.oracle_batch, a.hg, fp32_hg,
               a.seed)


if __name__ == "__main__":
    main()
