"""Weight-only int8 matmul for the decode step: a CUDA kernel for Hopper and
its plain version.

Replaces the JAX package's Pallas kernel ``wq_matmul``
(``tiny_audio_tpu/ops/wq_matmul.py``): ``x [B, K] bf16`` times an int8
weight ``w_i8 [K, N]`` with a per-output-channel fp32 ``scale [N]``, the
int8 converted to bf16 (exact), fp32 sums, the scale applied in fp32 and the
result rounded to bf16.  Decode is bound by the weight bytes it reads; int8
halves them.  The kernel (``csrc/int8_matmul.cu``, ``ta_wq_matmul``) does
the conversion in registers and the products on the tensor cores; its
source states the bound and the design.

The kernel splits K over blocks (:func:`int8_split_plan`, from shapes only,
shared with #5 in ``ops/wq_head.py`` and #9c and #9d in
``ops/wq_head_variants.py``)
and merges the splits inside the same
launch, through a scratch this wrapper allocates and the merge counters of
``kernels.counter_buffer`` (per device, never freed, zero
between launches): calls on one device must not run concurrently on two
streams, and every path of the port runs on one.  A batch of up to
``SPLIT_MAX_ROWS`` rows is one launch (the weights are read once); a larger
one is one launch per ``SPLIT_MAX_ROWS`` rows.  Shapes the design's 16-byte
copies cannot take (N not a multiple of 16, K not of 8, a tensor off a
16-byte boundary) go to the first design's tiles, in one launch.
:func:`wq_matmul_split_plain` repeats the split's arithmetic as a test
oracle; no path calls it.

On a CPU tensor :func:`wq_matmul` runs :func:`wq_matmul_plain`; on a CUDA
tensor it launches the kernel or raises.  The kernel sums in another order
than the plain version, so the two agree within ``WQ_RTOL``/``WQ_ATOL``, not
bitwise; it sums in a fixed order, so two runs agree bitwise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tiny_audio_tpu_torch import kernels

#: the JAX kernel's N tile; the LM head's int8 columns are padded to it
NT = 512

#: kernel vs plain version, |got - want| <= WQ_ATOL + WQ_RTOL * |want|: both
#: round an fp32 sum to bf16, whose spacing is at most 2**-7 of a value, so
#: a different summation order can move the output by one bf16 ulp (WQ_RTOL
#: allows two); WQ_ATOL covers outputs near zero, where the reordered fp32
#: sums of terms of either sign differ by more than their bf16 spacing.
WQ_RTOL = 2.0**-6
WQ_ATOL = 1e-3

#: The split over K of #5, #6, #9c and #9d (:func:`int8_split_plan`): a product
#: whose output tiles alone reach half SPLIT_TARGET_UNITS takes one split (a
#: split more adds its part's store, a fence, a counter and a reload from L2
#: to the launch's latency); a
#: narrower one enough splits to reach SPLIT_TARGET_UNITS, about one block
#: for each of the H100's 132 SMs (a sweep on the card found 128 units as
#: fast as 256 or faster at the layer shapes).  A tile's merge takes at most
#: SPLIT_MERGE_VALUES values (splits x rows x channels), and a launch at most
#: SPLIT_MAX_ROWS rows of x (8 MMA columns of 8).
SPLIT_TARGET_UNITS = 128
SPLIT_MERGE_VALUES = 16384
SPLIT_MAX_ROWS = 64
#: a warp's sub-tile: 32 output channels x 32 k; a block is 4 warps
SPLIT_SUB = 32
#: the s8 kinds' (#5, #9c, #9d) int8 activation chunk in shared memory,
#: rows x (split k + 32) bytes
SPLIT_X_BYTES = 96 * 1024
#: the kinds of product of the split design: #6, #5, #9c and #9d
SPLIT_KINDS = ("wq", "w8a8", "a8", "a8t")


class Int8SplitPlan(NamedTuple):
    """How #5, #6, #9c or #9d cuts one launch: a block's 4 warps stand ``warps_n``
    across the output channels (a tile of ``tile_n = 32 warps_n``) and
    ``4 / warps_n`` along k (a stage of ``tile_k`` k); ``split_k`` k a split
    (a multiple of ``tile_k``), ``splits`` of them over K; ``units`` = tiles
    x splits work units (the blocks of the launch, or what persistent blocks
    walk); the 4-byte partial sums of the splits, ``[splits, B, N]`` with N
    rounded up to 4 (0 with one split), and the merge counters (one per
    tile; 0 with one split)."""

    warps_n: int
    tile_n: int
    tile_k: int
    split_k: int
    splits: int
    tiles: int
    units: int
    scratch: int
    counters: int


def int8_split_plan(b: int, k: int, n: int, kind: str) -> Optional[Int8SplitPlan]:
    """The split of one launch of ``x [b, K] @ W [K -> N]``, from shapes
    alone (never from data, so a launch fits a CUDA graph); ``kind`` is
    ``"wq"`` (#6, weight ``[K, N]``), ``"w8a8"`` (#5, ``[N, K]``), ``"a8"``
    (#9c, ``[K, N]``) or ``"a8t"`` (#9d, ``[N, K]``).  For each block
    arrangement the kind takes (#5 and #9d: one warp across 32 channels,
    128-byte runs of its [N, K] rows; #9c: four warps across 128 channels,
    128-byte runs of its [K, N] rows; #6: both of those): one split where the
    tiles
    alone reach half SPLIT_TARGET_UNITS, else enough that tiles x splits
    reach it, at most as many as keep a tile's merge within
    SPLIT_MERGE_VALUES values; of the arrangements that fill the card so,
    the one with the fewest splits (the widest on a tie), else the one with
    the most units.  Splits start on a stage, a multiple of 32 k
    (the s8 products of #5, #9c and #9d take 32, #6's bf16 16).  None where
    the kernel's copies cannot take the shape (#6: N not a multiple of 16 or
    K of 8; #5: K not a multiple of 16; #9c and #9d: either not of 16) or
    ``b`` exceeds SPLIT_MAX_ROWS."""
    if kind not in SPLIT_KINDS:
        raise ValueError(f"kind must be one of {SPLIT_KINDS}, got {kind!r}")
    if not 1 <= b <= SPLIT_MAX_ROWS or k <= 0 or n <= 0:
        return None
    if (kind != "w8a8" and n % 16) or k % (8 if kind == "wq" else 16):
        return None
    rows = -(-b // 8) * 8
    plans = []
    for warps_n in {"wq": (4, 1), "w8a8": (1,), "a8": (4,), "a8t": (1,)}[kind]:
        tile_n, tile_k = SPLIT_SUB * warps_n, SPLIT_SUB * (4 // warps_n)
        tiles, stages = -(-n // tile_n), -(-k // tile_k)
        want = 1 if 2 * tiles >= SPLIT_TARGET_UNITS else -(-SPLIT_TARGET_UNITS // tiles)
        want = min(want, stages, max(1, SPLIT_MERGE_VALUES // (b * tile_n)))
        per = -(-stages // want)  # stages a split
        if kind != "wq":  # the split's int8 activation fits its shared memory
            while per > 1 and rows * (per * tile_k + SPLIT_SUB) > SPLIT_X_BYTES:
                per -= 1
        splits = -(-stages // per)
        plans.append(Int8SplitPlan(
            warps_n=warps_n, tile_n=tile_n, tile_k=tile_k, split_k=per * tile_k,
            splits=splits, tiles=tiles, units=tiles * splits,
            scratch=splits * b * -(-n // 4) * 4 if splits > 1 else 0,
            counters=tiles if splits > 1 else 0))
    filling = [p for p in plans if fills_card(p)]
    if filling:
        return min(filling, key=lambda p: (p.splits, -p.warps_n))
    return max(plans, key=lambda p: p.units)


def fills_card(plan: Int8SplitPlan) -> bool:
    """Whether a plan gives the card the work units :func:`int8_split_plan`
    aims at: SPLIT_TARGET_UNITS, or half as many tiles and no split."""
    return plan.units >= SPLIT_TARGET_UNITS or (
        plan.splits == 1 and 2 * plan.tiles >= SPLIT_TARGET_UNITS)


def launch_split(name: str, kind: str, xs: tuple, w: torch.Tensor, scale: torch.Tensor,
                 out: torch.Tensor, plan: Int8SplitPlan) -> None:
    """One launch of the split design (entry point ``name``) on checked CUDA
    tensors: ``xs`` is ``(x,)`` for #5 and #6, ``(x_i8, sx)`` for #9c and
    #9d; the partial sums' scratch allocated here (int32 for #5, #9c and
    #9d, fp32 for #6), the merge counters from ``counter_buffer``."""
    b, k = xs[0].shape
    n = out.shape[1]
    partial = counters = None
    if plan.splits > 1:
        dtype = torch.float32 if kind == "wq" else torch.int32
        partial = torch.empty(plan.scratch, dtype=dtype, device=out.device)
        counters = kernels.counter_buffer(out.device, plan.counters)
    kernels.launch(name, out.device, *(t.data_ptr() for t in xs), w.data_ptr(),
                   scale.data_ptr(), out.data_ptr(),
                   partial.data_ptr() if partial is not None else 0,
                   counters.data_ptr() if counters is not None else 0,
                   b, k, n, plan.warps_n, plan.split_k)


def split_units(plan: Int8SplitPlan, k: int, n: int) -> list[tuple[int, int, int, int]]:
    """What each work unit of ``plan`` computes, in unit order, as the
    kernel decodes it (a persistent block walks units blockIdx, blockIdx +
    grid, ...): unit u is tile ``u % tiles`` and split ``u // tiles``, the
    output channels ``[n0, n1)`` and the k ``[k0, k1)``, clipped to N and K
    (the copies zero-fill past them)."""
    units = []
    for u in range(plan.units):
        tile, split = u % plan.tiles, u // plan.tiles
        units.append((tile * plan.tile_n, min(n, (tile + 1) * plan.tile_n),
                      split * plan.split_k, min(k, (split + 1) * plan.split_k)))
    return units


def split_rows(b: int) -> list[tuple[int, int]]:
    """The row ranges of the launches of a batch of ``b``: one per
    SPLIT_MAX_ROWS rows."""
    return [(r, min(b, r + SPLIT_MAX_ROWS)) for r in range(0, b, SPLIT_MAX_ROWS)]


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of ``w [..., K, N]``:
    ``(w_i8 [..., K, N] int8, scale [..., N] fp32)`` with
    ``w ~= w_i8 * scale``.  The JAX ``quantize_weight``'s arithmetic (its
    ``vmap`` over stacked layers is the leading dims here); both divisions
    are IEEE divisions on every device (a tensor divisor: PyTorch on CUDA
    multiplies by the reciprocal of a Python scalar)."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=-2)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    w_i8 = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127).to(torch.int8)
    return w_i8, scale


def wq_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Reference (the JAX ``wq_matmul_xla``): ``x [B, K]`` (taken as bf16)
    times the int8 weight ``[K, N]`` converted to bf16, fp32 sums, times the
    fp32 scale, rounded to bf16.  int8 -> bf16 -> fp32 is exact, so the
    weight goes to fp32 directly."""
    acc = x.to(torch.bfloat16).to(torch.float32) @ w_i8.to(torch.float32)
    return (acc * scale.to(torch.float32)).to(torch.bfloat16)


def wq_matmul_split_plain(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor,
                          plan: Optional[Int8SplitPlan] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (a test oracle; no path calls it):
    an fp32 part per split of K (:func:`int8_split_plan`, or ``plan``), the
    parts summed in split order, times the scale, rounded to bf16."""
    b, k = x.shape
    plan = plan or int8_split_plan(min(b, SPLIT_MAX_ROWS), k, w_i8.shape[1], "wq")
    split_k = plan.split_k if plan is not None else k
    xf, wf = x.to(torch.bfloat16).to(torch.float32), w_i8.to(torch.float32)
    acc = None
    for k0 in range(0, k, split_k):
        part = xf[:, k0:k0 + split_k] @ wf[k0:k0 + split_k]
        acc = part if acc is None else acc + part
    return (acc * scale.to(torch.float32)).to(torch.bfloat16)


def _check_cuda_inputs(x, w_i8, scale) -> None:
    if x.dtype != torch.bfloat16 or w_i8.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"wq matmul kernel takes bf16 x, int8 w and fp32 scale, got "
                        f"{x.dtype}, {w_i8.dtype}, {scale.dtype}")
    if x.ndim != 2 or w_i8.ndim != 2 or x.shape[1] != w_i8.shape[0] or \
            scale.shape != (w_i8.shape[1],):
        raise ValueError(f"need x [B, K], w [K, N], scale [N]: {tuple(x.shape)} "
                         f"{tuple(w_i8.shape)} {tuple(scale.shape)}")
    for name, t in (("x", x), ("w_i8", w_i8), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{name} must be contiguous and 4-byte aligned")


def wq_matmul(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [B, K] bf16 @ dequant(w_i8 [K, N], scale [N]) -> [B, N] bf16``."""
    if not x.is_cuda:
        return wq_matmul_plain(x, w_i8, scale)
    _check_cuda_inputs(x, w_i8, scale)
    (b, k), n = x.shape, w_i8.shape[1]
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    aligned = x.data_ptr() % 16 == 0 and w_i8.data_ptr() % 16 == 0
    if not aligned or int8_split_plan(min(b, SPLIT_MAX_ROWS), k, n, "wq") is None:
        # the first design's tiles: any shape and alignment, one launch
        kernels.launch("ta_wq_matmul", x.device, x.data_ptr(), w_i8.data_ptr(),
                       scale.data_ptr(), out.data_ptr(), 0, 0, b, k, n, 0, 0)
        wq_matmul.launches += 1
        return out
    for r0, r1 in split_rows(b):
        launch_split("ta_wq_matmul", "wq", (x[r0:r1],), w_i8, scale, out[r0:r1],
                     int8_split_plan(r1 - r0, k, n, "wq"))
        wq_matmul.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
wq_matmul.launches = 0


def quantization_error(w, n_probe: int = 4096, seed: int = 0) -> dict:
    """Relative output error of int8 weight quantization of ``w [K, N]`` at
    a matmul probe of ``min(n_probe, 4096)`` random rows (the JAX
    package's offline quality signal)."""
    w = torch.as_tensor(np.asarray(w, np.float32))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((min(n_probe, 4096), w.shape[0])).astype(np.float32))
    w_i8, scale = quantize_weight(w)
    ref = x @ w
    got = x @ (w_i8.to(torch.float32) * scale[None, :])
    denom = float(torch.linalg.norm(ref)) or 1.0
    return {
        "rel_fro_error": float(torch.linalg.norm(got - ref)) / denom,
        "max_abs_error": float((got - ref).abs().max()),
    }
