"""Kernels #9b, #9c and #9d: the LM head's int8 product three more ways, CUDA
kernels for Hopper and their plain versions.

Replace the TPU bench kernels of ``scripts/bench_wq_head.py`` at the
flagship's LM head (x ``[48, 1024]``, an int8 head ``[1024, 151936]``).
Each is bound by the weight's bytes (155.6 MB at the bench shape: 0.051 ms
at 3.35 TB/s):

- :func:`wq_matmul_pipe` (#9b, ``build_pipe(nc, nt)``): #6's function
  (:func:`~tiny_audio_tpu_torch.ops.wq_matmul.wq_matmul_plain`).  The TPU
  kernel streamed its weight by hand; here the stream is the Tensor Memory
  Accelerator's (``csrc/int8_matmul_variants.cu``): persistent blocks, one
  an SM, walk 256- and 128-channel tiles over the whole K (:func:`pipe_plan`);
  a producer warp keeps TMA boxes of the weight in flight through a ring of
  mbarrier'd stages, x stays whole in shared memory as wgmma's B operand,
  and two consumer warpgroups, 128 channels each, convert the int8 to bf16
  in registers (RS A fragments) and run ``wgmma``.  No split, so the fp32
  sums run in one fixed order.  The script's ``nc`` and ``nt`` set nothing.
  About 0.077 ms at the bench shape from a CUDA graph, 0.67 of the bound
  (H100 80GB HBM3, 700 W; PERF.md);
- :func:`a8_matmul` (#9c, ``build_a8(nt)``): W8A8 with the activation
  quantized per row beforehand (``quantize_act``), the weight ``[K, N]``,
  int32 sums, ``bf16((acc * sx) * scale)``: the third kind of #5's and
  #6's split design (``csrc/int8_matmul.cu``, ``split_matmul_kernel<A8,
  ...>``) over :func:`~tiny_audio_tpu_torch.ops.wq_matmul.int8_split_plan`'s
  ``"a8"`` units (1,187 tiles of 128 channels at the bench shape, one
  split), the weight streamed through #6's ``cp.async`` ring, s8
  tensor-core products with a 4 x 4 byte transpose per A register;
- :func:`a8t_matmul` (#9d, ``build_a8t(nt)``): #9c's function with the
  weight stored ``[N, K]``: the fourth kind, ``split_matmul_kernel<A8T,
  ...>`` over the ``"a8t"`` plan, #5's stage of 32 channel rows x 128 k
  bytes and its s8 products straight off the rows, with #9c's x_i8 and sx
  loaded per split (no amax prologue, no cluster).  About 0.09 ms alone
  from a graph, 0.57 of the bound (#9c: 0.086, 0.59).

The script's tile width ``nt`` sets nothing in #9c or #9d either.  The plain
versions are the ones the port already has: #6's
:func:`~tiny_audio_tpu_torch.ops.wq_matmul.wq_matmul_plain` for #9b, #5's
:func:`~tiny_audio_tpu_torch.ops.wq_head.w8a8_matmul_plain` for #9c (on the
transposed weight) and #9d.  The sums of #9c and #9d are integers, so each
kernel equals its plain version bitwise (float64 sums, exact here); #9b sums
in fp32 in another order and agrees within #6's ``WQ_ATOL``/``WQ_RTOL``.  No
path of the port calls them: they are the yardsticks of #5's and #6's
redesigns, driven by ``python -m tiny_audio_tpu_torch.tools.bench_wq_head``.
On a CPU tensor each runs its plain version; on a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops.wq_head import quantize_act, w8a8_matmul_plain
from tiny_audio_tpu_torch.ops.wq_matmul import (
    int8_split_plan,
    launch_split,
    split_rows,
    wq_matmul_plain,
)

#: the bench's sweep points: the chunk widths nc of #9b, nt of #9c and #9d
PIPE_SWEEP = (8192, 16384)
A8_SWEEP = (2048, 4096, 8192)
#: #9b (``csrc/int8_matmul_variants.cu``): x rows (wgmma's N, padded to 16,
#: 32 or 48), channels of a unit (a TMA box's 128-byte rows; a tile is two
#: units or one), k rows of a weight stage (two boxes of [64][128] int8), the
#: ring's depth and the shared memory a block takes
PIPE_MAX_ROWS = 48
PIPE_UNIT_N = 128
PIPE_BOX_K = 64
PIPE_STAGE_BYTES = 2 * PIPE_BOX_K * PIPE_UNIT_N
PIPE_MAX_STAGES = 128 * 1024 // PIPE_STAGE_BYTES
PIPE_MIN_STAGES = 4
PIPE_SMEM_LIMIT = 227 * 1024


class PipePlan(NamedTuple):
    """One launch of #9b: x padded to ``nb`` rows (wgmma's N); ``units``
    128-channel units of the output in ``tiles`` tiles, the first ``pairs``
    of them two units wide (256 channels), the rest one; ``boxes`` 64-k
    stages a tile, a ring of ``stages`` stages, ``smem`` bytes of dynamic
    shared memory a block and ``grid`` persistent blocks (one an SM)."""

    nb: int
    units: int
    pairs: int
    tiles: int
    boxes: int
    stages: int
    smem: int
    grid: int


def pipe_plan(b: int, k: int, n: int, sms: int = 132) -> Optional[PipePlan]:
    """#9b's launch on a card of ``sms`` SMs, as ``ta_wq_matmul_pipe``
    computes it from shapes alone: each block takes ceil(units / blocks)
    units, as pair tiles where that keeps the blocks even (a block reads
    256-byte runs of the weight's rows there), else single ones.  None where
    the kernel refuses the shape (K or N off a multiple of 16, more than
    PIPE_MAX_ROWS rows, or x too large to stay in shared memory beside
    PIPE_MIN_STAGES stages)."""
    if not 1 <= b <= PIPE_MAX_ROWS or k <= 0 or n <= 0 or k % 16 or n % 16:
        return None
    nb = 16 if b <= 16 else 32 if b <= 32 else 48
    boxes = -(-k // PIPE_BOX_K)
    x_bytes = boxes * nb * 128
    room = PIPE_SMEM_LIMIT - (x_bytes + 8 + 1024) - 16 * PIPE_MAX_STAGES
    stages = min(PIPE_MAX_STAGES, room // PIPE_STAGE_BYTES)
    if stages < PIPE_MIN_STAGES:
        return None
    units = -(-n // PIPE_UNIT_N)
    blocks = min(units, sms)
    pairs = min(-(-units // blocks) // 2 * blocks, units // 2)
    tiles = units - pairs
    smem = x_bytes + stages * PIPE_STAGE_BYTES + 8 * (1 + 2 * stages) + 1024
    return PipePlan(nb, units, pairs, tiles, boxes, stages, smem, min(tiles, sms))


def pipe_tiles(plan: PipePlan) -> list[list[tuple[int, int]]]:
    """The tiles each persistent block of ``plan`` walks, in order (block i
    takes tiles i, i + grid, ...), as (first channel, units)."""
    def tile(i: int) -> tuple[int, int]:
        if i < plan.pairs:
            return 2 * PIPE_UNIT_N * i, 2
        return 2 * PIPE_UNIT_N * plan.pairs + PIPE_UNIT_N * (i - plan.pairs), 1
    return [[tile(i) for i in range(blk, plan.tiles, plan.grid)] for blk in range(plan.grid)]


def _check(name: str, x, w, scale, k_dim: int, tensors) -> tuple[int, int, int]:
    if w.dtype != torch.int8 or scale.dtype != torch.float32 or x.ndim != 2 or w.ndim != 2:
        raise TypeError(f"{name} takes x [B, K], an int8 weight and fp32 scales, got "
                        f"{x.dtype} {tuple(x.shape)}, {w.dtype} {tuple(w.shape)}, {scale.dtype}")
    b, k = x.shape
    n = w.shape[1 - k_dim]
    if w.shape[k_dim] != k or scale.shape != (n,):
        raise ValueError(f"{name}: x {tuple(x.shape)}, weight {tuple(w.shape)} and scale "
                         f"{tuple(scale.shape)} do not match")
    if k % 16 or n % 16:
        raise ValueError(f"{name} takes K and N multiples of 16, got K={k} N={n}")
    for t_name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{t_name} must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{t_name} must be contiguous and 16-byte aligned")
    return b, k, n


def wq_matmul_pipe(x, w_i8, scale, nc: int = 8192) -> torch.Tensor:
    """#6's function by the TMA-fed pipe.  x [B <= 48, K] bf16, w_i8 [K, N],
    scale [N] -> [B, N] bf16.  ``nc`` is the script's chunk width, kept as
    its sweep's parameter (a positive multiple of 32); it sets nothing."""
    if not x.is_cuda:
        return wq_matmul_plain(x, w_i8, scale)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"wq_matmul_pipe takes bf16 x, got {x.dtype}")
    b, k, n = _check("wq_matmul_pipe", x, w_i8, scale, 0,
                     (("x", x), ("w_i8", w_i8), ("scale", scale)))
    if b > PIPE_MAX_ROWS:
        raise ValueError(f"wq_matmul_pipe takes at most {PIPE_MAX_ROWS} rows, got {b}")
    if nc <= 0 or nc % 32:
        raise ValueError(f"nc = {nc} must be a positive multiple of 32")
    if pipe_plan(b, k, n) is None:
        raise ValueError(f"wq_matmul_pipe: x [{b}, {k}] does not fit shared memory beside "
                         f"{PIPE_MIN_STAGES} weight stages")
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    return launch_pipe(x, w_i8, scale, out, nc)


def launch_pipe(x, w_i8, scale, out, nc: int = 8192) -> torch.Tensor:
    """#9b's kernel alone into ``out`` [B, N] bf16, on CUDA tensors checked
    as :func:`wq_matmul_pipe` checks them: one launch."""
    b, k = x.shape
    kernels.launch("ta_wq_matmul_pipe", x.device, x.data_ptr(), w_i8.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), b, k, out.shape[1], nc)
    wq_matmul_pipe.launches += 1
    return out


def _quantized(entry: str, x, w, scale, k_dim: int):
    """quantize_act outside the kernel, as the TPU bench does; the checked
    shapes and an empty output."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{entry} takes bf16 x, got {x.dtype}")
    x_i8, sx = quantize_act(x)
    sx = sx.reshape(-1).contiguous()
    b, k, n = _check(entry, x, w, scale, k_dim,
                     (("x_i8", x_i8), ("sx", sx), ("weight", w), ("scale", scale)))
    return x_i8, sx, torch.empty((b, n), dtype=torch.bfloat16, device=x.device)


def a8_matmul(x, w_i8, scale, nt: int = 2048) -> torch.Tensor:
    """W8A8 on the ``[K, N]`` weight.  x [B, K] bf16 -> [B, N] bf16.  ``nt``
    is the script's tile width, kept as its sweep's parameter (a positive
    multiple of 16, as the script's tiles take it); the launch is the split
    design's ``"a8"`` plan whatever it is (:func:`launch_a8`)."""
    if not x.is_cuda:
        return w8a8_matmul_plain(x, w_i8.T, scale)
    if nt <= 0 or nt % 16:
        raise ValueError(f"nt must be a positive multiple of 16, got {nt}")
    x_i8, sx, out = _quantized("ta_a8_matmul", x, w_i8, scale, 0)
    return launch_a8(x_i8, sx, w_i8, scale, out)


def launch_a8(x_i8, sx, w_i8, scale, out) -> torch.Tensor:
    """The kernel alone on an activation already quantized (``quantize_act``'s
    x_i8 [B, K] and sx [B], CUDA tensors, checked as :func:`a8_matmul`
    checks them) into ``out`` [B, N] bf16: one launch per 64 rows."""
    (b, k), n = x_i8.shape, w_i8.shape[1]
    for r0, r1 in split_rows(b):
        launch_split("ta_a8_matmul", "a8", (x_i8[r0:r1], sx[r0:r1]), w_i8, scale, out[r0:r1],
                     int8_split_plan(r1 - r0, k, n, "a8"))
        a8_matmul.launches += 1
    return out


def a8t_matmul(x, wt_i8, scale, nt: int = 2048) -> torch.Tensor:
    """W8A8 on the ``[N, K]`` weight.  x [B, K] bf16 -> [B, N] bf16.  ``nt``
    is the script's tile width, kept as its sweep's parameter (a positive
    multiple of 64, the first design's tile); the launch is the split
    design's ``"a8t"`` plan whatever it is (:func:`launch_a8t`)."""
    if not x.is_cuda:
        return w8a8_matmul_plain(x, wt_i8, scale)
    if nt <= 0 or nt % 64:
        raise ValueError(f"nt must be a positive multiple of 64, got {nt}")
    x_i8, sx, out = _quantized("ta_a8t_matmul", x, wt_i8, scale, 1)
    return launch_a8t(x_i8, sx, wt_i8, scale, out)


def launch_a8t(x_i8, sx, wt_i8, scale, out) -> torch.Tensor:
    """#9d's kernel alone on an activation already quantized (x_i8 [B, K],
    sx [B], CUDA tensors checked as :func:`a8t_matmul` checks them) into
    ``out`` [B, N] bf16: one launch per 64 rows."""
    (b, k), n = x_i8.shape, wt_i8.shape[0]
    for r0, r1 in split_rows(b):
        launch_split("ta_a8t_matmul", "a8t", (x_i8[r0:r1], sx[r0:r1]), wt_i8, scale, out[r0:r1],
                     int8_split_plan(r1 - r0, k, n, "a8t"))
        a8t_matmul.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
wq_matmul_pipe.launches = 0
a8_matmul.launches = 0
a8t_matmul.launches = 0
