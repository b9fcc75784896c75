"""Kernels #9b, #9c and #9d: the LM head's int8 product three more ways, CUDA
kernels for Hopper and their plain versions.

Replace the TPU bench kernels of ``scripts/bench_wq_head.py`` at the
flagship's LM head (x ``[48, 1024]``, an int8 head ``[1024, 151936]``):

- :func:`wq_matmul_pipe` (#9b, ``build_pipe(nc, nt)``): #6's function
  (:func:`~tiny_audio_tpu_torch.ops.wq_matmul.wq_matmul_plain`), one block
  per ``nc``-wide output chunk streaming its weight through shared memory by
  hand, double-buffered (``csrc/int8_matmul_variants.cu``; the script's tile
  width ``nt`` has no counterpart: a ``[48, nt]`` fp32 tile fits on no SM,
  so the stages are ``[512, 32]`` slabs whatever ``nt`` was);
- :func:`a8_matmul` (#9c, ``build_a8(nt)``): W8A8 with the activation
  quantized per row beforehand (``quantize_act``), the weight ``[K, N]``,
  int32 sums, ``bf16((acc * sx) * scale)``, one block per ``nt`` channels
  (``csrc/int8_matmul_variants.cu``);
- :func:`a8t_matmul` (#9d, ``build_a8t(nt)``): #9c with the weight stored
  ``[N, K]``, #5's layout, on #5's tiles (``csrc/int8_matmul.cu``).

The plain versions are the ones the port already has: #6's
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

import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops.wq_head import quantize_act, w8a8_matmul_plain
from tiny_audio_tpu_torch.ops.wq_matmul import wq_matmul_plain

#: the bench's sweep points: the chunk widths nc of #9b, nt of #9c and #9d
PIPE_SWEEP = (8192, 16384)
A8_SWEEP = (2048, 4096, 8192)
PIPE_MAX_ROWS = 48  # #9b keeps x in shared memory as three 16-row tiles


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
    """#6's function by one block per ``nc`` output channels (a multiple
    of 32).  x [B <= 48, K] bf16, w_i8 [K, N], scale [N] -> [B, N] bf16."""
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
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    kernels.launch("ta_wq_matmul_pipe", x.device, x.data_ptr(), w_i8.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), b, k, n, nc)
    wq_matmul_pipe.launches += 1
    return out


def _a8_launch(entry: str, x, w, scale, nt: int, k_dim: int) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{entry} takes bf16 x, got {x.dtype}")
    x_i8, sx = quantize_act(x)  # outside the kernel, as the TPU bench does
    sx = sx.reshape(-1).contiguous()
    b, k, n = _check(entry, x, w, scale, k_dim,
                     (("x_i8", x_i8), ("sx", sx), ("weight", w), ("scale", scale)))
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    kernels.launch(entry, x.device, x_i8.data_ptr(), sx.data_ptr(), w.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), b, k, n, nt)
    return out


def a8_matmul(x, w_i8, scale, nt: int = 2048) -> torch.Tensor:
    """W8A8 on the ``[K, N]`` weight, one block per ``nt`` channels (a
    multiple of 16: the weight's 16-byte loads start at a block's first
    channel).  x [B, K] bf16 -> [B, N] bf16."""
    if not x.is_cuda:
        return w8a8_matmul_plain(x, w_i8.T, scale)
    if nt <= 0 or nt % 16:
        raise ValueError(f"nt must be a positive multiple of 16, got {nt}")
    out = _a8_launch("ta_a8_matmul", x, w_i8, scale, nt, 0)
    a8_matmul.launches += 1
    return out


def a8t_matmul(x, wt_i8, scale, nt: int = 2048) -> torch.Tensor:
    """W8A8 on the ``[N, K]`` weight, one block per ``nt`` channels (a
    multiple of 64, #5's wide tile).  x [B, K] bf16 -> [B, N] bf16."""
    if not x.is_cuda:
        return w8a8_matmul_plain(x, wt_i8, scale)
    if nt <= 0 or nt % 64:
        raise ValueError(f"nt must be a positive multiple of 64, got {nt}")
    out = _a8_launch("ta_a8t_matmul", x, wt_i8, scale, nt, 1)
    a8t_matmul.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
wq_matmul_pipe.launches = 0
a8_matmul.launches = 0
a8t_matmul.launches = 0
