"""W8A8 int8 matmul for the decode step: a CUDA kernel for Hopper and its
plain version.

Replaces the JAX package's Pallas kernel ``w8a8_matmul``
(``tiny_audio_tpu/ops/wq_head.py``): the activation ``x [B, K]`` is
quantized per row to int8 (``quantize_act``), multiplied by an int8 weight
stored transposed, ``wt_i8 [N, K]``, with int32 sums, and the two scales
fold into an fp32 epilogue, ``out = (acc * sx[b]) * scale[n]``, rounded to
bf16.  The JAX package uses it for the LM head (``enable_w8a8_head``) and,
as XLA's int8 dot of the same function, for every layer projection of a
decode step (``enable_w8a8_decode``); the port uses the kernel for both.

The kernel (``csrc/int8_matmul.cu``, ``ta_w8a8_matmul``) quantizes the
activation inside its blocks, so one product is one launch.  The sums are
integers, so the kernel and :func:`w8a8_matmul_plain` agree bitwise; the
plain version sums in float64, which is exact here (``127**2 * K < 2**53``)
on every device (PyTorch has no int32 matmul on CUDA).

On a CPU tensor :func:`w8a8_matmul` runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops.wq_matmul import quantize_weight

#: the JAX kernel's output-channel tile; the W8A8 head is padded to it
NT_HEAD = 2048


def quantize_head_w8a8(head: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize an LM head ``[K, N]``: ``(wt_i8 [N_pad, K] int8, scale
    [N_pad] fp32)``, transposed and padded to a multiple of ``NT_HEAD``
    rows; pad rows have scale 0 (exactly-zero logits, sliced off)."""
    w_i8, scale = quantize_weight(head)
    pad = -w_i8.shape[1] % NT_HEAD
    return F.pad(w_i8.T, (0, 0, 0, pad)).contiguous(), F.pad(scale, (0, pad))


def quantize_weight_w8a8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize layer projections ``[..., K, N]`` for W8A8: per-output-
    channel int8 stored transposed, ``([..., N, K] int8, [..., N] fp32)``,
    no padding."""
    w_i8, scale = quantize_weight(w)
    return w_i8.transpose(-1, -2).contiguous(), scale


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: ``x [B, K] -> (x_i8 [B, K], sx [B, 1] fp32)``
    with ``sx = max(max|x|, 1e-12) / 127`` (an IEEE division on every
    device) and ``x_i8`` rounded half to even."""
    x = x.to(torch.float32)
    ax = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-12)
    sx = ax / torch.full_like(ax, 127.0)
    x_i8 = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return x_i8, sx


def w8a8_matmul_plain(x: torch.Tensor, wt_i8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Reference (the JAX ``w8a8_matmul_xla``): ``x [B, K]`` -> ``[B, N]``
    bf16 for ``wt_i8 [N, K]`` and ``scale [N]``."""
    x_i8, sx = quantize_act(x)
    acc = x_i8.to(torch.float64) @ wt_i8.to(torch.float64).T  # exact integer sums
    return ((acc.to(torch.float32) * sx) * scale[None, :]).to(torch.bfloat16)


def _check_cuda_inputs(x, wt_i8, scale) -> None:
    if x.dtype != torch.bfloat16 or wt_i8.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"w8a8 matmul kernel takes bf16 x, int8 wt and fp32 scale, got "
                        f"{x.dtype}, {wt_i8.dtype}, {scale.dtype}")
    if x.ndim != 2 or wt_i8.ndim != 2 or x.shape[1] != wt_i8.shape[1] or \
            scale.shape != (wt_i8.shape[0],):
        raise ValueError(f"need x [B, K], wt [N, K], scale [N]: {tuple(x.shape)} "
                         f"{tuple(wt_i8.shape)} {tuple(scale.shape)}")
    if x.shape[1] % 16:
        raise ValueError(f"w8a8 matmul kernel takes K a multiple of 16, got {x.shape[1]}")
    for name, t in (("x", x), ("wt_i8", wt_i8), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def w8a8_matmul(x: torch.Tensor, wt_i8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [B, K] bf16`` through the int8 x int8 product with ``wt_i8
    [N, K]`` and ``scale [N]``: ``[B, N] bf16``."""
    if not x.is_cuda:
        return w8a8_matmul_plain(x, wt_i8, scale)
    _check_cuda_inputs(x, wt_i8, scale)
    (b, k), n = x.shape, wt_i8.shape[0]
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    kernels.launch("ta_w8a8_matmul", x.device, x.data_ptr(), wt_i8.data_ptr(), scale.data_ptr(),
                   out.data_ptr(), b, k, n)
    w8a8_matmul.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
w8a8_matmul.launches = 0
