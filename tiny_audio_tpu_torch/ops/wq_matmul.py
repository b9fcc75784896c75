"""Weight-only int8 matmul for the decode step: a CUDA kernel for Hopper and
its plain version.

Replaces the JAX package's Pallas kernel ``wq_matmul``
(``tiny_audio_tpu/ops/wq_matmul.py``): ``x [B, K] bf16`` times an int8
weight ``w_i8 [K, N]`` with a per-output-channel fp32 ``scale [N]``, the
int8 converted to bf16 (exact), fp32 sums, the scale applied in fp32 and the
result rounded to bf16.  Decode is bound by the weight bytes it reads; int8
halves them.  The kernel (``csrc/int8_matmul.cu``, ``ta_wq_matmul``) does
the conversion in registers; its source states the bound and the design.

On a CPU tensor :func:`wq_matmul` runs :func:`wq_matmul_plain`; on a CUDA
tensor it launches the kernel or raises.  The kernel sums in another order
than the plain version, so the two agree within ``WQ_RTOL``/``WQ_ATOL``, not
bitwise.
"""

from __future__ import annotations

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
    kernels.launch("ta_wq_matmul", x.device, x.data_ptr(), w_i8.data_ptr(), scale.data_ptr(),
                   out.data_ptr(), b, k, n)
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
