"""Encoder self-attention: a CUDA kernel for Hopper and its plain version.

Replaces ``tiny_audio_tpu/ops/encoder_attention.py::_encoder_attention_impl``,
the TPU kernel behind ``encoder_attention_tpu``: bidirectional multi-head
attention over packed heads ``[B, T, H*D]`` with a ``[B, T]`` key-padding
mask, as the encoder's q/k/v projections produce them (no transpose).

The kernel (entry point ``ta_encoder_attention`` in ``csrc/attention.cu``) is
a flash forward with an exact online softmax.  At the flagship's head_dim 64
in bf16 it is the Hopper design of ``csrc/attention_sm90.cu``: a producer
warp streams 128-key K/V tiles by TMA into a two-stage ring of swizzled
shared memory, a consumer warpgroup of 64 query rows runs S = Q K^T and
O += P V as ``wgmma`` (P from registers, V read transposed through its
descriptor), the per-key mask runs only on tiles that hold a padding key or
the ragged end, and two blocks share an SM.  At head_dim 16 and 32 it is the
``mma.sync`` template of ``csrc/attention.cu``; the fp32 instance
(``csrc/attention_f32.cu``, ``ta_encoder_attention_f32``) serves an fp32
model on the CUDA cores.  The output is in q's dtype, as the JAX kernel's
is.  It does not carry over the TPU kernel's constant-shift softmax window,
which was a workaround for the TPU's vector unit, nor its padding of T to a
256 multiple: it masks the ragged edge of T = 1500 itself.  It is bound by
compute, not memory: the [T, T] scores stay on the SM (the sources' headers
have the numbers).

Gradient: as the JAX package's custom VJP recomputes through the naive
formula (``tiny_audio_tpu/ops/encoder_attention.py:141-155``), the backward
of :class:`EncoderAttention` recomputes :func:`encoder_attention_plain` and
differentiates it; there is no backward kernel, as there is no backward
Pallas kernel.  Training keeps the encoder frozen under ``no_grad``, so only
a caller that trains the encoder reaches it.

On a CPU tensor :func:`encoder_attention` runs :func:`encoder_attention_plain`;
on a CUDA tensor it launches the kernel or raises, and with grad enabled on
an input that requires grad it goes through :class:`EncoderAttention`.
"""

from __future__ import annotations

from typing import Optional

import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.models.layers import attention as _attention

KERNEL_HEAD_DIMS = (16, 32, 64)  # the flagship's 64 and the tiny towers' 16
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def encoder_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """Reference formula on packed heads: q/k/v [B, T, H*D], kv_mask [B, T]
    (1 = real frame) or None.  Returns [B, T, H*D]."""
    b, t, packed = q.shape
    d = packed // num_heads
    qh, kh, vh = (x.reshape(b, t, num_heads, d) for x in (q, k, v))
    mask = None if kv_mask is None else kv_mask.to(torch.bool)[:, None, None, :]
    return _attention(qh, kh, vh, mask=mask).reshape(b, t, packed)


def _check_cuda_inputs(q, k, v, num_heads: int) -> None:
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"encoder attention kernel takes {KERNEL_DTYPES}, got {q.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, T, H*D] shape: {q.shape} {k.shape} {v.shape}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.shape[-1] % num_heads:
        raise ValueError(f"{q.shape[-1]} features do not split into {num_heads} heads")
    d = q.shape[-1] // num_heads
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"encoder attention kernel takes head_dim {KERNEL_HEAD_DIMS}, got {d}")


def encoder_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """Bidirectional multi-head attention over packed heads.

    q/k/v: [B, T, H*D]; kv_mask: [B, T] (1 = real frame) or None.
    Returns [B, T, H*D].  Rows whose frame is padding are computed too
    (they attend to the real frames) and are the caller's to ignore.
    """
    if not q.is_cuda:
        return encoder_attention_plain(q, k, v, kv_mask, num_heads)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return EncoderAttention.apply(q, k, v, kv_mask, num_heads)
    return _launch(q, k, v, kv_mask, num_heads)


class EncoderAttention(torch.autograd.Function):
    """Kernel #1 forward; the backward recomputes the plain formula and
    differentiates it (no backward kernel, as in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, num_heads):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.num_heads = num_heads
        return _launch(q, k, v, kv_mask, num_heads)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = encoder_attention_plain(*leaves, kv_mask, ctx.num_heads)
            dq, dk, dv = torch.autograd.grad(out, leaves, dout)
        return dq, dk, dv, None, None


def _launch(q, k, v, kv_mask, num_heads: int) -> torch.Tensor:
    _check_cuda_inputs(q, k, v, num_heads)
    b, t, packed = q.shape
    d = packed // num_heads
    mask_ptr = 0
    if kv_mask is not None:
        if kv_mask.shape != (b, t):
            raise ValueError(f"kv_mask must be [B, T] = {(b, t)}, got {tuple(kv_mask.shape)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
        mask_ptr = kv_mask.data_ptr()
    out = torch.empty_like(q)
    kernels.launch(
        kernels.dtype_entry("ta_encoder_attention", q.dtype), q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        b, t, num_heads, d, d ** -0.5,
    )
    encoder_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
encoder_attention.launches = 0
