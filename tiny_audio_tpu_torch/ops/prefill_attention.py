"""Causal GQA prefill attention: a CUDA kernel for Hopper and its plain version.

Replaces ``tiny_audio_tpu/ops/attention.py::_flash_call`` / ``flash_mha``,
which call the library Pallas kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` for the decoder's prefill:
causal attention with a key-padding mask.  The TPU path repeats the KV heads
to the query head count and pads T to a 128 multiple; the kernel
(``csrc/attention.cu``, ``ta_prefill_attention``) reads q ``[B, T, Hq, D]``
and k/v ``[B, T, Hkv, D]`` as the projections produce them, maps each query
head to ``kv_head = q_head // (Hq // Hkv)``, masks the ragged edge itself and
skips key tiles past the diagonal.  Forward only: the backward comes with
training.  Like the encoder kernel it is bound by compute (the source's
header has the numbers).

Rows whose query is padding are don't-care: the JAX package's naive path and
its segment-id flash path already disagree there, and so may the kernel.

On a CPU tensor :func:`prefill_attention` runs :func:`prefill_attention_plain`;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.models.layers import attention as _attention

KERNEL_HEAD_DIM = 128  # the serving path's; the library builds only this one


def prefill_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal reference: q [B, T, Hq, D], k/v [B, T, Hkv, D], padding_mask
    [B, T] (1 = real token) or None.  Returns [B, T, Hq, D]."""
    t = q.shape[1]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))[None, None]
    if padding_mask is not None:
        mask = causal & padding_mask.to(torch.bool)[:, None, None, :]
    else:
        mask = causal.expand(q.shape[0], 1, t, t)
    return _attention(q, k, v, mask=mask)


def _check_cuda_inputs(q, k, v) -> None:
    if q.dtype != torch.bfloat16:
        raise TypeError(f"prefill attention kernel takes bfloat16, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B,T,Hq,D], k/v [B,T,Hkv,D]: {q.shape} {k.shape} {v.shape}")
    b, t, hq, d = q.shape
    if k.shape[:2] != (b, t) or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} as GQA")
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"prefill attention kernel takes head_dim {KERNEL_HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal self-attention over fresh K/V with native GQA.

    q: [B, T, Hq, D]; k/v: [B, T, Hkv, D]; padding_mask: [B, T] (1 = real
    token, used for keys) or None.  Returns [B, T, Hq, D].
    """
    if not q.is_cuda:
        return prefill_attention_plain(q, k, v, padding_mask)
    _check_cuda_inputs(q, k, v)
    b, t, hq, d = q.shape
    mask_ptr = 0
    if padding_mask is not None:
        if padding_mask.shape != (b, t):
            raise ValueError(
                f"padding_mask must be [B, T] = {(b, t)}, got {tuple(padding_mask.shape)}"
            )
        padding_mask = padding_mask.to(device=q.device, dtype=torch.int32).contiguous()
        mask_ptr = padding_mask.data_ptr()
    out = torch.empty_like(q)
    kernels.launch(
        "ta_prefill_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        b, t, hq, k.shape[2], d, d ** -0.5,
    )
    prefill_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
prefill_attention.launches = 0
