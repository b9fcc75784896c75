"""Attention dispatch for the three attention shapes of serving and training.

Port of :mod:`tiny_audio_tpu.ops.attention`; public functions take the
[B, T, H, D] layout, as in the JAX package:

- encoder self-attention ([B, 1500, 20, 64]) -> the encoder kernel
  (:mod:`.encoder_attention`) for CUDA tensors, its plain version for CPU
  tensors; with grad, its backward recomputes the plain version;
- decoder causal attention over fresh K/V, the prefill and the training
  forward ([B, ~470-576, 16/8 GQA, 128]; head_dim 16-256, bf16 or fp32) -> the causal
  kernel (:mod:`.prefill_attention`) likewise; with grad, the forward keeps
  its softmax statistics and the backward runs the two backward kernels;
- the decode step (q_len == 1 over the KV cache) with a scalar ``kv_len``
  -> the decode kernel (:mod:`.decode_attention`) for CUDA tensors, its plain
  version for CPU tensors; without ``kv_len`` (a per-row cache index, which
  only the continuous engine uses) -> plain masked PyTorch on both devices.
"""

from __future__ import annotations

from typing import Optional

import torch

from tiny_audio_tpu_torch.models.layers import MASK_VALUE
from tiny_audio_tpu_torch.models.layers import attention as _attention
from tiny_audio_tpu_torch.ops.decode_attention import KvLen, decode_attention
from tiny_audio_tpu_torch.ops.encoder_attention import encoder_attention
from tiny_audio_tpu_torch.ops.prefill_attention import prefill_attention


def causal_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal self-attention over fresh K/V (prefill)."""
    return prefill_attention(q, k, v, padding_mask)


def encoder_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bidirectional self-attention with an optional [B, T] padding mask.
    [B, T, H, D] is viewed as the packed [B, T, H*D] the kernel reads."""
    b, t, h, d = q.shape
    out = encoder_attention(
        q.reshape(b, t, h * d), k.reshape(b, t, h * d), v.reshape(b, t, h * d),
        padding_mask, num_heads=h,
    )
    return out.reshape(b, t, h, d)


def decode_step_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    kv_valid: torch.Tensor,
    fresh_k: Optional[torch.Tensor] = None,
    fresh_v: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    kv_len: Optional[KvLen] = None,
) -> torch.Tensor:
    """q_len == 1 attention over the KV cache.  kv_valid: [B, S] or [S].

    With ``fresh_k``/``fresh_v`` ([B, 1, Hkv, D]) the cache is STALE at the
    current position: attention runs over the masked cache plus the fresh
    self position appended in score space, so the caller writes the cache
    once per step, after attention.

    ``k_scale``/``v_scale`` ([B, S, Hkv]): the cache holds per-entry-scaled
    int8; the scales fold into the scores and the probabilities, so no
    dequantized copy of the cache is made.

    ``kv_len`` (the number of valid cache rows, the same for every batch row:
    the decode loops' ``cache_index``, an int or a 0-d int32 tensor on the
    device) routes a step with fresh K/V to :func:`decode_attention`, which
    reads only those rows; ``kv_valid`` must then mark exactly them.
    """
    if kv_len is not None and fresh_k is not None:
        b, _, hq, d = q.shape
        out = decode_attention(
            q.reshape(b, hq, d), cache_k, cache_v,
            fresh_k.reshape(b, -1, d), fresh_v.reshape(b, -1, d), kv_len,
            k_scale=k_scale, v_scale=v_scale,
        )
        return out.reshape(b, 1, hq, d)
    if kv_valid.ndim == 1:
        kv_valid = kv_valid[None, :]
    if fresh_k is None:
        mask = kv_valid.to(torch.bool)[:, None, None, :]
        return _attention(q, cache_k, cache_v, mask=mask)

    b, _, hq, d = q.shape
    hkv = cache_k.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    f32 = torch.float32
    compute_dtype = q.dtype
    qg = q.reshape(b, hkv, group, d).to(f32)
    # cache -> compute dtype -> fp32 is exact and matches the JAX einsum's
    # fp32 accumulation over compute-dtype operands
    scores = torch.einsum(
        "bhgd,bkhd->bhgk", qg, cache_k.to(compute_dtype).to(f32)
    ) * scale
    if k_scale is not None:
        scores = scores * k_scale.transpose(1, 2)[:, :, None, :]
    scores = torch.where(kv_valid.to(torch.bool)[:, None, None, :], scores, MASK_VALUE)
    self_score = torch.einsum(
        "bhgd,bhd->bhg", qg, fresh_k.reshape(b, hkv, d).to(f32)
    )[..., None] * scale
    probs = torch.softmax(torch.cat([scores, self_score], dim=-1), dim=-1)
    cache_probs = probs[..., :-1]
    if v_scale is not None:  # fold the dequantization scale into the probabilities
        cache_probs = cache_probs * v_scale.transpose(1, 2)[:, :, None, :]
    out = torch.einsum(
        "bhgk,bkhd->bhgd",
        cache_probs.to(compute_dtype).to(f32),
        cache_v.to(compute_dtype).to(f32),
    )
    out = out + probs[..., -1:].to(compute_dtype) * fresh_v.reshape(b, hkv, 1, d).to(
        compute_dtype
    )
    return out.reshape(b, 1, hq, d).to(q.dtype)
