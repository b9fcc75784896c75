"""Shared building blocks: RMSNorm, rotary embeddings, the attention oracle.

Port of :mod:`tiny_audio_tpu.models.layers`.  Attention math keeps its
products and softmax in float32 even for bf16 inputs: a bf16 matmul in
PyTorch rounds its output to bf16, so the oracle upcasts its operands (exact)
where the JAX code asks for ``preferred_element_type=float32``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

# Large-negative mask value; -0.7*float32_max avoids NaN from (-inf) - (-inf)
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, offset: float = 0.0
) -> torch.Tensor:
    """RMSNorm with float32 statistics (LlamaRMSNorm semantics).

    ``offset=1.0`` selects the Gemma convention: weights stored zero-centered
    and applied as ``(1 + w)``, cast back to the compute dtype after the
    weight multiply."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (offset + weight.to(torch.float32))).to(dtype)


class RMSNorm(nn.Module):
    """RMSNorm with an fp32 ``weight`` (ones, or zeros under ``offset``)."""

    def __init__(self, dim: int, eps: float = 1e-6, offset: float = 0.0, device=None):
        super().__init__()
        self.eps = eps
        self.offset = offset
        init = torch.zeros if offset else torch.ones
        self.weight = nn.Parameter(init(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps, self.offset)


def rotary_embed(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for the given positions, NeoX half-rotation layout.

    positions: [B, T] int -> cos/sin [B, T, head_dim//2] float32.
    """
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exponent / head_dim))
    freqs = positions.to(torch.float32)[..., None] * inv_freq[None, None, :]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply rotary embedding.  x: [B, T, H, D]; cos/sin: [B, T, D//2]."""
    dtype = x.dtype
    x = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention with GQA support and fp32 softmax.

    q: [B, Tq, Hq, D];  k, v: [B, Tk, Hkv, D];  mask: broadcastable to
    [B, Hq, Tq, Tk] (True = attend; masked scores take ``MASK_VALUE``, so a
    fully masked row averages uniformly and never gives NaN).
    Returns [B, Tq, Hq, D] in q's dtype.
    """
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    group = hq // hkv

    qg = q.reshape(b, tq, hkv, group, d)
    scores = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32)
    ) * scale
    if mask is not None:
        m = mask.to(torch.bool)
        if m.ndim == 2:  # [B, Tk] padding mask
            m = m[:, None, None, None, :]
        else:
            if m.ndim == 3:  # [B, Tq, Tk]
                m = m[:, None]
            if m.shape[1] == 1:  # head-broadcast
                m = m[:, :, None]  # [B|1, 1, 1, Tq, Tk]
            else:
                m = m.expand(b, hq, tq, m.shape[-1]).reshape(b, hkv, group, tq, -1)
        scores = torch.where(m, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd",
        probs.to(v.dtype).to(torch.float32),
        v.to(torch.float32),
    )
    return out.reshape(b, tq, hq, d).to(q.dtype)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position table [length, dim] (float32)."""
    log_timescale = float(np.float32(np.log(10000.0))) / (dim // 2 - 1)
    inv_timescales = torch.exp(
        -log_timescale * torch.arange(dim // 2, dtype=torch.float32, device=device)
    )
    scaled = (
        torch.arange(length, dtype=torch.float32, device=device)[:, None]
        * inv_timescales[None, :]
    )
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
