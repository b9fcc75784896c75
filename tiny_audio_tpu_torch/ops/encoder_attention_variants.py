"""Kernel #9a: the encoder attention under 13 softmax modes, a CUDA kernel for
Hopper and its plain version.

Replaces the TPU bench kernel of ``scripts/bench_encoder_attention.py``
(``build(hg, sm)``): #1's function (:mod:`.encoder_attention`, bidirectional
attention over packed heads ``[B, T, H*64]`` with a key mask) with the
softmax done one of 13 ways (:data:`MODES`), which differ along four axes:
the shift (the exact row max; 8; ``min(s, 80) - 48``; one max over a
head's 256-row query group; the bound ``|q_row| * max_t |k_t| * D^-0.5``),
the exponential (fp32, or bf16 on ``bf16(s - m)``), where the division
falls (``bf16(p / denom)`` or ``bf16(p * rcp(denom))`` before P.V, or on the
``[256, 64]`` output after it) and a ``+1e-30`` guard on the denominator.
``packed2`` is two heads per block through block-diagonal K/V; the zero
blocks add nothing, so it is ``shift_post`` per head.

No path of the port calls it: it is the yardstick of #1's redesign, driven
by ``python -m tiny_audio_tpu_torch.tools.bench_encoder_attention``.  The
kernel (``csrc/encoder_attention_variants.cu``) is one template over the four
axes on #1's Hopper design (TMA loads issued ahead by one thread, ``wgmma``,
four warpgroups a block); its source states the design and the bound, and
:func:`variant_passes` the passes over the keys each mode takes.  On a CPU tensor
:func:`encoder_attention_variant` runs :func:`encoder_attention_variant_plain`;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.models.layers import MASK_VALUE

#: the softmax modes, in the kernel's numbering (ta_encoder_attention_variant)
MODES = ("fp32", "bf16", "rcp", "nomax", "shift", "tilemax", "tilemax_rcp", "qnorm",
         "qnorm_post", "fp32_post", "shift_post", "tilemax_post", "packed2")
#: groups of modes that compute one function up to fp32 rounding while no
#: exponential under- or overflows: the shift cancels in ``p / denom``, and
#: ``packed2`` is ``shift_post``.  Every other pair differs at bf16 rounding
#: points (where the probabilities, shifted or normalized, are rounded).
SAME_FUNCTION = (("fp32", "rcp", "nomax", "shift", "tilemax", "tilemax_rcp", "qnorm"),
                 ("shift_post", "packed2"))
#: query rows per TPU program: the ``tilemax`` modes share one max over them
BQ = 256
HEAD_DIM = 64  # the bench's, and the only head_dim the kernel builds

_SHIFT = {"fp32": "rowmax", "bf16": "rowmax", "rcp": "rowmax", "fp32_post": "rowmax",
          "nomax": "const8", "shift": "clamp48", "shift_post": "clamp48",
          "tilemax": "tilemax", "tilemax_rcp": "tilemax", "tilemax_post": "tilemax",
          "qnorm": "qnorm", "qnorm_post": "qnorm"}
_UNGUARDED = ("fp32", "bf16", "rcp", "nomax")
#: the most keys the kernel takes (its mask bits live in shared memory)
MAX_T = 65536


def variant_passes(mode: str) -> tuple[str, ...]:
    """The kernel's passes over the keys under ``mode``, in order: ``knorm``
    (max_t |k_t|, reads K only), ``max`` (S, the exact or the 256-row
    group's max), ``den`` (S and the exponentials, the denominator a
    normalise-before-P.V mode needs) and ``pv`` (S, the exponentials and
    P.V).  Merging ``max`` into ``den`` with an online rescale would round
    the denominator otherwise: another function."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the modes are {MODES}")
    shift = _SHIFT.get(mode, "clamp48")  # packed2 is shift_post per head
    passes = ("knorm",) if shift == "qnorm" else ()
    if shift in ("rowmax", "tilemax"):
        passes += ("max",)
    if not (mode.endswith("_post") or mode == "packed2"):
        passes += ("den",)
    return passes + ("pv",)


def variant_units(mode: str) -> int:
    """Products over all keys that ``mode`` takes, S = Q K^T and P.V one
    unit each: #1 takes 2."""
    units = {"knorm": 0, "max": 1, "den": 1, "pv": 2}
    return sum(units[p] for p in variant_passes(mode))


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, T, H*D] -> fp32 [B, H, T, D] (bf16 -> fp32 is exact)."""
    b, t, packed = x.shape
    return x.reshape(b, t, h, packed // h).transpose(1, 2).to(torch.float32)


def _packed2_plain(qh, kh, vh, mask, scale):
    """``packed2``'s formula: heads (2i, 2i + 1) as one 128-wide product
    against block-diagonal K2, V2 [2T, 128]; the two halves of the scores
    are normalized apart.  qh/kh/vh fp32 [B, H, T, D]; returns [B, H, T, D]."""
    b, h, t, d = qh.shape
    pair = lambda x: x.reshape(b, h // 2, 2, t, d)  # noqa: E731
    qp = pair(qh).transpose(2, 3).reshape(b, h // 2, t, 2 * d)  # [q1 | q2]
    k1, k2 = pair(kh).unbind(2)
    v1, v2 = pair(vh).unbind(2)
    zeros = torch.zeros_like(k1)
    kd = torch.cat([torch.cat([k1, zeros], -1), torch.cat([zeros, k2], -1)], dim=2)  # [.., 2T, 2D]
    vd = torch.cat([torch.cat([v1, zeros], -1), torch.cat([zeros, v2], -1)], dim=2)
    s = (qp @ kd.transpose(-1, -2)) * scale
    s = torch.where(torch.cat([mask, mask], -1)[:, None, None, :], s, MASK_VALUE)
    p = torch.exp(s.clamp(max=80.0) - 48.0)
    d1 = p[..., :t].sum(-1, keepdim=True) + 1e-30
    d2 = p[..., t:].sum(-1, keepdim=True) + 1e-30
    o = p.to(torch.bfloat16).to(torch.float32) @ vd  # [o1 * Z1 | o2 * Z2]
    o = torch.cat([o[..., :d] / d1, o[..., d:] / d2], dim=-1)
    return o.reshape(b, h // 2, t, 2, d).transpose(2, 3).reshape(b, h, t, d)


def encoder_attention_variant_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    num_heads: int,
    mode: str,
) -> torch.Tensor:
    """Mode ``mode``'s formula with the TPU kernel's rounding points: fp32
    scores of the bf16 inputs, the mode's shift, exponential and
    denominator, the probabilities (or, for the ``*_post`` modes and
    ``packed2``, the unnormalized ones) rounded to bf16 for the fp32 P.V,
    the output rounded to bf16.  q/k/v [B, T, H*D] bf16, kv_mask [B, T]
    (1 = real key) or None.  (The kernel's heads per block, ``hg``, do not
    change the function.)"""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the modes are {MODES}")
    b, t, packed = q.shape
    h = num_heads
    d = packed // h
    scale = d ** -0.5
    mask = (torch.ones((b, t), dtype=torch.bool, device=q.device) if kv_mask is None
            else kv_mask.to(torch.bool))
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    if mode == "packed2":
        o = _packed2_plain(qh, kh, vh, mask, scale)
        return o.to(torch.bfloat16).transpose(1, 2).reshape(b, t, packed)
    s = torch.where(mask[:, None, None, :], (qh @ kh.transpose(-1, -2)) * scale, MASK_VALUE)
    shift = _SHIFT[mode]
    if shift == "rowmax":
        x = s - s.amax(-1, keepdim=True)
    elif shift == "const8":
        x = s - 8.0
    elif shift == "clamp48":
        x = s.clamp(max=80.0) - 48.0
    elif shift == "tilemax":
        if t % BQ:
            raise ValueError(f"the tilemax modes group query rows by {BQ}: T = {t}")
        m = s.reshape(b, h, t // BQ, BQ * t).amax(-1)  # one max per 256-row group
        x = s - m.repeat_interleave(BQ, dim=-1)[..., None]
    else:  # qnorm: |q_row| * (max over all T keys of |k_t|) * D^-0.5
        qn = torch.sqrt((qh * qh).sum(-1, keepdim=True))
        kmax = torch.sqrt((kh * kh).sum(-1).amax(-1))[..., None, None]
        x = s - qn * (kmax * scale)
    if mode == "bf16":
        p = torch.exp(x.to(torch.bfloat16)).to(torch.float32)
    else:
        p = torch.exp(x)
    denom = p.sum(-1, keepdim=True)
    if mode not in _UNGUARDED:
        denom = denom + 1e-30
    if mode.endswith("_post"):
        o = (p.to(torch.bfloat16).to(torch.float32) @ vh) / denom
    else:
        pn = p * torch.reciprocal(denom) if mode in ("rcp", "tilemax_rcp") else p / denom
        o = pn.to(torch.bfloat16).to(torch.float32) @ vh
    return o.to(torch.bfloat16).transpose(1, 2).reshape(b, t, packed)


def encoder_attention_fp64(q, k, v, kv_mask, num_heads: int) -> torch.Tensor:
    """The exact function in float64 (the bench script's oracle): padding
    keys score -1e30.  Returns [B, T, H*D] float64."""
    b, t, packed = q.shape
    h = num_heads
    d = packed // h
    qh, kh, vh = (x.reshape(b, t, h, d).transpose(1, 2).to(torch.float64) for x in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * d ** -0.5
    if kv_mask is not None:
        s = torch.where(kv_mask.to(torch.bool)[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return (p @ vh).transpose(1, 2).reshape(b, t, packed)


def _check_cuda_inputs(q, k, v, num_heads: int, mode: str, hg: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the modes are {MODES}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"encoder attention variant kernel takes bfloat16, got {q.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, T, H*D] shape: {q.shape} {k.shape} {v.shape}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    b, t, packed = q.shape
    if packed != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}: {packed} features, "
                         f"{num_heads} heads")
    if t % BQ or t > MAX_T:
        raise ValueError(f"the kernel takes T a multiple of {BQ} up to {MAX_T}, got {t}")
    if hg <= 0 or num_heads % hg or (mode == "packed2" and hg % 2):
        raise ValueError(f"hg = {hg} must divide H = {num_heads} (and be even for packed2)")


def encoder_attention_variant(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    num_heads: int,
    mode: str,
    hg: int = 10,
) -> torch.Tensor:
    """#1's function under softmax mode ``mode``, ``hg`` heads per thread
    block.  q/k/v [B, T, H*64] bf16 (T a multiple of 256), kv_mask [B, T] or
    None.  Returns [B, T, H*64] bf16."""
    if not q.is_cuda:
        return encoder_attention_variant_plain(q, k, v, kv_mask, num_heads, mode)
    _check_cuda_inputs(q, k, v, num_heads, mode, hg)
    b, t, _ = q.shape
    if kv_mask is None:
        kv_mask = torch.ones((b, t), dtype=torch.int32, device=q.device)
    if kv_mask.shape != (b, t):
        raise ValueError(f"kv_mask must be [B, T] = {(b, t)}, got {tuple(kv_mask.shape)}")
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    kernels.launch("ta_encoder_attention_variant", q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                   b, t, num_heads, HEAD_DIM, hg, MODES.index(mode), HEAD_DIM ** -0.5)
    encoder_attention_variant.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
encoder_attention_variant.launches = 0
