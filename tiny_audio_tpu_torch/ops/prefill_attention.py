"""Causal GQA prefill attention and its gradient: CUDA kernels for Hopper and
their plain versions.

Replaces ``tiny_audio_tpu/ops/attention.py::_flash_call`` / ``flash_mha``,
which call the library Pallas kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` for the decoder's
prefill and training forward (causal attention with a key-padding mask), and
under ``jax.value_and_grad`` its two backward kernels
(``_flash_attention_bwd_dkv``, ``_flash_attention_bwd_dq``).  The TPU path
repeats the KV heads to the query head count and pads T to a 128 multiple;
the kernels read q ``[B, T, Hq, D]`` and k/v ``[B, T, Hkv, D]`` as the
projections produce them (``kv_head = q_head // (Hq // Hkv)``), mask the
ragged edge themselves and skip key tiles past the diagonal, at head_dim
16, 32, 64, 128 and 256, in bf16 (tensor cores) or fp32 (the ``_f32``
instances of ``csrc/attention_f32.cu``, fp32 FMAs on the CUDA cores):

- forward (entry points in ``csrc/attention.cu``): ``ta_prefill_attention``
  for serving, ``ta_prefill_attention_fwd_stats`` for training, which also
  writes each row's softmax max ``m`` and sum ``l`` ``[B, Hq, T]`` fp32, kept
  apart so a row whose visible keys are all padding keeps its ``l``
  (:func:`prefill_attention_stats_plain` is their plain version).  In bf16
  at head_dim 64 and 128 (the flagship's decoder) both run the Hopper design
  of ``csrc/attention_sm90.cu``: 64 query rows a block (one consumer
  warpgroup, two blocks an SM), 64-key K/V tiles streamed by TMA into a
  two-stage ring, ``wgmma`` products with P kept in registers, the per-key
  mask only on the diagonal, ragged and padded tiles, and the heaviest
  (last) query tiles scheduled first; at head_dim 16, 32 and 256 the
  ``mma.sync`` template of ``csrc/attention.cu``;
- backward (entry points in ``csrc/attention_bwd.cu``):
  ``ta_prefill_attention_bwd_dkv`` (dK, dV, the GQA group summed in the
  kernel, no atomics) and ``ta_prefill_attention_bwd_dq``, after
  ``delta = rowsum(dO * O)`` in torch, as the library computes it outside
  Pallas too.  In bf16 at head_dim 64 and 128 both run the Hopper design of
  ``csrc/attention_bwd_sm90.cu``: the block's K and V (dkv) or Q and dO
  (dq) loaded once by TMA, the other pair streamed through a two-stage
  ring, ``wgmma`` products with every accumulator in registers (dkv: two
  consumer warpgroups of 64 keys, ``setmaxnreg`` moving registers from the
  producer to them; dq: one of 64 query rows), P and dS formed in registers
  as the next product's operand, the per-element mask only on the
  diagonal, padded and ragged tiles, and the heaviest tiles first; at
  head_dim 16, 32 and 256 the ``mma.sync`` template of
  ``csrc/attention_bwd.cu``.

None reaches its bound (the larger of its bytes over 3.35 TB/s and its
FLOPs over 989 TFLOP/s; the two nearly meet at training shapes).  On the
training path's inputs (B = 6, T = 512, 16/8 heads of 128; NVIDIA H100
80GB HBM3 at 700 W, CUDA graph, ``chip_smoke.py``; PERF.md section 6)
dkv takes 0.05623 ms, 27% of its 0.01521 ms bound (229.6 TFLOP/s), and dq
0.04637 ms, 33% (208.8 TFLOP/s), against 3.0% and 4.5% for the
``mma.sync`` design at the same shape; the sources' headers say what each
leaves serial.  ``attention_delta``'s torch chain (casts, product, sum,
transpose) takes 0.08330 ms there, longer than either kernel.

On a CPU tensor :func:`prefill_attention` runs :func:`prefill_attention_plain`
(autograd differentiates it); on a CUDA tensor it launches the kernels or
raises: with grad enabled and an input that requires grad it goes through
:class:`PrefillAttention` (forward with statistics, backward kernels),
otherwise through the serving launch.  :func:`prefill_attention_backward_plain`
is the oracle of both backward kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.models.layers import MASK_VALUE
from tiny_audio_tpu_torch.models.layers import attention as _attention

_LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)  # the supported decoders and the tiny towers
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


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


def prefill_attention_stats_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The row statistics of the forward with statistics, in fp32: ``m``
    [B, Hq, T], each row's max score in log2 units (scale applied; a padding
    key scores ``MASK_VALUE``, keys past the diagonal are excluded), and
    ``l`` [B, Hq, T], the sum of ``exp2(score - m)`` over the row's keys."""
    b, t, hq, d = q.shape
    kk = k.float().repeat_interleave(hq // k.shape[2], dim=2)
    x = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * (d ** -0.5 * _LOG2E)
    if padding_mask is not None:
        x = x.masked_fill(~padding_mask.to(torch.bool)[:, None, None, :], MASK_VALUE)
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    x = x.masked_fill(~causal, float("-inf"))
    m = x.amax(-1)
    return m, torch.exp2(x - m[..., None]).sum(-1)


def prefill_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    dout: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by autograd through :func:`prefill_attention_plain`, in
    the inputs' dtypes: the oracle of the two backward kernels."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = prefill_attention_plain(*leaves, padding_mask)
        dq, dk, dv = torch.autograd.grad(out, leaves, dout)
    return dq, dk, dv


def _check_cuda_inputs(q, k, v) -> None:
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"prefill attention kernel takes {KERNEL_DTYPES}, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B,T,Hq,D], k/v [B,T,Hkv,D]: {q.shape} {k.shape} {v.shape}")
    b, t, hq, d = q.shape
    if k.shape[:2] != (b, t) or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} as GQA")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"prefill attention kernels take head_dim {KERNEL_HEAD_DIMS}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _kernel_mask(padding_mask: Optional[torch.Tensor], q: torch.Tensor):
    """The [B, T] int32 mask the kernels read (or None) and its pointer; the
    caller holds the tensor until the launch is queued."""
    if padding_mask is None:
        return None, 0
    b, t = q.shape[:2]
    if padding_mask.shape != (b, t):
        raise ValueError(
            f"padding_mask must be [B, T] = {(b, t)}, got {tuple(padding_mask.shape)}")
    mask = padding_mask.to(device=q.device, dtype=torch.int32).contiguous()
    return mask, mask.data_ptr()


def _shape_args(q: torch.Tensor, k: torch.Tensor) -> tuple:
    b, t, hq, d = q.shape
    return b, t, hq, k.shape[2], d, d ** -0.5


def prefill_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training forward on the card: (out [B, T, Hq, D], m, l), with
    ``m``/``l`` [B, Hq, T] fp32 the rows' max score (log2 units, scale
    applied) and sum of ``exp2(score - m)``.  Counts a launch of
    :func:`prefill_attention`."""
    _check_cuda_inputs(q, k, v)
    mask, mask_ptr = _kernel_mask(padding_mask, q)
    b, t, hq = q.shape[:3]
    out = torch.empty_like(q)
    m = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    kernels.launch(kernels.dtype_entry("ta_prefill_attention_fwd_stats", q.dtype), q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
                   m.data_ptr(), l.data_ptr(), *_shape_args(q, k))
    prefill_attention.launches += 1
    return out, m, l


def _check_backward_inputs(q, k, v, dout, m, l, delta) -> None:
    _check_cuda_inputs(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous {q.dtype} tensor of shape {tuple(q.shape)}")
    b, t, hq = q.shape[:3]
    for name, x in (("m", m), ("l", l), ("delta", delta)):
        if x.shape != (b, hq, t) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [B, Hq, T] = {(b, hq, t)}")


def prefill_attention_bwd_dkv(q, k, v, padding_mask, dout, m, l, delta):
    """(dk, dv) [B, T, Hkv, D] from the backward kernel ``bwd_dkv``: ``m``,
    ``l`` from :func:`prefill_attention_forward`, ``delta`` [B, Hq, T] =
    rowsum(dout * out) in fp32."""
    _check_backward_inputs(q, k, v, dout, m, l, delta)
    mask, mask_ptr = _kernel_mask(padding_mask, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernels.launch(kernels.dtype_entry("ta_prefill_attention_bwd_dkv", q.dtype), q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, dout.data_ptr(),
                   m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   *_shape_args(q, k))
    prefill_attention_bwd_dkv.launches += 1
    return dk, dv


def prefill_attention_bwd_dq(q, k, v, padding_mask, dout, m, l, delta):
    """dq [B, T, Hq, D] from the backward kernel ``bwd_dq`` (arguments as
    :func:`prefill_attention_bwd_dkv`)."""
    _check_backward_inputs(q, k, v, dout, m, l, delta)
    mask, mask_ptr = _kernel_mask(padding_mask, q)
    dq = torch.empty_like(q)
    kernels.launch(kernels.dtype_entry("ta_prefill_attention_bwd_dq", q.dtype), q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, dout.data_ptr(),
                   m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                   *_shape_args(q, k))
    prefill_attention_bwd_dq.launches += 1
    return dq


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dout * out) in fp32 as [B, Hq, T], the backward's delta."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class PrefillAttention(torch.autograd.Function):
    """Kernel #2 with its gradient on the card: the forward keeps the row
    statistics, the backward runs ``bwd_dkv`` and ``bwd_dq``.  Recomputing
    the forward under ``torch.utils.checkpoint`` launches the forward again
    and saves fresh statistics."""

    @staticmethod
    def forward(ctx, q, k, v, padding_mask):
        out, m, l = prefill_attention_forward(q, k, v, padding_mask)
        ctx.save_for_backward(q, k, v, padding_mask, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, padding_mask, out, m, l = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = attention_delta(out, dout)
        dk, dv = prefill_attention_bwd_dkv(q, k, v, padding_mask, dout, m, l, delta)
        dq = prefill_attention_bwd_dq(q, k, v, padding_mask, dout, m, l, delta)
        return dq, dk, dv, None


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return PrefillAttention.apply(q, k, v, padding_mask)
    _check_cuda_inputs(q, k, v)
    mask, mask_ptr = _kernel_mask(padding_mask, q)
    out = torch.empty_like(q)
    kernels.launch(kernels.dtype_entry("ta_prefill_attention", q.dtype), q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
                   *_shape_args(q, k))
    prefill_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count): the forward,
#: serving and training alike, and each of the two backward kernels
prefill_attention.launches = 0
prefill_attention_bwd_dkv.launches = 0
prefill_attention_bwd_dq.launches = 0
