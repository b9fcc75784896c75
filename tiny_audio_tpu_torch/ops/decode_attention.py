"""Decode-step attention over the KV cache: CUDA kernels for Hopper and their
plain versions.

Replaces the JAX package's two Pallas decode kernels
(``tiny_audio_tpu/ops/decode_attention.py``):

- :func:`decode_attention` for ``decode_attention_tpu``: one query row per
  head attends over the valid cache prefix ``[0, kv_len)`` plus the fresh
  (not yet cached) row; the caller writes the cache afterwards;
- :func:`decode_attention_update` for ``decode_attention_update_tpu``: the
  same attention over one layer's cache views, plus the in-place write of
  the fresh row at ``kv_len`` (int8-quantized with ``quantize_kv``'s
  arithmetic when the cache is int8).

The kernels (``csrc/decode_attention.cu``) read only the first ``kv_len``
cache rows, int8 dequantized with the per-entry scales; the source's header
states the bound and the design.  They split the cache rows over blocks
(:func:`split_plan`) and merge the splits inside the same launch, through
an fp32 scratch the wrapper allocates and counters it owns
(:func:`counter_buffer`: per device, never freed, zero between launches),
so calls on one device must not run concurrently on two streams: every
path of the port runs on one stream.
:func:`decode_attention_split_plain` repeats the kernels' arithmetic (a
part per split, merged in split order) as a test oracle; no path calls it.
They work in the model's dtype, bf16 or fp32: q, the fresh K/V and the
output in it, the cache in it or in int8.  The JAX package left both kernels
off by default because XLA copies a loop-carried cache that a custom call
reads; a torch cache written in place has no such copy.

``kv_len`` is a Python int or a 0-d int32 tensor on the kernel's device: the
kernel reads it from device memory, so a step can be launched without the
host knowing it.  On a CPU tensor each wrapper runs its plain version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from tiny_audio_tpu_torch import kernels

#: head_dims, GQA groups (query heads per KV head) and model dtypes the
#: kernels take: Qwen3, Llama-3.2, SmolLM2 and Gemma shapes, and the tiny towers
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
KERNEL_GROUPS = (1, 2, 3, 4, 8)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

KvLen = Union[int, torch.Tensor]

#: query heads one block holds (a group of 8 takes two blocks per KV head)
MAX_HEADS = 4
#: the split: blocks the grid aims at (a little under the 396 that the
#: H100's 132 SMs hold at once, three of 256 threads each), rows a split (a
#: multiple of SPLIT_ROW_STEP) and the most splits
SPLIT_TARGET_BLOCKS = 352
SPLIT_ROW_STEP = 8
MAX_SPLITS = 12


class SplitPlan(NamedTuple):
    """How the decode kernels cut one launch: ``rows`` cache rows per split,
    ``splits`` of them over ``[0, S)``, the grid (head chunk x KV head,
    split, batch row), the fp32 scratch for the splits' parts (0 with one
    split) and the int32 counters (one per batch row, KV head and chunk)."""

    rows: int
    splits: int
    grid: tuple[int, int, int]
    scratch_floats: int
    counters: int


def split_plan(b: int, s: int, hkv: int, group: int, d: int,
               cache_dtype: torch.dtype) -> SplitPlan:
    """The split of a launch over ``[B, S, Hkv, D]`` cache views, from values
    the host knows (never ``kv_len``, so a launch fits a CUDA graph): enough
    splits that the grid reaches about SPLIT_TARGET_BLOCKS blocks, at most
    MAX_SPLITS; one split where the batch rows and heads alone fill the card
    (B = 48 at Hkv 8).  Every split starts on a row, and a row of one head is
    ``D x elem`` bytes, a multiple of the copies' 16."""
    if (d * torch.empty((), dtype=cache_dtype).element_size()) % 16:
        raise ValueError(f"a cache row of head_dim {d} in {cache_dtype} is not a multiple "
                         "of 16 bytes")
    heads = min(group, MAX_HEADS)
    chunks = group // heads
    per_split = b * hkv * chunks
    want = min(max(-(-SPLIT_TARGET_BLOCKS // per_split), 1), MAX_SPLITS)
    rows = -(-s // want)  # ceil(S / want), then up to a multiple of the step
    rows = -(-rows // SPLIT_ROW_STEP) * SPLIT_ROW_STEP
    splits = -(-s // rows)
    return SplitPlan(rows=rows, splits=splits, grid=(hkv * chunks, splits, b),
                     scratch_floats=b * hkv * group * splits * (d + 2) if splits > 1 else 0,
                     counters=b * hkv * chunks)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-entry symmetric int8 quantization over the head dim.

    x: [..., D] -> (int8 [..., D], fp32 scale [...]).  Rounds half to even,
    as ``jnp.round`` does.  Both divisions are IEEE divisions on every device
    (PyTorch on CUDA turns a division by a Python scalar into a multiply by
    its reciprocal, so 127 is a tensor here), and the append kernel stores
    the same bytes and scales.
    """
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def decode_attention_plain(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    fresh_k: torch.Tensor,
    fresh_v: torch.Tensor,
    kv_len: KvLen,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference: q [B, Hq, D], cache_k/v [B, S, Hkv, D] (bf16/fp32, or int8
    with k/v_scale [B, S, Hkv] fp32), fresh_k/v [B, Hkv, D].  Returns
    [B, Hq, D] in q's dtype.

    The math of ``ops.attention.decode_step_attention`` with the cache sliced
    to ``[:, :kv_len]`` instead of masked, so rows past ``kv_len`` are never
    read, as in the kernel."""
    n = int(kv_len)
    b, hq, d = q.shape
    hkv = cache_k.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    f32 = torch.float32
    compute_dtype = q.dtype
    qg = q.reshape(b, hkv, group, d).to(f32)
    ck, cv = cache_k[:, :n], cache_v[:, :n]
    # cache -> compute dtype -> fp32 is exact (the JAX einsum's operands)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, ck.to(compute_dtype).to(f32)) * scale
    if k_scale is not None:
        scores = scores * k_scale[:, :n].transpose(1, 2)[:, :, None, :]
    self_score = torch.einsum(
        "bhgd,bhd->bhg", qg, fresh_k.reshape(b, hkv, d).to(f32)
    )[..., None] * scale
    probs = torch.softmax(torch.cat([scores, self_score], dim=-1), dim=-1)
    cache_probs = probs[..., :-1]
    if v_scale is not None:  # fold the dequantization scale into the probabilities
        cache_probs = cache_probs * v_scale[:, :n].transpose(1, 2)[:, :, None, :]
    out = torch.einsum(
        "bhgk,bkhd->bhgd",
        cache_probs.to(compute_dtype).to(f32),
        cv.to(compute_dtype).to(f32),
    )
    out = out + probs[..., -1:].to(compute_dtype) * fresh_v.reshape(b, hkv, 1, d).to(
        compute_dtype
    )
    return out.reshape(b, hq, d).to(q.dtype)


def write_cache_rows(layer_cache: dict, k: torch.Tensor, v: torch.Tensor, index: int) -> None:
    """IN-PLACE write of fresh K/V [B, T, Hkv, D] at rows index..index+T-1
    of one layer's cache views ``{"k", "v"[, "k_scale", "v_scale"]}``,
    quantized when the cache is int8."""
    rows = slice(index, index + k.shape[1])
    if "k_scale" in layer_cache:
        for name, x in (("k", k), ("v", v)):
            x_q, x_s = quantize_kv(x)
            layer_cache[name][:, rows] = x_q
            layer_cache[f"{name}_scale"][:, rows] = x_s
    else:
        layer_cache["k"][:, rows] = k
        layer_cache["v"][:, rows] = v


def decode_attention_update_plain(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    fresh_k: torch.Tensor,
    fresh_v: torch.Tensor,
    kv_len: KvLen,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference for the kernel with the append: writes row ``kv_len`` of the
    cache views (and scales) in place, then attends over the stale prefix
    ``[0, kv_len)`` plus the fresh row."""
    views = {"k": cache_k, "v": cache_v}
    if k_scale is not None:
        views.update(k_scale=k_scale, v_scale=v_scale)
    write_cache_rows(views, fresh_k[:, None], fresh_v[:, None], int(kv_len))
    return decode_attention_plain(q, cache_k, cache_v, fresh_k, fresh_v, kv_len,
                                  k_scale, v_scale)


def decode_attention_split_plain(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    fresh_k: torch.Tensor,
    fresh_v: torch.Tensor,
    kv_len: KvLen,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch, a test oracle (no path calls
    it).  Shapes as :func:`decode_attention_plain`.  In fp32: scores
    ``q.k D^-0.5 (x k_scale)`` in log2 units; per split of
    :func:`split_plan`'s ``rows`` cache rows below ``kv_len`` its part, the
    split's max ``m``, ``l = sum exp2(s - m)`` and ``acc = sum exp2(s - m)
    (x v_scale) v``; at kv_len 0 one empty part.  The parts are merged in
    split order against the running max taken with the fresh row's score,
    and the fresh row is folded in last.  Returns [B, Hq, D] in q's dtype."""
    n = int(kv_len)
    b, hq, d = q.shape
    _, s, hkv, _ = cache_k.shape
    group = hq // hkv
    rows = split_plan(b, s, hkv, group, d, cache_k.dtype).rows
    f32 = torch.float32
    scale_log2 = d ** -0.5 * math.log2(math.e)
    qg = q.reshape(b, hkv, group, d).to(f32)
    parts = []
    for lo in range(0, max(n, 1), rows):
        hi = min(lo + rows, n)
        scores = torch.einsum("bhgd,brhd->bhgr", qg, cache_k[:, lo:hi].to(f32)) * scale_log2
        if k_scale is not None:
            scores = scores * k_scale[:, lo:hi].transpose(1, 2)[:, :, None, :]
        m = (scores.amax(dim=-1) if hi > lo
             else torch.full(scores.shape[:-1], -math.inf, dtype=f32, device=q.device))
        p = torch.exp2(scores - m[..., None])
        l = p.sum(dim=-1)
        if v_scale is not None:
            p = p * v_scale[:, lo:hi].transpose(1, 2)[:, :, None, :]
        parts.append((m, l, torch.einsum("bhgr,brhd->bhgd", p, cache_v[:, lo:hi].to(f32))))
    self_score = (qg * fresh_k.reshape(b, hkv, 1, d).to(f32)).sum(dim=-1) * scale_log2
    m_all = self_score
    for m, _, _ in parts:
        m_all = torch.maximum(m_all, m)
    num = torch.zeros_like(qg)
    denom = torch.zeros_like(m_all)
    for m, l, acc in parts:  # in split order; a part with no row weighs exp2(-inf) = 0
        w = torch.exp2(m - m_all)
        denom = denom + l * w
        num = num + acc * w[..., None]
    p_self = torch.exp2(self_score - m_all)
    num = num + p_self[..., None] * fresh_v.reshape(b, hkv, 1, d).to(f32)
    denom = denom + p_self
    return (num / denom[..., None]).reshape(b, hq, d).to(q.dtype)


def _check_cuda_inputs(q, cache_k, cache_v, fresh_k, fresh_v, k_scale, v_scale) -> None:
    if q.dtype not in KERNEL_DTYPES or fresh_k.dtype != q.dtype or fresh_v.dtype != q.dtype:
        raise TypeError(
            f"decode attention kernel takes q and fresh K/V of one dtype in {KERNEL_DTYPES}, "
            f"got {q.dtype}, {fresh_k.dtype}, {fresh_v.dtype}"
        )
    if q.ndim != 3 or cache_k.ndim != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(f"need q [B,Hq,D], cache [B,S,Hkv,D]: {q.shape} {cache_k.shape} "
                         f"{cache_v.shape}")
    b, hq, d = q.shape
    _, s, hkv, _ = cache_k.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got q {tuple(q.shape)} with head_dim {d}")
    if cache_k.shape[0] != b or cache_k.shape[3] != d or hq % hkv:
        raise ValueError(f"cache {tuple(cache_k.shape)} does not match q {tuple(q.shape)}")
    if hq // hkv not in KERNEL_GROUPS:
        raise ValueError(f"decode attention kernel takes {KERNEL_GROUPS} query heads per KV "
                         f"head, got {hq} over {hkv} (q {tuple(q.shape)}, cache "
                         f"{tuple(cache_k.shape)})")
    if fresh_k.shape != (b, hkv, d) or fresh_v.shape != (b, hkv, d):
        raise ValueError(f"fresh K/V must be [B, Hkv, D] = {(b, hkv, d)}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    want_cache = torch.int8 if quantized else q.dtype
    if cache_k.dtype != want_cache or cache_v.dtype != want_cache:
        raise TypeError(f"a {want_cache} cache is needed, got {cache_k.dtype}")
    tensors = [("q", q), ("cache_k", cache_k), ("cache_v", cache_v),
               ("fresh_k", fresh_k), ("fresh_v", fresh_v)]
    if quantized:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float32 or x.shape != (b, s, hkv):
                raise ValueError(f"{name} must be float32 [B, S, Hkv] = {(b, s, hkv)}")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, x in tensors:
        if x.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _device_kv_len(kv_len: KvLen, s: int, device: torch.device) -> torch.Tensor:
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dtype != torch.int32 or kv_len.ndim != 0 or kv_len.device != device:
            raise ValueError(f"kv_len must be a 0-d int32 tensor on {device}")
        return kv_len
    if not 0 <= kv_len < s:
        raise ValueError(f"kv_len {kv_len} outside the cache rows [0, {s})")
    return torch.full((), kv_len, dtype=torch.int32, device=device)


#: the kernels' merge counters: int32 buffers per device, zeroed once
#: (outside any graph capture) and left zero by every launch.  A buffer is
#: never freed, because a CUDA graph captured with it keeps its address: a
#: grid that needs more counters gets a larger buffer beside the old ones.
#: The int8 products #5 and #6 (``ops/wq_matmul.launch_split``) count on
#: the same buffers: launches on one stream never overlap.
_counters: dict = {}
#: counters of a device's first buffer: grids of up to B x Hkv x chunks = 64K
COUNTERS_MIN = 1 << 16


def counter_buffer(device: torch.device, n: int) -> torch.Tensor:
    """The merge counters of ``device`` that a launch uses, at least ``n``
    of them."""
    buffers = _counters.setdefault(device, [])
    if not buffers or buffers[-1].numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a kernel needs {n} merge counters on {device} and cannot allocate them "
                "during a CUDA graph capture: run the same call once before capturing")
        buffers.append(torch.zeros(max(n, COUNTERS_MIN), dtype=torch.int32, device=device))
    return buffers[-1]


def counter_buffers(device: torch.device) -> list[torch.Tensor]:
    """Every merge-counter buffer ``device`` has had, the newest last: all
    zero between launches."""
    return list(_counters.get(device, []))


def _launch(name: str, q, cache_k, cache_v, fresh_k, fresh_v, kv_len, k_scale, v_scale):
    _check_cuda_inputs(q, cache_k, cache_v, fresh_k, fresh_v, k_scale, v_scale)
    b, hq, d = q.shape
    _, s, hkv, _ = cache_k.shape
    plan = split_plan(b, s, hkv, hq // hkv, d, cache_k.dtype)
    kv_len_t = _device_kv_len(kv_len, s, q.device)
    out = torch.empty_like(q)
    partial = (torch.empty(plan.scratch_floats, dtype=torch.float32, device=q.device)
               if plan.scratch_floats else None)
    counters = counter_buffer(q.device, plan.counters)
    quantized = k_scale is not None
    kernels.launch(
        name, q.device,
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        k_scale.data_ptr() if quantized else 0, v_scale.data_ptr() if quantized else 0,
        fresh_k.data_ptr(), fresh_v.data_ptr(), kv_len_t.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else 0, counters.data_ptr(),
        b, s, hq, hkv, d, plan.rows, int(quantized), int(q.dtype == torch.float32), d ** -0.5,
    )
    return out


def decode_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    fresh_k: torch.Tensor,
    fresh_v: torch.Tensor,
    kv_len: KvLen,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step's attention over the stale cache prefix plus the
    fresh row.  Shapes as :func:`decode_attention_plain`; returns [B, Hq, D]."""
    if not q.is_cuda:
        return decode_attention_plain(q, cache_k, cache_v, fresh_k, fresh_v, kv_len,
                                      k_scale, v_scale)
    out = _launch("ta_decode_attention", q, cache_k, cache_v, fresh_k, fresh_v, kv_len,
                  k_scale, v_scale)
    decode_attention.launches += 1
    return out


def decode_attention_update(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    fresh_k: torch.Tensor,
    fresh_v: torch.Tensor,
    kv_len: KvLen,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Append the fresh row at ``kv_len`` to one layer's cache views (in
    place) and attend over the prefix plus that row.  Returns [B, Hq, D]."""
    if not q.is_cuda:
        return decode_attention_update_plain(q, cache_k, cache_v, fresh_k, fresh_v, kv_len,
                                             k_scale, v_scale)
    out = _launch("ta_decode_attention_update", q, cache_k, cache_v, fresh_k, fresh_v,
                  kv_len, k_scale, v_scale)
    decode_attention_update.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
decode_attention.launches = 0
decode_attention_update.launches = 0
