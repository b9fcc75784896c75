"""The split of the decode kernels #3 and #4 over the cache rows, on the CPU.

``split_plan`` is the pure function the wrappers of
``tiny_audio_tpu_torch/ops/decode_attention.py`` cut a launch with: its
splits cover the cache rows exactly, start on 16-byte boundaries and fill the
H100 at the path's shape.  ``decode_attention_split_plain`` repeats the
kernels' arithmetic (a part per split in fp32, merged in split order, the
fresh row last); it is held against ``decode_attention_plain`` and against
the JAX package's Pallas kernels ``decode_attention_tpu`` and
``decode_attention_update_tpu`` in interpret mode, at every (GQA group,
head_dim) the kernels take, over an int8 and an fp32 cache, at kv_len on
either side of the first split's end.  The CUDA kernels themselves are
checked on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_audio_tpu.ops.decode_attention import (
    decode_attention_tpu,
    decode_attention_update_tpu,
)
from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops.decode_attention import (
    KERNEL_GROUPS,
    KERNEL_HEAD_DIMS,
    MAX_SPLITS,
    SPLIT_ROW_STEP,
    decode_attention_plain,
    decode_attention_split_plain,
    split_plan,
)

torch.set_num_threads(1)

# the oracle, the plain version and the Pallas kernels all work in fp32 from
# the same inputs and differ by sums in other orders and exp2 of log2-scaled
# scores for exp: a few fp32 ulps of each term, well inside 2e-5 of the
# outputs here (|out| < ~4)
ATOL, RTOL = 2e-5, 1e-5
B, S, HKV = 1, 64, 2


# ------------------------------------------------------------ (a) the plan

PLAN_SHAPES = [(b, s, hkv, group, d, dtype)
               for b in (1, 4, 48) for s in (96, 608, 4096, 40000) for hkv in (1, 8)
               for group in KERNEL_GROUPS for d in (16, 128, 256)
               for dtype in (torch.int8, torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("b,s,hkv,group,d,dtype", PLAN_SHAPES[::7] + [
    (4, 608, 8, 2, 128, torch.int8), (48, 608, 8, 2, 128, torch.int8),
    (1, 608, 8, 2, 128, torch.bfloat16), (2, 96, 2, 8, 128, torch.bfloat16)])
def test_split_plan_covers_the_cache_on_aligned_rows(b, s, hkv, group, d, dtype):
    plan = split_plan(b, s, hkv, group, d, dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    chunks = 2 if group == 8 else 1
    # the splits cover [0, S) exactly, in order, none empty
    starts = [i * plan.rows for i in range(plan.splits)]
    ends = [min(x + plan.rows, s) for x in starts]
    assert starts[0] == 0 and ends[-1] == s and all(x < y for x, y in zip(starts, ends))
    assert all(e == n for e, n in zip(ends[:-1], starts[1:]))
    assert 1 <= plan.splits <= MAX_SPLITS and plan.rows % SPLIT_ROW_STEP == 0
    # each split starts on a row of each head, 16-byte aligned for cp.async
    for start in starts:
        assert (start * hkv * d * elem) % 16 == 0 and (d * elem) % 16 == 0
    assert plan.grid == (hkv * chunks, plan.splits, b)
    assert plan.counters == b * hkv * chunks
    assert plan.scratch_floats == (b * hkv * group * plan.splits * (d + 2)
                                   if plan.splits > 1 else 0)


def test_split_plan_fills_the_card_at_the_paths_shape():
    """B 4, S 608, Hkv 8 (the flagship's first decode step, kv_len 468):
    at least two blocks with rows per SM of the H100 (264); at the JAX
    bench's batch of 48 the splits' parts stay under a tenth of the cache."""
    plan = split_plan(4, 608, 8, 2, 128, torch.int8)
    with_rows = plan.grid[0] * math.ceil(468 / plan.rows) * plan.grid[2]
    assert with_rows >= 264, (plan, with_rows)
    big = split_plan(48, 608, 8, 2, 128, torch.int8)
    cache_bytes = 2 * 48 * 608 * 8 * (128 + 4)
    assert big.rows >= 128 and big.scratch_floats * 4 < cache_bytes / 10, big
    # the plan never reads kv_len: the same launch serves every step
    assert split_plan(4, 608, 8, 2, 128, torch.bfloat16).grid == plan.grid


def test_split_plan_rejects_unaligned_rows():
    with pytest.raises(ValueError, match="16 bytes"):
        split_plan(1, 64, 2, 2, 8, torch.int8)


# ------------------------------------------------- (b) the split's oracle


def _inputs(group, d, quantized, seed, b=B, s=S, hkv=HKV):
    rng = np.random.default_rng(seed)
    hq = group * hkv
    x = {"q": rng.standard_normal((b, hq, d)).astype(np.float32) * 2,
         "fresh_k": rng.standard_normal((b, hkv, d)).astype(np.float32),
         "fresh_v": rng.standard_normal((b, hkv, d)).astype(np.float32)}
    if quantized:
        x["cache_k"], x["cache_v"] = (rng.integers(-127, 128, (b, s, hkv, d)).astype(np.int8)
                                      for _ in range(2))
        x["k_scale"], x["v_scale"] = (
            (np.abs(rng.standard_normal((b, s, hkv))) * 0.02 + 1e-3).astype(np.float32)
            for _ in range(2))
    else:
        x["cache_k"], x["cache_v"] = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
                                      for _ in range(2))
        x["k_scale"] = x["v_scale"] = None
    return x


def _torch_args(x, kv_len):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return (t(x["q"]), t(x["cache_k"]), t(x["cache_v"]), t(x["fresh_k"]), t(x["fresh_v"]),
            kv_len, t(x["k_scale"]), t(x["v_scale"]))


def _jax_kernels(x, kv_len):
    """decode_attention_tpu's output and decode_attention_update_tpu's (one
    layer plane), both in interpret mode."""
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    d = x["q"].shape[-1]
    out3 = decode_attention_tpu(
        j(x["q"]), j(x["cache_k"]), j(x["cache_v"]), j(x["fresh_k"]), j(x["fresh_v"]),
        jnp.int32(kv_len), k_scale=j(x["k_scale"]), v_scale=j(x["v_scale"]), interpret=True)
    lead = lambda a: None if a is None else jnp.asarray(a)[None]  # noqa: E731
    res = decode_attention_update_tpu(
        j(x["q"]), jnp.asarray(x["cache_k"].reshape(1, B, S, HKV * d)),
        jnp.asarray(x["cache_v"].reshape(1, B, S, HKV * d)), j(x["fresh_k"]),
        j(x["fresh_v"]), jnp.int32(kv_len), jnp.int32(0), k_scale=lead(x["k_scale"]),
        v_scale=lead(x["v_scale"]), interpret=True)
    return np.asarray(out3), np.asarray(res[0])


def _split_kv_lens():
    """(group, head_dim, kv_len) at the first split's edges of the plan the
    kernels take at [B, S, Hkv] = [1, 64, 2] (every group and head_dim give
    rows = 8 here, eight splits), kv_len 0 and the last row."""
    cases = []
    for group in KERNEL_GROUPS:
        for d in KERNEL_HEAD_DIMS:
            rows = split_plan(B, S, HKV, group, d, torch.float32).rows
            assert rows == split_plan(B, S, HKV, group, d, torch.int8).rows
            cases += [(group, d, n) for n in sorted({0, 1, rows - 1, rows, rows + 1, S - 1})
                      if n < S]
    return cases


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "fp32"])
@pytest.mark.parametrize("group,d,kv_len", _split_kv_lens())
def test_split_oracle_matches_plain_and_jax(group, d, kv_len, quantized):
    x = _inputs(group, d, quantized, seed=group * 1000 + d)
    args = _torch_args(x, kv_len)
    got = decode_attention_split_plain(*args).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, decode_attention_plain(*args).numpy(), atol=ATOL, rtol=RTOL)
    jax3, jax4 = _jax_kernels(x, kv_len)
    np.testing.assert_allclose(got, jax3, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, jax4, atol=ATOL, rtol=RTOL)
    if kv_len == 0:  # only the fresh row: its value, exactly
        want = np.repeat(x["fresh_v"], group, axis=1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,s,hkv,rows", [(1, 64, 2, 8), (1, 192, 2, 16), (4, 384, 8, 40),
                                          (16, 256, 8, 88), (48, 96, 8, 96)])
def test_split_oracle_is_the_same_function_at_any_split(b, s, hkv, rows):
    """The split changes the order of the sums only: at each shape, whose plan
    takes its own rows per split (eight splits down to one), the oracle gives
    the plain version's output at the path's head shape."""
    assert split_plan(b, s, hkv, 2, 128, torch.int8).rows == rows
    x = _inputs(2, 128, True, seed=rows, b=b, s=s, hkv=hkv)
    for kv_len in sorted(n for n in {1, rows - 1, rows, rows + 1, s // 2, s - 1} if n < s):
        args = _torch_args(x, kv_len)
        np.testing.assert_allclose(decode_attention_split_plain(*args).numpy(),
                                   decode_attention_plain(*args).numpy(), atol=ATOL, rtol=RTOL)


def test_split_oracle_never_reads_past_kv_len():
    """NaN planted in every row at and past kv_len (an int8 cache's scales
    and an fp32 cache's rows) cannot reach the output."""
    for quantized in (True, False):
        x = _inputs(2, 64, quantized, seed=5)
        kv_len = 37
        for name in (("k_scale", "v_scale") if quantized else ("cache_k", "cache_v")):
            x[name] = x[name].copy()
            x[name][:, kv_len:] = np.nan
        args = _torch_args(x, kv_len)
        got = decode_attention_split_plain(*args).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, decode_attention_plain(*args).numpy(),
                                   atol=ATOL, rtol=RTOL)


def test_counter_buffers_are_never_freed(monkeypatch):
    """A grid that needs more merge counters gets a new buffer beside the
    old ones: a CUDA graph captured with an older buffer keeps its address,
    so that buffer must stay allocated (and zero)."""
    monkeypatch.setattr(kernels, "_counters", {})
    monkeypatch.setattr(kernels, "COUNTERS_MIN", 4)
    cpu = torch.device("cpu")
    small = kernels.counter_buffer(cpu, 3)
    assert small.numel() == 4 and kernels.counter_buffer(cpu, 4) is small
    large = kernels.counter_buffer(cpu, 384)
    assert large.numel() == 384 and kernels.counter_buffer(cpu, 100) is large
    kept = kernels.counter_buffers(cpu)
    assert len(kept) == 2 and kept[0] is small and kept[1] is large
    assert not any(buf.any() for buf in kept)
