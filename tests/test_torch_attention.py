"""Attention ops of the PyTorch port vs the JAX package, on the CPU.

The plain versions are checked here against the JAX functions; the CUDA
kernels are checked against the plain versions in test_torch_kernels.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tiny_audio_tpu.ops import attention as jattn
from tiny_audio_tpu.ops.encoder_attention import _naive_packed, encoder_attention_tpu
from tiny_audio_tpu_torch.ops import attention as tattn
from tiny_audio_tpu_torch.ops.encoder_attention import (
    encoder_attention,
    encoder_attention_plain,
)

torch.set_num_threads(1)


def _randn(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _ragged_mask(b, t, lengths):
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    return mask


@pytest.mark.parametrize("b,t,h,d,lengths", [
    (2, 300, 4, 64, (300, 170)),   # ragged per-row lengths, T no tile multiple
    (3, 64, 2, 16, (64, 0, 10)),   # a fully masked row
])
def test_encoder_attention_plain_matches_naive(b, t, h, d, lengths):
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, (b, t, h * d)) for _ in range(3))
    mask = _ragged_mask(b, t, lengths)
    want = np.asarray(_naive_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), h
    ))
    got = encoder_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), h,
    )
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_encoder_attention_plain_matches_tpu_kernel_interpret():
    b, t, h, d = 2, 300, 4, 64
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, (b, t, h * d)) for _ in range(3))
    mask = _ragged_mask(b, t, (300, 123))
    want = np.asarray(encoder_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        num_heads=h, interpret=True,
    ))
    got = encoder_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), h,
    ).numpy()
    valid = mask.astype(bool)
    # the TPU kernel's own tolerance against the naive formula
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-3)


@pytest.mark.parametrize("hq,hkv,lengths", [(4, 2, (40, 25)), (4, 4, (40, 40)), (8, 2, (17, 33))])
def test_prefill_plain_matches_jax_causal(hq, hkv, lengths):
    b, t, d = 2, 40, 16
    rng = np.random.default_rng(2)
    q = _randn(rng, (b, t, hq, d))
    k, v = (_randn(rng, (b, t, hkv, d)) for _ in range(2))
    mask = _ragged_mask(b, t, lengths)
    want = np.asarray(jattn.causal_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)
    ))
    got = tattn.causal_self_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask),
    ).numpy()
    valid = mask.astype(bool)  # padding query rows are don't-care
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_decode_step_attention_matches_jax(cache):
    b, s, hq, hkv, d = 2, 24, 4, 2, 16
    rng = np.random.default_rng(3)
    q = _randn(rng, (b, 1, hq, d))
    fresh_k, fresh_v = (_randn(rng, (b, 1, hkv, d)) for _ in range(2))
    if cache == "int8":
        ck, cv = (rng.integers(-127, 128, (b, s, hkv, d)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.random((b, s, hkv)).astype(np.float32) * 0.05 for _ in range(2))
    else:
        ck, cv = (_randn(rng, (b, s, hkv, d)) for _ in range(2))
        ks = vs = None
    kv_valid = (np.arange(s) < 11)[None].astype(np.int32)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    want = np.asarray(jattn.decode_step_attention(
        j(q), j(ck), j(cv), j(kv_valid), fresh_k=j(fresh_k), fresh_v=j(fresh_v),
        k_scale=j(ks), v_scale=j(vs),
    ))
    got = tattn.decode_step_attention(
        t(q), t(ck), t(cv), t(kv_valid), fresh_k=t(fresh_k), fresh_v=t(fresh_v),
        k_scale=t(ks), v_scale=t(vs),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if cache == "float32":  # the stale-cache-only form
        want = np.asarray(jattn.decode_step_attention(j(q), j(ck), j(cv), j(kv_valid)))
        got = tattn.decode_step_attention(t(q), t(ck), t(cv), t(kv_valid))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
