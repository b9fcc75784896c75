"""PyTorch shared layers vs the JAX ones, fp32 on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tiny_audio_tpu.models import layers as J
from tiny_audio_tpu_torch.models import layers as T

torch.set_num_threads(1)
ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_mask_value_identical():
    assert T.MASK_VALUE == J.MASK_VALUE


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(J.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset))
    got = T.rms_norm(_t(x), _t(w), 1e-6, offset)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    module = T.RMSNorm(32, offset=offset)
    assert float(module.weight.detach().sum()) == (0.0 if offset else 32.0)


@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (128, 1e6), (64, 1e4)])
def test_rotary(head_dim, theta):
    rng = np.random.default_rng(1)
    pos = np.stack([np.arange(40), np.arange(40) + 300]).astype(np.int32)
    cos_j, sin_j = J.rotary_embed(jnp.asarray(pos), head_dim, theta)
    cos_t, sin_t = T.rotary_embed(_t(pos), head_dim, theta)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=ATOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=ATOL)
    x = rng.standard_normal((2, 40, 3, head_dim)).astype(np.float32)
    want = np.asarray(J.apply_rotary(jnp.asarray(x), cos_j, sin_j))
    got = T.apply_rotary(_t(x), cos_t, sin_t)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_sinusoidal_positions():
    want = np.asarray(J.sinusoidal_positions(1500, 1280))
    got = T.sinusoidal_positions(1500, 1280).numpy()
    # XLA's float32 exp is not correctly rounded, so a few inverse timescales
    # differ from PyTorch's by one ulp; the angle's error then grows with the
    # position (1500 * 2**-24 * 1 rad ~ 1e-4).  Rows near 0 are exact to ATOL.
    np.testing.assert_allclose(got[:16], want[:16], atol=ATOL)
    np.testing.assert_allclose(got, want, atol=2e-4)


def _mask(kind, b, hq, tq, tk, rng):
    if kind is None:
        return None
    shapes = {"2d": (b, tk), "3d": (b, tq, tk), "4d_head1": (b, 1, tq, tk),
              "4d_heads": (b, hq, tq, tk)}
    m = rng.random(shapes[kind]) > 0.3
    m[..., 0] = True
    return m


@pytest.mark.parametrize("mask_kind", [None, "2d", "3d", "4d_head1", "4d_heads"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_attention_oracle(mask_kind, hq, hkv):
    rng = np.random.default_rng(2)
    b, tq, tk, d = 2, 7, 9, 16
    q = rng.standard_normal((b, tq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    m = _mask(mask_kind, b, hq, tq, tk, rng)
    want = np.asarray(J.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if m is None else jnp.asarray(m),
    ))
    got = T.attention(_t(q), _t(k), _t(v), None if m is None else _t(m))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_attention_fully_masked_row_is_uniform():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 5, 2, 8)).astype(np.float32))
    out = T.attention(q, v, v, torch.zeros((1, 5), dtype=torch.bool))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 0], v[0].mean(0), atol=ATOL, rtol=0)
