"""The port's fused encoder FFN (ops/encoder_ffn.py) vs the JAX package's
kernel in Pallas interpret mode, on the CPU.

The JAX function takes flax kernels (w1 [D, F], w2 [F, D]); the port takes
nn.Linear weights (w1 [F, D], w2 [D, F]), converted with the bridge's rule
for every Dense kernel (a transpose).
"""

import ml_dtypes
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tiny_audio_tpu.ops.encoder_ffn import BM, encoder_ffn_tpu
from tiny_audio_tpu.ops.encoder_ffn import naive_ffn as jax_naive_ffn
from tiny_audio_tpu_torch.ops import encoder_ffn as tffn

torch.set_num_threads(1)
SHAPES = [(BM, 256, 512), (2 * BM, 128, 1024)]  # (M, D, F), as tests/test_encoder_ffn.py


def _mats(m, d, f, seed=0, dtype=np.float32):
    """(x, w1, b1, w2, b2) in the JAX layout, numpy, from a seed."""
    rng = np.random.default_rng(seed)
    return tuple(a.astype(dtype) for a in (
        rng.standard_normal((m, d)),
        rng.standard_normal((d, f)) / np.sqrt(d),
        rng.standard_normal(f) * 0.1,
        rng.standard_normal((f, d)) / np.sqrt(f),
        rng.standard_normal(d) * 0.1,
    ))


def _to_port(x, w1, b1, w2, b2):
    """numpy (JAX layout) -> torch tensors in nn.Linear's layout."""
    def tensor(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(a))
    return tensor(x), tensor(w1).T.contiguous(), tensor(b1), tensor(w2).T.contiguous(), tensor(b2)


@pytest.mark.parametrize("m,d,f", SHAPES)
def test_forward_matches_jax_kernel_fp32(m, d, f):
    mats = _mats(m, d, f)
    want = np.asarray(encoder_ffn_tpu(*map(jnp.asarray, mats), True))
    got = tffn.encoder_ffn(*_to_port(*mats))
    assert got.dtype == torch.float32 and got.shape == (m, d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("m,d,f", SHAPES)
def test_forward_matches_jax_kernel_bf16(m, d, f):
    """bf16 operands: the port's plain version computes the kernel's formula
    (fp32 h through the GELU, g rounded once).  Both round g and the output
    to bf16 after fp32 sums taken in other orders, so an element may differ
    by a flipped rounding: at least 99% must be bitwise equal and every one
    within 1e-2 + 2^-6 |want| (chip_smoke.py's bf16 kernel tolerance).
    naive_ffn, which rounds h to bf16 before the GELU, agrees bitwise on
    about a third of the elements only."""
    mats = _mats(m, d, f, seed=1, dtype=ml_dtypes.bfloat16)
    want = np.asarray(encoder_ffn_tpu(*map(jnp.asarray, mats), True)).astype(np.float32)
    port = _to_port(*mats)
    got = tffn.encoder_ffn(*port)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=2.0**-6)
    assert np.mean(got == want) >= 0.99
    naive = tffn.naive_ffn(*port, torch.bfloat16).float().numpy()
    assert np.mean(naive == want) < 0.5
    jnaive = np.asarray(jax_naive_ffn(*map(jnp.asarray, mats), jnp.bfloat16)).astype(np.float32)
    assert np.mean(naive == jnaive) >= 0.99  # the port's naive_ffn is the JAX oracle's


def _launch_plain(x, w1, b1, w2, b2):
    return tffn.encoder_ffn_plain(x, w1, b1, w2, b2)


@pytest.mark.parametrize("route", ["plain_autograd", "encoder_ffn_function"])
def test_gradients_match_jax(route, monkeypatch):
    """The five gradients of sum(out^2) against jax.grad of encoder_ffn_tpu
    (its custom VJP recomputes naive_ffn), atol 5e-2, rtol 5e-3 as
    tests/test_encoder_ffn.py.  ``encoder_ffn_function`` runs EncoderFFN with
    its forward's launch replaced by the plain version, so its backward (the
    naive recompute) is the one differentiated."""
    mats = _mats(BM, 128, 512, seed=1)

    def loss(*a):
        return jnp.sum(encoder_ffn_tpu(*a, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, mats))
    leaves = [t.requires_grad_(True) for t in _to_port(*mats)]
    if route == "plain_autograd":
        out = tffn.encoder_ffn(*leaves)
    else:
        monkeypatch.setattr(tffn, "_launch", _launch_plain)
        out = tffn.EncoderFFN.apply(*leaves)
    (out**2).sum().backward()
    x, w1, b1, w2, b2 = (leaf.grad.numpy() for leaf in leaves)
    for got, w in zip((x, w1.T, b1, w2.T, b2), want):
        np.testing.assert_allclose(got, np.asarray(w), atol=5e-2, rtol=5e-3)


def test_fused_ffn_ragged_rows():
    """[B, T, D] with B*T = 231, no row-tile multiple: the port masks the
    ragged rows; the JAX kernel runs on the rows padded to its 512-row tile."""
    b, t, d, f = 3, 77, 256, 512
    x, w1, b1, w2, b2 = _mats(b * t, d, f, seed=2)
    x_pad = np.pad(x, ((0, BM - b * t), (0, 0)))
    want = np.asarray(encoder_ffn_tpu(*map(jnp.asarray, (x_pad, w1, b1, w2, b2)), True))[: b * t]
    port = _to_port(x, w1, b1, w2, b2)
    got = tffn.fused_ffn(port[0].reshape(b, t, d), *port[1:], torch.float32)
    assert got.shape == (b, t, d)
    np.testing.assert_allclose(got.reshape(b * t, d).numpy(), want, atol=2e-3, rtol=1e-3)


def test_applicability_gate():
    assert tffn.fused_ffn_applicable(1280, 5120)      # flagship encoder
    assert tffn.fused_ffn_applicable(384, 1536)       # whisper-tiny
    assert not tffn.fused_ffn_applicable(1280, 5000)  # ffn not a multiple of 64
    assert not tffn.fused_ffn_applicable(100, 5120)   # d_model not a multiple of 128
    assert tffn.fused_ffn_applicable(1536, 6144)      # past 1,280: no register-bound cap


def test_plain_is_the_encoder_mlp_in_fp32():
    """In fp32 the kernel's formula is the encoder block's MLP (fc1, tanh
    GELU, fc2), which models/encoder.py runs unfused."""
    import torch.nn.functional as F

    x, w1, b1, w2, b2 = _to_port(*_mats(64, 128, 256, seed=3))
    want = F.linear(F.gelu(F.linear(x, w1, b1), approximate="tanh"), w2, b2)
    torch.testing.assert_close(tffn.encoder_ffn(x, w1, b1, w2, b2), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [128, 256, 384, 512, 1024, 1280, 1536, 2048, 100, 200, 640, 0])
@pytest.mark.parametrize("f", [64, 512, 1024, 1536, 5120, 6144, 5000, 96, 0])
def test_applicability_gate_against_jax(d, f):
    """The port's gate is d_model % 128 == 0 and ffn_dim % 64 == 0 (the
    products' 64-deep steps), with no cap on d_model; every shape the JAX
    gate takes (ffn_dim a multiple of its 512-wide blocks) the port takes."""
    from tiny_audio_tpu.ops.encoder_ffn import fused_ffn_applicable as jax_applicable

    want = d > 0 and f > 0 and d % 128 == 0 and f % 64 == 0
    assert tffn.fused_ffn_applicable(d, f) == want
    if d > 0 and f > 0 and jax_applicable(d, f):
        assert tffn.fused_ffn_applicable(d, f)


@pytest.mark.parametrize("m", [1, 127, 128, 129, 6000, 49152])
@pytest.mark.parametrize("d,f", [(1280, 5120), (384, 1536), (128, 64), (1536, 6144)])
def test_tile_plan_counts_and_order(m, d, f):
    """ffn_tile_plan, the kernel's queue: every (phase, row block, column
    block) once; row blocks of 128 and column blocks of 256 cover [M, F]
    (phase 1) and [M, D] (phase 2); every phase-2 tile comes after all of
    its row block's phase-1 tiles (the only tiles it waits for), at most
    ``lag`` row blocks later."""
    plan = tffn.ffn_tile_plan(m, d, f)
    rows = -(-m // tffn.BM)
    n1, n2 = -(-f // tffn.BN), -(-d // tffn.BN)
    assert (plan.rows, plan.n1, plan.n2) == (rows, n1, n2)
    assert plan.lag == min(tffn.FFN_LAG, rows) and plan.total == rows * (n1 + n2)
    tiles = plan.tiles()
    assert len(tiles) == plan.total == len(set(tiles))
    assert set(tiles) == ({(1, r, c) for r in range(rows) for c in range(n1)}
                          | {(2, r, c) for r in range(rows) for c in range(n2)})
    position = {tile: i for i, tile in enumerate(tiles)}
    for (phase, r, c), i in position.items():
        if phase == 2:
            deps = [position[(1, r, c1)] for c1 in range(n1)]
            assert max(deps) < i
            # no later row block's phase-1 tiles than r + lag come before it
            assert all(position[(1, r2, c1)] > i for r2 in range(r + plan.lag + 1, rows)
                       for c1 in range(n1))
    # the queue runs row block by row block: phase-1 tiles in row order
    firsts = [r for phase, r, _ in tiles if phase == 1]
    assert firsts == sorted(firsts)


@pytest.mark.parametrize("m,d,f,want", [
    # one row block: lag 1, its phase-1 tiles then its phase-2 tiles
    (100, 256, 512, [(1, 0, 0), (1, 0, 1), (2, 0, 0)]),
    # fewer row blocks than FFN_LAG: every phase-1 tile, then every phase-2 tile
    (300, 256, 512, [(1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1), (1, 2, 0), (1, 2, 1),
                     (2, 0, 0), (2, 1, 0), (2, 2, 0)]),
    # ten row blocks: phase 2 of row block i follows phase 1 of row block i + 8
    (1280, 256, 256, [(1, r, 0) for r in range(8)]
     + [(1, 8, 0), (2, 0, 0), (1, 9, 0), (2, 1, 0)] + [(2, r, 0) for r in range(2, 10)]),
])
def test_tile_plan_lag_is_ffn_lag_or_every_row_block(m, d, f, want):
    """The queue lags phase 2 by min(FFN_LAG, rows) row blocks, the kernel's
    ``LAG`` (8): with one row block the queue is that block's phase-1 tiles
    then its phase-2 tiles."""
    plan = tffn.ffn_tile_plan(m, d, f)
    assert tffn.FFN_LAG == 8 and plan.lag == min(8, plan.rows)
    assert plan.tiles() == want
