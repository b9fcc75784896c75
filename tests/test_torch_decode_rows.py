"""Decode kernels #3/#4 with per-row lengths, and the decoder's per-row step.

The continuous engine keeps each slot at its own length, so a decode step
takes ``kv_len`` / ``cache_index`` as a ``[B]`` int32 tensor:

- the plain versions of #3 and #4 (and the split oracle) with a ``[B]``
  length of mixed values equal ``B`` calls with each row's scalar length
  (bitwise: the same function on the same row);
- ``Qwen3Decoder.forward`` with a ``[B]`` ``cache_index`` equals the JAX
  package's ``Qwen3Decoder`` with an array ``cache_index`` (logits within
  ``LOGIT_ATOL``, fp32; every cache row the step does not write bit for bit,
  its written rows within ``WRITE_ATOL``, one int8 count), on both cache
  kinds, and the per-row write itself bit for bit JAX's scatter of
  ``quantize_kv``'s bytes and scales on equal K/V;
- ``cuda`` tests (skipped without a card) hold the kernels with a ``[B]``
  length to the per-row plain version within the decode kernels' tolerance
  (``KERNEL_ATOL``/``KERNEL_RTOL``), to the scalar launch bitwise at equal
  lengths, and the rows other than each row's append unchanged.

The JAX parity tests import jax inside their fixture, so on a GPU machine
without it the file runs with ``--noconftest`` and they skip.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.config import tiny_test_config
from tiny_audio_tpu_torch.models.decoder import Qwen3Decoder
from tiny_audio_tpu_torch.ops import attention as tattn
from tiny_audio_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    decode_attention_split_plain,
    decode_attention_update,
    decode_attention_update_plain,
    write_cache_rows,
)
from tiny_audio_tpu_torch.ops.fused_decode import fused_decode_step

torch.set_num_threads(1)

#: the decode kernels' tolerance against their plain version (as in
#: tests/test_torch_kernels.py)
KERNEL_ATOL, KERNEL_RTOL = 1e-2, 2.0**-6
#: fp32 logits of the tiny decoder, JAX's XLA against the port's PyTorch
LOGIT_ATOL = 1e-4
#: a written fp32 cache entry (K/V of the same step), relative to 1 + |want|
WRITE_ATOL = 1e-5

B, S, HKV, GROUP, D = 5, 40, 2, 2, 16
LENGTHS = (0, 1, S - 1, 17, 8)


def _inputs(quantized: bool, seed: int = 0, device="cpu", b=B, s=S, hkv=HKV, d=D,
            dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa: E731
    q = (randn(b, GROUP * hkv, d) * 2).to(dtype)
    fresh_k, fresh_v = (randn(b, hkv, d).to(dtype) for _ in range(2))
    if quantized:
        ck, cv = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=device)
                  .to(torch.int8) for _ in range(2))
        ks, vs = ((randn(b, s, hkv).abs() * 0.02 + 1e-3) for _ in range(2))
    else:
        ck, cv = (randn(b, s, hkv, d).to(dtype) for _ in range(2))
        ks = vs = None
    return q, ck, cv, fresh_k, fresh_v, ks, vs


def _clone(xs):
    return [None if x is None else x.clone() for x in xs]


def _row(x, i):
    return None if x is None else x[i:i + 1]


# ------------------------------------------------------------ plain versions


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("plain", [decode_attention_plain, decode_attention_split_plain])
def test_plain_rows_equal_scalar_calls(quantized, plain):
    q, ck, cv, fk, fv, ks, vs = _inputs(quantized)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    got = plain(q, ck, cv, fk, fv, lens, ks, vs)
    for i, n in enumerate(LENGTHS):
        want = plain(q[i:i + 1], ck[i:i + 1], cv[i:i + 1], fk[i:i + 1], fv[i:i + 1], n,
                     _row(ks, i), _row(vs, i))
        assert torch.equal(got[i:i + 1], want), (i, n)


@pytest.mark.parametrize("quantized", [True, False])
def test_plain_update_rows_equal_scalar_calls(quantized):
    q, ck, cv, fk, fv, ks, vs = _inputs(quantized, seed=1)
    mine, ref = _clone((ck, cv, ks, vs)), _clone((ck, cv, ks, vs))
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    got = decode_attention_update_plain(q, mine[0], mine[1], fk, fv, lens, mine[2], mine[3])
    for i, n in enumerate(LENGTHS):
        views = [_row(x, i) for x in ref]
        want = decode_attention_update_plain(q[i:i + 1], views[0], views[1], fk[i:i + 1],
                                             fv[i:i + 1], n, views[2], views[3])
        assert torch.equal(got[i:i + 1], want), (i, n)
    for a, b in zip(mine, ref):
        if a is not None:
            assert torch.equal(a, b)
    # each row's append landed at its own length, nothing else moved
    for buf, before in zip(mine, (ck, cv, ks, vs)):
        if buf is None:
            continue
        changed = (buf != before).reshape(B, S, -1).any(dim=-1)
        for i, n in enumerate(LENGTHS):
            assert not changed[i, :n].any() and not changed[i, n + 1:].any(), (i, n)


@pytest.mark.parametrize("quantized", [True, False])
def test_plain_length_past_the_cache_writes_nothing(quantized):
    """A row at S (the kernel clamps to S and appends nothing) attends over
    all S rows and leaves the cache as it was; a negative length reads none."""
    q, ck, cv, fk, fv, ks, vs = _inputs(quantized, seed=2)
    mine = _clone((ck, cv, ks, vs))
    lens = torch.tensor([S, -3, 4, S, 0], dtype=torch.int32)
    got = decode_attention_update_plain(q, mine[0], mine[1], fk, fv, lens, mine[2], mine[3])
    for buf, before in zip(mine, (ck, cv, ks, vs)):
        if buf is not None:
            assert torch.equal(buf[[0, 1, 3]], before[[0, 1, 3]])
    full = decode_attention_plain(q[:1], ck[:1], cv[:1], fk[:1], fv[:1], S, _row(ks, 0),
                                  _row(vs, 0))
    assert torch.equal(got[:1], full)
    empty = decode_attention_plain(q[1:2], ck[1:2], cv[1:2], fk[1:2], fv[1:2], 0, _row(ks, 1),
                                   _row(vs, 1))
    assert torch.equal(got[1:2], empty)


def test_step_attention_routes_per_row_lengths_on_the_cpu_to_the_masked_path():
    """On CPU tensors a [B] length takes plain masked PyTorch (the JAX
    package's masked path), which agrees with the kernel's plain version."""
    q, ck, cv, fk, fv, _, _ = _inputs(False, seed=3)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    kv_valid = (torch.arange(S)[None, :] < lens[:, None]).to(torch.int32)
    before = decode_attention.launches
    got = tattn.decode_step_attention(q[:, None], ck, cv, kv_valid, fresh_k=fk[:, None],
                                      fresh_v=fv[:, None], kv_len=lens)
    assert decode_attention.launches == before
    want = decode_attention_plain(q, ck, cv, fk, fv, lens)
    torch.testing.assert_close(got[:, 0], want, atol=1e-5, rtol=1e-5)


def test_write_cache_rows_per_row_drops_out_of_range_rows():
    cache = {"k": torch.zeros(3, 6, 1, 4), "v": torch.zeros(3, 6, 1, 4)}
    k = torch.arange(1, 4, dtype=torch.float32).view(3, 1, 1, 1).expand(3, 1, 1, 4)
    write_cache_rows(cache, k, -k, torch.tensor([2, 6, -1], dtype=torch.int32))
    assert cache["k"][0, 2].eq(1).all() and cache["v"][0, 2].eq(-1).all()
    assert cache["k"].count_nonzero() == 4 and cache["v"].count_nonzero() == 4


# ------------------------------------------------ the decoder's per-row step


@pytest.fixture(scope="module")
def jax_decoders():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from tiny_audio_tpu.config import tiny_test_config as jax_tiny_config
    from tiny_audio_tpu.models.decoder import Qwen3Decoder as JaxQwen3Decoder
    from tiny_audio_tpu_torch.bridge import jax_to_state_dict

    out = {}
    for kvd in ("bfloat16", "int8"):
        cfg = dataclasses.replace(jax_tiny_config().decoder, kv_cache_dtype=kvd)
        dec = JaxQwen3Decoder(cfg, dtype=jnp.float32, param_dtype=jnp.float32)
        variables = dec.init(jax.random.PRNGKey(3), jnp.zeros((1, 4, cfg.hidden_size)),
                             jnp.zeros((1, 4), jnp.int32))
        port_cfg = dataclasses.replace(tiny_test_config().decoder, kv_cache_dtype=kvd)
        port = Qwen3Decoder(port_cfg, dtype=torch.float32, device="cpu")
        params = jax.tree.map(lambda x: np.asarray(x, np.float32), variables["params"])
        state = {name.removeprefix("decoder."): torch.from_numpy(np.array(arr))
                 for name, arr in jax_to_state_dict({"decoder": params}).items()}
        with torch.no_grad():
            for name, p in port.named_parameters():
                p.copy_(state.pop(name))
        assert not state, sorted(state)
        out[kvd] = (jax, jnp, dec, variables, port)
    return out


def _as_torch(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kvd", ["bfloat16", "int8"])
@pytest.mark.parametrize("fused", [False, True])
def test_decoder_per_row_step_matches_jax(jax_decoders, kvd, fused):
    """A prefilled cache, then two per-row steps at lengths (7, 0, 23, 12)
    + step: the port's logits within LOGIT_ATOL of JAX's, every cache row
    (int8 bytes and scales too) bitwise.  ``fused`` runs the port's fused
    step (its plain version on the CPU) instead of ``forward``."""
    jax, jnp, dec, variables, port = jax_decoders[kvd]
    cfg = dec.cfg
    rng = np.random.default_rng(11)
    b, s, t = 4, 32, 24
    embeds = rng.standard_normal((b, t, cfg.hidden_size)).astype(np.float32)
    positions = np.broadcast_to(np.arange(t), (b, t))
    cache_j = dec.init_cache(b, s, dtype=jnp.float32)
    _, cache_j = dec.apply(variables, jnp.asarray(embeds), jnp.asarray(positions),
                           cache=cache_j, cache_index=0)
    cache_t = {name: _as_torch(x).contiguous() for name, x in cache_j.items()}
    pos = np.array([7, 0, 23, 12], np.int32)
    for step in range(2):
        ids = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        emb_j = dec.apply(variables, jnp.asarray(ids), method=type(dec).embed)
        kv_valid = (np.arange(s)[None, :] < pos[:, None]).astype(np.int32)
        logits_j, cache_j = dec.apply(variables, emb_j, jnp.asarray(pos[:, None]),
                                      step_kv_valid=jnp.asarray(kv_valid), cache=cache_j,
                                      cache_index=jnp.asarray(pos))
        pos_t = torch.from_numpy(pos.copy())
        with torch.inference_mode():
            if fused:
                logits_t = fused_decode_step(port, torch.from_numpy(ids[:, 0]), pos_t, cache_t)
            else:
                logits_t = port(port.embed(torch.from_numpy(ids)), pos_t[:, None],
                                step_kv_valid=torch.from_numpy(kv_valid), cache=cache_t,
                                cache_index=pos_t)[:, 0]
        np.testing.assert_allclose(logits_t.float().numpy(), np.asarray(logits_j)[:, 0],
                                   atol=LOGIT_ATOL, rtol=0)
        for name, x in cache_j.items():
            got, want = cache_t[name].numpy(), np.asarray(x)
            written = np.zeros(got.shape[:3], bool)
            written[:, np.arange(b), pos] = True
            # every row but this step's writes: bitwise (the same prefill)
            assert np.array_equal(got[~written], want[~written]), (step, name)
            # this step's rows: the two frameworks' fp32 projections differ
            # by ulps (WRITE_ATOL); an int8 byte then by at most one count
            diff = np.abs(got[written].astype(np.float64) - want[written])
            limit = 1 if got.dtype == np.int8 else WRITE_ATOL * (
                1 + np.abs(want[written]).astype(np.float64))
            assert (diff <= limit).all(), (step, name, diff.max())
        # teacher-forced: the next step starts from JAX's cache
        cache_t = {name: _as_torch(x).contiguous() for name, x in cache_j.items()}
        pos = pos + 1


@pytest.mark.parametrize("kvd", ["bfloat16", "int8"])
def test_per_row_write_is_jaxs_scatter_bitwise(jax_decoders, kvd):
    """The per-row write itself on equal K/V: the JAX decoder's array
    ``cache_index`` scatter of ``quantize_kv``'s bytes and scales
    (``tiny_audio_tpu/models/decoder.py``), bit for bit, rows at S dropped."""
    jax, jnp, dec, _, port = jax_decoders[kvd]
    from tiny_audio_tpu.models.decoder import quantize_kv as jax_quantize_kv

    rng = np.random.default_rng(12)
    b, s = 4, 16
    cache_j = dec.init_cache(b, s, dtype=jnp.float32)
    cache_j = {name: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)).astype(x.dtype)
               for name, x in cache_j.items()}
    cache_t = {name: _as_torch(x)[0].clone() for name, x in cache_j.items()}  # layer 0
    k = rng.standard_normal((b, 1) + cache_j["k"].shape[3:]).astype(np.float32) * 3
    v = rng.standard_normal(k.shape).astype(np.float32)
    idx = np.array([3, s, 0, s - 1], np.int32)
    rows = jnp.arange(b)
    for name, x in (("k", k), ("v", v)):
        vals = {name: jnp.asarray(x)}
        if kvd == "int8":
            q, sc = jax_quantize_kv(jnp.asarray(x))
            vals = {name: q, f"{name}_scale": sc}
        for key, val in vals.items():
            cache_j[key] = cache_j[key].at[0, rows, jnp.asarray(idx)].set(val[:, 0])
    write_cache_rows(cache_t, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(idx))
    for name, x in cache_j.items():
        assert np.array_equal(cache_t[name].numpy(), np.asarray(x)[0]), name


# ----------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels are built with nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counters_zero(device):
    torch.cuda.synchronize()
    return not any(buf.any() for buf in kernels.counter_buffers(device))


def _card_inputs(device, b, quantized, seed):
    return _inputs(quantized, seed, device, b=b, s=608, hkv=8, d=128, dtype=torch.bfloat16)


def _spread(b, s, seed):
    """Lengths spread over [0, s): 0, 1 and s - 1 among them."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, s, b)
    lens[:3] = (0, 1, s - 1)[:b]
    return torch.tensor(lens, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("b", [1, 4, 16, 48])
def test_per_row_kernels_match_plain(cuda_device, quantized, b):
    q, ck, cv, fk, fv, ks, vs = _card_inputs(cuda_device, b, quantized, 40 + b)
    lens = _spread(b, 608, b).to(cuda_device)
    got3 = decode_attention(q, ck, cv, fk, fv, lens, ks, vs)
    want3 = decode_attention_plain(q, ck, cv, fk, fv, lens, ks, vs)
    torch.testing.assert_close(got3.float(), want3.float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    mine, ref = _clone((ck, cv, ks, vs)), _clone((ck, cv, ks, vs))
    got4 = decode_attention_update(q, mine[0], mine[1], fk, fv, lens, mine[2], mine[3])
    want4 = decode_attention_update_plain(q, ref[0], ref[1], fk, fv, lens, ref[2], ref[3])
    torch.testing.assert_close(got4.float(), want4.float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    for a, r in zip(mine, ref):  # each row's append, the rest untouched
        if a is not None:
            assert torch.equal(a.view(torch.uint8), r.view(torch.uint8))
    assert _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("b", [4, 16, 48])
def test_equal_lengths_equal_the_scalar_launch_bitwise(cuda_device, quantized, b):
    q, ck, cv, fk, fv, ks, vs = _card_inputs(cuda_device, b, quantized, 60 + b)
    for n in (0, 1, 55, 468, 607):
        lens = torch.full((b,), n, dtype=torch.int32, device=cuda_device)
        assert torch.equal(decode_attention(q, ck, cv, fk, fv, lens, ks, vs),
                           decode_attention(q, ck, cv, fk, fv, n, ks, vs)), n
        a, c = _clone((ck, cv, ks, vs)), _clone((ck, cv, ks, vs))
        assert torch.equal(decode_attention_update(q, a[0], a[1], fk, fv, lens, a[2], a[3]),
                           decode_attention_update(q, c[0], c[1], fk, fv, n, c[2], c[3])), n
        for x, y in zip(a, c):
            if x is not None:
                assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
def test_per_row_lengths_out_of_range_are_safe(cuda_device, quantized):
    """Lengths the host never checks: S and past it read every row and
    append nothing, negative ones read none; nothing outside the cache is
    written."""
    b = 4
    q, ck, cv, fk, fv, ks, vs = _card_inputs(cuda_device, b, quantized, 70)
    lens = torch.tensor([608, 5000, -7, 3], dtype=torch.int32, device=cuda_device)
    mine, ref = _clone((ck, cv, ks, vs)), _clone((ck, cv, ks, vs))
    got = decode_attention_update(q, mine[0], mine[1], fk, fv, lens, mine[2], mine[3])
    want = decode_attention_update_plain(q, ref[0], ref[1], fk, fv, lens, ref[2], ref[3])
    torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    for a, r in zip(mine, ref):
        if a is not None:
            assert torch.equal(a.view(torch.uint8), r.view(torch.uint8))
    assert _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
def test_per_row_graph_replay(cuda_device, quantized):
    """#4 then #3 captured with a [B] length the graph advances: each replay
    equals the eager calls bitwise."""
    b = 16
    q, ck, cv, fk, fv, ks, vs = _card_inputs(cuda_device, b, quantized, 80)
    start = _spread(b, 600, 5).to(cuda_device)
    graph_bufs, eager_bufs, warm = (_clone((ck, cv, ks, vs)) for _ in range(3))
    lens = start.clone()
    decode_attention_update(q, warm[0], warm[1], fk, fv, lens, warm[2], warm[3])
    decode_attention(q, warm[0], warm[1], fk, fv, lens, warm[2], warm[3])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out4 = decode_attention_update(q, graph_bufs[0], graph_bufs[1], fk, fv, lens,
                                       graph_bufs[2], graph_bufs[3])
        out3 = decode_attention(q, graph_bufs[0], graph_bufs[1], fk, fv, lens,
                                graph_bufs[2], graph_bufs[3])
        lens.add_(1)
    for step in range(3):
        graph.replay()
        eager = start + step
        want4 = decode_attention_update(q, eager_bufs[0], eager_bufs[1], fk, fv, eager,
                                        eager_bufs[2], eager_bufs[3])
        want3 = decode_attention(q, eager_bufs[0], eager_bufs[1], fk, fv, eager,
                                 eager_bufs[2], eager_bufs[3])
        torch.cuda.synchronize()
        assert torch.equal(out4, want4) and torch.equal(out3, want3), step
    for a, e in zip(graph_bufs, eager_bufs):
        if a is not None:
            assert torch.equal(a.view(torch.uint8), e.view(torch.uint8))
    assert _counters_zero(cuda_device)


def test_per_row_length_must_match_the_batch():
    from tiny_audio_tpu_torch.ops.decode_attention import _device_kv_len

    dev = torch.device("cpu")
    lens = torch.zeros(3, dtype=torch.int32)
    assert _device_kv_len(lens, 3, 10, dev)[1] == 1
    assert _device_kv_len(torch.tensor(4, dtype=torch.int32), 3, 10, dev)[1] == 0
    with pytest.raises(ValueError):
        _device_kv_len(lens, 4, 10, dev)
    with pytest.raises(ValueError):
        _device_kv_len(lens.long(), 3, 10, dev)
