"""The decode step of the PyTorch port vs the JAX package, on the CPU.

The plain versions of the two decode kernels are held against the JAX Pallas
kernels run in interpret mode (as ``tests/test_decode_attention.py`` runs
them) and against ``decode_step_attention``; the port's ``fused_decode_step``
is held against the JAX one, teacher-forced, with the contract of
``tests/test_fused_decode.py``.  The CUDA kernels themselves are checked
against these plain versions on the card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tiny_audio_tpu.config import DecoderConfig as JaxDecoderConfig
from tiny_audio_tpu.models.decoder import Qwen3Decoder as JaxQwen3Decoder
from tiny_audio_tpu.ops.attention import decode_step_attention as jax_decode_step_attention
from tiny_audio_tpu.ops.decode_attention import (
    decode_attention_tpu,
    decode_attention_update_tpu,
)
from tiny_audio_tpu.ops.fused_decode import flatten_cache
from tiny_audio_tpu.ops.fused_decode import fused_decode_step as jax_fused_decode_step
from tiny_audio_tpu_torch.bridge import jax_to_state_dict
from tiny_audio_tpu_torch.config import DecoderConfig
from tiny_audio_tpu_torch.models.decoder import Qwen3Decoder
from tiny_audio_tpu_torch.ops import attention as tattn
from tiny_audio_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    decode_attention_update,
)
from tiny_audio_tpu_torch.ops.fused_decode import fused_decode_step

torch.set_num_threads(1)

B, S, HKV, GROUP, D = 2, 384, 4, 2, 128
HQ = HKV * GROUP


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def tensors():
    rng = np.random.default_rng(0)
    return {
        "q": _rand(rng, B, HQ, D),
        "cache_k": _rand(rng, B, S, HKV, D),
        "cache_v": _rand(rng, B, S, HKV, D),
        "fresh_k": _rand(rng, B, HKV, D),
        "fresh_v": _rand(rng, B, HKV, D),
    }


def _int8_cache(seed=1, layers=None):
    rng = np.random.default_rng(seed)
    lead = (B,) if layers is None else (layers, B)
    ck, cv = (rng.integers(-127, 128, lead + (S, HKV, D)).astype(np.int8) for _ in range(2))
    ks, vs = ((0.5 + rng.random(lead + (S, HKV))).astype(np.float32) for _ in range(2))
    return ck, cv, ks, vs


def _port_plain(t, kv_len, ck=None, cv=None, ks=None, vs=None):
    tt = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return decode_attention_plain(
        tt(t["q"]), tt(t["cache_k"] if ck is None else ck), tt(t["cache_v"] if cv is None else cv),
        tt(t["fresh_k"]), tt(t["fresh_v"]), kv_len, tt(ks), tt(vs),
    ).numpy()


def _jax_kernel(t, kv_len, ck=None, cv=None, ks=None, vs=None):
    jj = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    return np.asarray(decode_attention_tpu(
        jj(t["q"]), jj(t["cache_k"] if ck is None else ck), jj(t["cache_v"] if cv is None else cv),
        jj(t["fresh_k"]), jj(t["fresh_v"]), jnp.int32(kv_len),
        k_scale=jj(ks), v_scale=jj(vs), interpret=True,
    ))


def _jax_module(t, kv_len, ck=None, cv=None, ks=None, vs=None):
    jj = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    kv_valid = (np.arange(S) < kv_len)[None, :].astype(np.int32)
    out = jax_decode_step_attention(
        jj(t["q"][:, None]), jj(t["cache_k"] if ck is None else ck),
        jj(t["cache_v"] if cv is None else cv), jj(kv_valid),
        fresh_k=jj(t["fresh_k"][:, None]), fresh_v=jj(t["fresh_v"][:, None]),
        k_scale=jj(ks), v_scale=jj(vs),
    )
    return np.asarray(out)[:, 0]


# ------------------------------------------- (a) decode attention, kernel #3


@pytest.mark.parametrize("kv_len", [1, 100, 255, 256, 257, S - 1])
def test_decode_attention_plain_matches_jax_fp32(tensors, kv_len):
    got = _port_plain(tensors, kv_len)
    np.testing.assert_allclose(got, _jax_kernel(tensors, kv_len), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, _jax_module(tensors, kv_len), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_len", [1, 200, 256, S - 1])
def test_decode_attention_plain_matches_jax_int8(tensors, kv_len):
    ck, cv, ks, vs = _int8_cache()
    got = _port_plain(tensors, kv_len, ck, cv, ks, vs)
    want = _jax_kernel(tensors, kv_len, ck, cv, ks, vs)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-3)
    np.testing.assert_allclose(got, _jax_module(tensors, kv_len, ck, cv, ks, vs),
                               atol=5e-2, rtol=1e-3)


def test_decode_attention_nan_tail_stays_finite(tensors):
    """Rows past kv_len are never read: NaN planted there cannot reach the
    output (the Pallas kernel zero-fills those slabs)."""
    bad = tensors["cache_v"].copy()
    bad[:, 300:] = np.nan
    badk = tensors["cache_k"].copy()
    badk[:, 300:] = np.nan
    got = _port_plain(tensors, 128, ck=badk, cv=bad)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_kernel(tensors, 128, cv=bad), atol=2e-5, rtol=1e-5)


def test_decode_step_attention_routes_kv_len(tensors):
    """With kv_len, decode_step_attention takes the kernel's wrapper (the plain
    version on the CPU) and equals the masked path."""
    t = {k: torch.from_numpy(v) for k, v in tensors.items()}
    kv_valid = (torch.arange(S) < 150)[None].to(torch.int32)
    args = (t["q"][:, None], t["cache_k"], t["cache_v"], kv_valid)
    kw = dict(fresh_k=t["fresh_k"][:, None], fresh_v=t["fresh_v"][:, None])
    decode_attention.launches = 0
    got = tattn.decode_step_attention(*args, **kw, kv_len=150)
    want = tattn.decode_step_attention(*args, **kw)
    assert got.shape == (B, 1, HQ, D) and decode_attention.launches == 0
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-6)


# --------------------------------- (b) decode attention + append, kernel #4


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kv_len", [1, 255, 300])
def test_decode_attention_update_plain_matches_jax(tensors, quantized, kv_len):
    layers, layer = 2, 1
    rng = np.random.default_rng(2)
    if quantized:
        ck, cv, ks, vs = _int8_cache(seed=3, layers=layers)
    else:
        ck, cv = (_rand(rng, layers, B, S, HKV, D) for _ in range(2))
        ks = vs = None
    jj = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    res = decode_attention_update_tpu(
        jnp.asarray(tensors["q"]), jnp.asarray(ck.reshape(layers, B, S, HKV * D)),
        jnp.asarray(cv.reshape(layers, B, S, HKV * D)),
        jnp.asarray(tensors["fresh_k"]), jnp.asarray(tensors["fresh_v"]),
        jnp.int32(kv_len), jnp.int32(layer), k_scale=jj(ks), v_scale=jj(vs), interpret=True,
    )
    want_out = np.asarray(res[0])
    want = {"k": np.asarray(res[1]).reshape(ck.shape), "v": np.asarray(res[2]).reshape(cv.shape)}
    if quantized:
        want["k_scale"], want["v_scale"] = np.asarray(res[3]), np.asarray(res[4])

    port = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    if quantized:
        port["k_scale"], port["v_scale"] = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
    decode_attention_update.launches = 0
    got_out = decode_attention_update(
        torch.from_numpy(tensors["q"]), port["k"][layer], port["v"][layer],
        torch.from_numpy(tensors["fresh_k"]), torch.from_numpy(tensors["fresh_v"]), kv_len,
        k_scale=port["k_scale"][layer] if quantized else None,
        v_scale=port["v_scale"][layer] if quantized else None,
    ).numpy()
    assert decode_attention_update.launches == 0  # CPU: the plain version
    tol = dict(atol=5e-2, rtol=1e-3) if quantized else dict(atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_out, want_out, **tol)
    for name, w in want.items():
        g = port[name].numpy()
        # the written row: the same int8 counts and scales (both quantize
        # in fp32 with IEEE division and round half to even)
        np.testing.assert_array_equal(g[layer, :, kv_len], w[layer, :, kv_len], err_msg=name)
        # every other row, and the other layer, unchanged
        before = {"k": ck, "v": cv, "k_scale": ks, "v_scale": vs}[name]
        keep = np.ones(S, bool)
        keep[kv_len] = False
        np.testing.assert_array_equal(g[layer][:, keep], before[layer][:, keep], err_msg=name)
        np.testing.assert_array_equal(g[1 - layer], before[1 - layer], err_msg=name)


# ---------------------------------------------- (c) the fused decode step


def _fused_setup(kv_cache_dtype, qk_norm):
    """tests/test_fused_decode.py's setup, with the port's decoder beside it."""
    cfg = JaxDecoderConfig(
        vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
        num_kv_heads=1, head_dim=128, intermediate_size=160,
        max_position_embeddings=256, kv_cache_dtype=kv_cache_dtype, qk_norm=qk_norm,
    )
    dec = JaxQwen3Decoder(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    rng = np.random.default_rng(7)
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 12)), jnp.int32)
    variables = dec.init(
        jax.random.PRNGKey(1), jnp.zeros((2, 4, 128), jnp.bfloat16),
        jnp.zeros((2, 4), jnp.int32),
    )
    port = Qwen3Decoder(DecoderConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__
    }), dtype=torch.bfloat16, device="cpu")
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), variables["params"])
    state = {name.removeprefix("decoder."): torch.from_numpy(np.array(arr))
             for name, arr in jax_to_state_dict({"decoder": params}).items()}
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(state.pop(name))
    assert not state, sorted(state)
    return cfg, dec, variables, ids, rng, port


def _to_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("kvd,qk_norm", [("bfloat16", True), ("int8", True), ("bfloat16", False)])
def test_fused_step_matches_jax(kvd, qk_norm):
    cfg, dec, variables, ids, rng, port = _fused_setup(kvd, qk_norm)
    b, t = ids.shape
    steps, s = 3, 16
    embeds = dec.apply(variables, ids, method=JaxQwen3Decoder.embed)
    cache = dec.init_cache(b, s, dtype=jnp.bfloat16)
    positions = jnp.arange(t)[None, :].repeat(b, 0)
    _, cache = dec.apply(variables, embeds, positions, cache=cache, cache_index=0,
                         last_logit_only=True)
    cache_jax = flatten_cache(jax.tree.map(jnp.copy, cache))
    # the port steps from the same prefilled cache, in its own layout
    cache_port = {}
    for name, x in cache.items():
        dtype = {jnp.int8: torch.int8, jnp.float32: torch.float32}.get(x.dtype.type, torch.bfloat16)
        cache_port[name] = _to_torch(x).to(dtype).contiguous()
    teach = np.asarray(rng.integers(0, cfg.vocab_size, (steps, b)), np.int32)

    for i in range(steps):
        pos = t + i
        lg_j, cache_jax = jax_fused_decode_step(
            variables["params"], cfg, jnp.asarray(teach[i]), jnp.int32(pos), cache_jax,
            interpret=True,
        )
        lg_t = fused_decode_step(port, torch.from_numpy(teach[i]).long(), pos, cache_port)
        assert lg_t.dtype == torch.float32 and lg_t.shape == (b, cfg.vocab_size)
        drift = float(np.max(np.abs(lg_t.numpy() - np.asarray(lg_j))))
        assert drift < 0.25, f"step {i}: logit drift {drift}"
        kj = np.asarray(jnp.asarray(cache_jax["k"][:, :, pos], jnp.float32)).reshape(
            cfg.num_layers, b, cfg.num_kv_heads, cfg.head_dim)
        kt = cache_port["k"][:, :, pos].float().numpy()
        if kvd == "int8":
            assert np.max(np.abs(kt - kj)) <= 3, f"step {i}: quant count diff"
            np.testing.assert_allclose(cache_port["k_scale"][:, :, pos].numpy(),
                                       np.asarray(cache_jax["k_scale"][:, :, pos]), rtol=2e-2)
        else:
            # bf16 ulps at the scale of the largest element (rotary's
            # k1*cos - k2*sin cancels): layer 0 to JAX's own bound; deeper
            # layers carry the other framework's bf16 rounding of the block
            # before them (measured: ~half the entries off by 1-2 ulps)
            ulp = 2.0 ** (np.floor(np.log2(np.max(np.abs(kj)))) - 7)
            atol0 = 2 * float(np.max(np.abs(kj[0]))) * 2**-8
            np.testing.assert_allclose(kt[0], kj[0], atol=atol0)
            np.testing.assert_allclose(kt[1:], kj[1:], atol=4 * ulp)


def test_fused_step_matches_module_step():
    """On one model, the fused step and the module step give the same logits
    and write the same cache rows (the CPU runs both plain versions)."""
    cfg, dec, variables, ids, rng, port = _fused_setup("int8", True)
    b, s = 2, 24
    embeds = torch.from_numpy(rng.standard_normal((b, 10, 128)).astype(np.float32))
    positions = torch.arange(10).expand(b, 10)
    caches = []
    for _ in range(2):
        cache = port.init_cache(b, s)
        port(embeds, positions, cache=cache, cache_index=0)
        caches.append(cache)
    cur = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)).long()
    with torch.inference_mode():
        fused = fused_decode_step(port, cur, 10, caches[0])
        kv_valid = (torch.arange(s) < 10)[None].to(torch.int32)
        module = port(port.embed(cur[:, None]), torch.full((b, 1), 10, dtype=torch.int32),
                      step_kv_valid=kv_valid, cache=caches[1], cache_index=10)[:, 0].float()
    torch.testing.assert_close(fused, module, atol=0, rtol=0)
    for name in caches[0]:
        assert torch.equal(caches[0][name], caches[1][name]), name
