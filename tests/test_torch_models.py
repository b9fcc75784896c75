"""PyTorch encoder, projector and decoder vs the JAX modules, on the CPU.

Both models come from ``tiny_test_config`` (the port's config built from the
JAX one's dict) with the JAX model's random params carried into the port by
:func:`tiny_audio_tpu_torch.bridge.load_jax_params`.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.models.decoder import quantize_kv as jax_quantize_kv
from tiny_audio_tpu_torch.bridge import jax_to_state_dict, load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.ops.decode_attention import quantize_kv
from tiny_audio_tpu_torch.models.projectors import frame_stack

torch.set_num_threads(1)


def _port(cfg):
    """The port's own config with the fields of a JAX config."""
    return PortASRConfig.from_dict(cfg.to_dict())


def _pair(model_dtype="float32", kv_cache_dtype="bfloat16"):
    cfg = tiny_test_config(model_dtype=model_dtype, kv_cache_dtype=kv_cache_dtype)
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(_port(cfg), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


@pytest.fixture(scope="module")
def int8_pair():
    return _pair(kv_cache_dtype="int8")


@pytest.fixture(scope="module")
def bf16_pair():
    return _pair(model_dtype="bfloat16")


def _features(cfg, b=2, t_mel=64, lengths=(64, 37), seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, cfg.encoder.num_mel_bins, t_mel)).astype(np.float32)
    mask = (np.arange(t_mel)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    return feats, mask


def _encode_both(jm, tm):
    feats, mask = _features(jm.config)
    want = jm.encoder.apply(
        {"params": jm.params["encoder"]}, jnp.asarray(feats), frame_mask=jnp.asarray(mask)
    )
    with torch.inference_mode():
        got = tm.encoder(torch.from_numpy(feats), torch.from_numpy(mask))
    return np.asarray(want.astype(jnp.float32)), got.float().numpy(), got.dtype


def test_bridge_covers_every_parameter(fp32_pair):
    jm, tm = fp32_pair
    names = set(jax_to_state_dict(jax.tree.map(np.asarray, jm.params)))
    assert names == {n for n, _ in tm.named_parameters()}
    bad = {"encoder": {"unknown": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError):
        load_jax_params(tm, bad)


def test_encoder_fp32(fp32_pair):
    want, got, dtype = _encode_both(*fp32_pair)
    assert dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_encoder_bf16(bf16_pair):
    want, got, dtype = _encode_both(*bf16_pair)
    assert dtype == torch.bfloat16
    # bf16 activations round at other points in the two frameworks (XLA
    # rounds each op of the tanh GELU, PyTorch the fused result), and two
    # residual blocks carry those few-ulp differences into LayerNorm'd
    # outputs of up to ~3.3, where a bf16 ulp is 2**-6: 0.0625 is 4 ulps.
    np.testing.assert_allclose(got, want, atol=0.0625)
    assert np.mean(np.abs(got - want)) < 0.01


def test_projector(fp32_pair):
    jm, tm = fp32_pair
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 33, jm.config.encoder.d_model)).astype(np.float32)
    want, _ = jm.projector.apply(
        {"params": jm.params["projector"]}, jnp.asarray(hidden), train=False
    )
    with torch.inference_mode():
        got, aux = tm.projector(torch.from_numpy(hidden))
    assert float(aux) == 0.0
    assert got.shape == want.shape == (2, jm.projector.get_output_length(33), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tm.projector.get_output_length(33) == jm.projector.get_output_length(33)
    np.testing.assert_array_equal(
        frame_stack(torch.from_numpy(hidden), 4).numpy(),
        np.asarray(jax.numpy.asarray(hidden)[:, :32].reshape(2, 8, -1)),
    )


def test_projector_bf16(bf16_pair):
    jm, tm = bf16_pair
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 24, jm.config.encoder.d_model)).astype(np.float32)
    want, _ = jm.projector.apply(
        {"params": jm.params["projector"]}, jnp.asarray(hidden, jnp.bfloat16), train=False
    )
    with torch.inference_mode():
        got, _ = tm.projector(torch.from_numpy(hidden).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and tm.projector.linear_1.weight.dtype == torch.float32
    # RMS-normed outputs of O(1) in bf16 (relative spacing 2**-7): a few ulps
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=5e-2
    )


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 63.5, -0.5, 0.0]  # a half-way tie: 63.5 -> 64 (even)
    q_j, s_j = jax_quantize_kv(jnp.asarray(x))
    q_t, s_t = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)


def _compare_cache(got: dict, want: dict, rows: slice):
    for name in want:
        w = np.asarray(want[name])[:, :, rows]
        g = got[name][:, :, rows].numpy()
        if name in ("k", "v") and g.dtype == np.int8:
            # fresh K/V agree to ~1e-6, so an entry can land on the other
            # side of a rounding tie: off by one in a tiny share of entries
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and np.mean(diff) < 1e-3, name
        elif name.endswith("scale"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("pair", ["fp32_pair", "int8_pair"])
def test_decoder_prefill_and_step(pair, request):
    jm, tm = request.getfixturevalue(pair)
    cfg = jm.config.decoder
    b, t, t_real, s = 2, 12, 9, 32
    rng = np.random.default_rng(4)
    embeds = rng.standard_normal((b, t, cfg.hidden_size)).astype(np.float32)
    positions = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    ones = np.ones((b, t), np.int32)
    jdec = jm.decoder
    jvars = {"params": jm.params["decoder"]}
    tdec = tm.decoder
    with torch.inference_mode():
        # full prefill logits, then the bucketed-prompt prefill into a cache
        want = jdec.apply(jvars, jnp.asarray(embeds), jnp.asarray(positions),
                          padding_mask=jnp.asarray(ones))[0]
        got = tdec(torch.from_numpy(embeds), torch.from_numpy(positions),
                   padding_mask=torch.from_numpy(ones))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

        jcache = jdec.init_cache(b, s, dtype=jnp.float32)
        want, jcache = jdec.apply(
            jvars, jnp.asarray(embeds), jnp.asarray(positions),
            padding_mask=jnp.asarray(ones), cache=jcache, cache_index=0,
            last_logit_index=jnp.int32(t_real - 1),
        )
        tcache = tdec.init_cache(b, s)
        assert {k: tuple(v.shape) for k, v in tcache.items()} == {
            k: v.shape for k, v in jcache.items()}
        got = tdec(torch.from_numpy(embeds), torch.from_numpy(positions),
                   padding_mask=torch.from_numpy(ones), cache=tcache, cache_index=0,
                   last_logit_index=t_real - 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        _compare_cache(tcache, jcache, slice(0, s))

        # one decode step at pos = t_real over the stale cache + fresh row
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        pos = t_real
        kv_valid = (np.arange(s) < pos)[None].astype(np.int32)
        jemb = jdec.apply(jvars, jnp.asarray(tok), method=type(jdec).embed)
        want, jcache = jdec.apply(
            jvars, jemb, jnp.full((b, 1), pos, jnp.int32),
            step_kv_valid=jnp.asarray(kv_valid), cache=jcache, cache_index=pos,
        )
        temb = tdec.embed(torch.from_numpy(tok).long())
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=0)
        got = tdec(temb, torch.full((b, 1), pos, dtype=torch.int32),
                   step_kv_valid=torch.from_numpy(kv_valid), cache=tcache, cache_index=pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        _compare_cache(tcache, jcache, slice(0, s))


def test_random_init_follows_flax_defaults():
    cfg = tiny_test_config(model_dtype="float32")
    m = ASRModel(_port(cfg), seed=0, device="cpu")
    again = ASRModel(_port(cfg), seed=0, device="cpu")
    for (name, p), (_, q) in zip(m.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), name  # seeded: the same weights every time
    w = m.encoder.layers[0].fc1.weight.float()
    assert abs(w.std().item() - cfg.encoder.d_model ** -0.5) < 0.1 * cfg.encoder.d_model ** -0.5
    assert w.abs().max() <= 2 * cfg.encoder.d_model ** -0.5 / 0.87962566103423978 + 1e-6
    assert float(m.encoder.layers[0].q_proj.bias.abs().sum()) == 0.0
    assert torch.equal(m.decoder.layers[0].q_norm, torch.ones(cfg.decoder.head_dim))
    emb = m.decoder.embed_tokens.weight
    assert abs(emb.std().item() - cfg.decoder.hidden_size ** -0.5) < 0.05 * cfg.decoder.hidden_size ** -0.5


@pytest.mark.parametrize("variant", [
    {"qk_norm": False},  # Llama / SmolLM2 / Mistral
    {"qk_norm": False, "rms_norm_offset": True, "hidden_activation": "gelu_tanh",
     "embedding_normalizer": True},  # Gemma v1
])
def test_decoder_family_knobs(variant):
    cfg = tiny_test_config(model_dtype="float32")
    cfg.decoder = dataclasses.replace(cfg.decoder, **variant)
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(_port(cfg), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    rng = np.random.default_rng(5)
    b, t = 2, 10
    embeds = rng.standard_normal((b, t, cfg.decoder.hidden_size)).astype(np.float32)
    positions = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    want = jm.decoder.apply({"params": jm.params["decoder"]}, jnp.asarray(embeds),
                            jnp.asarray(positions))[0]
    with torch.inference_mode():
        got = tm.decoder(torch.from_numpy(embeds), torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
