"""Beam search (``generate_beams``) in the port vs the JAX package, on the CPU.

The JAX decoder's random params are carried into the port; beams must give
JAX's tokens for both KV-cache dtypes and both decode steps (JAX's beams run
the module step only), with scores within 1e-5 over a cache of the model's
dtype.  Over the int8 cache the scores are held at 5e-3: the two packages
sum fp32 products in different orders, so a per-entry scale can differ by an
ulp and flip one int8 rounding of a decode step's K/V row, which moves a
step's log-probability by ~1e-3 (greedy's ``return_scores`` shows the same
on these inputs; the tokens stay equal).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.generation import GenerationConfig as JaxGen
from tiny_audio_tpu.generation import generate_beams as jax_generate_beams
from tiny_audio_tpu.generation import generate_tokens as jax_generate_tokens
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.models.decoder import Qwen3Decoder as JaxDecoder
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch import generation
from tiny_audio_tpu_torch.bridge import load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.generation import GenerationConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.processing import ASRProcessor

torch.set_num_threads(1)

SCORE_ATOL = {"bfloat16": 1e-5, "int8": 5e-3}


def _pair(kv_cache_dtype, params=None):
    cfg = tiny_test_config(model_dtype="float32", kv_cache_dtype=kv_cache_dtype)
    cfg.max_new_tokens = 10
    jm = JaxASRModel(cfg, seed=0, params=params)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def pair(request):
    return _pair(request.param)


def _prompt(jm, tm, b=2, t=6, seed=0):
    ids = np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int32)
    jemb = jm.decoder.apply({"params": jm.params["decoder"]}, jnp.asarray(ids),
                            method=JaxDecoder.embed)
    with torch.inference_mode():
        temb = tm.decoder.embed(torch.from_numpy(ids).long())
    return ids, jemb, temb


def _both(jm, tm, fused, kwargs, with_ids=True, seed=0):
    ids, jemb, temb = _prompt(jm, tm, seed=seed)
    jt, js = jax_generate_beams(jm.decoder, {"params": jm.params["decoder"]}, jemb,
                                JaxGen(**kwargs),
                                input_ids=jnp.asarray(ids) if with_ids else None)
    tt, ts = generation.generate_beams(tm.decoder, temb, GenerationConfig(**kwargs),
                                       input_ids=torch.from_numpy(ids) if with_ids else None,
                                       fused_decode=fused)
    return (np.asarray(jt), np.asarray(js)), (tt.numpy(), ts.numpy())


BASE = {"max_new_tokens": 8, "eos_token_ids": (), "pad_token_id": 0}
CASES = {
    "k1": {"num_beams": 1},
    "k2": {"num_beams": 2},
    "k4_lp0": {"num_beams": 4, "length_penalty": 0.0},
    "k4_lp1": {"num_beams": 4, "length_penalty": 1.0},
    "k4_lp1.3": {"num_beams": 4, "length_penalty": 1.3},
    "k4_penalties": {"num_beams": 4, "repetition_penalty": 1.3, "no_repeat_ngram_size": 2,
                     "min_new_tokens": 5, "eos_token_ids": (13, 409)},
    "k3_ngram3": {"num_beams": 3, "no_repeat_ngram_size": 3, "length_penalty": 1.3},
}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_beams_match_jax(pair, fused, case):
    jm, tm = pair
    (jt, js), (tt, ts) = _both(jm, tm, fused, {**BASE, **CASES[case]})
    assert tt.shape == (2, 8) and tt.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=SCORE_ATOL[tm.config.kv_cache_dtype], rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_beams_without_prompt_ids(pair, fused):
    """The n-gram ring's prompt region holds -1 without ``input_ids``."""
    jm, tm = pair
    kwargs = {**BASE, "num_beams": 2, "no_repeat_ngram_size": 2, "repetition_penalty": 1.2}
    (jt, js), (tt, ts) = _both(jm, tm, fused, kwargs, with_ids=False, seed=4)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=SCORE_ATOL[tm.config.kv_cache_dtype], rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_one_beam_is_greedy(pair, fused):
    jm, tm = pair
    ids, _, temb = _prompt(jm, tm)
    greedy, _ = generation.generate_tokens(tm.decoder, temb, torch.from_numpy(ids),
                                           GenerationConfig(**BASE), fused_decode=fused)
    beams, _ = generation.generate_beams(tm.decoder, temb,
                                         GenerationConfig(**BASE, num_beams=1),
                                         input_ids=torch.from_numpy(ids), fused_decode=fused)
    np.testing.assert_array_equal(beams.numpy(), greedy.numpy())


@pytest.mark.parametrize("fused", [True, False])
def test_eos_freezes_beams_with_pad_after(pair, fused):
    jm, tm = pair
    ids, jemb, temb = _prompt(jm, tm)
    greedy, _ = jax_generate_tokens(jm.decoder, {"params": jm.params["decoder"]}, jemb,
                                    jnp.asarray(ids), JaxGen(**BASE))
    eos = int(np.asarray(greedy)[0, 2])  # a token greedy emits early
    kwargs = {**BASE, "eos_token_ids": (eos,), "pad_token_id": 7, "num_beams": 2}
    (jt, js), (tt, ts) = _both(jm, tm, fused, kwargs)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=SCORE_ATOL[tm.config.kv_cache_dtype], rtol=0)
    hit = np.flatnonzero(tt[0] == eos)
    assert hit.size and (tt[0, hit[0] + 1:] == 7).all()


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    values, indices = generation._top_k(x, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))


@pytest.fixture(scope="module")
def tied_pair():
    """Token embeddings equal in groups of four: the tied LM head gives every
    token the logit of three others, so every top-k of the beams has ties."""
    base = JaxASRModel(tiny_test_config(model_dtype="float32"), seed=0)
    params = jax.tree.map(np.asarray, base.params)
    emb = params["decoder"]["embed_tokens"]["embedding"]
    params["decoder"]["embed_tokens"]["embedding"] = emb[np.arange(emb.shape[0]) // 4 * 4]
    return _pair("bfloat16", params=jax.tree.map(jnp.asarray, params))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("num_beams", [2, 4])
def test_beams_with_constructed_ties(tied_pair, fused, num_beams):
    jm, tm = tied_pair
    (jt, js), (tt, ts) = _both(jm, tm, fused, {**BASE, "num_beams": num_beams})
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    assert (tt % 4 == 0).all()  # of each tied group, the lowest id


def _features(jm, tm, seconds=(1.0, 0.55)):
    rng = np.random.default_rng(0)
    audio = [rng.standard_normal(int(s * 16000)).astype(np.float32) * 0.1 for s in seconds]
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features(audio)
    tf = ASRProcessor(tm.projector, num_mel_bins=80, device="cpu").extract_features(audio)
    return ((jf["input_features"], jf["audio_attention_mask"]),
            (tf["input_features"], tf["audio_attention_mask"]))


@pytest.mark.parametrize("fused", [True, False])
def test_model_generate_with_beams(pair, fused):
    jm, tm = pair
    jargs, targs = _features(jm, tm)
    want = jm.generate(*jargs, num_beams=2, min_new_tokens=4)
    got = tm.generate(*targs, num_beams=2, min_new_tokens=4, fused_decode=fused)
    np.testing.assert_array_equal(got, want)


def test_beams_ignore_int8_weights_and_refuse_scores(pair):
    jm, tm = pair
    _, targs = _features(jm, tm)
    plain = tm.generate(*targs, num_beams=2)
    tm.enable_wq_decode()
    try:
        wq = tm.wq
        np.testing.assert_array_equal(tm.generate(*targs, num_beams=2), plain)
        assert tm.wq is wq and tm.decoder.layers[0].wq is not None
    finally:
        tm.wq = None
    with pytest.raises(ValueError, match="beam search"):
        tm.generate(*targs, num_beams=2, return_scores=True)
