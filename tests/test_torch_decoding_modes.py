"""Sampling and ``no_repeat_ngram_size`` in the port's decode loops vs the JAX
package, on the CPU.

The n-gram bans are held bitwise to JAX's ``_ban_repeated_ngrams``; greedy
decoding with bans is token-exact with JAX's ``generate`` (both KV-cache
dtypes, both decode steps, streaming).  The two packages draw from different
random streams, so sampling is held to JAX by its filter (the set of tokens
it keeps) and to greedy where the filter leaves one token, and the port's
draws to ``softmax(_filter_logits)`` by a chi-square test.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.stats
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.generation import GenerationConfig as JaxGen
from tiny_audio_tpu.generation import _ban_repeated_ngrams as jax_ban
from tiny_audio_tpu.generation import _select_token as jax_select
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch import generation
from tiny_audio_tpu_torch.bridge import load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.generation import GenerationConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.processing import ASRProcessor

torch.set_num_threads(1)

#: chi-square tests reject at this p-value (seeded draws: deterministic)
CHI2_P = 1e-3


def _pair(kv_cache_dtype):
    cfg = tiny_test_config(model_dtype="float32", kv_cache_dtype=kv_cache_dtype)
    cfg.max_new_tokens = 16
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def pair(request):
    return _pair(request.param)


def _features(jm, tm, seconds=(1.0, 0.55, 0.3), seed=0):
    rng = np.random.default_rng(seed)
    audio = [rng.standard_normal(int(s * 16000)).astype(np.float32) * 0.1 for s in seconds]
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features(audio)
    tproc = ASRProcessor(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    tf = tproc.extract_features(audio)
    return ((jf["input_features"], jf["audio_attention_mask"]),
            (tf["input_features"], tf["audio_attention_mask"]))


# ------------------------------------------------------------------ n-gram bans


def _ban_cases(n, seed):
    rng = np.random.default_rng(seed)
    b, s, vocab = 3, 20, 6
    tokens = rng.integers(0, 3, (b, s))  # few ids: many repeated n-grams
    tokens[0, :4] = -1  # an unseeded beam prompt: sentinels never match or ban
    tokens[1, rng.integers(0, s)] = vocab + 2  # a follower past the vocabulary is dropped
    logits = rng.standard_normal((b, vocab)).astype(np.float32)
    return logits, tokens


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ban_repeated_ngrams_bitwise(n, seed):
    logits, tokens = _ban_cases(n, seed)
    banned_any = False
    for cur_len in range(0, tokens.shape[1] + 1):  # includes cur_len < n - 1
        want = np.asarray(jax_ban(jnp.asarray(logits), jnp.asarray(tokens, jnp.int32),
                                  jnp.int32(cur_len), n))
        got = generation._ban_repeated_ngrams(torch.from_numpy(logits),
                                              torch.from_numpy(tokens), cur_len, n).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        banned_any |= bool((got == np.finfo(np.float32).min).any())
    assert banned_any


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("overrides", [
    {"no_repeat_ngram_size": 2},
    {"no_repeat_ngram_size": 3, "repetition_penalty": 1.3, "min_new_tokens": 6},
])
def test_greedy_with_ngram_bans_token_exact(pair, fused, overrides):
    jm, tm = pair
    jargs, targs = _features(jm, tm)
    want = jm.generate(*jargs, **overrides)
    got = tm.generate(*targs, fused_decode=fused, **overrides)
    np.testing.assert_array_equal(got, want)
    plain = tm.generate(*targs, fused_decode=fused)
    assert not np.array_equal(got, plain)  # the bans changed the decode


@pytest.mark.parametrize("overrides", [{"no_repeat_ngram_size": 2},
                                       {"do_sample": True, "top_k": 1,
                                        "no_repeat_ngram_size": 3}])
def test_streaming_same_fragments(pair, overrides):
    jm, tm = pair
    clip = np.random.default_rng(3).standard_normal(12000).astype(np.float32) * 0.1
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features([clip])
    tproc = ASRProcessor(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    tf = tproc.extract_features([clip])
    j_gen, t_gen = jm.gen_config, tm.gen_config
    jm.gen_config = dataclasses.replace(j_gen, **overrides)
    tm.gen_config = dataclasses.replace(t_gen, **overrides)
    try:
        want = list(jm.generate_streaming(jf["input_features"], jf["audio_attention_mask"]))
        got = list(tm.generate_streaming(tf["input_features"], tf["audio_attention_mask"]))
    finally:
        jm.gen_config, tm.gen_config = j_gen, t_gen
    assert got == want and got


# --------------------------------------------------------------------- sampling


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sampling", [{"top_k": 1}, {"temperature": 1e-6}])
def test_sampling_collapses_to_greedy(pair, fused, sampling):
    jm, tm = pair
    jargs, targs = _features(jm, tm)
    want = jm.generate(*jargs, min_new_tokens=8)
    got = tm.generate(*targs, fused_decode=fused, min_new_tokens=8, do_sample=True, **sampling)
    np.testing.assert_array_equal(got, want)


def test_return_scores_with_sampling(pair):
    """top_k = 1 samples greedy's tokens, so the scores (the raw
    distribution's mean log-probability) are JAX's greedy scores."""
    jm, tm = pair
    jargs, targs = _features(jm, tm)
    want, want_scores = jm.generate(*jargs, return_scores=True)
    got, got_scores = tm.generate(*targs, return_scores=True, do_sample=True, top_k=1,
                                  generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(got, want)
    assert got_scores.shape == (3,) and np.isfinite(got_scores).all()
    tol = 1e-5 if tm.config.kv_cache_dtype != "int8" else 5e-3  # see test_torch_beams
    np.testing.assert_allclose(got_scores, want_scores, atol=tol)


def _logits(b=2, vocab=16, seed=0):
    return np.random.default_rng(seed).standard_normal((b, vocab)).astype(np.float32) * 2


def _jax_draws(logits, gen, n=2000):
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    draws = jax.vmap(lambda k: jax_select(jnp.asarray(logits), gen, k))(keys)
    return np.asarray(draws)  # [n, B]


@pytest.mark.parametrize("sampling", [{"top_k": 3}, {"top_k": 3, "temperature": 0.7}])
def test_top_k_kept_set_is_jax_draw_set(sampling):
    logits = _logits()
    draws = _jax_draws(logits, JaxGen(do_sample=True, **sampling))
    kept = torch.isfinite(generation._filter_logits(
        torch.from_numpy(logits), GenerationConfig(do_sample=True, **sampling))).numpy()
    for row in range(logits.shape[0]):
        assert set(np.flatnonzero(kept[row])) == set(draws[:, row])


@pytest.mark.parametrize("sampling", [{"top_p": 0.8}, {"top_p": 0.8, "temperature": 0.7},
                                      {"top_p": 0.5, "top_k": 6}])
def test_top_p_kept_set_holds_every_jax_draw(sampling):
    logits = _logits(seed=1)
    draws = _jax_draws(logits, JaxGen(do_sample=True, **sampling))
    kept = torch.isfinite(generation._filter_logits(
        torch.from_numpy(logits), GenerationConfig(do_sample=True, **sampling))).numpy()
    for row in range(logits.shape[0]):
        assert set(draws[:, row]) <= set(np.flatnonzero(kept[row]))
        assert 1 <= kept[row].sum() < logits.shape[1]


def test_top_p_keeps_ties_and_one_token():
    """Every logit at the threshold survives (ties included), and a top_p
    below the largest probability still keeps one token."""
    logits = torch.tensor([[3.0, 1.0, 1.0, 1.0, -2.0], [5.0, 0.0, 0.0, 0.0, 0.0]])
    kept = torch.isfinite(generation._filter_logits(
        logits, GenerationConfig(do_sample=True, top_p=0.9))).numpy()
    want = np.isfinite(np.asarray(jax.jit(
        lambda x: _jax_filtered(x, 0.9))(jnp.asarray(logits.numpy()))))
    np.testing.assert_array_equal(kept, want)
    assert kept[0, :4].all() and not kept[0, 4]
    only = torch.isfinite(generation._filter_logits(
        logits, GenerationConfig(do_sample=True, top_p=1e-3))).numpy()
    np.testing.assert_array_equal(only.sum(axis=1), [1, 1])


def _jax_filtered(logits, top_p):
    """JAX's top-p filter (the body of ``_select_token`` before its draw)."""
    sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = jnp.sum(cum - probs < top_p, axis=-1, keepdims=True)
    threshold = jnp.take_along_axis(sorted_logits, keep - 1, axis=-1)
    return jnp.where(logits < threshold, -jnp.inf, logits)


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.7}, {"top_k": 5},
                                      {"top_p": 0.8}, {"top_k": 6, "top_p": 0.9,
                                                       "temperature": 1.4}])
def test_draws_follow_the_filtered_distribution(sampling):
    n, vocab = 20000, 8
    logits = torch.from_numpy(_logits(b=1, vocab=vocab, seed=2))
    gen = GenerationConfig(do_sample=True, **sampling)
    probs = torch.softmax(generation._filter_logits(logits, gen), dim=-1)[0].double().numpy()
    draws = generation._select_token(logits.expand(n, vocab), gen,
                                     torch.Generator().manual_seed(0)).numpy()
    counts = np.bincount(draws, minlength=vocab)
    assert counts[probs == 0].sum() == 0
    support = probs > 0
    expected = probs[support] * n
    stat = float(((counts[support] - expected) ** 2 / expected).sum())
    assert stat < scipy.stats.chi2.ppf(1 - CHI2_P, int(support.sum()) - 1), (counts, expected)


def test_same_generator_same_tokens_and_global_rng_untouched(pair):
    _, tm = pair
    _, targs = _features(tm=tm, jm=pair[0])
    kwargs = dict(do_sample=True, top_p=0.9, temperature=1.5, min_new_tokens=8)
    state = torch.get_rng_state()
    a = tm.generate(*targs, generator=torch.Generator().manual_seed(7), **kwargs)
    b = tm.generate(*targs, generator=torch.Generator().manual_seed(7), **kwargs)
    c = tm.generate(*targs, generator=torch.Generator().manual_seed(8), **kwargs)
    d, e = tm.generate(*targs, **kwargs), tm.generate(*targs, **kwargs)  # None: seed 0
    assert torch.equal(torch.get_rng_state(), state)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(d, e)
    assert not np.array_equal(a, c)
    greedy = tm.generate(*targs, min_new_tokens=8)
    assert not np.array_equal(a, greedy)
