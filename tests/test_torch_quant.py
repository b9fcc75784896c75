"""The int8 decode modes of the PyTorch port vs the JAX package, on the CPU.

The quantizers and both ``wq`` collections must equal JAX's byte for byte;
the plain versions of kernels #5 (W8A8) and #6 (weight-only) are held
against the JAX Pallas kernels in interpret mode and their XLA oracles; fp32
``generate`` under each mode must give JAX's tokens on both of the port's
decode paths.  The CUDA kernels are checked against these plain versions on
the card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models import decoder as jax_decoder
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.ops import wq_head as jax_wq_head
from tiny_audio_tpu.ops import wq_matmul as jax_wq_matmul
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch.bridge import load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.models.decoder import (
    PROJECTIONS,
    quantize_decoder_w8a8,
    quantize_decoder_wq,
)
from tiny_audio_tpu_torch.ops import wq_head, wq_matmul
from tiny_audio_tpu_torch.processing import ASRProcessor

torch.set_num_threads(1)
MODES = ("enable_wq_decode", "enable_w8a8_head", "enable_w8a8_decode")


def _pair(kv_cache_dtype="bfloat16"):
    cfg = tiny_test_config(model_dtype="float32", kv_cache_dtype=kv_cache_dtype)
    cfg.max_new_tokens = 16
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def pair(request):
    return _pair(request.param)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bytes(got, want) -> None:
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype,
                                                                got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((2, 48, 300)) * 0.05).astype(np.float32)  # ragged N
    w[:, :, 7] = 0.0  # an all-zero column takes the 1e-12 scale guard
    return w


def test_quantizers_match_jax():
    w = _weights()
    for i in range(w.shape[0]):  # JAX's quantizers take one [K, N] at a time
        for port_fn, jax_fn in ((wq_matmul.quantize_weight, jax_wq_matmul.quantize_weight),
                                (wq_head.quantize_head_w8a8, jax_wq_head.quantize_head_w8a8),
                                (wq_head.quantize_weight_w8a8, jax_wq_head.quantize_weight_w8a8)):
            got = port_fn(torch.from_numpy(w[i]))
            want = jax_fn(jnp.asarray(w[i]))
            for g, j in zip(got, want):
                _same_bytes(g, j)
    # stacked layers: the leading dims stand for JAX's vmap
    got = wq_matmul.quantize_weight(torch.from_numpy(w))
    want = jax.vmap(jax_wq_matmul.quantize_weight)(jnp.asarray(w))
    for g, j in zip(got, want):
        _same_bytes(g, j)
    x = (np.random.default_rng(1).standard_normal((3, 64)) * 3).astype(np.float32)
    x[1] = 0.0
    xb = jnp.asarray(x, jnp.bfloat16)
    for g, j in zip(wq_head.quantize_act(torch.from_numpy(x).to(torch.bfloat16)),
                    jax_wq_head.quantize_act(xb)):
        _same_bytes(g, j)


@pytest.mark.parametrize("kind", ["wq", "w8a8"])
def test_collections_match_jax(pair, kind):
    jm, tm = pair
    port_fn, jax_fn = {"wq": (quantize_decoder_wq, jax_decoder.quantize_decoder_wq),
                       "w8a8": (quantize_decoder_w8a8, jax_decoder.quantize_decoder_w8a8)}[kind]
    got = port_fn(tm.decoder)
    want = jax_fn(jm.params["decoder"], jm.decoder.cfg)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in leaves:
        value = got
        for key in path:
            value = value[key.key]
        _same_bytes(value, leaf)


def _matmul_inputs(b, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, k)) * 2).astype(np.float32)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    scale = (rng.random(n) * 0.01).astype(np.float32)
    scale[-1] = 0.0  # a pad row
    return x, w, scale


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [300, 2048])
def test_w8a8_plain_matches_jax_bitwise(b, n):
    x, wt, scale = _matmul_inputs(b, 64, n, seed=b * n)
    xj = jnp.asarray(x, jnp.bfloat16)
    got = wq_head.w8a8_matmul_plain(torch.from_numpy(x).to(torch.bfloat16),
                                    torch.from_numpy(wt), torch.from_numpy(scale))
    want = jax_wq_head.w8a8_matmul_xla(xj, jnp.asarray(wt), jnp.asarray(scale))
    _same_bytes(got.view(torch.int16), np.asarray(want).view(np.int16))
    if n % jax_wq_head.NT_HEAD == 0:  # the Pallas kernel takes whole N tiles
        kernel = jax_wq_head.w8a8_matmul(xj, jnp.asarray(wt), jnp.asarray(scale), interpret=True)
        _same_bytes(got.view(torch.int16), np.asarray(kernel).view(np.int16))
    assert wq_head.w8a8_matmul.launches == 0  # a CPU tensor takes the plain version


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [300, 1024])
def test_wq_plain_matches_jax(b, n):
    """fp32 sums in another order than XLA's could move a bf16 output by one
    ulp: held within WQ_ATOL + WQ_RTOL |want| (bitwise at these shapes)."""
    x, wt, scale = _matmul_inputs(b, 96, n, seed=7 + b * n)
    w = np.ascontiguousarray(wt.T)  # [K, N]
    xj = jnp.asarray(x, jnp.bfloat16)
    got = wq_matmul.wq_matmul_plain(torch.from_numpy(x).to(torch.bfloat16),
                                    torch.from_numpy(w), torch.from_numpy(scale)).float().numpy()
    for want in (jax_wq_matmul.wq_matmul_xla(xj, jnp.asarray(w), jnp.asarray(scale)),
                 jax_wq_matmul.wq_matmul(xj, jnp.asarray(w), jnp.asarray(scale), interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=wq_matmul.WQ_ATOL, rtol=wq_matmul.WQ_RTOL)
    assert wq_matmul.wq_matmul.launches == 0


def test_quantization_error_matches_jax():
    w = _weights()[0]
    got = wq_matmul.quantization_error(w, n_probe=64)
    want = jax_wq_matmul.quantization_error(w, n_probe=64)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-4)


def _features(jm, tm, seconds=(1.0, 0.55, 0.3), seed=0):
    rng = np.random.default_rng(seed)
    audio = [rng.standard_normal(int(s * 16000)).astype(np.float32) * 0.1 for s in seconds]
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features(audio)
    tf = ASRProcessor(tm.projector, num_mel_bins=80, device="cpu").extract_features(audio)
    return jf, tf


def _enable(model, mode):
    model.wq = None
    getattr(model, mode)()


@pytest.mark.parametrize("mode", MODES)
def test_generate_token_exact_under_each_mode(pair, mode):
    """Both of the port's decode paths read the collection (fused and module
    steps dispatch in ``project_qkv``/``finish``/``logits``) and give the
    JAX module path's tokens; the prefill's one-row head is quantized too."""
    jm, tm = pair
    jf, tf = _features(jm, tm)
    _enable(jm, mode)
    _enable(tm, mode)
    try:
        want = jm.generate(jf["input_features"], jf["audio_attention_mask"], min_new_tokens=8)
        for fused in (True, False):
            got = tm.generate(tf["input_features"], tf["audio_attention_mask"], min_new_tokens=8,
                              fused_decode=fused)
            np.testing.assert_array_equal(got, want)
    finally:
        jm.wq = tm.wq = None


def test_modes_change_tokens_and_none_turns_them_off(pair):
    """Setting ``wq`` to None gives the bf16-weight tokens back (the JAX
    package's off switch); the W8A8 collection changes them on these random
    weights, so the decode really reads it."""
    _, tm = pair
    _, tf = _features(*pair)
    run = lambda: tm.generate(tf["input_features"], tf["audio_attention_mask"],  # noqa: E731
                              min_new_tokens=8)
    base = run()
    tm.enable_w8a8_decode()
    try:
        assert "q_proj_t_i8" in tm.wq["layers"] and "head_t_i8" in tm.wq
        assert tm.decoder.layers[0].wq["q_proj_t_i8"].shape == \
            tm.decoder.layers[0].q_proj.weight.shape
        quantized = run()
    finally:
        tm.wq = None
    assert tm.decoder.layers[0].wq is None
    np.testing.assert_array_equal(run(), base)
    assert not np.array_equal(quantized, base)


def _step_logits(tm):
    dec = tm.decoder
    cache = dec.init_cache(1, 16)
    with torch.inference_mode():
        return dec(dec.embed(torch.tensor([[5]])), torch.zeros((1, 1), dtype=torch.int32),
                   step_kv_valid=torch.zeros((1, 16), dtype=torch.int32), cache=cache,
                   cache_index=0).float()


@pytest.mark.parametrize("mode", ["enable_wq_decode", "enable_w8a8_decode"])
def test_decode_step_reads_int8_layer_weights(pair, mode):
    """Zeroing the int8 layer weights (the bf16 ones intact) changes a
    T == 1 step's logits: the step reads the collection."""
    _, tm = pair
    _enable(tm, mode)
    try:
        base = _step_logits(tm)
        zeroed = dict(tm.wq)
        zeroed["layers"] = {k: torch.zeros_like(v) if v.dtype == torch.int8 else v
                            for k, v in tm.wq["layers"].items()}
        tm.wq = zeroed
        assert not torch.allclose(base, _step_logits(tm))
    finally:
        tm.wq = None


def test_w8a8_head_composes_with_wq_decode(pair):
    jm, tm = pair
    for model in (jm, tm):
        model.wq = None
        model.enable_wq_decode()
        model.enable_w8a8_head()
    try:
        assert set(tm.wq) == set(jm.wq)
        for name in PROJECTIONS:
            assert f"{name}_i8" in tm.wq["layers"]
        _same_bytes(tm.wq["head_t_i8"], jm.wq["head_t_i8"])
        jf, tf = _features(jm, tm, seconds=(0.7,), seed=5)
        want = jm.generate(jf["input_features"], jf["audio_attention_mask"], min_new_tokens=8)
        got = tm.generate(tf["input_features"], tf["audio_attention_mask"], min_new_tokens=8)
        np.testing.assert_array_equal(got, want)
    finally:
        jm.wq = tm.wq = None


def test_streaming_and_scores_read_the_int8_weights(pair):
    """Streaming (the module step at batch 1) and ``return_scores`` under an
    int8 mode give JAX's fragments, tokens and scores; enabling a mode
    replaces the collection of an earlier one."""
    jm, tm = pair
    _enable(jm, "enable_w8a8_decode")
    _enable(tm, "enable_wq_decode")
    _enable(tm, "enable_w8a8_decode")
    try:
        jf, tf = _features(jm, tm, seconds=(0.8,), seed=3)
        want = list(jm.generate_streaming(jf["input_features"], jf["audio_attention_mask"]))
        got = list(tm.generate_streaming(tf["input_features"], tf["audio_attention_mask"]))
        assert got == want
        jf, tf = _features(jm, tm, seed=4)
        want_tokens, want_scores = jm.generate(jf["input_features"], jf["audio_attention_mask"],
                                               return_scores=True)
        got_tokens, got_scores = tm.generate(tf["input_features"], tf["audio_attention_mask"],
                                             return_scores=True)
        np.testing.assert_array_equal(got_tokens, want_tokens)
        # the int8 head's logits are bf16, and the two packages' fp32
        # activations differ in their last bits: a logit can move by one bf16
        # ulp, 2**-6 at |logit| in [2, 4), and the scores average log-softmax
        np.testing.assert_allclose(got_scores, want_scores, atol=2.0**-6)
    finally:
        jm.wq = tm.wq = None
