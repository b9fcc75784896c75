"""The serving slice as a whole: the PyTorch port vs the JAX package, on the CPU.

The JAX model's random params are carried into the port; greedy decoding
must then give the same tokens, for both KV-cache dtypes, and the pipelines
the same texts.  A subprocess imports every module of the port with jax and
flax blocked.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.pipeline import ASRPipeline as JaxASRPipeline
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch.bridge import load_jax_params
from tiny_audio_tpu_torch.models.asr import ASRModel, splice_audio
from tiny_audio_tpu_torch.ops.encoder_attention import encoder_attention
from tiny_audio_tpu_torch.ops.prefill_attention import prefill_attention
from tiny_audio_tpu_torch.pipeline import ASRPipeline
from tiny_audio_tpu_torch.processing import ASRProcessor, bucket_frames

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _pair(kv_cache_dtype):
    cfg = tiny_test_config(model_dtype="float32", kv_cache_dtype=kv_cache_dtype)
    cfg.max_new_tokens = 16
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(cfg, seed=1)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def pair(request):
    return _pair(request.param)


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(int(s * 16000)).astype(np.float32) * 0.1 for s in seconds]


@pytest.mark.parametrize("overrides", [
    {},
    {"repetition_penalty": 1.3, "min_new_tokens": 6, "return_scores": True},
])
def test_generate_token_exact(pair, overrides):
    jm, tm = pair
    audio = _audio((1.0, 0.55, 0.3))  # mixed lengths in one batch
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features(audio)
    tf = ASRProcessor(tm.projector, num_mel_bins=80).extract_features(audio)
    np.testing.assert_array_equal(tf["audio_attention_mask"].numpy(),
                                  np.asarray(jf["audio_attention_mask"]))
    want = jm.generate(jf["input_features"], jf["audio_attention_mask"], **overrides)
    encoder_attention.launches = prefill_attention.launches = 0
    got = tm.generate(tf["input_features"], tf["audio_attention_mask"], **overrides)
    assert encoder_attention.launches == 0 and prefill_attention.launches == 0  # CPU
    if overrides.get("return_scores"):
        (want, want_scores), (got, got_scores) = want, got
        np.testing.assert_allclose(got_scores, want_scores, atol=1e-5)
    assert got.shape == (3, 16) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pipeline_same_texts(pair):
    jm, tm = pair
    jpipe, tpipe = JaxASRPipeline(jm), ASRPipeline(tm)
    for clip in _audio((0.4, 1.3, 2.0), seed=1):
        want = jpipe(clip)
        got = tpipe(clip)
        assert isinstance(got["text"], str)
        assert got == want


def test_splice_audio_row_aligned():
    text = torch.zeros((2, 6, 3))
    mask = torch.tensor([[0, 1, 1, 0, 0, 0], [1, 0, 0, 1, 1, 0]], dtype=torch.bool)
    audio = torch.arange(2 * 3 * 3, dtype=torch.float32).reshape(2, 3, 3)
    out = splice_audio(text, mask, audio)
    torch.testing.assert_close(out[0, 1:3], audio[0, :2])
    torch.testing.assert_close(out[1, [0, 3, 4]], audio[1])
    assert float(out[0, 0].abs().sum()) == 0.0


def test_bucket_frames_and_prompt_bucket(pair):
    jm, tm = pair
    from tiny_audio_tpu.processing import bucket_frames as jax_bucket_frames

    for n in (1, 500, 501, 2999, 3000, 3001, 4700):
        assert bucket_frames(n) == jax_bucket_frames(n)
    for n_audio in (3, 40, 64):
        ids = tm.build_prompt_ids(n_audio)
        assert ids == jm.build_prompt_ids(n_audio)
        assert tm._bucket_prompt_len(len(ids), n_audio) == jm._bucket_prompt_len(len(ids), n_audio)
    assert tm.mel_window_frames() == jm.mel_window_frames()


def test_unported_decoding_modes_raise(pair):
    _, tm = pair
    audio = _audio((0.3,))
    feats = ASRProcessor(tm.projector, num_mel_bins=80).extract_features(audio)
    for override in ({"do_sample": True}, {"num_beams": 2}, {"no_repeat_ngram_size": 3}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.generate(feats["input_features"], feats["audio_attention_mask"], **override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.generate_streaming(feats["input_features"], feats["audio_attention_mask"])


_NO_JAX_SCRIPT = r"""
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, BlockJax())
import numpy as np
import torch
import tiny_audio_tpu_torch

torch.set_num_threads(1)
names = [m.name for m in pkgutil.walk_packages(tiny_audio_tpu_torch.__path__,
                                               "tiny_audio_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.pipeline import ASRPipeline

cfg = tiny_test_config(kv_cache_dtype="int8")
cfg.max_new_tokens = 4
pipe = ASRPipeline(ASRModel(cfg, seed=0))
feats = pipe.processor.extract_features([np.zeros(8000, np.float32)])
tokens = pipe.model.generate(feats["input_features"], feats["audio_attention_mask"])
assert tokens.shape == (1, 4), tokens.shape
assert isinstance(pipe(np.zeros(4000, np.float32))["text"], str)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not loaded, loaded
print("OK", len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
