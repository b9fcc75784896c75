"""The serving slice as a whole: the PyTorch port vs the JAX package, on the CPU.

The JAX model's random params are carried into the port; greedy decoding
must then give the same tokens, for both KV-cache dtypes and both decode
paths, the pipelines the same texts and streaming the same fragments.  A
subprocess imports every module of the port (the training package
included) with jax, flax and the JAX package blocked, serves a checkpoint
and runs a stage-2 train step.
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
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
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
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
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
    tf = ASRProcessor(tm.projector, num_mel_bins=80, device="cpu").extract_features(audio)
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


@pytest.mark.parametrize("fused", [True, False])
def test_generate_token_exact_both_decode_paths(pair, fused):
    """The fused step (one append+attend per layer) and the module step
    (attention, then the cache write) are both token-exact with JAX.  The
    gate keeps the fused step off on the CPU, so it is asked for here."""
    jm, tm = pair
    audio = _audio((1.0, 0.55, 0.3))
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features(audio)
    tf = ASRProcessor(tm.projector, num_mel_bins=80, device="cpu").extract_features(audio)
    want = jm.generate(jf["input_features"], jf["audio_attention_mask"], min_new_tokens=8)
    got = tm.generate(tf["input_features"], tf["audio_attention_mask"], min_new_tokens=8,
                      fused_decode=fused)
    np.testing.assert_array_equal(got, want)


def _stream_both(jm, tm, audio):
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features([audio])
    tf = ASRProcessor(tm.projector, num_mel_bins=80, device="cpu").extract_features([audio])
    want = list(jm.generate_streaming(jf["input_features"], jf["audio_attention_mask"]))
    got = list(tm.generate_streaming(tf["input_features"], tf["audio_attention_mask"]))
    return tf["input_features"].shape[-1], want, got


@pytest.mark.parametrize("seconds", [0.8, 7.0])
def test_generate_streaming_same_fragments(pair, seconds):
    """Short clips stream from one window; a clip longer than the encoder
    window (512 mel frames here) is streamed window by window."""
    jm, tm = pair
    frames, want, got = _stream_both(jm, tm, _audio((seconds,), seed=3)[0])
    assert (frames > tm.mel_window_frames()) == (seconds > 5.12)
    assert got == want
    assert all(isinstance(f, str) for f in got)


def test_streaming_pipeline_same_fragments(pair):
    jm, tm = pair
    clip = _audio((1.5,), seed=4)[0]
    assert list(ASRPipeline(tm).transcribe_streaming(clip)) == list(
        JaxASRPipeline(jm).transcribe_streaming(clip))


@pytest.mark.parametrize("chunks", [
    ["hel", "lo <thi", "nk>secret</th", "ink> world"],
    ["a</think>b<think>c", "</think>d"],
    ["<think>never closed", " still"],
    ["x <thi"],
    ["plain ", "text"],
    ["</think>hi <think>", "x", "</think>", "y<th", "ink>z</think>"],
])
def test_filter_think_stream_matches_jax(chunks):
    from tiny_audio_tpu.models.asr import filter_think_stream as jax_filter
    from tiny_audio_tpu_torch.models.asr import filter_think_stream

    assert list(filter_think_stream(iter(chunks))) == list(jax_filter(iter(chunks)))


def test_port_configs_and_text_layer_match_jax():
    """The port's own copies of config, tokenizer and post-processing."""
    from tiny_audio_tpu import config as jcfg, pipeline as jpipe, tokenization as jtok
    from tiny_audio_tpu_torch import config as pcfg, pipeline as ppipe, tokenization as ptok

    for overrides in ({}, {"kv_cache_dtype": "int8", "model_dtype": "float32"}):
        assert pcfg.tiny_test_config(**overrides).to_dict() == \
            jcfg.tiny_test_config(**overrides).to_dict()
    assert pcfg.ASRConfig().to_dict() == jcfg.ASRConfig().to_dict()
    d = jcfg.tiny_test_config(kv_cache_dtype="int8").to_dict()
    assert pcfg.ASRConfig.from_dict(d).to_dict() == jcfg.ASRConfig.from_dict(d).to_dict()
    for n in (1, 500, 3000, 4700):
        assert pcfg.compute_encoder_output_length(n) == jcfg.compute_encoder_output_length(n)
    assert pcfg.DEFAULT_ENCODER_CONV_LAYERS == jcfg.DEFAULT_ENCODER_CONV_LAYERS

    pt, jt = ptok.ByteTokenizer(512), jtok.ByteTokenizer(512)
    assert ptok.AUDIO_TOKEN == jtok.AUDIO_TOKEN
    assert (pt.audio_token_id, pt.eos_token_ids, pt.pad_token_id) == \
        (jt.audio_token_id, jt.eos_token_ids, jt.pad_token_id)
    msgs = [{"role": "system", "content": "sys"},
            {"role": "user", "content": "<audio><audio> hi"},
            {"role": "assistant", "content": "ok"}]
    for gen_prompt in (True, False):
        assert pt.apply_chat_template(msgs, add_generation_prompt=gen_prompt) == \
            jt.apply_chat_template(msgs, add_generation_prompt=gen_prompt)
        assert pt.apply_chat_template(msgs, tokenize=False, add_generation_prompt=gen_prompt) == \
            jt.apply_chat_template(msgs, tokenize=False, add_generation_prompt=gen_prompt)
    ids = pt.encode("héllo <think>x</think> wörld<|im_end|>")
    assert ids == jt.encode("héllo <think>x</think> wörld<|im_end|>")
    assert pt.decode(ids, skip_special_tokens=False) == jt.decode(ids, skip_special_tokens=False)

    for text in ("no444444", "the the the", "i am sorry i am sorry i am sorry",
                 "a b c d e f g", "ok ok", ""):
        assert ppipe.truncate_repetitions(text) == jpipe.truncate_repetitions(text)


def test_postprocess_tokens_matches_jax(pair):
    jm, tm = pair
    jp, tp = JaxASRPipeline(jm), ASRPipeline(tm)
    tok = tm.tokenizer
    for text in ("<think>hmm</think> hello hello hello", "plain words", "xx<|im_end|>yy"):
        ids = np.asarray(tok.encode(text) + [tok.pad_token_id] * 3)
        assert tp.postprocess_tokens(ids) == jp.postprocess_tokens(ids)


def test_entry_points_default_to_cuda():
    """Without a device the model and processor target the card; on a
    machine without one they raise instead of running on the CPU."""
    from tiny_audio_tpu_torch.config import tiny_test_config as port_tiny

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would build there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ASRModel(port_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ASRProcessor()
    assert ASRProcessor(device="cpu").device.type == "cpu"


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
    feats = ASRProcessor(tm.projector, num_mel_bins=80, device="cpu").extract_features(audio)
    for override in ({"do_sample": True}, {"num_beams": 2}, {"no_repeat_ngram_size": 3}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.generate(feats["input_features"], feats["audio_attention_mask"], **override)


_NO_JAX_SCRIPT = r"""
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "tiny_audio_tpu"):
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
from tiny_audio_tpu_torch.config import tiny_test_config
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.pipeline import ASRPipeline

cfg = tiny_test_config(kv_cache_dtype="int8")
cfg.max_new_tokens = 4
pipe = ASRPipeline(ASRModel(cfg, seed=0, device="cpu"))
feats = pipe.processor.extract_features([np.zeros(8000, np.float32)])
for fused in (True, False):
    tokens = pipe.model.generate(feats["input_features"], feats["audio_attention_mask"],
                                 fused_decode=fused)
    assert tokens.shape == (1, 4), tokens.shape
assert isinstance(pipe(np.zeros(4000, np.float32))["text"], str)
assert all(isinstance(f, str) for f in pipe.transcribe_streaming(np.zeros(4000, np.float32)))

# a checkpoint round trip and the server over it, with msgpack blocked too
import json, tempfile, threading, urllib.request
from tiny_audio_tpu_torch.batching import DynamicBatcher
from tiny_audio_tpu_torch.handler import EndpointHandler
from tiny_audio_tpu_torch.serving import make_server

ckpt = tempfile.mkdtemp()
pipe.model.save_pretrained(ckpt)
handler = EndpointHandler(ckpt, device="cpu", w8a8_decode=True)
for (name, a), (_, b) in zip(pipe.model.named_parameters(), handler.pipe.model.named_parameters()):
    assert a.dtype == b.dtype and torch.equal(a, b), name
batcher = DynamicBatcher(handler.pipe)
server = make_server(handler, host="127.0.0.1", port=0, batcher=batcher)
threading.Thread(target=server.serve_forever, daemon=True).start()
req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/transcribe",
                             data=np.zeros(8000, np.float32).tobytes(),
                             headers={"Content-Type": "application/pcm-f32"})
with urllib.request.urlopen(req, timeout=120) as r:
    assert isinstance(json.loads(r.read())["text"], str)
batcher.close()
server.shutdown()

# one stage-2 train step (LoRA, checkpointed blocks) and its model/ save
from tiny_audio_tpu_torch.train.collator import DataCollator
from tiny_audio_tpu_torch.train.data import synthetic_dataset
from tiny_audio_tpu_torch.train.optim import OptimizerConfig, build_optimizer, make_train_step

train_cfg = tiny_test_config(use_lora=True, freeze_projector=True, gradient_checkpointing=True)
model = ASRModel(train_cfg, seed=0, device="cpu")
collator = DataCollator(model.tokenizer, model.projector, num_mel_bins=80, device="cpu")
opt, labels = build_optimizer(train_cfg, OptimizerConfig(), model)
before = model.decoder.layers[0].q_proj_lora_b.detach().clone()
loss, metrics = make_train_step(model, opt)(collator(synthetic_dataset(2, seed=0)))
assert torch.isfinite(loss) and float(metrics["grad_norm"]) > 0
assert not torch.equal(before, model.decoder.layers[0].q_proj_lora_b)
model.save_pretrained(ckpt + "/stage2", save_towers=False)
back = ASRModel.from_pretrained(ckpt + "/stage2", device="cpu")
assert torch.equal(back.decoder.layers[0].q_proj_lora_b, model.decoder.layers[0].q_proj_lora_b)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "tiny_audio_tpu"))
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
