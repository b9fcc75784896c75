"""The serving slice as a whole: the PyTorch port vs the JAX package, on the CPU.

The JAX model's random params are carried into the port; greedy decoding
must then give the same tokens, for both KV-cache dtypes and both decode
paths, the pipelines the same texts and streaming the same fragments.  A
subprocess imports every module of the port (the training package
included) with jax, flax, msgpack, transformers, websockets, websocket-client
and the JAX package blocked, serves a checkpoint over HTTP and over the
realtime WebSocket server, runs ``run_eval`` through the realtime backend and
the pipecat service under a stub ``pipecat``, runs a stage-2 train step,
builds the MOSA, MoE and QFormer projectors, runs the convergence ladder's
pieces, beams and sampling, the neural VAD, diarization and the aligner,
serves over a tp = 2 grid of two rank processes (the started rank imports
none of the blocked packages either), and runs the profiler, the stage split
of ``tools/bench_stages`` and the backpressure part of
``tools/bench_serving``.
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
    tproc = ASRProcessor(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    tf = tproc.extract_features(audio)
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
    tproc = ASRProcessor(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    tf = tproc.extract_features(audio)
    want = jm.generate(jf["input_features"], jf["audio_attention_mask"], min_new_tokens=8)
    got = tm.generate(tf["input_features"], tf["audio_attention_mask"], min_new_tokens=8,
                      fused_decode=fused)
    np.testing.assert_array_equal(got, want)


def _stream_both(jm, tm, audio):
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features([audio])
    tproc = ASRProcessor(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    tf = tproc.extract_features([audio])
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
    from tiny_audio_tpu_torch.tokenization import ByteTokenizer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would build there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ASRModel(port_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ASRProcessor(ByteTokenizer())
    assert ASRProcessor(ByteTokenizer(), device="cpu").device.type == "cpu"


def test_processor_signature_is_the_jax_packages():
    """The JAX package's parameters in its order, ``device`` last: a JAX
    caller's positional tokenizer no longer lands in ``projector``."""
    import inspect

    ours = list(inspect.signature(ASRProcessor).parameters.values())
    theirs = list(inspect.signature(JaxASRProcessor).parameters.values())
    assert [(p.name, p.default) for p in ours[:-1]] == [(p.name, p.default) for p in theirs]
    assert ours[-1].name == "device" and ours[-1].default == "cuda"


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


_NO_JAX_SCRIPT = r"""
import functools, importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "tiny_audio_tpu",
                                  "transformers", "websockets", "websocket", "safetensors",
                                  "huggingface_hub"):
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

# a world of two ranks: the handler over a tp=2 grid of CPU ranks; the started
# rank imports none of the blocked packages either
from tiny_audio_tpu_torch.parallel.launch import Probe

grid = EndpointHandler(ckpt, device="cpu", tp=2)
assert isinstance(grid({"inputs": np.zeros(8000, np.float32)})["text"], str)
rank_modules = grid.mesh.dispatch(Probe.place(grid.mesh), "loaded_modules", (), {},
                                  gather=True)[1]
assert "tiny_audio_tpu_torch.models.asr" in rank_modules
blocked = [m for m in rank_modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "tiny_audio_tpu")]
assert not blocked, blocked
grid.close()
server.shutdown()

# a realtime session (the port's server and client, the neural stream VAD),
# run_eval through the realtime backend, and the pipecat service under a stub
import asyncio, contextlib, importlib, io, types
from tiny_audio_tpu_torch.eval.cli import run_eval
from tiny_audio_tpu_torch.integrations import pipecat_stt
from tiny_audio_tpu_torch.realtime import RealtimeServer
from tiny_audio_tpu_torch.utils.speech_synth import synth_utterance
from tiny_audio_tpu_torch.utils.websocket import connect

rt = RealtimeServer(handler.pipe, host="127.0.0.1", port=0, partial_every_s=1e9).start()
assert rt.vad_fn is None
speech = np.concatenate([np.zeros(8000, np.float32), synth_utterance(1.5, seed=21)[0],
                         np.zeros(20000, np.float32)])
with connect(f"ws://127.0.0.1:{rt.port}/ws?sample_rate=16000") as ws:
    ws.send((np.clip(speech, -1, 1) * 32767).astype("<i2").tobytes())
    ws.send(json.dumps({"type": "Terminate"}))
    msgs = [json.loads(ws.recv(timeout=60))]
    while msgs[-1]["type"] != "Termination":
        msgs.append(json.loads(ws.recv(timeout=60)))
assert sum(m["type"] == "Turn" and m["end_of_turn"] for m in msgs) == 1, msgs
rt.shutdown()
with contextlib.redirect_stdout(io.StringIO()):  # its "Results saved to" line
    metrics = run_eval(ckpt, "synthetic", num_samples=1, backend="realtime",
                       output_dir=tempfile.mkdtemp(), device="cpu")
assert metrics["num_samples"] == 1 and "turns_avg" in metrics, metrics

stub = {name: types.ModuleType(name) for name in (
    "pipecat", "pipecat.frames", "pipecat.frames.frames", "pipecat.services",
    "pipecat.services.stt_service", "pipecat.utils", "pipecat.utils.time")}
for name in ("Frame", "ErrorFrame", "InterimTranscriptionFrame", "TranscriptionFrame"):
    setattr(stub["pipecat.frames.frames"], name,
            type(name, (), {"__init__": lambda self, text, *a: setattr(self, "text", text)}))
stub["pipecat.services.stt_service"].SegmentedSTTService = type(
    "SegmentedSTTService", (), {"__init__": lambda self, sample_rate=16000, **kw: None})
stub["pipecat.utils.time"].time_now_iso8601 = lambda: "now"
sys.modules.update(stub)
pipecat_stt = importlib.reload(pipecat_stt)
service = pipecat_stt.TinyAudioSTTService(model_path=ckpt, device="cpu")

async def frames():
    return [type(f).__name__ async for f in service.run_stt(b"\x00\x01" * 8000)]

kinds = asyncio.run(frames())
assert set(kinds) <= {"InterimTranscriptionFrame", "TranscriptionFrame"}, kinds

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

# the MOSA, MoE and QFormer projectors: generate, and a train-mode loss
# whose draws come from a generator (MoE adds its router loss)
from tiny_audio_tpu_torch.processing import ASRProcessor

for kind in ("mosa", "moe", "qformer"):
    model = ASRModel(tiny_test_config(projector_type=kind), seed=0, device="cpu")
    feats = ASRProcessor(model.tokenizer, model.projector, num_mel_bins=80, device="cpu").extract_features(
        [np.zeros(8000, np.float32)])
    tokens = model.generate(feats["input_features"], feats["audio_attention_mask"],
                            max_new_tokens=2)
    assert tokens.shape == (1, 2), (kind, tokens.shape)
    collator = DataCollator(model.tokenizer, model.projector, num_mel_bins=80, device="cpu")
    loss, metrics = model.compute_loss(collator(synthetic_dataset(2, seed=0)), train=True,
                                       generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and (float(metrics["aux_loss"]) > 0) == (kind == "moe")

# WER scoring, synthetic speech and the convergence ladder's pieces
from tiny_audio_tpu_torch.eval.normalizer import TextNormalizer
from tiny_audio_tpu_torch.eval.wer import corpus_wer
from tiny_audio_tpu_torch.train import convergence
from tiny_audio_tpu_torch.utils.speech_synth import labeled_speech_dataset

assert TextNormalizer()("The Colour, twenty-five!") == "the color 25"
assert corpus_wer(["a b"], ["a c"]) == 0.5
rows = labeled_speech_dataset(3, convergence.DEFAULT_VOCAB, seed=0)
model = ASRModel(tiny_test_config(model_dtype="float32"), seed=0, device="cpu")
convergence.load_pretrained_encoder(model, str(convergence.ENCODER_ARTIFACT))
ctc = convergence.pretrain_encoder_ctc(model, rows, rows, convergence.DEFAULT_VOCAB, steps=1,
                                       batch=2, verbose=False)
assert 0.0 <= ctc["token_error_rate"] and len(ctc["curve"]) == 1
assert convergence._wer_eval(model, rows[:1], max_new_tokens=2) >= 0.0

# beams, sampling and n-gram bans; the neural VAD, ECAPA diarization and the
# wav2vec2 aligner attached from a checkpoint directory
from tiny_audio_tpu_torch import alignment, diarization, vad
from tiny_audio_tpu_torch.bridge import tower_flax_tree
from tiny_audio_tpu_torch.models.wav2vec2 import Wav2Vec2CTC
from tiny_audio_tpu_torch.utils import msgpack_io
from tiny_audio_tpu_torch.utils.speech_synth import synth_conversation

model = pipe.model
for kwargs in ({"num_beams": 2, "no_repeat_ngram_size": 2, "fused_decode": True},
               {"num_beams": 2, "fused_decode": False},
               {"do_sample": True, "top_p": 0.9, "generator": torch.Generator().manual_seed(0)}):
    tokens = model.generate(feats["input_features"], feats["audio_attention_mask"], **kwargs)
    assert tokens.shape == (1, 4), (kwargs, tokens.shape)
clip, _, _ = synth_conversation(3.0, n_speakers=2, seed=0)
assert vad.frame_vad_auto(clip, device="cpu")[1]
assert vad.StreamingVad.make().feed(clip).any()
assert diarization.EcapaEmbedder.get("cpu").tier == "synthetic"
msgpack_io.save(ckpt + "/wav2vec2_aligner.msgpack", tower_flax_tree(Wav2Vec2CTC()))
ASRModel._attach_aux_towers(ckpt, "cpu")
assert alignment.ForcedAligner.has_model()
words = alignment.ForcedAligner.align(clip, "one two", device="cpu")
assert [w["word"] for w in words] == ["one", "two"] and not any("fallback" in w for w in words)
result = pipe(clip, return_timestamps=True, return_speakers=True)
assert "timestamp_error" not in result and "diarization_error" not in result, result
assert result["speaker_segments"], result

# the continuous engine on both decode steps, and the three offline tools
from tiny_audio_tpu_torch.continuous import ContinuousEngine
from tiny_audio_tpu_torch.tools import handler_local, train_speaker_embedder, train_vad

from tiny_audio_tpu_torch import continuous, generation

for fused in (False, True):
    continuous.decode_chunk = functools.partial(generation.decode_chunk, fused_decode=fused)
    eng = ContinuousEngine(pipe, n_slots=2, chunk_steps=2)
    futs = [eng.submit(np.zeros(4000, np.float32)) for _ in range(3)]
    assert all(isinstance(f.result(timeout=120), str) for f in futs)
    eng.close()
continuous.decode_chunk = generation.decode_chunk
tools_dir = tempfile.mkdtemp()
with contextlib.redirect_stdout(io.StringIO()):
    train_vad.main(["--device", "cpu", "--steps", "1", "--utts", "2", "--batch", "2",
                    "--out", tools_dir + "/vad.msgpack", "--no-eval"])
    train_speaker_embedder.main(["--device", "cpu", "--steps", "1", "--speakers", "2",
                                 "--utts", "2", "--batch", "2",
                                 "--out", tools_dir + "/ecapa.msgpack", "--no-der"])
    assert handler_local.main(["-m", ckpt, "--device", "cpu"]) == 0
assert vad.NeuralVAD.from_file(tools_dir + "/vad.msgpack", "cpu")(clip).shape
assert diarization.EcapaEmbedder.from_synthetic(tools_dir + "/ecapa.msgpack", "cpu").trained

# HF-layout towers written and converted back, the CLI over the result, the
# host tools: with safetensors, transformers and huggingface_hub blocked too
from pathlib import Path
from tiny_audio_tpu_torch import (analysis, cli, convert, debug, devtools, doctor, export, hub,
                                  native)
from tiny_audio_tpu_torch.bridge import state_dict_to_jax
from tiny_audio_tpu_torch.utils import safetensors_io, subtitles
from tiny_audio_tpu_torch.utils.audio_io import write_wav

model = pipe.model
tree = state_dict_to_jax(model)
root = Path(tempfile.mkdtemp())
audio_cfg, text_cfg = export.tower_config_dicts(model.config)
for sub, sd, tower_cfg in (
        ("enc", export.export_encoder_state(tree["encoder"], model.config.encoder,
                                            "audio_tower."), {"audio_config": audio_cfg}),
        ("dec", export.export_decoder_state(tree["decoder"], model.config.decoder), text_cfg)):
    (root / sub).mkdir()
    safetensors_io.save_file(sd, root / sub / "model.safetensors")
    (root / sub / "config.json").write_text(json.dumps(tower_cfg))
export.export_reference_artifact(model, root / "ref")
config = json.loads((root / "ref" / "config.json").read_text())
(root / "ref" / "config.json").write_text(json.dumps({**config, "kv_cache_dtype": "int8"}))
converted = convert.convert_reference_checkpoint(root / "ref", encoder_path=root / "enc",
                                                 decoder_path=root / "dec",
                                                 output_dir=root / "out", device="cpu")
for (name, a), (_, b) in zip(model.named_parameters(), converted.named_parameters()):
    assert a.dtype == b.dtype and torch.equal(a, b), name
write_wav(root / "a.wav", np.zeros(8000, np.float32))
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert cli.main(["transcribe", "-m", str(root / "out"), str(root / "a.wav"),
                     str(root / "a.wav"), "--json", "--device", "cpu"]) == 0
    assert cli.main(["transcribe", "-m", str(root / "out"), str(root / "a.wav"), "--srt",
                     "--device", "cpu"]) == 0
    assert cli.main(["debug", "check-gradient-flow", "-m", str(root / "out"),
                     "--device", "cpu"]) == 0
assert len([l for l in out.getvalue().splitlines() if l.startswith("{")]) == 2
assert subtitles.to_srt([{"word": "a", "start": 0.0, "end": 0.5}]).startswith("1\n")
assert hub.stage_artifact(root / "out") and not devtools.security_scan([root / "out"])

# the profiler and the serving measurement tools
from tiny_audio_tpu_torch.tools import bench_serving, bench_stages
from tiny_audio_tpu_torch.utils import profiling

assert {"tiny_audio_tpu_torch.utils.profiling", "tiny_audio_tpu_torch.tools.bench_stages",
        "tiny_audio_tpu_torch.tools.bench_serving"} <= set(names)
timer = profiling.StageTimer()
with profiling.trace(root / "traces", device="cpu"), timer.stage("stages"):
    stages = bench_stages.measure_stages(model, 1, reps=1, clip_s=0.5)
assert stages["n_audio"] > 0 and timer.summary()["stages"]["count"] == 1
assert list((root / "traces").glob("*.pt.trace.json"))
with contextlib.redirect_stdout(io.StringIO()) as out:
    burst = bench_serving.bench_backpressure(handler, handler.pipe,
                                             np.zeros(8000, np.float32).tobytes(), burst=6)
assert out.getvalue().startswith("backpressure")
assert burst["n_200"] + burst["n_503"] == 6

loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "tiny_audio_tpu",
                                       "transformers", "websockets", "websocket",
                                       "safetensors", "huggingface_hub"))
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
