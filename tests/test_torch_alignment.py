"""Forced alignment (wav2vec2-CTC, the CTC trellis, ``ForcedAligner``), the
checkpoint's auxiliary towers and the pipeline's timestamps and speakers:
the port vs the JAX package, on the CPU.

wav2vec2 runs at its full width (the widths are module constants): its
~95 M parameters are drawn with numpy from a seed in the shapes of JAX's
``eval_shape`` and written as the flax file both packages load.  Random
weights give near-flat emissions, on which two correct Viterbi passes can
part on near-ties, so timestamps are compared on one and the same emission
matrix and the emissions separately.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import serialization

from tiny_audio_tpu import alignment as jax_alignment
from tiny_audio_tpu import diarization as jax_diarization
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.models.ecapa import EcapaTDNN as JaxEcapaTDNN
from tiny_audio_tpu.models.wav2vec2 import Wav2Vec2CTC as JaxWav2Vec2CTC
from tiny_audio_tpu.ops.ctc import ctc_backtrack as jax_ctc_backtrack
from tiny_audio_tpu.ops.ctc import ctc_trellis as jax_ctc_trellis
from tiny_audio_tpu.pipeline import ASRPipeline as JaxASRPipeline
from tiny_audio_tpu_torch import alignment, diarization
from tiny_audio_tpu_torch.bridge import load_flax_tower, load_jax_params, tower_flax_tree
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.models.wav2vec2 import Wav2Vec2CTC, conv_frame_count
from tiny_audio_tpu_torch.ops.ctc import ctc_backtrack, ctc_trellis
from tiny_audio_tpu_torch.pipeline import ASRPipeline
from tiny_audio_tpu_torch.utils.speech_synth import synth_conversation

torch.set_num_threads(1)

EMISSION_ATOL = 1e-4
TRELLIS_ATOL = 1e-5
TIME_ATOL = 1e-3  # seconds
CLIP_SAMPLES = 52800  # 3.3 s: padded to the 5 s bucket


def seeded_tree(shapes, seed: int = 0) -> dict:
    """Parameters of the given flax shapes from numpy: kernels N(0, 1/fan_in),
    norm scales near 1, biases near 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = path[-1].key
        draw = rng.standard_normal(shape.shape, np.float32)
        if name == "kernel":
            value = draw / np.sqrt(np.prod(shape.shape[:-1]))
        elif name == "scale":
            value = 1.0 + 0.1 * draw
        else:
            value = 0.1 * draw
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def aligner_file(tmp_path_factory):
    shapes = jax.eval_shape(JaxWav2Vec2CTC().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1280), jnp.float32))["params"]
    path = tmp_path_factory.mktemp("aligner") / "wav2vec2_aligner.msgpack"
    path.write_bytes(serialization.to_bytes(seeded_tree(shapes)))
    return path


@pytest.fixture(scope="module")
def aligners(aligner_file):
    """Both packages' aligners loaded from the same JAX-written file (the
    process-wide state is restored afterwards)."""
    saved_jax = (jax_alignment.ForcedAligner._model, jax_alignment.ForcedAligner._params,
                 jax_alignment.ForcedAligner._jit_apply)
    saved = (alignment.ForcedAligner._tree, alignment.ForcedAligner._model)
    jax_alignment.ForcedAligner.load_weights(aligner_file)
    alignment.ForcedAligner.load_weights(aligner_file, device="cpu")
    yield jax_alignment.ForcedAligner, alignment.ForcedAligner
    (jax_alignment.ForcedAligner._model, jax_alignment.ForcedAligner._params,
     jax_alignment.ForcedAligner._jit_apply) = saved_jax
    alignment.ForcedAligner._tree, alignment.ForcedAligner._model = saved


def _speech(n_samples=CLIP_SAMPLES, seed=0):
    audio, _, _ = synth_conversation(n_samples / 16000 + 0.2, seed=seed)
    return audio[:n_samples]


def test_emissions_unpadded_match_jax(aligners):
    jax_aligner, aligner = aligners
    audio = _speech()
    want = np.asarray(jax_aligner._model.apply({"params": jax_aligner._params},
                                               jnp.asarray(audio[None])))[0]
    with torch.inference_mode():
        got = aligner._model_on("cpu")(torch.from_numpy(audio[None]))[0].numpy()
    assert got.shape == want.shape == (conv_frame_count(len(audio)), 29)
    np.testing.assert_allclose(got, want, atol=EMISSION_ATOL, rtol=0)


def test_emissions_bucket_padded_match_jax(aligners):
    jax_aligner, aligner = aligners
    audio = _speech()
    want = jax_aligner._emissions(audio)
    got = aligner._emissions(audio, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=EMISSION_ATOL, rtol=0)
    with torch.inference_mode():
        unpadded = aligner._model_on("cpu")(torch.from_numpy(audio[None]))[0].numpy()
    np.testing.assert_allclose(got, unpadded, atol=EMISSION_ATOL, rtol=0)


def test_bridge_round_trip(aligner_file):
    from tiny_audio_tpu_torch.utils import msgpack_io

    tree = msgpack_io.load(aligner_file)
    model = Wav2Vec2CTC()
    load_flax_tower(model, tree)
    back = tower_flax_tree(model)
    assert back["pos_conv"]["kernel"].shape == (128, 48, 768)
    assert model.pos_conv.weight.shape == (768, 48, 128)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for path, value in jax.tree_util.tree_flatten_with_path(back)[0]:
        assert torch.equal(value, flat[path]), path
    with pytest.raises(KeyError, match="no counterpart"):
        load_flax_tower(model, {**tree, "extra": {"kernel": torch.zeros(2, 2)}})
    with pytest.raises(KeyError, match="left unset"):
        load_flax_tower(model, {k: v for k, v in tree.items() if k != "ctc_head"})


def _emission(aligners, seed=0):
    return aligners[0]._emissions(_speech(seed=seed))


@pytest.mark.parametrize("text", ["HELLO WORLD", "the quick brown fox", "A 123 b $5 C!"])
def test_ctc_trellis_matches_jax(aligners, text):
    emission = _emission(aligners)
    tokens = np.asarray(alignment.ForcedAligner.tokenize_transcript(text), np.int32)
    assert tokens.tolist() == jax_alignment.ForcedAligner.tokenize_transcript(text)
    want_t, want_m = jax_ctc_trellis(jnp.asarray(emission), jnp.asarray(tokens))
    got_t, got_m = ctc_trellis(torch.tensor(emission), torch.from_numpy(tokens))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=TRELLIS_ATOL, rtol=0)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    spans = ctc_backtrack(got_t.numpy(), got_m.numpy(), tokens)
    assert spans == jax_ctc_backtrack(np.asarray(want_t), np.asarray(want_m), tokens)


def test_ctc_backtrack_fallback_and_mismatch():
    tokens = np.array([3, 4, 5])
    trellis = np.full((3, 4), -1e30, np.float32)
    trellis[0, 0] = 0.0
    assert ctc_backtrack(trellis, np.zeros((2, 4), bool), tokens) == \
        jax_ctc_backtrack(trellis, np.zeros((2, 4), bool), tokens)
    trellis[2, 3] = -1.0
    with pytest.raises(ValueError, match="inconsistent"):
        ctc_backtrack(trellis, np.zeros((2, 4), bool), tokens)
    assert ctc_backtrack(trellis, np.zeros((2, 4), bool), np.array([])) == []


@pytest.mark.parametrize("text", [
    "HELLO WORLD",
    "the cat sat on the mat twice",
    "call 911 now",          # a word made only of digits
    "42 is the answer 7",    # digit words at both ends
    "$5 !!",                 # no token at all
    "",
])
def test_align_emissions_matches_jax(aligners, text):
    emission = _emission(aligners, seed=1)
    want = jax_alignment.ForcedAligner.align_emissions(emission, text, 0.02)
    got = alignment.ForcedAligner.align_emissions(emission, text, 0.02)
    assert got == want
    got_t = alignment.ForcedAligner.align_emissions(torch.tensor(emission), text, 0.02)
    assert got_t == want


def test_align_matches_jax(aligners):
    audio = _speech(seed=2)
    text = "one two three 4 five"
    emission = aligners[0]._emissions(audio)
    want = jax_alignment.ForcedAligner.align_emissions(emission, text, 0.02)
    got = alignment.ForcedAligner.align_emissions(emission, text, 0.02)
    assert got == want  # the same emission: the same words
    got = alignment.ForcedAligner.align(audio, text, device="cpu")
    assert [w["word"] for w in got] == text.split()
    assert [bool(w.get("fallback")) for w in got] == [False, False, False, True, False]


def test_uniform_spread_without_aligner(monkeypatch):
    monkeypatch.setattr(jax_alignment.ForcedAligner, "_params", None)
    monkeypatch.setattr(alignment.ForcedAligner, "_tree", None)
    audio = np.zeros(44100, np.float32)
    for text in ("a b c", ""):
        want = jax_alignment.ForcedAligner.align(audio, text, sample_rate=22050)
        got = alignment.ForcedAligner.align(audio, text, sample_rate=22050, device="cpu")
        assert got == want
        assert all(w["fallback"] for w in got)


def test_attach_aux_towers_loads_jax_files(tmp_path, aligner_file, monkeypatch, capsys):
    monkeypatch.setattr(alignment.ForcedAligner, "_tree", None)
    monkeypatch.setattr(alignment.ForcedAligner, "_model", None)
    monkeypatch.setattr(diarization.EcapaEmbedder, "_instances", {})
    (tmp_path / "wav2vec2_aligner.msgpack").write_bytes(aligner_file.read_bytes())
    module = JaxEcapaTDNN(channels=(64, 64, 64, 64, 192), embed_dim=32, attention_channels=16)
    params = module.init(jax.random.PRNGKey(1), jnp.zeros((1, 75, 80)))["params"]
    (tmp_path / "ecapa_embedder.msgpack").write_bytes(serialization.to_bytes(params))
    ASRModel._attach_aux_towers(tmp_path, "cpu")
    assert alignment.ForcedAligner.has_model()
    emb = diarization.EcapaEmbedder.get("cpu")
    assert emb.tier == "speechbrain" and emb.embed_dim == 32
    want = jax_diarization.EcapaEmbedder.from_converted(tmp_path / "ecapa_embedder.msgpack")
    windows = np.random.default_rng(0).standard_normal((3, 12000)).astype(np.float32)
    np.testing.assert_allclose(emb.embed_windows(windows), want.embed_windows(windows),
                               atol=1e-4, rtol=0)

    # an unusable file is reported and skipped
    monkeypatch.setattr(alignment.ForcedAligner, "_tree", None)
    monkeypatch.setattr(diarization.EcapaEmbedder, "_instances", {})
    (tmp_path / "wav2vec2_aligner.msgpack").write_bytes(b"\x81\xa1x\x01")
    (tmp_path / "ecapa_embedder.msgpack").write_bytes(b"junk")
    ASRModel._attach_aux_towers(tmp_path, "cpu")
    out = capsys.readouterr().out
    assert "aligner weights unusable" in out and "ecapa weights unusable" in out
    assert not alignment.ForcedAligner.has_model()
    assert "cpu" not in diarization.EcapaEmbedder._instances


@pytest.fixture(scope="module")
def pipelines(aligners):
    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 24
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return JaxASRPipeline(jm), ASRPipeline(tm)


def test_from_pretrained_attaches_aux_towers(tmp_path, pipelines, aligner_file, monkeypatch):
    monkeypatch.setattr(alignment.ForcedAligner, "_tree", None)
    monkeypatch.setattr(alignment.ForcedAligner, "_model", None)
    _, pipe = pipelines
    pipe.model.save_pretrained(tmp_path)
    (tmp_path / "wav2vec2_aligner.msgpack").write_bytes(aligner_file.read_bytes())
    ASRModel.from_pretrained(tmp_path, device="cpu")
    assert alignment.ForcedAligner.has_model()


def _same_words(got, want):
    assert [{k: v for k, v in w.items() if k not in ("start", "end")} for w in got] == \
        [{k: v for k, v in w.items() if k not in ("start", "end")} for w in want]
    for g, w in zip(got, want):
        assert abs(g["start"] - w["start"]) <= TIME_ATOL and abs(g["end"] - w["end"]) <= TIME_ATOL


def test_pipeline_timestamps_and_speakers_match_jax(pipelines, monkeypatch):
    monkeypatch.setattr(jax_diarization.EcapaEmbedder, "_instance",
                        jax_diarization.EcapaEmbedder.from_synthetic())
    monkeypatch.setattr(diarization.EcapaEmbedder, "_instances", {})
    jax_pipe, pipe = pipelines
    audio, _, _ = synth_conversation(4.6, n_speakers=2, seed=3, turn_s=(1.2, 1.8))
    kwargs = dict(return_timestamps=True, return_speakers=True, min_new_tokens=24,
                  no_repeat_ngram_size=2)
    want = jax_pipe(audio, **kwargs)
    got = pipe(audio, **kwargs)
    assert "timestamp_error" not in got and "diarization_error" not in got
    assert "timestamp_error" not in want and "diarization_error" not in want
    assert got["text"] == want["text"]
    assert any(not w.get("fallback") for w in got["words"]), got["words"]
    _same_words(got["words"], want["words"])
    assert len(got["speaker_segments"]) == len(want["speaker_segments"]) > 0
    for g, w in zip(got["speaker_segments"], want["speaker_segments"]):
        assert g["speaker"] == w["speaker"] and g.keys() == w.keys()
        assert abs(g["start"] - w["start"]) <= TIME_ATOL and abs(g["end"] - w["end"]) <= TIME_ATOL
