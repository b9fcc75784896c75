"""Speaker diarization (ECAPA-TDNN, the clusterer, ``diarize``) in the port vs
the JAX package, on the CPU.

ECAPA runs on the checked-in synthetic tier (byte-identical copy) and on a
JAX-written ``ecapa_embedder.msgpack`` of another geometry; embeddings agree
within 1e-4.  The clusterer is compared on the same embeddings first (its
eigen solver and k-means are numpy, copied), then ``diarize`` end to end on a
two-voice synthetic conversation.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import serialization

from tiny_audio_tpu import diarization as jax_diarization
from tiny_audio_tpu.models.ecapa import EcapaTDNN as JaxEcapaTDNN
from tiny_audio_tpu_torch import diarization
from tiny_audio_tpu_torch.utils.speech_synth import synth_conversation

torch.set_num_threads(1)

EMBED_ATOL = 1e-4


@pytest.fixture(scope="module")
def conversation():
    audio, truth, _ = synth_conversation(16.0, n_speakers=2, seed=0)
    return audio, truth


@pytest.fixture(scope="module")
def synthetic():
    return jax_diarization.EcapaEmbedder.from_synthetic(), \
        diarization.EcapaEmbedder.from_synthetic(device="cpu")


def _windows(audio, seconds=8.0):
    segments = diarization.decisions_to_segments(diarization.frame_vad(audio[:int(seconds * 16000)]))
    windows, spans = diarization.sliding_windows(audio, segments)
    want_w, want_s = jax_diarization.sliding_windows(audio, segments)
    np.testing.assert_array_equal(windows, want_w)
    assert spans == want_s
    return windows


def test_synthetic_weights_are_the_jax_packages():
    assert diarization.EcapaEmbedder.SYNTH_WEIGHTS.read_bytes() == \
        jax_diarization.EcapaEmbedder._synth_weights_path().read_bytes()


@pytest.mark.parametrize("batch,frames", [(1, 75), (4, 75), (3, 160)])
def test_ecapa_synthetic_tier_matches_jax(synthetic, batch, frames):
    jax_emb, emb = synthetic
    feats = np.random.default_rng(batch).standard_normal((batch, frames, 80)).astype(np.float32)
    want = np.asarray(jax_emb._apply(jax_emb.params, jnp.asarray(feats)))
    with torch.inference_mode():
        got = emb.module(torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (batch, 192)
    np.testing.assert_allclose(got, want, atol=EMBED_ATOL * max(1.0, np.abs(want).max()), rtol=0)
    assert emb.tier == "synthetic" and emb.trained
    assert all(p.dtype == torch.float32 for p in emb.module.parameters())


@pytest.mark.parametrize("n", [1, 5, 16])
def test_embed_windows_matches_jax(synthetic, conversation, n):
    jax_emb, emb = synthetic
    windows = _windows(conversation[0])[:n]
    want = jax_emb.embed_windows(windows)
    got = emb.embed_windows(windows)
    assert got.shape == (n, 192)
    np.testing.assert_allclose(got, want, atol=EMBED_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_from_converted_other_geometry(tmp_path, conversation):
    """A JAX-written ``ecapa_embedder.msgpack`` with 64 channels, a 32-wide
    embedding and 16 attention channels: the geometry comes from the shapes."""
    module = JaxEcapaTDNN(channels=(64, 64, 64, 64, 192), embed_dim=32, attention_channels=16)
    params = module.init(jax.random.PRNGKey(3), jnp.zeros((1, 75, 80)))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(  # non-trivial BatchNorm statistics
        lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.random(x.shape).astype(np.float32)),
        params)
    path = tmp_path / "ecapa_embedder.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    want_emb = jax_diarization.EcapaEmbedder.from_converted(path)
    got_emb = diarization.EcapaEmbedder.from_converted(path, device="cpu")
    assert got_emb.tier == "speechbrain" and got_emb.embed_dim == 32
    windows = _windows(conversation[0])[:6]
    np.testing.assert_allclose(got_emb.embed_windows(windows), want_emb.embed_windows(windows),
                               atol=EMBED_ATOL, rtol=0)
    got_emb.load_weights(path)  # the same geometry loads in place
    assert got_emb.tier == "speechbrain"


@pytest.mark.parametrize("kwargs", [{}, {"num_speakers": 2}, {"num_speakers": 3},
                                    {"min_speakers": 2, "max_speakers": 4}])
def test_clusterer_labels_match_on_same_embeddings(synthetic, conversation, kwargs):
    jax_emb, _ = synthetic
    audio = conversation[0]
    segments = jax_diarization.decisions_to_segments(jax_diarization.frame_vad(audio))
    windows, _ = jax_diarization.sliding_windows(audio, segments)
    emb = jax_emb.embed_windows(windows)
    emb[3] = np.nan  # the NaN guard
    want = jax_diarization.SpeakerClusterer(**kwargs)(emb)
    got = diarization.SpeakerClusterer(**kwargs)(emb)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 2


@pytest.fixture()
def fresh_singletons(monkeypatch):
    """Both packages' default embedders: the synthetic tier."""
    monkeypatch.setattr(jax_diarization.EcapaEmbedder, "_instance",
                        jax_diarization.EcapaEmbedder.from_synthetic())
    monkeypatch.setattr(diarization.EcapaEmbedder, "_instances", {})


@pytest.mark.parametrize("kwargs", [{}, {"num_speakers": 2}])
def test_diarize_matches_jax(conversation, fresh_singletons, kwargs):
    audio, truth = conversation
    want = jax_diarization.SpeakerDiarizer.diarize(audio, **kwargs)
    got = diarization.SpeakerDiarizer.diarize(audio, device="cpu", **kwargs)
    assert got == want
    assert {seg["speaker"] for seg in got} == {"SPEAKER_00", "SPEAKER_01"}
    assert all(seg.get("embedder") == "synthetic" and "vad_fallback" not in seg for seg in got)
    assert diarization.EcapaEmbedder.get("cpu").tier == "synthetic"


def test_diarize_resamples_like_jax(conversation, fresh_singletons):
    audio = conversation[0][: 8 * 16000]
    from tiny_audio_tpu_torch.utils.audio_io import resample

    audio8k = resample(audio, 16000, 8000)
    want = jax_diarization.SpeakerDiarizer.diarize(audio8k, sample_rate=8000)
    got = diarization.SpeakerDiarizer.diarize(audio8k, sample_rate=8000, device="cpu")
    assert got == want and got


def test_assign_speakers_to_words_matches_jax():
    segments = [{"speaker": "SPEAKER_00", "start": 0.0, "end": 1.2},
                {"speaker": "SPEAKER_01", "start": 1.5, "end": 3.0}]
    words = [{"word": "a", "start": 0.1, "end": 0.3}, {"word": "b", "start": 1.25, "end": 1.45},
             {"word": "c", "start": 2.0, "end": 2.4}, {"word": "d", "start": 3.5, "end": 3.9},
             {"word": "e"}]
    for segs in (segments, []):
        assert diarization.SpeakerDiarizer.assign_speakers_to_words(words, segs) == \
            jax_diarization.SpeakerDiarizer.assign_speakers_to_words(words, segs)


def test_decisions_to_segments_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        decisions = rng.random(400) < 0.6
        decisions[rng.integers(0, 400, 40)] = False
        assert diarization.decisions_to_segments(decisions, total_duration=6.0) == \
            jax_diarization.decisions_to_segments(decisions, total_duration=6.0)


def test_one_embedder_per_device(monkeypatch):
    monkeypatch.setattr(diarization.EcapaEmbedder, "_instances", {})
    emb = diarization.EcapaEmbedder.get("cpu")
    assert diarization.EcapaEmbedder.get("cpu") is emb and emb.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            diarization.EcapaEmbedder.get()
