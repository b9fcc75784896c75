"""The neural VAD (``tiny_audio_tpu_torch.vad``) vs the JAX package, on the CPU.

Both read the checked-in weights (the port's copy is byte-identical); the
features, the network's probabilities at every length bucket and on a tiled
clip, the streaming VAD, ``frame_vad_auto`` and the heuristic ``frame_vad``
must agree.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tiny_audio_tpu import vad as jax_vad
from tiny_audio_tpu import diarization as jax_diarization
from tiny_audio_tpu_torch import diarization, vad
from tiny_audio_tpu_torch.utils.speech_synth import synth_utterance

torch.set_num_threads(1)

FEATURE_ATOL = 1e-6
PROB_ATOL = 1e-5


def _clip(n_frames: int, seed: int = 0) -> np.ndarray:
    """Synthetic speech with background noise, ``n_frames`` hops long plus a
    partial hop."""
    n = n_frames * vad.HOP + 100
    speech, _ = synth_utterance(n / 16000 + 0.1, seed=seed)
    noise = np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 0.01
    return (speech[:n] + noise).astype(np.float32)


def test_weights_are_the_jax_packages():
    assert vad.WEIGHTS_PATH.read_bytes() == jax_vad.WEIGHTS_PATH.read_bytes()


@pytest.mark.parametrize("n_frames", [1, 37, 256, 700])
def test_features_match_jax(n_frames):
    audio = _clip(n_frames, seed=n_frames)
    want = np.asarray(jax_vad.vad_logmel(jnp.asarray(audio)))
    got = vad.vad_logmel(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (n_frames, vad.N_MELS)
    np.testing.assert_allclose(got, want, atol=FEATURE_ATOL * max(1.0, np.abs(want).max()),
                               rtol=0)
    np.testing.assert_array_equal(vad.vad_logmel_np(audio), jax_vad.vad_logmel_np(audio))


@pytest.fixture(scope="module")
def models():
    jax_model = jax_vad.NeuralVAD.get()
    assert jax_model is not None
    return jax_model, vad.NeuralVAD.get("cpu")


@pytest.mark.parametrize("n_frames", [3, 256, 600, 1024, 4096, 4500, 9000])
def test_probabilities_match_jax(models, n_frames):
    """Every bucket (256, 1024, 4096), its edges, and clips past the largest
    bucket, which are tiled with 32 frames of left context."""
    jax_model, model = models
    audio = _clip(n_frames, seed=1)
    want = jax_model.frame_probs(audio)
    got = model.frame_probs(audio)
    assert got.shape == want.shape == (n_frames,)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    if n_frames >= 256:
        assert 0.1 < float((got >= vad.THRESHOLD).mean()) < 0.95


def test_numpy_mirror_matches_the_network(models):
    _, model = models
    audio = _clip(1024, seed=2)
    p = vad._np_params(model.params)
    mirror = vad.frame_probs_with(audio, lambda f: vad.np_vadnet_forward(p, f[0]))
    np.testing.assert_allclose(model.frame_probs(audio), mirror, atol=PROB_ATOL, rtol=0)


def test_one_instance_per_device(models):
    _, model = models
    assert vad.NeuralVAD.get("cpu") is model and model.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vad.NeuralVAD.get()


@pytest.mark.parametrize("chunks", [[16000], [512, 511, 1, 3000, 12000],
                                    [100] * 160 + [5000], [256] * 80])
def test_streaming_vad_matches_jax(chunks):
    audio = _clip(600, seed=3)
    want_vad, got_vad = jax_vad.StreamingVad.make(), vad.StreamingVad.make()
    pos = 0
    for size in chunks * 4:
        piece = audio[pos:pos + size]
        pos += size
        np.testing.assert_array_equal(got_vad.feed(piece), want_vad.feed(piece))
        if pos >= len(audio):
            break
    got_vad.reset(keep_level=True), want_vad.reset(keep_level=True)
    np.testing.assert_array_equal(got_vad.feed(audio[:9000]), want_vad.feed(audio[:9000]))


@pytest.mark.parametrize("sample_rate", [16000, 8000])
def test_frame_vad_auto_matches_jax(sample_rate):
    audio = _clip(900, seed=4)[: 900 * vad.HOP * sample_rate // 16000]
    want, want_trained = jax_vad.frame_vad_auto(audio, sample_rate)
    got, got_trained = vad.frame_vad_auto(audio, sample_rate, device="cpu")
    assert got_trained and want_trained
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 5])
def test_heuristic_frame_vad_matches_jax_numpy_path(monkeypatch, seed):
    from tiny_audio_tpu import native
    from tiny_audio_tpu_torch import native as port_native

    monkeypatch.setattr(native, "vad_features", lambda audio, hop: None)
    monkeypatch.setattr(port_native, "vad_features", lambda audio, hop: None)
    audio = _clip(700, seed=seed)
    audio[: 50 * vad.HOP] *= 0.01  # a quiet lead-in
    want = jax_diarization.frame_vad(audio)
    got = diarization.frame_vad(audio)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
