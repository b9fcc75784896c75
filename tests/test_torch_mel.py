"""PyTorch mel front-end vs the JAX one, fp32 on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tiny_audio_tpu.ops import mel as jmel
from tiny_audio_tpu_torch.ops import mel as tmel

torch.set_num_threads(1)


def test_constants_identical():
    np.testing.assert_array_equal(
        tmel.mel_filter_bank(201, 80), jmel.mel_filter_bank(201, 80)
    )
    for a, b in zip(tmel._dft_basis(), jmel._dft_basis()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "n_samples,mels,dtype",
    [
        (16000, 80, np.float32),
        (4800, 128, np.float32),
        (160 * 37, 80, np.int16),  # int16 PCM is cast as is, in both packages
        (160, 80, np.float32),  # shorter than N_FFT//2+1: zero padding, not reflect
    ],
)
def test_log_mel_matches_jax(n_samples, mels, dtype):
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((2, n_samples)) * 0.1
    if dtype == np.int16:
        audio = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    else:
        audio = audio.astype(dtype)
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), num_mel_bins=mels))
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio), num_mel_bins=mels)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_frame_attention_mask():
    lengths = np.array([0, 161, 1600, 4000])
    want = np.asarray(jmel.frame_attention_mask(jnp.asarray(lengths), 25))
    got = tmel.frame_attention_mask(torch.from_numpy(lengths), 25)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert tmel.num_frames(4800) == jmel.num_frames(4800)
