"""The port's fused log-mel entry point (ops/mel_fused.py) vs the JAX
package's Pallas kernel in interpret mode, on the CPU, at the shapes of
tests/test_mel_pallas.py; and the kernel's constants and frame indexing,
replayed in numpy, against the port's plain mel."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tiny_audio_tpu.ops.mel_pallas import TILE_T, log_mel_spectrogram_pallas
from tiny_audio_tpu_torch.ops import mel as tmel
from tiny_audio_tpu_torch.ops import mel_fused

torch.set_num_threads(1)
HOP = tmel.HOP_LENGTH


@pytest.mark.parametrize(
    "batch,n_samples,mels,silent",
    [
        (2, 16000, 80, False),          # 1 s, whisper-base bins, one partial tile
        (2, 48000, 128, False),         # 3 s, large-v3 bins
        (2, TILE_T * HOP, 128, False),  # exactly one TPU tile
        (2, 480000, 128, False),        # 30 s window
        (1, 32000, 80, True),           # silence: every bin at the floor
        (2, 160, 80, False),            # fewer than 201 samples: constant padding
    ],
)
def test_matches_jax_pallas_kernel(batch, n_samples, mels, silent):
    rng = np.random.default_rng(0)
    if silent:
        audio = np.zeros((batch, n_samples), np.float32)
    else:
        audio = (rng.standard_normal((batch, n_samples)) * 0.1).astype(np.float32)
    want = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(audio), num_mel_bins=mels,
                                                 interpret=True))
    mel_fused.log_mel_spectrogram_fused.launches = 0
    got = mel_fused.log_mel_spectrogram_fused(torch.from_numpy(audio), num_mel_bins=mels)
    assert mel_fused.log_mel_spectrogram_fused.launches == 0  # a CPU tensor launches nothing
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


@pytest.mark.parametrize("mels", [80, 128])
def test_kernel_layout_replayed_in_numpy(mels):
    """The kernel's operands and indexing, in float64: frame t is the 400
    samples at t * hop of the padded row (no chunk copies), bin b's cos and
    sin sit in basis columns 2b and 2b + 1, bins past 200 are zero, and the
    filterbank is read for bins 0..200.  Against the plain mel at 1e-5."""
    rng = np.random.default_rng(mels)
    audio = (rng.standard_normal((2, 16000 + 7 * HOP)) * 0.1).astype(np.float32)
    basis, fb = mel_fused.kernel_constants(mels)
    assert basis.shape == (tmel.N_FFT, 2 * mel_fused.BINS_PAD) and fb.shape == (201, mels)
    assert not basis[:, 2 * 201:].any()
    padded = tmel.pad_audio(torch.from_numpy(audio)).numpy().astype(np.float64)
    n_frames = audio.shape[1] // HOP
    starts = np.arange(n_frames)[:, None] * HOP + np.arange(tmel.N_FFT)[None, :]
    frames = padded[:, starts]  # [B, T, 400]
    stft = frames @ basis.astype(np.float64)
    power = stft[..., 0::2] ** 2 + stft[..., 1::2] ** 2  # [B, T, 256]
    mel = power[..., :201] @ fb.astype(np.float64)
    log_spec = np.log10(np.maximum(mel, 1e-10)).transpose(0, 2, 1)
    got = tmel.normalize_log_spec(torch.from_numpy(log_spec)).numpy()
    want = tmel.log_mel_spectrogram(torch.from_numpy(audio), mels).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
