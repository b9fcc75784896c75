"""Whisper-compatible log-mel front-end in PyTorch.

Port of :mod:`tiny_audio_tpu.ops.mel`.  The STFT is the same windowed-DFT
matmul over hop-sized chunks (no ``torch.stft``), so the features match the
JAX function and not only a library STFT:

    frames  = hop-chunked view of pad_reflect(audio)
    stft    = frames @ (window * [cos|sin] DFT basis)
    power   = cos^2 + sin^2
    mel     = power @ mel_filters
    logmel  = (max(log10(clip(mel)), rowmax - 8) + 4) / 4

Both matmuls run in full float32 (the JAX version asks for
``Precision.HIGHEST``); on CUDA TF32 is switched off around them.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds — Whisper's fixed window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE

# Frames are assembled from hop-sized chunks, so the window length must be a
# multiple of HOP_LENGTH; the basis is zero-padded from 400 to 480 rows
# (the window is zero there).
FRAME_CHUNKS = -(-N_FFT // HOP_LENGTH)  # 3
PADDED_FRAME = FRAME_CHUNKS * HOP_LENGTH  # 480


def hertz_to_mel_slaney(freq):
    """Slaney-style mel scale (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
        mels,
    )


def mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel,
        min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
        freq,
    )


def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float = 0.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Triangular mel filterbank, slaney scale + slaney norm.

    Returns [num_frequency_bins, num_mel_filters] float64.
    """
    mel_min = hertz_to_mel_slaney(min_frequency)
    mel_max = hertz_to_mel_slaney(max_frequency)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz_slaney(mel_freqs)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)

    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(np.zeros(1), np.minimum(down_slopes, up_slopes))

    # Slaney normalization: scale each filter by 2 / bandwidth
    enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    fb *= np.expand_dims(enorm, 0)
    return fb


def _dft_basis(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis: (cos, sin) each [n_freq, n_fft], hann-windowed."""
    n_freq = n_fft // 2 + 1
    # Periodic hann window (matches transformers.audio_utils.window_function)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    k = np.arange(n_freq)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    cos_b = np.cos(ang) * window[None, :]
    sin_b = -np.sin(ang) * window[None, :]
    return cos_b, sin_b


@functools.lru_cache(maxsize=8)
def _constants(num_mel_bins: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(dft_basis [PADDED_FRAME, 2*n_freq], mel_fb [n_freq, n_mels]) float32."""
    cos_b, sin_b = _dft_basis()
    basis = np.concatenate([cos_b, sin_b], axis=0)  # [2*n_freq, n_fft]
    basis = np.pad(basis, ((0, 0), (0, PADDED_FRAME - N_FFT)))
    fb = mel_filter_bank(N_FFT // 2 + 1, num_mel_bins).astype(np.float32)
    return (
        torch.from_numpy(basis.T.astype(np.float32)).to(device),
        torch.from_numpy(fb).to(device),
    )


@contextlib.contextmanager
def full_fp32_matmul():
    """Full-precision float32 matmuls on CUDA (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def num_frames(num_samples: int) -> int:
    """Mel frame count for a padded sample count (HF drops the final frame)."""
    return num_samples // HOP_LENGTH


def log_mel_spectrogram(audio: torch.Tensor, num_mel_bins: int = 128) -> torch.Tensor:
    """Compute Whisper-style log-mel features.

    Args:
        audio: [batch, num_samples] waveform (any real or integer dtype; cast
            to float32 as is) at 16 kHz.  ``num_samples`` must be a multiple
            of ``HOP_LENGTH``.
        num_mel_bins: 80 or 128.

    Returns:
        [batch, num_mel_bins, num_samples // HOP_LENGTH] float32 features on
        ``audio``'s device.
    """
    n_frames = audio.shape[1] // HOP_LENGTH
    return normalize_log_spec(log_spec_from_padded(pad_audio(audio), n_frames, num_mel_bins))


def log_spec_from_padded(padded: torch.Tensor, n_frames: int, num_mel_bins: int) -> torch.Tensor:
    """``log10(max(mel, 1e-10))`` [B, mels, T] of padded audio
    [B, (T + FRAME_CHUNKS) * hop] float32, before the per-row clamp: what
    the fused kernel computes (``ops/mel_fused.py``)."""
    basis, fb = _constants(num_mel_bins, padded.device)
    batch = padded.shape[0]

    # Overlapping frames without gather: frame t is the concatenation of
    # hop-sized chunks [t, t+1, t+2]; the final partial frame is dropped.
    chunks = padded.reshape(batch, -1, HOP_LENGTH)
    frames = torch.cat(
        [chunks[:, i : i + n_frames] for i in range(FRAME_CHUNKS)], dim=-1
    )  # [B, T, PADDED_FRAME]

    n_freq = N_FFT // 2 + 1
    with full_fp32_matmul():
        stft = frames @ basis  # [B, T, 2*n_freq]
        power = stft[..., :n_freq] ** 2 + stft[..., n_freq:] ** 2
        mel = (power @ fb).transpose(1, 2)  # [B, mels, T]
    return torch.log10(torch.clamp(mel, min=1e-10))


def pad_audio(audio: torch.Tensor) -> torch.Tensor:
    """[B, N] audio as float32, padded for framing: center=True reflect
    padding of n_fft // 2 on both sides, plus trailing zeros so frame starts
    up to (N // hop - 1) * hop have a whole chunk view.  Returns
    [B, (N // hop + FRAME_CHUNKS) * hop].  Reflect needs pad < length;
    shorter inputs fall back to zero padding."""
    audio = audio.to(torch.float32)
    n_samples = audio.shape[1]
    half = N_FFT // 2
    if n_samples > half:
        padded = F.pad(audio[:, None], (half, half), mode="reflect")[:, 0]
    else:
        padded = F.pad(audio, (half, half))
    tail = (n_samples // HOP_LENGTH + FRAME_CHUNKS) * HOP_LENGTH - padded.shape[1]
    if tail > 0:
        padded = F.pad(padded, (0, tail))
    return padded.contiguous()


def normalize_log_spec(log_spec: torch.Tensor) -> torch.Tensor:
    """Per-sample dynamic-range clamp (max - 8) and affine normalization of
    [B, mels, T] log10 power."""
    global_max = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, global_max - 8.0)
    return (log_spec + 4.0) / 4.0


def frame_attention_mask(lengths: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[B, n_frames] int32 mask of real (non-padding) mel frames: frame ``t``
    is real iff sample ``t * hop`` lies within the unpadded waveform."""
    idx = torch.arange(n_frames, device=lengths.device)[None, :] * HOP_LENGTH
    return (idx < lengths[:, None]).to(torch.int32)
