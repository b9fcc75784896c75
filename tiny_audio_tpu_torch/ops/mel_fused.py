"""The fused log-mel front end: a CUDA kernel for Hopper and its plain version.

Counterpart of ``tiny_audio_tpu/ops/mel_pallas.py``.  Replaces its TPU
kernel ``log_mel_spectrogram_pallas`` (``mel_pallas.py:93``, pallas_call
``:136``), which fuses framing, the windowed-DFT matmul, the power spectrum,
the mel filterbank and log10 per tile of frames, so that only the
``[B, mels, T]`` features reach device memory.

The kernel (``csrc/mel.cu``, ``ta_log_mel``) keeps the same split: the
reflect (or, below 201 samples, constant) padding before it and the
per-row ``max - 8`` clamp and affine step after it stay in plain torch, as
the JAX function keeps them in XLA.  All its arithmetic is fp32 on the CUDA
cores (no TF32: the squaring in the power spectrum amplifies its lost
digits); the source's header has the design and its bound.

The plain version is the port's :func:`tiny_audio_tpu_torch.ops.mel.log_mel_spectrogram`,
which computes the same function.  No path of the port calls this module:
``processing.extract_features`` runs the plain mel, as the JAX package's
``processing`` runs the XLA mel and not the Pallas kernel.

On a CPU tensor :func:`log_mel_spectrogram_fused` runs the plain version; on
a CUDA tensor it launches the kernel or raises.  With grad, :class:`LogMel`
carries the gradient: its backward recomputes the plain formula
(:func:`~tiny_audio_tpu_torch.ops.mel.log_spec_from_padded`) and
differentiates it; there is no backward kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops.mel import (
    FRAME_CHUNKS,
    HOP_LENGTH,
    N_FFT,
    _dft_basis,
    log_mel_spectrogram,
    log_spec_from_padded,
    mel_filter_bank,
    normalize_log_spec,
    pad_audio,
)

N_FREQ = N_FFT // 2 + 1  # 201
BINS_PAD = 256           # the kernel's bins: 4 tiles of 64, zero past 201
MAX_MELS = 128


@functools.lru_cache(maxsize=4)
def kernel_constants(num_mel_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's operands, float32: the windowed DFT basis
    ``[N_FFT, 2 * BINS_PAD]`` with bin b's cos and sin in columns 2b and
    2b + 1 (zero past bin 200), and the filterbank ``[N_FREQ, mels]``."""
    cos_b, sin_b = _dft_basis()  # each [N_FREQ, N_FFT]
    basis = np.zeros((N_FFT, 2 * BINS_PAD), np.float32)
    basis[:, 0 : 2 * N_FREQ : 2] = cos_b.T
    basis[:, 1 : 2 * N_FREQ : 2] = sin_b.T
    fb = mel_filter_bank(N_FREQ, num_mel_bins).astype(np.float32)
    return basis, np.ascontiguousarray(fb)


@functools.lru_cache(maxsize=8)
def _device_constants(num_mel_bins: int, device: torch.device):
    basis, fb = kernel_constants(num_mel_bins)
    return torch.from_numpy(basis).to(device), torch.from_numpy(fb).to(device)


def log_mel_spectrogram_fused(audio: torch.Tensor, num_mel_bins: int = 128) -> torch.Tensor:
    """Whisper log-mel features through the fused kernel.

    The contract of ``tiny_audio_tpu/ops/mel_pallas.py:93``
    (``log_mel_spectrogram_pallas``): audio ``[B, N]`` (any real or integer
    dtype, cast to float32 as is), N a multiple of ``HOP_LENGTH``; returns
    ``[B, num_mel_bins, N // HOP_LENGTH]`` float32 on ``audio``'s device.
    """
    if not audio.is_cuda:
        return log_mel_spectrogram(audio, num_mel_bins)
    if audio.is_complex() or audio.dtype == torch.bool:
        raise TypeError(f"log-mel kernel takes real audio, got {audio.dtype}")
    if audio.ndim != 2:
        raise ValueError(f"audio must be [B, N], got {tuple(audio.shape)}")
    if num_mel_bins % 8 or not 0 < num_mel_bins <= MAX_MELS:
        raise ValueError(f"log-mel kernel takes a multiple of 8 up to {MAX_MELS} mel bins, "
                         f"got {num_mel_bins}")
    batch, n_samples = audio.shape
    n_frames = n_samples // HOP_LENGTH
    if batch == 0 or n_frames == 0:
        raise ValueError(f"log-mel kernel needs at least one frame, got {tuple(audio.shape)}")
    # [B, (T + 3) * hop]: every frame's 400 samples, and a multiple of 4 floats
    padded = pad_audio(audio)[:, : (n_frames + FRAME_CHUNKS) * HOP_LENGTH].contiguous()
    if torch.is_grad_enabled() and padded.requires_grad:
        log_spec = LogMel.apply(padded, n_frames, num_mel_bins)
    else:
        log_spec = launch_log_mel(padded, n_frames, num_mel_bins)
    return normalize_log_spec(log_spec)


class LogMel(torch.autograd.Function):
    """Kernel #7 forward on padded audio; the backward recomputes
    :func:`log_spec_from_padded` and differentiates it (no backward kernel)."""

    @staticmethod
    def forward(ctx, padded, n_frames, num_mel_bins):
        ctx.save_for_backward(padded)
        ctx.shape = (n_frames, num_mel_bins)
        return launch_log_mel(padded, n_frames, num_mel_bins)

    @staticmethod
    def backward(ctx, dout):
        (padded,) = ctx.saved_tensors
        with torch.enable_grad():
            leaf = padded.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(log_spec_from_padded(leaf, *ctx.shape), leaf, dout)
        return grad, None, None


def launch_log_mel(padded: torch.Tensor, n_frames: int, num_mel_bins: int) -> torch.Tensor:
    """The kernel alone: padded audio [B, (T + 3) * hop] float32 on the card
    -> log10(max(mel, 1e-10)) [B, mels, T], before the per-row clamp."""
    if padded.dtype != torch.float32 or not padded.is_contiguous() or padded.data_ptr() % 16:
        raise ValueError("padded audio must be contiguous, 16-byte aligned float32")
    if padded.shape[1] != (n_frames + FRAME_CHUNKS) * HOP_LENGTH:
        raise ValueError(f"padded audio must hold {n_frames + FRAME_CHUNKS} hops, "
                         f"got {padded.shape[1]} samples")
    basis, fb = _device_constants(num_mel_bins, padded.device)
    log_spec = torch.empty((padded.shape[0], num_mel_bins, n_frames), dtype=torch.float32,
                           device=padded.device)
    kernels.launch(
        "ta_log_mel", padded.device,
        padded.data_ptr(), basis.data_ptr(), fb.data_ptr(), log_spec.data_ptr(),
        padded.shape[0], padded.shape[1], n_frames, num_mel_bins,
    )
    log_mel_spectrogram_fused.launches += 1
    return log_spec


#: kernel launches since the last reset (CPU calls never count)
log_mel_spectrogram_fused.launches = 0
