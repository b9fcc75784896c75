"""The fused log-mel front end: a CUDA kernel for Hopper and its plain version.

Counterpart of ``tiny_audio_tpu/ops/mel_pallas.py``.  Replaces its TPU
kernel ``log_mel_spectrogram_pallas`` (``mel_pallas.py:93``, pallas_call
``:136``), which fuses framing, the windowed-DFT matmul, the power spectrum,
the mel filterbank and log10 per tile of frames, so that only the
``[B, mels, T]`` features reach device memory.

The kernel (``csrc/mel.cu``, ``ta_log_mel``) keeps the same split: the
reflect (or, below 201 samples, constant) padding before it and the
per-row ``max - 8`` clamp and affine step after it stay in plain torch, as
the JAX function keeps them in XLA.  Its bound is its bytes (the padded
audio read once, the features written once: under 20 FLOP a byte), so it
does no dense DFT: a block of ``FRAME_TILE`` frames takes each frame's
even and odd samples as one 200-point complex sequence, transforms it in
fp32 registers (radix-8 butterflies, one exchange through shared memory,
25-point DFTs as 5 x 5), splits it into the 201 real-FFT bins and applies
the filterbank as a banded gather.  No TF32 anywhere: the squaring in the
power spectrum amplifies lost digits.  The kernel's operands are
:func:`kernel_constants`: the window and twiddle tables, computed in float64
and rounded to fp32 once, and the filterbank's bands.

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
    log_mel_spectrogram,
    log_spec_from_padded,
    mel_filter_bank,
    normalize_log_spec,
    pad_audio,
)

N_FREQ = N_FFT // 2 + 1  # 201
MAX_MELS = 128
#: frames a block of the kernel transforms (its 32 lanes store a mel's row)
FRAME_TILE = 32
#: the complex transform: frame sample 2n is the real part of z[n], sample
#: 2n + 1 the imaginary part, n < FFT_LEN; FFT_LEN = FFT_N1 x FFT_N2 with
#: n = FFT_N2 n1 + n2 and bin k = k1 + FFT_N1 k2; the 25-point DFTs are
#: 5 x 5 with n2 = 5 p + q and k2 = r + 5 s
FFT_LEN = N_FFT // 2  # 200
FFT_N1, FFT_N2 = 8, 25
#: float2 entries of the table :func:`kernel_constants` returns: the window
#: pairs (w[2n], w[2n + 1]); the twiddles W200^(n2 k1) at TAB_STAGE + 25 k1 +
#: n2, W25^(q r) at TAB_W25 + 5 q + r and W400^k at TAB_POST + k (W_N^j =
#: exp(-2 pi i j / N)); the butterflies' W8^1, W5^1 and W5^2 at TAB_W8,
#: TAB_W5 and TAB_W5 + 1.  The kernel reads the window, W200 and W400 from
#: the table and has W25, W8 and W5 as fp32 literals equal to its entries.
TAB_WINDOW, TAB_STAGE, TAB_W25, TAB_POST, TAB_W8, TAB_W5 = 0, 200, 400, 425, 625, 626
TAB_LEN = 628


def _twiddle(n: int, j) -> np.ndarray:
    ang = -2.0 * np.pi * np.asarray(j, np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


@functools.lru_cache(maxsize=16)
def kernel_constants(num_mel_bins: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's operands: the table ``[TAB_LEN, 2]`` float32 (the
    periodic Hann window of 400 in (even, odd) pairs and every twiddle, in
    float64 rounded once); each mel's band of the filterbank as
    ``[mels, 2]`` int32 (first bin, bin count) and its weights
    ``[mels, width]`` float32 (zero past the count), ``width`` the widest
    band rounded up to 4 (the kernel copies them in 16-byte pieces).  The
    bands hold every nonzero weight of ``mel_filter_bank(201, mels)``, whose
    triangles are contiguous runs of bins."""
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT)
    table = np.zeros((TAB_LEN, 2), np.float64)
    table[TAB_WINDOW:TAB_WINDOW + FFT_LEN] = window.reshape(FFT_LEN, 2)
    k1, n2 = np.meshgrid(np.arange(FFT_N1), np.arange(FFT_N2), indexing="ij")
    table[TAB_STAGE:TAB_STAGE + FFT_LEN] = _twiddle(FFT_LEN, k1 * n2).reshape(-1, 2)
    q, r = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    table[TAB_W25:TAB_W25 + 25] = _twiddle(25, q * r).reshape(-1, 2)
    table[TAB_POST:TAB_POST + FFT_LEN] = _twiddle(N_FFT, np.arange(FFT_LEN))
    table[TAB_W8] = _twiddle(8, 1)
    table[TAB_W5:TAB_W5 + 2] = _twiddle(5, [1, 2])
    fb = mel_filter_bank(N_FREQ, num_mel_bins).astype(np.float32)
    nonzero = [np.flatnonzero(fb[:, m]) for m in range(num_mel_bins)]
    band = np.array([(nz[0], nz[-1] + 1 - nz[0]) if nz.size else (0, 0) for nz in nonzero],
                    np.int32).reshape(num_mel_bins, 2)
    weights = np.zeros((num_mel_bins, -(-max(1, int(band[:, 1].max())) // 4) * 4), np.float32)
    for m, (first, count) in enumerate(band):
        weights[m, :count] = fb[first:first + count, m]
    return table.astype(np.float32), band, weights


@functools.lru_cache(maxsize=8)
def _device_constants(num_mel_bins: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in kernel_constants(num_mel_bins))


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
    table, band, weights = _device_constants(num_mel_bins, padded.device)
    log_spec = torch.empty((padded.shape[0], num_mel_bins, n_frames), dtype=torch.float32,
                           device=padded.device)
    kernels.launch(
        "ta_log_mel", padded.device,
        padded.data_ptr(), table.data_ptr(), band.data_ptr(), weights.data_ptr(),
        log_spec.data_ptr(), padded.shape[0], padded.shape[1], n_frames, num_mel_bins,
        weights.shape[1],
    )
    log_mel_spectrogram_fused.launches += 1
    return log_spec


#: kernel launches since the last reset (CPU calls never count)
log_mel_spectrogram_fused.launches = 0
