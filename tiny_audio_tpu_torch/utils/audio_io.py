"""Audio I/O without external dependencies: WAV read and write, resampling.

The port's own copy of what :mod:`tiny_audio_tpu.utils.audio_io` gives the
pipeline: PCM WAV is decoded by the native C++ runtime
(:mod:`tiny_audio_tpu_torch.native`) when it is built, else by the stdlib
``wave`` module (its oracle), and resampled with scipy's polyphase filter.
"""

from __future__ import annotations

import io
import wave
from math import gcd
from pathlib import Path
from typing import Union

import numpy as np


def read_wav(source: Union[str, Path, bytes]) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file/bytes -> (float32 mono waveform in [-1, 1], rate)."""
    data = Path(source).read_bytes() if isinstance(source, (str, Path)) else source
    from tiny_audio_tpu_torch import native

    decoded = native.wav_decode(data)
    if decoded is not None:
        return decoded
    with wave.open(io.BytesIO(data), "rb") as w:
        rate = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        audio = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        audio = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        audio = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")
    if n_channels > 1:
        audio = audio.reshape(-1, n_channels).mean(axis=1)
    return audio, rate


def resample(audio: np.ndarray, orig_rate: int, target_rate: int = 16000) -> np.ndarray:
    if orig_rate == target_rate:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly

    g = gcd(orig_rate, target_rate)
    out = resample_poly(audio.astype(np.float64), target_rate // g, orig_rate // g)
    return out.astype(np.float32)


def write_wav(path: Union[str, Path], audio: np.ndarray, rate: int = 16000) -> None:
    """16-bit mono PCM WAV, samples clipped to [-1, 1]."""
    audio16 = np.clip(audio, -1.0, 1.0)
    audio16 = (audio16 * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(audio16.tobytes())
