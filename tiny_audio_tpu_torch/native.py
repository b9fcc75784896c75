"""ctypes binding of the repo's native C++ audio runtime (``native/ta_audio.cpp``).

The port's own copy of :mod:`tiny_audio_tpu.native`.  The library is built
with ``g++`` at first use into ``build/native/<hash>/`` beside the package,
keyed on a hash of the source and the flags (a changed source builds anew);
each process compiles to a temporary name and renames it into place, so a
concurrent loader never opens half a file.  Host code, not a device kernel:
every function returns None when the library is unavailable (no source, no
compiler, or ``TA_DISABLE_NATIVE=1``) and its caller takes the numpy code,
which stays the oracle the tests hold this runtime to.

- :func:`available`: did the library build and load?
- :func:`wav_decode`: WAV bytes -> (float32 mono, rate)
- :func:`resample`: windowed-sinc resampling at any ratio
- :func:`fft_convolve`: same-length FFT convolution (RIR augmentation)
- :func:`mix_at_snr`: additive noise at a target SNR
- :func:`vad_features`: per-frame energy dB and spectral flatness
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "ta_audio.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIB_NAME = "libta_audio.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_I64, _I32 = ctypes.c_int64, ctypes.c_int32
_SIGNATURES = {  # name -> (restype, argtypes)
    "ta_wav_info": (ctypes.c_int, [_u8p, _I64, ctypes.POINTER(_I64), ctypes.POINTER(_I32)]),
    "ta_wav_decode": (_I64, [_u8p, _I64, _f32p]),
    "ta_resample": (_I64, [_f32p, _I64, _I32, _I32, _f32p]),
    "ta_fft_convolve": (_I64, [_f32p, _I64, _f32p, _I64, _f32p]),
    "ta_mix_snr": (ctypes.c_int, [_f32p, _I64, _f32p, _I64, ctypes.c_float]),
    "ta_vad_features": (_I64, [_f32p, _I64, _I32, _f32p, _f32p]),
}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless this source's build exists; raises when
    the source or the compiler is missing or the compile fails."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TA_DISABLE_NATIVE") == "1" or not SOURCE.exists():
            return None
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError):
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library built (or was built before) and loaded."""
    return _load() is not None


# ----------------------------------------------------------------- wrappers


def wav_decode(data: bytes) -> Optional[tuple[np.ndarray, int]]:
    """WAV bytes -> (float32 mono, rate); None when the library is
    unavailable or the format unsupported."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    frames, rate = _I64(), _I32()
    if lib.ta_wav_info(buf, buf.size, ctypes.byref(frames), ctypes.byref(rate)):
        return None
    out = np.empty(frames.value, np.float32)
    n = lib.ta_wav_decode(buf, buf.size, out)
    if n < 0:
        return None
    return out[:n], int(rate.value)


def resample(audio: np.ndarray, orig_rate: int, target_rate: int) -> Optional[np.ndarray]:
    """Windowed-sinc resampling; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, np.float32)
    # the exact integer ceiling of ta_resample's output length: the C code
    # writes that many samples into this buffer
    out_len = (len(audio) * target_rate + orig_rate - 1) // orig_rate
    out = np.empty(max(out_len, 1), np.float32)
    n = lib.ta_resample(audio, len(audio), orig_rate, target_rate, out)
    if n < 0 or n > out.size:
        return None
    return out[:n]


def fft_convolve(a: np.ndarray, kernel: np.ndarray) -> Optional[np.ndarray]:
    """``a`` convolved with ``kernel``, the first ``len(a)`` samples."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.float32)
    kernel = np.ascontiguousarray(kernel, np.float32)
    out = np.empty(len(a), np.float32)
    n = lib.ta_fft_convolve(a, len(a), kernel, len(kernel), out)
    return out if n == len(a) else None


def mix_at_snr(audio: np.ndarray, noise: np.ndarray, snr_db: float) -> Optional[np.ndarray]:
    """``audio`` plus ``noise`` scaled to ``snr_db`` (a new array)."""
    lib = _load()
    if lib is None:
        return None
    out = np.ascontiguousarray(audio, np.float32).copy()
    noise = np.ascontiguousarray(noise, np.float32)
    lib.ta_mix_snr(out, len(out), noise, len(noise), float(snr_db))
    return out


def vad_features(audio: np.ndarray, hop: int) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(energy dB, spectral flatness) per ``hop``-sample frame."""
    lib = _load()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, np.float32)
    frames = len(audio) // hop
    if frames <= 0:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    energy = np.empty(frames, np.float32)
    flat = np.empty(frames, np.float32)
    n = lib.ta_vad_features(audio, len(audio), hop, energy, flat)
    if n != frames:
        return None
    return energy, flat
