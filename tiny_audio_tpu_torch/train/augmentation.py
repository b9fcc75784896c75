"""Audio augmentation: RIR reverb + noise chain, self-contained numpy DSP.

Port of :mod:`tiny_audio_tpu.train.augmentation` (the port's own copy): the
same seed and sample key give the same samples, bit for bit.  The FFT
convolution is numpy's (the JAX package prefers its optional C++ runtime
when built, and falls back to the same numpy code).

Re-designed equivalent of the reference's ``tiny_audio/augmentation.py``
(292 LoC), which composes audiomentations/torchaudio transforms.  Here every
transform is explicit numpy (FFT convolution / FFT-domain filters) so the
chain runs on dataloader workers with zero extra dependencies:

- :class:`RIRAugmentation` — recorded room-impulse-response convolution at
  p=0.5 (reference :71-93; corpus: OpenSLR-28 downloaded separately).  A
  synthetic exponential-decay RIR bank is generated when no corpus directory
  is given, so the pipeline works (and tests run) hermetically.
- :class:`NoiseAugmentation` — the reference's Compose (reference :96-216):
  background noise at 5-30 dB SNR (p=0.8), short transient noise (p=0.3),
  always-on Gaussian sensor floor at 20-40 dB SNR, 7-band EQ +/-4 dB
  (p=0.4), clipping of the top 10 % amplitudes (p=0.2), OneOf{low-pass
  3-7.5 kHz, telephony band-pass 300-3400 Hz} (p=0.3).
- :meth:`NoiseAugmentation.sample_noise_only` — random noise windows for
  silence-injection training (reference :225-292).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SAMPLE_RATE = 16000


_sample_key = threading.local()


def set_sample_key(key: Optional[tuple]) -> None:
    """Pin the augmentation RNG stream for the CURRENT thread to ``key``
    (e.g. ``(epoch, dataset_index)``).

    ``batch_iterator`` sets this around every transform call so the random
    draws for a given sample depend only on (seed, epoch, index) — NOT on
    which pool thread picked the sample up or how many workers exist.  Two
    runs with the same seed therefore augment identically regardless of
    ``transform_workers`` and scheduler timing.  ``None`` clears the pin.
    """
    _sample_key.key = key


class _ThreadRng:
    """Thread-safe numpy Generator with per-sample-deterministic streams.

    ``np.random.Generator`` is not safe under concurrent calls; the
    augmentation chain runs on ``batch_iterator``'s transform thread pool.
    While a sample key is pinned (:func:`set_sample_key`), the stream is
    derived from ``SeedSequence([seed, *key])`` — reproducible per sample
    across runs and worker counts.  Outside a pinned region (e.g. the
    synthetic-RIR draws in ``__init__``) each thread falls back to its own
    spawned child stream.  Delegates attribute access, so it drops in
    wherever a Generator was used.
    """

    def __init__(self, seed: int, salt: int = 0):
        self._seed = int(seed)
        # fixed per-owner salt: two augmentations built with the same seed
        # (e.g. RIR + noise both at seed 0) must not draw identical keyed
        # streams.  A constant (not construction-order) salt keeps streams
        # stable across object reconstruction within one process.
        self._salt = int(salt)
        self._seq = np.random.SeedSequence(seed)
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _get(self) -> np.random.Generator:
        key = getattr(_sample_key, "key", None)
        if key is not None:
            if getattr(self._tls, "key", None) != key:
                self._tls.key = key
                self._tls.keyed_rng = np.random.default_rng(
                    np.random.SeedSequence(
                        [self._seed, self._salt, *map(int, key)]
                    )
                )
            return self._tls.keyed_rng
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            with self._lock:
                child = self._seq.spawn(1)[0]
            rng = self._tls.rng = np.random.default_rng(child)
        return rng

    def __getattr__(self, name):
        return getattr(self._get(), name)


def _fft_convolve(audio: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    n = len(audio) + len(kernel) - 1
    nfft = 1 << (n - 1).bit_length()
    out = np.fft.irfft(
        np.fft.rfft(audio, nfft) * np.fft.rfft(kernel, nfft), nfft
    )[: len(audio)]
    return out.astype(np.float32)


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x)) + 1e-12))


def _mix_at_snr(
    audio: np.ndarray, noise: np.ndarray, snr_db: float
) -> np.ndarray:
    """Add noise scaled so that signal/noise power ratio is ``snr_db``."""
    if len(noise) < len(audio):
        reps = -(-len(audio) // len(noise))
        noise = np.tile(noise, reps)
    noise = noise[: len(audio)]
    sig_rms, noise_rms = _rms(audio), _rms(noise)
    if noise_rms <= 0:
        return audio
    gain = sig_rms / noise_rms / (10.0 ** (snr_db / 20.0))
    return (audio + gain * noise).astype(np.float32)


def synthetic_rir(
    rng: np.random.Generator,
    duration_s: float = 0.25,
    rt60_s: float = 0.15,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Exponentially-decaying noise RIR (image-method stand-in) with a
    direct-path spike, normalized to unit direct gain."""
    n = int(duration_s * sample_rate)
    t = np.arange(n) / sample_rate
    decay = np.exp(-6.908 * t / rt60_s)  # -60 dB at rt60
    rir = rng.standard_normal(n).astype(np.float32) * decay * 0.3
    rir[0] = 1.0
    return (rir / np.abs(rir).max()).astype(np.float32)


def _load_wav_dir(
    directory, limit: int = 256, exclude_parts: tuple = ()
) -> list[np.ndarray]:
    """Load wavs under ``directory``; paths with any component in
    ``exclude_parts`` are skipped (e.g. MUSAN's speech/ subtree).  Unreadable
    files are dropped — path filtering happens here, per file, so a skip can
    never misalign a separate path list."""
    from tiny_audio_tpu_torch.utils.audio_io import read_wav, resample

    out = []
    for p in sorted(Path(directory).rglob("*.wav"))[:limit]:
        if exclude_parts and any(part in p.parts for part in exclude_parts):
            continue
        try:
            audio, rate = read_wav(p)
            audio = np.asarray(audio, np.float32).squeeze()
            if audio.ndim > 1:
                audio = audio.mean(axis=0)
            if rate != SAMPLE_RATE:
                audio = resample(audio, rate, SAMPLE_RATE)
            if audio.size:
                out.append(audio)
        except Exception:
            continue
    return out


class RIRAugmentation:
    """Convolve with a recorded (or synthetic) room impulse response
    (reference augmentation.py:71-93)."""

    def __init__(
        self,
        rir_dir: Optional[str] = None,
        p: float = 0.5,
        seed: int = 0,
        n_synthetic: int = 32,
    ):
        self.p = p
        self.rng = _ThreadRng(seed, salt=1)  # thread-safe: see _ThreadRng
        self.rirs: list[np.ndarray] = []
        if rir_dir and Path(rir_dir).is_dir():
            self.rirs = _load_wav_dir(rir_dir)
        if not self.rirs:
            self.rirs = [
                synthetic_rir(self.rng, rt60_s=float(rt))
                for rt in self.rng.uniform(0.05, 0.5, n_synthetic)
            ]

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        if self.rng.random() >= self.p:
            return audio
        rir = self.rirs[self.rng.integers(len(self.rirs))]
        wet = _fft_convolve(audio, rir)
        peak = np.abs(wet).max()
        src_peak = np.abs(audio).max()
        if peak > 0 and src_peak > 0:  # keep loudness comparable
            wet = wet * (src_peak / peak)
        return wet


class NoiseAugmentation:
    """The reference noise Compose as an explicit numpy chain
    (reference augmentation.py:96-216)."""

    # 7-band EQ center frequencies (Hz), log-spaced over speech band
    EQ_CENTERS = (125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 7000.0)

    def __init__(
        self,
        noise_dir: Optional[str] = None,
        transient_dir: Optional[str] = None,
        p_background: float = 0.8,
        p_transient: float = 0.3,
        p_eq: float = 0.4,
        p_clip: float = 0.2,
        p_filter: float = 0.3,
        seed: int = 0,
    ):
        self.rng = _ThreadRng(seed, salt=2)  # thread-safe: see _ThreadRng
        self.p_background = p_background
        self.p_transient = p_transient
        self.p_eq = p_eq
        self.p_clip = p_clip
        self.p_filter = p_filter
        self.background: list[np.ndarray] = []
        self.transients: list[np.ndarray] = []
        if noise_dir and Path(noise_dir).is_dir():
            # exclude speech/ subdirs (MUSAN layout, reference :259-265)
            self.background = _load_wav_dir(noise_dir, exclude_parts=("speech",))
        if transient_dir and Path(transient_dir).is_dir():
            self.transients = _load_wav_dir(transient_dir)

    # ------------------------------------------------------------ primitives

    def _gaussian_floor(self, audio: np.ndarray) -> np.ndarray:
        """Always-on sensor noise at 20-40 dB SNR (reference :131-137)."""
        snr = self.rng.uniform(20.0, 40.0)
        noise = self.rng.standard_normal(len(audio)).astype(np.float32)
        return _mix_at_snr(audio, noise, snr)

    def _background_noise(self, audio: np.ndarray) -> np.ndarray:
        if not self.background or self.rng.random() >= self.p_background:
            return audio
        noise = self.background[self.rng.integers(len(self.background))]
        if len(noise) > len(audio):
            start = self.rng.integers(len(noise) - len(audio) + 1)
            noise = noise[start : start + len(audio)]
        return _mix_at_snr(audio, noise, self.rng.uniform(5.0, 30.0))

    def _transient(self, audio: np.ndarray) -> np.ndarray:
        if not self.transients or self.rng.random() >= self.p_transient:
            return audio
        t = self.transients[self.rng.integers(len(self.transients))]
        t = t[: len(audio)]
        out = audio.copy()
        start = self.rng.integers(max(len(audio) - len(t), 0) + 1)
        snr = self.rng.uniform(0.0, 15.0)
        gain = _rms(audio) / max(_rms(t), 1e-8) / (10.0 ** (snr / 20.0))
        out[start : start + len(t)] += gain * t
        return out

    def _seven_band_eq(self, audio: np.ndarray) -> np.ndarray:
        """+/-4 dB random gain per band, applied as a smooth FFT-domain
        gain curve (reference :139-146)."""
        if self.rng.random() >= self.p_eq:
            return audio
        n = len(audio)
        freqs = np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE)
        gains_db = self.rng.uniform(-4.0, 4.0, len(self.EQ_CENTERS))
        log_c = np.log10(self.EQ_CENTERS)
        log_f = np.log10(np.maximum(freqs, 1.0))
        curve_db = np.interp(log_f, log_c, gains_db)
        spec = np.fft.rfft(audio) * 10.0 ** (curve_db / 20.0)
        return np.fft.irfft(spec, n).astype(np.float32)

    def _clip(self, audio: np.ndarray) -> np.ndarray:
        """Clip the top ~10 % of absolute amplitudes (reference :148-153)."""
        if self.rng.random() >= self.p_clip:
            return audio
        threshold = np.percentile(np.abs(audio), 90.0)
        if threshold <= 0:
            return audio
        return np.clip(audio, -threshold, threshold).astype(np.float32)

    def _fft_filter(self, audio: np.ndarray, lo: float, hi: float) -> np.ndarray:
        n = len(audio)
        freqs = np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE)
        mask = ((freqs >= lo) & (freqs <= hi)).astype(np.float32)
        # soften edges over ~50 Hz to avoid ringing
        kernel = np.ones(max(int(50 * n / SAMPLE_RATE), 1), np.float32)
        kernel /= kernel.sum()
        mask = np.convolve(mask, kernel, mode="same")
        return np.fft.irfft(np.fft.rfft(audio) * mask, n).astype(np.float32)

    def _band_limit(self, audio: np.ndarray) -> np.ndarray:
        """OneOf{low-pass 3-7.5 kHz, telephony band-pass 300-3400 Hz}
        (reference :155-165)."""
        if self.rng.random() >= self.p_filter:
            return audio
        if self.rng.random() < 0.5:
            cutoff = self.rng.uniform(3000.0, 7500.0)
            return self._fft_filter(audio, 0.0, cutoff)
        return self._fft_filter(audio, 300.0, 3400.0)

    # ------------------------------------------------------------------- API

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        if audio.size == 0:
            return audio
        audio = self._background_noise(audio)
        audio = self._transient(audio)
        audio = self._gaussian_floor(audio)
        audio = self._seven_band_eq(audio)
        audio = self._clip(audio)
        audio = self._band_limit(audio)
        peak = np.abs(audio).max()
        if peak > 1.0:
            audio = audio / peak
        return audio

    def sample_noise_only(
        self, duration_s: float = 2.0, max_tries: int = 3
    ) -> np.ndarray:
        """A noise-only window for silence-injection training
        (reference augmentation.py:225-292).  Falls back to shaped Gaussian
        noise when no corpus is available."""
        n = int(duration_s * SAMPLE_RATE)
        for _ in range(max_tries):
            if not self.background:
                break
            noise = self.background[self.rng.integers(len(self.background))]
            if len(noise) >= n:
                start = self.rng.integers(len(noise) - n + 1)
                window = noise[start : start + n]
                if _rms(window) > 1e-5:
                    return window.astype(np.float32)
        # fallback: low-passed Gaussian at a quiet level
        noise = self.rng.standard_normal(n).astype(np.float32) * 0.01
        return self._fft_filter(noise, 0.0, 4000.0)


class AugmentationPipeline:
    """RIR + noise chain + silence injection, the reference's
    ``dataset.with_transform`` wiring (reference train.py:530-587)."""

    def __init__(
        self,
        rir: Optional[RIRAugmentation] = None,
        noise: Optional[NoiseAugmentation] = None,
        silence_injection_prob: float = 0.0,
        seed: int = 0,
    ):
        self.rir = rir
        self.noise = noise
        self.silence_injection_prob = silence_injection_prob
        self.rng = _ThreadRng(seed, salt=3)  # thread-safe: see _ThreadRng

    def __call__(self, sample: dict) -> dict:
        """sample: {"audio": {"array", "sampling_rate"}, "text", ...}."""
        out = dict(sample)
        audio = np.asarray(
            sample["audio"]["array"]
            if isinstance(sample.get("audio"), dict)
            else sample.get("audio"),
            np.float32,
        )
        if (
            self.noise is not None
            and self.silence_injection_prob > 0
            and self.rng.random() < self.silence_injection_prob
        ):
            # Replace audio with pure noise + empty transcript so the model
            # learns "no speech -> EOS" (reference train.py:566-582).  The
            # ``silence`` flag exempts the row from the collator's
            # empty-label drop — in the reference the filter silently drops
            # every injected row (train.py:296 vs :576), a latent bug that
            # defeats the feature; we implement the documented intent.
            duration = min(len(audio) / SAMPLE_RATE, 5.0) or 2.0
            audio = self.noise.sample_noise_only(duration)
            out["text"] = ""
            out["silence"] = True
        else:
            if self.rir is not None:
                audio = self.rir(audio)
            if self.noise is not None:
                audio = self.noise(audio)
        out["audio"] = {"array": audio, "sampling_rate": SAMPLE_RATE}
        return out
