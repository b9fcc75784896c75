"""Formant-synthesized speech for offline validation.

The port's copy of :mod:`tiny_audio_tpu.utils.speech_synth` (numpy and
``scipy.signal.lfilter``; the same rows for the same seed).  It renders
source-filter speech: a glottal pulse train (F0 with jitter + declination)
driven through cascaded two-pole formant resonators whose targets move
between vowels, interleaved with band-passed fricative noise, shaped by a
syllabic (~4 Hz) envelope with word pauses, with an exact ground-truth
speech mask.  :func:`labeled_speech_dataset` makes the labeled utterances
of the convergence ladder (:mod:`tiny_audio_tpu_torch.train.convergence`).

It is not a substitute for evaluation on real corpora: it bounds behavior,
it does not certify WER.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000

# (F1, F2, F3) vowel formant targets in Hz — canonical adult-male values.
_VOWELS = {
    "a": (730.0, 1090.0, 2440.0),
    "i": (270.0, 2290.0, 3010.0),
    "u": (300.0, 870.0, 2240.0),
    "e": (530.0, 1840.0, 2480.0),
    "o": (570.0, 840.0, 2410.0),
}
_BANDWIDTHS = (90.0, 110.0, 170.0)


def _resonator(x: np.ndarray, freq: np.ndarray, bw: float, sr: int) -> np.ndarray:
    """Time-varying two-pole resonator (digital formant filter).

    ``freq`` is per-sample (formant trajectories); coefficients are updated
    per sample via the standard resonator recurrence
    ``y[n] = A x[n] + B y[n-1] + C y[n-2]``.
    """
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bw / sr)
    theta = 2.0 * np.pi * np.asarray(freq, np.float64) / sr
    if theta.ndim == 0 or np.all(theta == theta.flat[0]):
        th = float(np.reshape(theta, -1)[0])
        b_coef = [(1 - r * r) * np.sin(th)]
        a_coef = [1.0, -2 * r * np.cos(th), r * r]
        return lfilter(b_coef, a_coef, x).astype(np.float32)
    # piecewise-constant coefficients per 10 ms block (plenty for vowel
    # glides), filter state carried across blocks via ``zi``
    hop = sr // 100
    y = np.empty(len(x), np.float64)
    zi = np.zeros(2)
    for s0 in range(0, len(x), hop):
        s1 = min(s0 + hop, len(x))
        th = float(theta[s0])
        b_coef = [(1 - r * r) * np.sin(th)]
        a_coef = [1.0, -2 * r * np.cos(th), r * r]
        y[s0:s1], zi = lfilter(b_coef, a_coef, x[s0:s1], zi=zi)
    return y.astype(np.float32)


def _glottal_train(n: int, f0: float, sr: int, rng: np.random.Generator) -> np.ndarray:
    """Impulse train at ``f0`` with 2% jitter and a slow declination,
    pre-shaped by a -12 dB/oct glottal roll-off (leaky integrator)."""
    out = np.zeros(n, np.float32)
    t = 0.0
    pos = 0
    while pos < n:
        out[int(pos)] = 1.0
        # declination: f0 drops ~15% across the utterance
        cur_f0 = f0 * (1.0 - 0.15 * (pos / max(n, 1))) * (
            1.0 + 0.02 * rng.standard_normal()
        )
        pos += sr / max(cur_f0, 40.0)
        t += 1
    # leaky integrator ≈ glottal pulse low-pass
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -0.96], out).astype(np.float32)


def _syllable(
    dur_s: float, sr: int, f0: float, vowel: str, scale: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """One voiced syllable: glottal source -> 3 cascaded formant resonators
    gliding from a random onset toward the vowel target, syllabic envelope."""
    n = max(int(dur_s * sr), 64)
    src = _glottal_train(n, f0, sr, rng)
    onset = _VOWELS[rng.choice(list(_VOWELS))]
    target = _VOWELS[vowel]
    glide = np.linspace(0.0, 1.0, n, dtype=np.float32) ** 0.5
    y = src
    for i, bw in enumerate(_BANDWIDTHS):
        f_track = (onset[i] + (target[i] - onset[i]) * glide) * scale
        y = _resonator(y, f_track, bw * scale, sr)
    # syllabic amplitude envelope: fast attack, slow decay
    t = np.linspace(0, 1, n, dtype=np.float32)
    env = np.minimum(t / 0.12, 1.0) * np.exp(-1.8 * np.maximum(t - 0.25, 0))
    y = y * env
    peak = np.max(np.abs(y)) + 1e-9
    return (y / peak).astype(np.float32)


def _fricative(
    dur_s: float, sr: int, rng: np.random.Generator,
    band: tuple[float, float] = (2000.0, 7000.0),
) -> np.ndarray:
    """Unvoiced consonant: band-passed noise burst (default 2–7 kHz)."""
    n = max(int(dur_s * sr), 32)
    noise = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    spec[(freqs < band[0]) | (freqs > band[1])] = 0.0
    y = np.fft.irfft(spec, n).astype(np.float32)
    env = np.hanning(n).astype(np.float32) ** 0.5
    y = y * env
    return (0.35 * y / (np.max(np.abs(y)) + 1e-9)).astype(np.float32)


def synth_utterance(
    duration_s: float,
    sr: int = SAMPLE_RATE,
    seed: int = 0,
    f0: float = 120.0,
    vocal_tract_scale: float = 1.0,
    speech_fraction: float = 0.65,
    level: float = 0.25,
) -> tuple[np.ndarray, np.ndarray]:
    """Render ``duration_s`` of synthetic speech with word pauses.

    Returns ``(audio float32 [n], speech_mask bool [n])`` — the mask marks
    samples inside rendered syllables/fricatives (the VAD ground truth).

    ``speech_fraction`` steers the speech/pause ratio; ``f0`` and
    ``vocal_tract_scale`` differentiate speakers (e.g. 120 Hz/1.0 vs
    210 Hz/1.18 for a male/female pair).
    """
    rng = np.random.default_rng(seed)
    n_total = int(duration_s * sr)
    audio = np.zeros(n_total, np.float32)
    mask = np.zeros(n_total, bool)
    pos = 0
    while pos < n_total:
        # one "word": 1–4 syllables, optional leading fricative
        word_parts = []
        if rng.random() < 0.4:
            word_parts.append(_fricative(rng.uniform(0.05, 0.10), sr, rng))
        for _ in range(rng.integers(1, 5)):
            word_parts.append(
                _syllable(
                    rng.uniform(0.12, 0.30), sr,
                    f0 * (1.0 + 0.1 * rng.standard_normal()),
                    rng.choice(list(_VOWELS)), vocal_tract_scale, rng,
                )
            )
        word = np.concatenate(word_parts)
        end = min(pos + len(word), n_total)
        audio[pos:end] += word[: end - pos]
        mask[pos:end] = True
        pos = end
        # pause scaled so the long-run speech fraction ≈ speech_fraction
        pause = len(word) * (1.0 - speech_fraction) / max(speech_fraction, 0.05)
        pos += int(pause * rng.uniform(0.5, 1.5))
    peak = np.max(np.abs(audio)) + 1e-9
    return (level * audio / peak).astype(np.float32), mask


def synth_conversation(
    duration_s: float,
    n_speakers: int = 2,
    sr: int = SAMPLE_RATE,
    seed: int = 0,
    turn_s: tuple[float, float] = (1.5, 4.0),
    gap_s: tuple[float, float] = (0.3, 1.0),
    overlap_prob: float = 0.0,
    overlap_s: tuple[float, float] = (0.2, 0.8),
    voices: "list[tuple[float, float]] | None" = None,
) -> tuple[np.ndarray, list[dict], np.ndarray]:
    """Alternating-turn multi-speaker audio.

    Returns ``(audio, segments, speech_mask)`` where ``segments`` is
    ``[{"speaker": int, "start": s, "end": s}]`` per turn (diarization ground
    truth) and ``speech_mask`` is the sample-level VAD ground truth.
    Speakers get distinct (f0, vocal-tract) settings — override with
    ``voices`` (list of ``(f0_hz, vocal_tract_scale)``, one per speaker) to
    make the separation task arbitrarily hard (close-voice pairs).  With
    ``overlap_prob`` a turn may start before the previous one ends
    (interruption-style overlapped speech, summed).
    """
    rng = np.random.default_rng(seed)
    if voices is None:
        voices = [
            (110.0 + 55.0 * i / max(n_speakers - 1, 1), 1.0 + 0.12 * i)
            for i in range(n_speakers)
        ]
    if len(voices) != n_speakers:
        raise ValueError(f"{len(voices)} voices for {n_speakers} speakers")
    n_total = int(duration_s * sr)
    audio = np.zeros(n_total, np.float32)
    mask = np.zeros(n_total, bool)
    segments: list[dict] = []
    pos = 0
    spk = 0
    while pos < n_total - sr // 2:
        t_len = rng.uniform(*turn_s)
        f0, scale = voices[spk]
        utt, utt_mask = synth_utterance(
            t_len, sr, seed=int(rng.integers(1 << 30)), f0=f0,
            vocal_tract_scale=scale, speech_fraction=0.8,
        )
        end = min(pos + len(utt), n_total)
        audio[pos:end] += utt[: end - pos]
        mask[pos:end] |= utt_mask[: end - pos]
        segments.append(
            {"speaker": spk, "start": pos / sr, "end": end / sr}
        )
        if rng.random() < overlap_prob:
            pos = max(end - int(rng.uniform(*overlap_s) * sr), pos + 1)
        else:
            pos = end + int(rng.uniform(*gap_s) * sr)
        spk = (spk + 1) % n_speakers
    peak = np.max(np.abs(audio)) + 1e-9
    if peak > 1.0:  # overlap sums can exceed full scale
        audio /= peak
    return audio, segments, mask


# ---------------------------------------------------------- labeled speech
#
# The convergence benchmark (does the training stack learn?) needs
# utterances whose ACOUSTICS encode
# their transcript — the harmonic smoke corpus in train/data.py has labels
# uncorrelated with the waveform, so no amount of training can reduce its
# WER.  Each vocabulary word gets a deterministic, collision-free
# pronunciation (a unique vowel pair + a redundant fricative-onset cue);
# speaker voice (f0, vocal-tract length) and glide onsets vary per
# utterance, so a model must generalize across voices, not memorize
# waveforms: the offline stand-in for a real speech corpus.

_VOWEL_ORDER = ("a", "i", "u", "e", "o")


def word_pronunciation(index: int) -> dict:
    """Deterministic pronunciation for vocab ``index`` (unique for <= 25
    words — two base-5 vowel digits cover indices 0-24):
    two syllable vowels from the base-5 digits, plus a fricative onset
    (low or high band) on even indices as a redundant cue."""
    v1 = _VOWEL_ORDER[index % 5]
    v2 = _VOWEL_ORDER[(index // 5) % 5]
    return {
        "vowels": (v1, v2),
        "fricative": index % 2 == 0,
        "band": (2000.0, 4200.0) if (index // 2) % 2 == 0 else (4200.0, 7000.0),
    }


def synth_word(
    index: int,
    sr: int = SAMPLE_RATE,
    f0: float = 120.0,
    vocal_tract_scale: float = 1.0,
    rng: "np.random.Generator | None" = None,
) -> np.ndarray:
    """Render vocab word ``index`` as fricative-onset? + two vowel syllables.

    The vowel TARGETS are fixed per word; glide onsets, jitter, and exact
    durations come from ``rng`` (speaker/utterance variability)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    pron = word_pronunciation(index)
    parts = []
    if pron["fricative"]:
        parts.append(_fricative(rng.uniform(0.06, 0.09), sr, rng, pron["band"]))
    for k, vowel in enumerate(pron["vowels"]):
        parts.append(
            _syllable(
                rng.uniform(0.13, 0.18), sr,
                f0 * (1.06 if k == 0 else 0.94),  # fixed word-level contour
                vowel, vocal_tract_scale, rng,
            )
        )
    return np.concatenate(parts)


def labeled_speech_dataset(
    n: int,
    vocab: list[str],
    seed: int = 0,
    words_per_utt: tuple[int, int] = (2, 4),
    sr: int = SAMPLE_RATE,
    level: float = 0.25,
) -> list[dict]:
    """``n`` labeled rows ``{"audio": {...}, "text": ...}`` of synthetic
    speech whose waveform deterministically encodes the word sequence.

    Each utterance samples a speaker (f0 100–210 Hz, vocal tract 0.92–1.15)
    so held-out splits (different ``seed``) contain unseen voices."""
    if len(vocab) > 25:
        raise ValueError("word_pronunciation is collision-free only for <= 25 words")
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
        idxs = rng.integers(0, len(vocab), k)
        f0 = float(rng.uniform(100.0, 210.0))
        scale = float(rng.uniform(0.92, 1.15))
        parts = [np.zeros(int(rng.uniform(0.04, 0.09) * sr), np.float32)]
        for i in idxs:
            parts.append(
                synth_word(
                    int(i), sr, f0 * (1.0 + 0.04 * rng.standard_normal()),
                    scale, rng,
                )
            )
            parts.append(np.zeros(int(rng.uniform(0.05, 0.15) * sr), np.float32))
        audio = np.concatenate(parts)
        audio = level * audio / (np.max(np.abs(audio)) + 1e-9)
        rows.append(
            {
                "audio": {"array": audio.astype(np.float32), "sampling_rate": sr},
                "text": " ".join(vocab[int(i)] for i in idxs),
            }
        )
    return rows


def mask_to_frames(mask: np.ndarray, hop: int) -> np.ndarray:
    """Sample-level bool mask -> per-frame majority vote (VAD frame grid)."""
    n_frames = len(mask) // hop
    if n_frames == 0:
        return np.zeros(0, bool)
    return (
        mask[: n_frames * hop].reshape(n_frames, hop).mean(axis=1) > 0.5
    )
