"""The one traffic generator: clips, lengths and transcripts from a seed.

A workload's ``traffic`` object sets the parameters.  Lengths are the same
set for every seed (evenly spaced quantiles of the stated uniform range),
in an order the seed draws, so that a seed changes what is heard and not
how much work there is.  The audio is clipped Gaussian noise as int16 PCM,
each clip at its own level: its std one of the same evenly spaced set over
the range ``noise_std`` (recordings differ in loudness, and rows of one
level would all be heard alike); transcripts are random lowercase words at
``chars_per_s`` bytes (byte-tokenizer tokens) per audio second.
"""

from __future__ import annotations

import math

import numpy as np

SAMPLE_RATE = 16000


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the seed (``stream`` tells uses apart)."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def stratified(lo: float, hi: float, n: int, offset: float = 0.5) -> np.ndarray:
    """``n`` lengths in seconds, one in each of ``n`` equal strata of
    ``[lo, hi]``, at ``offset`` inside its stratum."""
    return lo + (hi - lo) * (np.arange(n) + offset) / n


def samples(seconds) -> np.ndarray:
    return np.round(np.asarray(seconds) * SAMPLE_RATE).astype(np.int64)


def noise_pcm(r: np.random.Generator, n_samples: int, std: float) -> np.ndarray:
    """``n_samples`` int16 of clipped Gaussian noise of ``std``."""
    x = r.standard_normal(n_samples, dtype=np.float32) * np.float32(std)
    return (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)


def levels(traffic: dict, r: np.random.Generator, n: int) -> np.ndarray:
    """Each of ``n`` clips' noise std: evenly spaced over the range, in a
    seeded order."""
    lo, hi = traffic["noise_std"]
    return stratified(lo, hi, n)[r.permutation(n)]


class ServePool:
    """The clips of an offline serving cell.  ``batch`` rows a lap; lap
    ``k`` holds the pool's clips rotated by ``k * ROTATE`` rows, so every lap
    sends the same lengths in another order.  ``pcm`` is zero past each
    clip's length, ``padded`` samples wide (the mel bucket of the longest)."""

    ROTATE = 97

    def __init__(self, traffic: dict, seed: int):
        lo, hi = traffic["clip_s"]
        self.batch = int(traffic["batch"])
        order = rng(seed, 1).permutation(self.batch)
        self.lengths = samples(stratified(lo, hi, self.batch))[order]
        frames = int(math.ceil(self.lengths.max() / 160))
        self.mel_frames = np.minimum(np.ceil(self.lengths / 160).astype(np.int64), frames)
        self.padded = bucket_frames(frames) * 160
        r = rng(seed, 2)
        self.pcm = np.zeros((self.batch, self.padded), np.int16)
        for i, std in enumerate(levels(traffic, r, self.batch)):
            self.pcm[i, :self.lengths[i]] = noise_pcm(r, int(self.lengths[i]), std)
        self.max_new_tokens = int(traffic["max_new_tokens"])

    def rows(self, lap: int) -> np.ndarray:
        """The pool index of each row of lap ``lap``."""
        return (np.arange(self.batch) + lap * self.ROTATE) % self.batch

    def audio_s(self) -> float:
        """Real audio seconds in one lap."""
        return float(self.lengths.sum()) / SAMPLE_RATE


def bucket_frames(n: int, buckets=(500, 1000, 1500, 2000, 2500, 3000)) -> int:
    """The serving and training front end's mel bucket of ``n`` frames."""
    for b in buckets:
        if n <= b:
            return b
    step = buckets[-1] - buckets[-2]
    return buckets[-1] + int(math.ceil((n - buckets[-1]) / step) * step)


def transcript(r: np.random.Generator, n_chars: int) -> str:
    """``n_chars`` of random lowercase words (2-8 letters, single spaces)."""
    out: list[str] = []
    size = 0
    while size < n_chars:
        word = "".join(r.choice(list("abcdefghijklmnopqrstuvwxyz"), int(r.integers(2, 9))))
        out.append(word)
        size += len(word) + 1
    text = " ".join(out)[:n_chars].rstrip()
    return text + "x" * (n_chars - len(text))


class TrainRows:
    """The rows of a training cell: ``micro_batches`` micro-batches of
    ``micro_batch`` clips.  Each micro-batch holds one clip from each of
    ``micro_batch`` strata of the length range (its own offset inside them),
    in an order the seed draws; transcripts of ``chars_per_s`` a second."""

    def __init__(self, traffic: dict, seed: int):
        lo, hi = traffic["clip_s"]
        self.micro_batch = b = int(traffic["micro_batch"])
        self.micro_batches = m = int(traffic["micro_batches"])
        self.accum = int(traffic["accum"])
        r_order, r_audio, r_text = rng(seed, 3), rng(seed, 4), rng(seed, 5)
        self.batches = []
        for i in range(m):
            secs = stratified(lo, hi, b, (i + 0.5) / m)[r_order.permutation(b)]
            lengths = samples(secs)
            clips = [noise_pcm(r_audio, int(n), std)
                     for n, std in zip(lengths, levels(traffic, r_audio, b))]
            texts = [transcript(r_text, int(round(traffic["chars_per_s"] * s))) for s in secs]
            self.batches.append({"pcm": clips, "texts": texts, "lengths": lengths})

    @staticmethod
    def audio(pcm: np.ndarray) -> np.ndarray:
        """A clip as the float waveform the collator reads."""
        return pcm.astype(np.float32) / 32768.0
