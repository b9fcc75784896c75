"""Speaker diarization: VAD -> windowed speaker embeddings -> spectral clustering.

Port of :mod:`tiny_audio_tpu.diarization`:

1. :func:`~tiny_audio_tpu_torch.vad.frame_vad_auto` (the neural VAD on the
   device, or :func:`frame_vad`, the energy + flatness heuristic in numpy),
   then :func:`decisions_to_segments` (gap-fill <= 0.5 s, min duration
   0.05 s, +/-0.05 s padding).
2. :class:`EcapaEmbedder`: ECAPA-TDNN (:mod:`tiny_audio_tpu_torch.models.
   ecapa`) on the device over every sliding window (0.75 s / 0.15 s step) in
   one batched forward, its batch padded to a power of 2 as in the JAX
   package.  One embedder per device (:meth:`EcapaEmbedder.get`).
3. :class:`SpectralCluster` and :class:`SpeakerClusterer` (numpy): cosine
   affinity, p-pruning, the normalized Laplacian's eigen-ratio speaker
   count, k-means, split and merge refinement.
4. 10 ms consensus voting masked by VAD, short-segment merge, and
   word->speaker assignment.

Stages 3 and 4, the windows and the segment logic are copied from the JAX
package as they are.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from tiny_audio_tpu_torch.bridge import load_flax_tower
from tiny_audio_tpu_torch.device import require_device
from tiny_audio_tpu_torch.models.ecapa import EcapaTDNN
from tiny_audio_tpu_torch.ops.mel import mel_filter_bank
from tiny_audio_tpu_torch.utils import msgpack_io

SAMPLE_RATE = 16000
VAD_HOP = 256  # TEN-VAD hop size
MAX_GAP_S = 0.5
MIN_SEGMENT_S = 0.05
SEGMENT_PAD_S = 0.05
WINDOW_S = 0.75
WINDOW_STEP_S = 0.15
VOTE_GRID_S = 0.01
MIN_FINAL_SEGMENT_S = 0.2


# --------------------------------------------------------------------------- VAD


def frame_vad(
    audio: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    hop: int = VAD_HOP,
    energy_percentile: float = 10.0,
    margin_db: float = 6.0,
) -> np.ndarray:
    """Per-frame speech decisions (bool, one per ``hop`` samples): the
    energy + spectral-flatness heuristic, in numpy.

    Adaptive threshold: the noise floor is the ``energy_percentile``-th
    percentile of frame energies and the margin above it shrinks with the
    clip's dynamic range (``min(margin_db, 0.3 * (p95 - p10))``); an absolute
    -70 dBFS floor rejects digital silence.  A frame is speech when it clears
    the threshold and its spectral flatness is below 0.5, or when its energy
    is very high regardless.
    """
    audio = np.asarray(audio, np.float32).reshape(-1)
    n_frames = max(len(audio) // hop, 0)
    if n_frames == 0:
        return np.zeros(0, dtype=bool)

    frames = audio[: n_frames * hop].reshape(n_frames, hop)
    energy_db = 10.0 * np.log10(np.mean(frames**2, axis=1) + 1e-10)
    window = np.hanning(hop).astype(np.float32)
    spec = np.abs(np.fft.rfft(frames * window, axis=1)) + 1e-10
    # flatness: geometric mean / arithmetic mean of the power spectrum
    power = spec**2
    flatness = np.exp(np.mean(np.log(power), axis=1)) / np.mean(power, axis=1)

    floor_db = float(np.percentile(energy_db, energy_percentile))
    ceil_db = float(np.percentile(energy_db, 95.0))
    eff_margin = min(margin_db, 0.3 * max(ceil_db - floor_db, 0.0))
    threshold_db = max(floor_db + eff_margin, -70.0)
    loud = energy_db > threshold_db
    very_loud = energy_db > threshold_db + 2.0 * margin_db
    return (loud & (flatness < 0.5)) | very_loud


def decisions_to_segments(
    decisions: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    hop: int = VAD_HOP,
    max_gap: float = MAX_GAP_S,
    min_duration: float = MIN_SEGMENT_S,
    padding: float = SEGMENT_PAD_S,
    total_duration: Optional[float] = None,
) -> list[tuple[float, float]]:
    """Frame decisions -> (start, end) seconds with hysteresis: gap-fill,
    minimum duration, symmetric padding."""
    frame_s = hop / sample_rate
    segments: list[list[float]] = []
    start = None
    for i, speech in enumerate(decisions):
        if speech and start is None:
            start = i * frame_s
        elif not speech and start is not None:
            segments.append([start, i * frame_s])
            start = None
    if start is not None:
        segments.append([start, len(decisions) * frame_s])

    # gap-fill: merge segments separated by < max_gap
    merged: list[list[float]] = []
    for seg in segments:
        if merged and seg[0] - merged[-1][1] <= max_gap:
            merged[-1][1] = seg[1]
        else:
            merged.append(seg)

    total = total_duration if total_duration is not None else len(decisions) * frame_s
    out = []
    for s, e in merged:
        if e - s < min_duration:
            continue
        out.append((max(0.0, s - padding), min(total, e + padding)))
    return out


# ------------------------------------------------------------ speaker embedder


def _speaker_fbank(frames: np.ndarray, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """[N, samples] windows -> [N, T, 80] log-mel features (25 ms / 10 ms)."""
    win_len = int(0.025 * sample_rate)
    hop = int(0.010 * sample_rate)
    n_fft = 512
    n, total = frames.shape
    n_frames = 1 + (total - win_len) // hop
    idx = np.arange(win_len)[None, :] + hop * np.arange(n_frames)[:, None]
    windowed = frames[:, idx] * np.hamming(win_len).astype(np.float32)
    spec = np.abs(np.fft.rfft(windowed, n=n_fft, axis=-1)) ** 2
    fb = mel_filter_bank(
        num_frequency_bins=n_fft // 2 + 1,
        num_mel_filters=80,
        min_frequency=20.0,
        max_frequency=sample_rate / 2,
        sampling_rate=sample_rate,
    ).astype(np.float32)
    mel = np.log(spec @ fb + 1e-6)
    mel = mel - mel.mean(axis=1, keepdims=True)  # per-window CMN
    return mel.astype(np.float32)


class EcapaEmbedder:
    """ECAPA-TDNN on one device, giving L2-normalized embeddings.

    Tiers: ``"synthetic"`` (the checked-in compact model,
    ``data/ecapa_synthetic.msgpack``, fp16 on disk and fp32 after load),
    ``"speechbrain"`` (converted weights: :meth:`from_converted`,
    :meth:`load_weights`) or ``"random"`` (a seeded init: :attr:`trained` is
    False and the diarizer tags its segments ``"fallback"``).  :meth:`get`
    keeps one embedder per device, and an embedder never serves another
    device.
    """

    _instances: dict = {}

    SYNTH_WEIGHTS = Path(__file__).parent / "data" / "ecapa_synthetic.msgpack"
    SYNTH_CHANNELS = (256, 256, 256, 256, 768)

    def __init__(self, module=None, params: Optional[dict] = None, seed: int = 0,
                 tier: Optional[str] = None, device="cuda"):
        self.device = require_device(device)
        if module is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                module = EcapaTDNN()
        self.module = module.to(self.device).eval()
        if params is None:
            self.tier = tier or "random"
        else:
            load_flax_tower(self.module, params)
            self.tier = tier or "speechbrain"

    @property
    def trained(self) -> bool:
        """True when the weights are not a random init (synthetic or
        speechbrain tier); ``tier`` says which."""
        return self.tier != "random"

    @property
    def embed_dim(self) -> int:
        return self.module.embed_dim

    @classmethod
    def get(cls, device="cuda") -> "EcapaEmbedder":
        """The best tier attached for ``device``: converted speechbrain
        weights when attached (``ASRModel.from_pretrained``), else the
        checked-in synthetic tier, else a random init."""
        key = str(require_device(device))
        if key not in cls._instances:
            try:
                cls._instances[key] = cls.from_synthetic(device=device)
            except Exception:
                cls._instances[key] = cls(device=device)
        return cls._instances[key]

    @classmethod
    def from_synthetic(cls, path=None, device="cuda") -> "EcapaEmbedder":
        """The compact synthetic-voice-trained tier (fp16 on disk)."""

        params = msgpack_io.load(path or cls.SYNTH_WEIGHTS)
        return cls(module=EcapaTDNN(channels=cls.SYNTH_CHANNELS), params=params,
                   tier="synthetic", device=device)

    def load_weights(self, path) -> None:
        """Converted weights of this embedder's geometry."""

        load_flax_tower(self.module, msgpack_io.load(path))
        self.tier = "speechbrain"

    @classmethod
    def from_converted(cls, path, device="cuda") -> "EcapaEmbedder":
        """An ``ecapa_embedder.msgpack`` (the JAX package's converted
        speechbrain weights); the geometry comes from the stored shapes, so
        the 512- and 1024-channel releases both load."""

        raw = msgpack_io.load(path)
        c0 = raw["blocks_0"]["conv"]["kernel"].shape[2]
        c4 = raw["mfa"]["conv"]["kernel"].shape[2]
        module = EcapaTDNN(
            channels=(c0, c0, c0, c0, c4),
            embed_dim=raw["fc"]["kernel"].shape[-1],
            attention_channels=raw["asp_tdnn"]["conv"]["kernel"].shape[2],
        )
        return cls(module=module, params=raw, tier="speechbrain", device=device)

    @torch.inference_mode()
    def embed_windows(self, windows: np.ndarray) -> np.ndarray:
        """[N, samples] -> [N, embed_dim] L2-normalized embeddings; the batch
        pads to a power of 2 (the JAX package's shapes)."""
        if windows.shape[0] == 0:
            return np.zeros((0, self.embed_dim), np.float32)
        feats = _speaker_fbank(windows)
        n = feats.shape[0]
        bucket = 1
        while bucket < n:
            bucket *= 2
        if bucket != n:
            feats = np.concatenate(
                [feats, np.zeros((bucket - n,) + feats.shape[1:], feats.dtype)]
            )
        x = torch.from_numpy(feats).to(self.device)
        emb = self.module(x)[:n].float().cpu().numpy()
        norm = np.linalg.norm(emb, axis=1, keepdims=True)
        return emb / np.maximum(norm, 1e-8)


def sliding_windows(
    audio: np.ndarray,
    segments: Sequence[tuple[float, float]],
    sample_rate: int = SAMPLE_RATE,
    window_s: float = WINDOW_S,
    step_s: float = WINDOW_STEP_S,
) -> tuple[np.ndarray, list[tuple[float, float]]]:
    """Cut fixed-size windows inside VAD segments.

    Returns ([N, window_samples] float32, [(start_s, end_s)] per window).
    Windows shorter than the nominal size are zero-padded (segment tails).
    """
    wlen = int(window_s * sample_rate)
    step = int(step_s * sample_rate)
    chunks, spans = [], []
    for seg_start, seg_end in segments:
        s0 = int(seg_start * sample_rate)
        s1 = min(int(seg_end * sample_rate), len(audio))
        pos = s0
        while pos < s1:
            # clamp to the segment end: reading past s1 would embed the next
            # speaker's audio into this segment's window
            chunk = audio[pos : min(pos + wlen, s1)]
            if len(chunk) < wlen // 3:  # skip tiny tails
                break
            if len(chunk) < wlen:
                chunk = np.pad(chunk, (0, wlen - len(chunk)))
            chunks.append(chunk)
            spans.append((pos / sample_rate, min(pos + wlen, s1) / sample_rate))
            if pos + wlen >= s1:
                break
            pos += step
    if not chunks:
        return np.zeros((0, wlen), np.float32), []
    return np.stack(chunks).astype(np.float32), spans


# ---------------------------------------------------------------- clustering


def _kmeans(x: np.ndarray, k: int, n_iter: int = 50, seed: int = 0) -> np.ndarray:
    """Plain k-means with k-means++ init (replaces sklearn KMeans)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((x - c) ** 2, axis=1) for c in centers], axis=0
        )
        total = d2.sum()
        if total <= 0:
            centers.append(x[rng.integers(n)])
            continue
        centers.append(x[rng.choice(n, p=d2 / total)])
    centers = np.stack(centers)
    labels = np.zeros(n, np.int64)
    for _ in range(n_iter):
        dists = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = dists.argmin(1)
        if np.array_equal(new_labels, labels) and _ > 0:
            break
        labels = new_labels
        for j in range(k):
            pts = x[labels == j]
            if len(pts):
                centers[j] = pts.mean(0)
    return labels


@dataclasses.dataclass
class SpectralCluster:
    """Spectral clustering with eigengap speaker-count estimation.

    It uses the symmetric normalized Laplacian
    ``I - D^-1/2 A D^-1/2`` and pick k by the largest eigenvalue RATIO
    ``(ev[k]+eps)/(ev[k-1]+eps)`` — scale-invariant, so it survives
    embedders with different affinity ranges (the checked-in synthetic
    tier's same-speaker cosine is ~0.5 vs speechbrain's ~0.9).  Measured on
    the synthetic-conversation grid (16 rows, 4 seeds): ratio-gap matched
    the true count 15/16 vs 11/16 for the unnormalized absolute gap.  The
    one miss is structural — p-pruning can leave the affinity graph with
    c < k_true exact connected components, making ev[c-1] exactly zero and
    saturating the ratio at k=c; :class:`SpeakerClusterer`'s split
    refinement recovers that case from the embedding side."""

    min_clusters: int = 2
    max_clusters: int = 10
    pval: float = 0.06
    #: softens the ratio at near-zero eigenvalues so numerical noise in a
    #: ~1e-8 eigenvalue cannot manufacture a huge ratio
    eps: float = 1e-3

    def _prune(self, affinity: np.ndarray) -> np.ndarray:
        n = affinity.shape[0]
        keep = max(int(np.ceil(self.pval * n)), 2)
        pruned = np.array(affinity)
        for i in range(n):
            idx = np.argsort(pruned[i])[: n - keep]
            pruned[i, idx] = 0.0
        return (pruned + pruned.T) / 2.0  # symmetrize

    def estimate_num_speakers(self, eigenvalues: np.ndarray) -> int:
        """Largest ratio-gap over k in [min_clusters, max_clusters]."""
        n = len(eigenvalues)
        hi = min(self.max_clusters, n - 1)
        if hi < self.min_clusters:
            return self.min_clusters
        ev = np.maximum(eigenvalues, 0.0)  # eigh noise can go slightly <0
        ratios = [
            (ev[k] + self.eps) / (ev[k - 1] + self.eps)
            for k in range(self.min_clusters, hi + 1)
        ]
        return int(np.argmax(ratios) + self.min_clusters)

    def __call__(
        self, embeddings: np.ndarray, num_speakers: Optional[int] = None
    ) -> np.ndarray:
        n = embeddings.shape[0]
        if n == 0:
            return np.zeros(0, np.int64)
        if n == 1 or (num_speakers is not None and num_speakers <= 1):
            return np.zeros(n, np.int64)

        affinity = embeddings @ embeddings.T  # embeddings are L2-normalized
        affinity = self._prune(np.clip(affinity, 0.0, 1.0))
        degree = affinity.sum(axis=1)
        dinv = 1.0 / np.sqrt(np.maximum(degree, 1e-10))
        laplacian = np.eye(n) - dinv[:, None] * affinity * dinv[None, :]
        eigvals, eigvecs = np.linalg.eigh(laplacian)

        k = (
            int(num_speakers)
            if num_speakers is not None
            else self.estimate_num_speakers(eigvals)
        )
        k = min(k, n)
        # Ng-Jordan-Weiss: row-normalize the spectral embedding before
        # k-means (rows of unequal norm otherwise bias the centroids)
        spectral = eigvecs[:, :k]
        spectral = spectral / np.maximum(
            np.linalg.norm(spectral, axis=1, keepdims=True), 1e-10
        )
        return _kmeans(spectral, k)


class SpeakerClusterer:
    """NaN guards + oracle-count mode + centroid post-merge."""

    def __init__(
        self,
        num_speakers: Optional[int] = None,
        min_speakers: int = 2,
        max_speakers: int = 10,
        merge_threshold: float = 0.90,
        split_threshold: float = 0.25,
    ):
        self.num_speakers = num_speakers
        self.merge_threshold = merge_threshold
        self.split_threshold = split_threshold
        self.max_speakers = max_speakers
        self.cluster = SpectralCluster(
            min_clusters=min_speakers, max_clusters=max_speakers
        )

    def __call__(self, embeddings: np.ndarray) -> np.ndarray:
        emb = np.asarray(embeddings, np.float32)
        if emb.ndim != 2 or emb.shape[0] == 0:
            return np.zeros(emb.shape[0] if emb.ndim else 0, np.int64)
        bad = ~np.isfinite(emb).all(axis=1)
        if bad.all():
            return np.zeros(emb.shape[0], np.int64)
        if bad.any():  # replace NaN rows with the mean of good rows (on a copy)
            emb = emb.copy()
            emb[bad] = emb[~bad].mean(axis=0)
        labels = self.cluster(emb, num_speakers=self.num_speakers)
        if self.num_speakers is None:
            labels = self._split_mixed_clusters(emb, labels)
            labels = self._merge_close_centroids(emb, labels)
        # relabel to consecutive ids ordered by first appearance
        order = {}
        for lb in labels:
            if lb not in order:
                order[lb] = len(order)
        return np.array([order[lb] for lb in labels], np.int64)

    def _split_mixed_clusters(
        self, emb: np.ndarray, labels: np.ndarray, min_windows: int = 6
    ) -> np.ndarray:
        """Split clusters that contain two clearly distinct voices.

        Covers the spectral estimator's structural blind spot: when
        p-pruning disconnects the affinity graph into c components but one
        component holds 2 speakers, the eigen-spectrum says k=c and two
        voices land in one cluster.  Remedy: 2-means each cluster in the
        ORIGINAL embedding space and accept the split only when the two
        sub-centroids' cosine falls below ``split_threshold`` (0.25 —
        far below any observed same-speaker centroid cosine: averaging
        windows puts same-voice centroids at >=0.7 even for the synthetic
        embedder tier whose window-level same-speaker cosine is ~0.5, while
        distinct synthetic voices measure ~0.13; speechbrain-tier values
        run higher still, so false splits stay out of reach).  Each side
        must keep ``min_windows`` windows (~1.5 s of speech at the 0.15 s
        window step) so outlier windows cannot shave off a phantom speaker."""
        labels = np.array(labels)
        next_id = int(labels.max()) + 1 if len(labels) else 0
        changed = True
        while changed and len(np.unique(labels)) < self.max_speakers:
            changed = False
            for cid in np.unique(labels):
                idx = np.where(labels == cid)[0]
                if len(idx) < 2 * min_windows:
                    continue
                sub = _kmeans(emb[idx], 2, seed=1)
                n1 = int(sub.sum())
                if min(n1, len(idx) - n1) < min_windows:
                    continue
                cents = []
                for side in (0, 1):
                    c = emb[idx[sub == side]].mean(0)
                    cents.append(c / max(float(np.linalg.norm(c)), 1e-8))
                if float(cents[0] @ cents[1]) < self.split_threshold:
                    labels[idx[sub == 1]] = next_id
                    next_id += 1
                    changed = True
        return labels

    def _merge_close_centroids(
        self, emb: np.ndarray, labels: np.ndarray
    ) -> np.ndarray:
        """Agglomerative merge of centroids with cosine >= threshold."""
        while True:
            ids = np.unique(labels)
            if len(ids) <= 1:
                return labels
            cents = np.stack([emb[labels == i].mean(0) for i in ids])
            cents = cents / np.maximum(
                np.linalg.norm(cents, axis=1, keepdims=True), 1e-8
            )
            sim = cents @ cents.T
            np.fill_diagonal(sim, -1.0)
            i, j = np.unravel_index(np.argmax(sim), sim.shape)
            if sim[i, j] < self.merge_threshold:
                return labels
            labels = np.where(labels == ids[j], ids[i], labels)


# --------------------------------------------------------------- orchestration


class LocalSpeakerDiarizer:
    """VAD -> windows -> batched embeddings -> clustering -> 10 ms consensus
    voting -> segments, with the VAD and the embedder on ``device``."""

    def __init__(
        self,
        num_speakers: Optional[int] = None,
        min_speakers: int = 2,
        max_speakers: int = 10,
        embedder: Optional[EcapaEmbedder] = None,
        device="cuda",
    ):
        self.clusterer = SpeakerClusterer(
            num_speakers=num_speakers,
            min_speakers=min_speakers,
            max_speakers=max_speakers,
        )
        self.embedder = embedder
        self.device = require_device(device)

    def diarize(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> list[dict]:
        audio = np.asarray(audio, np.float32).reshape(-1)
        if sample_rate != SAMPLE_RATE:
            # the embedder's features assume 16 kHz
            from tiny_audio_tpu_torch.utils.audio_io import resample

            audio = resample(audio, sample_rate, SAMPLE_RATE)
            sample_rate = SAMPLE_RATE
        duration = len(audio) / sample_rate

        from tiny_audio_tpu_torch.vad import frame_vad_auto

        decisions, vad_trained = frame_vad_auto(audio, sample_rate, device=self.device)
        vad_segments = decisions_to_segments(decisions, sample_rate, total_duration=duration)
        if not vad_segments:
            return []

        windows, spans = sliding_windows(audio, vad_segments, sample_rate)
        if len(spans) == 0:
            return []
        if len(spans) == 1:
            return [{"speaker": "SPEAKER_00", "start": spans[0][0], "end": spans[0][1]}]

        embedder = self.embedder or EcapaEmbedder.get(self.device)
        embeddings = embedder.embed_windows(windows)
        labels = self.clusterer(embeddings)
        segments = self._vote(labels, spans, vad_segments, duration)
        tier = getattr(embedder, "tier", None)
        if not getattr(embedder, "trained", False):
            # random-init embeddings give arbitrary speaker labels
            for seg in segments:
                seg["fallback"] = True
        elif tier == "synthetic":
            # the compact embedder trained on synthesized voices only
            for seg in segments:
                seg["embedder"] = "synthetic"
        if not vad_trained:
            # the heuristic VAD ran (no trained weights)
            for seg in segments:
                seg["vad_fallback"] = True
        return segments

    def _vote(
        self,
        labels: np.ndarray,
        spans: list[tuple[float, float]],
        vad_segments: list[tuple[float, float]],
        duration: float,
    ) -> list[dict]:
        """10 ms grid consensus voting masked by VAD."""
        n_cells = int(np.ceil(duration / VOTE_GRID_S)) + 1
        n_spk = int(labels.max()) + 1 if len(labels) else 0
        votes = np.zeros((n_cells, n_spk), np.int32)
        for (start, end), lb in zip(spans, labels):
            a = int(start / VOTE_GRID_S)
            z = min(int(end / VOTE_GRID_S), n_cells)
            votes[a:z, lb] += 1

        vad_mask = np.zeros(n_cells, bool)
        for start, end in vad_segments:
            vad_mask[int(start / VOTE_GRID_S) : min(int(np.ceil(end / VOTE_GRID_S)), n_cells)] = True

        cell_label = np.where(
            (votes.sum(axis=1) > 0) & vad_mask, votes.argmax(axis=1), -1
        )

        segments: list[dict] = []
        cur = -1
        seg_start = 0.0
        for i, lb in enumerate(list(cell_label) + [-1]):
            if lb != cur:
                if cur >= 0:
                    segments.append(
                        {
                            "speaker": f"SPEAKER_{cur:02d}",
                            "start": seg_start,
                            "end": i * VOTE_GRID_S,
                        }
                    )
                cur = lb
                seg_start = i * VOTE_GRID_S
        return self._merge_short(segments)

    @staticmethod
    def _merge_short(segments: list[dict]) -> list[dict]:
        """Absorb segments shorter than MIN_FINAL_SEGMENT_S into the previous
        same-speaker run or drop them."""
        out: list[dict] = []
        for seg in segments:
            if out and out[-1]["speaker"] == seg["speaker"] and seg["start"] - out[-1]["end"] < MAX_GAP_S:
                out[-1]["end"] = seg["end"]
                continue
            if seg["end"] - seg["start"] < MIN_FINAL_SEGMENT_S:
                # absorb only into an adjacent SAME-speaker run; a short
                # different-speaker blip is dropped, not relabeled
                if (
                    out
                    and out[-1]["speaker"] == seg["speaker"]
                    and seg["start"] - out[-1]["end"] < 0.1
                ):
                    out[-1]["end"] = seg["end"]
                continue
            out.append(dict(seg))
        return out


class SpeakerDiarizer:
    """The JAX package's public facade, with the device of the VAD and the
    embedder."""

    @staticmethod
    def diarize(
        audio: np.ndarray,
        sample_rate: int = SAMPLE_RATE,
        num_speakers: Optional[int] = None,
        min_speakers: int = 2,
        max_speakers: int = 10,
        device="cuda",
    ) -> list[dict]:
        return LocalSpeakerDiarizer(
            num_speakers=num_speakers,
            min_speakers=min_speakers,
            max_speakers=max_speakers,
            device=device,
        ).diarize(audio, sample_rate)

    @staticmethod
    def assign_speakers_to_words(
        words: list[dict], segments: list[dict]
    ) -> list[dict]:
        """Word-midpoint containment with closest-segment fallback.

        Every returned word carries a ``speaker`` key — ``None`` when no
        segments exist (silent-ish clips), so downstream consumers never
        hit a schema that varies by clip content."""
        if not segments:
            return [dict(w, speaker=None) for w in words]
        out = []
        for word in words:
            mid = (word.get("start", 0.0) + word.get("end", 0.0)) / 2.0
            speaker = None
            for seg in segments:
                if seg["start"] <= mid <= seg["end"]:
                    speaker = seg["speaker"]
                    break
            if speaker is None:
                dists = [
                    min(abs(mid - s["start"]), abs(mid - s["end"])) for s in segments
                ]
                speaker = segments[int(np.argmin(dists))]["speaker"]
            w = dict(word)
            w["speaker"] = speaker
            out.append(w)
        return out
