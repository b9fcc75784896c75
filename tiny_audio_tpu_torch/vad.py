"""Trained neural VAD: a small causal conv + GRU frame classifier.

Port of :mod:`tiny_audio_tpu.vad`.  The network reads 40-band log-mel
features on the hop-256 grid (16 kHz) and gives one speech logit per frame;
it is causal (left-padded convs, a forward GRU), so it also streams.  Its
weights are a byte-identical copy of the JAX package's checked-in
``vad_weights.msgpack`` (``data/vad_weights.msgpack``).

- :class:`NeuralVAD` runs :class:`VADNet` on its device over length buckets
  (long clips tiled with 32 frames of left context); one instance per
  device (:meth:`NeuralVAD.get`).
- The numpy mirror (:func:`np_conv_stack`, :func:`np_gru_head`,
  :func:`np_vadnet_forward`) and :class:`StreamingVad` (incremental, on the
  host) are copied as they are.
- :func:`frame_vad_auto` is the diarizer's entry: the neural VAD when the
  weights load, else the energy / flatness heuristic (callers can tell which
  ran).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tiny_audio_tpu_torch.bridge import load_flax_tower
from tiny_audio_tpu_torch.device import require_device
from tiny_audio_tpu_torch.utils import msgpack_io

SAMPLE_RATE = 16000
HOP = 256          # TEN-VAD frame grid
WIN = 512          # analysis window (2 hops, hann)
N_MELS = 40
WEIGHTS_PATH = Path(__file__).parent / "data" / "vad_weights.msgpack"

#: inference length buckets (frames); 62.5 frames/s, so 4096 frames ~ 65 s
_FRAME_BUCKETS = (256, 1024, 4096)
#: left-context frames of each tile of a clip longer than the largest bucket
_TILE_CONTEXT = 32

#: decision threshold on sigmoid(logit)
THRESHOLD = 0.5


# ------------------------------------------------------------------- features


def _mel_filterbank(n_mels: int = N_MELS, n_fft: int = WIN,
                    sr: int = SAMPLE_RATE) -> np.ndarray:
    """Triangular mel filterbank [n_fft//2+1, n_mels] (HTK mel scale,
    0..Nyquist)."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    fb = np.zeros((n_fft // 2 + 1, n_mels), np.float32)
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[:, i] = np.maximum(0.0, np.minimum(up, down))
    return fb


_FILTERBANK: Optional[np.ndarray] = None
_HANN: Optional[np.ndarray] = None


def _dsp_tables() -> tuple[np.ndarray, np.ndarray]:
    global _FILTERBANK, _HANN
    if _FILTERBANK is None:
        _FILTERBANK = _mel_filterbank()
        _HANN = np.hanning(WIN).astype(np.float32)
    return _FILTERBANK, _HANN


def _raw_logmel_np(frames: np.ndarray) -> np.ndarray:
    """[T, WIN] sample frames -> [T, N_MELS] un-normalized log-mel (numpy)."""
    fb, hann = _dsp_tables()
    power = np.abs(np.fft.rfft(frames * hann, axis=-1)) ** 2
    return np.log(power @ fb + 1e-8).astype(np.float32)


def _frame_signal(audio: np.ndarray, n_frames: int) -> np.ndarray:
    """[n] samples -> [n_frames, WIN] hop-strided frames (zero-padded
    tail), matching :func:`vad_logmel`'s framing."""
    need = n_frames * HOP + (WIN - HOP)
    if audio.shape[-1] < need:
        audio = np.pad(audio, (0, need - audio.shape[-1]))
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(WIN)[None, :]
    return audio[idx]


def vad_logmel_np(audio: np.ndarray, n_frames: Optional[int] = None) -> np.ndarray:
    """Numpy features of one clip: [n] float32 -> [T, N_MELS], per-clip
    mean-subtracted.  Inference uses these (the host does the DSP)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    if n_frames is None:
        n_frames = audio.size // HOP
    logmel = _raw_logmel_np(_frame_signal(audio, n_frames))
    return logmel - logmel.mean(axis=0, keepdims=True)


def vad_logmel(audio: torch.Tensor, n_frames: Optional[int] = None) -> torch.Tensor:
    """[..., n] float32 -> [..., T, N_MELS] log-mel on the hop-256 grid, on
    the audio's device.

    Frame t covers samples ``[t*HOP, t*HOP + WIN)`` (zero-padded past the
    end), so it needs one hop of lookahead; per-clip log-domain mean
    subtraction gives level invariance."""
    fb, hann = _dsp_tables()
    audio = audio.to(torch.float32)
    if n_frames is None:
        n_frames = int(audio.shape[-1]) // HOP
    pad = n_frames * HOP + (WIN - HOP) - audio.shape[-1]
    if pad > 0:
        audio = F.pad(audio, (0, int(pad)))
    frames = audio.unfold(-1, WIN, HOP)[..., :n_frames, :]
    frames = frames * torch.from_numpy(hann).to(audio.device)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    logmel = torch.log(power @ torch.from_numpy(fb).to(audio.device) + 1e-8)
    return logmel - logmel.mean(dim=-2, keepdim=True)


# -------------------------------------------------------------------- network


class VADNet(nn.Module):
    """Causal dilated-conv stack + forward GRU + per-frame logit (~47 k
    parameters): three convs of kernel 5 at dilations 1, 2, 4, each
    left-padded by ``4 * dilation`` and followed by ReLU, a GRU of 48 -> 64
    and a Dense layer to one logit.  Names follow the flax tree (the GRU is
    flax's ``GRUCell_0``)."""

    DILATIONS = (1, 2, 4)

    def __init__(self, hidden: int = 48, gru_hidden: int = 64, device=None):
        super().__init__()
        for d in self.DILATIONS:
            self.add_module(f"conv_d{d}", nn.Conv1d(N_MELS if d == 1 else hidden, hidden, 5,
                                                    dilation=d, device=device))
        self.GRUCell_0 = nn.GRU(hidden, gru_hidden, batch_first=True, device=device)
        self.out = nn.Linear(gru_hidden, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, N_MELS] normalized features -> [B, T] logits."""
        x = x.transpose(1, 2)
        for d in self.DILATIONS:
            x = torch.relu(getattr(self, f"conv_d{d}")(F.pad(x, (4 * d, 0))))
        h, _ = self.GRUCell_0(x.transpose(1, 2))
        return self.out(h)[..., 0]


# ------------------------------------------------------------------ inference


def frame_probs_with(audio: np.ndarray,
                     logits_of: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """[n] float32 samples -> [n//HOP] speech probabilities, with
    ``logits_of`` mapping padded features ``[1, bucket, N_MELS]`` to logits
    ``[bucket]``.

    Features are computed over the real frames first and only then padded
    to the bucket (the per-clip mean must not see the padding; the causal
    net cannot see it either).  A clip past the largest bucket is tiled:
    each tile scores ``bucket - 32`` frames after 32 frames of left
    context."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    n_frames = len(audio) // HOP
    if n_frames == 0:
        return np.zeros(0, np.float32)
    bucket = next((b for b in _FRAME_BUCKETS if b >= n_frames), None)
    if bucket is None:
        probs = np.zeros(n_frames, np.float32)
        step = _FRAME_BUCKETS[-1] - _TILE_CONTEXT
        start = 0
        while start < n_frames:
            s0 = max(start - _TILE_CONTEXT, 0)
            end = min(start + step, n_frames)
            p = frame_probs_with(audio[s0 * HOP: end * HOP], logits_of)
            probs[start:end] = p[start - s0: end - s0]
            start = end
        return probs
    feats = vad_logmel_np(audio, n_frames=n_frames)[None]
    if bucket > n_frames:
        feats = np.pad(feats, ((0, 0), (0, bucket - n_frames), (0, 0)))
    logits = np.asarray(logits_of(feats), np.float32)
    return 1.0 / (1.0 + np.exp(-logits[:n_frames]))


class NeuralVAD:
    """The VAD net on one device.  :meth:`get` keeps one instance per
    device (None when the weights are missing or unusable: the diarizer then
    takes the heuristic); an instance never serves another device."""

    _instances: dict = {}
    _lock = threading.Lock()
    _load_failed = False

    def __init__(self, params: dict, device="cuda"):
        self.device = require_device(device)
        self.params = params  # the flax tree (CPU tensors), for the numpy mirror
        self.net = VADNet(device=self.device).eval()
        load_flax_tower(self.net, params)

    @classmethod
    def get(cls, device="cuda") -> Optional["NeuralVAD"]:
        device = require_device(device)
        with cls._lock:
            if str(device) in cls._instances:
                return cls._instances[str(device)]
            if cls._load_failed or not WEIGHTS_PATH.is_file():
                return None
            try:
                cls._instances[str(device)] = cls.from_file(WEIGHTS_PATH, device)
            except Exception:  # corrupt / incompatible weights -> heuristic
                cls._load_failed = True
                return None
            return cls._instances[str(device)]

    @classmethod
    def from_file(cls, path, device="cuda") -> "NeuralVAD":
        return cls(msgpack_io.load(path), device)

    @torch.inference_mode()
    def _logits(self, feats: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(self.device)
        return self.net(x)[0].cpu().numpy()

    def frame_probs(self, audio: np.ndarray) -> np.ndarray:
        """[n] float32 samples -> [n//HOP] speech probabilities."""
        return frame_probs_with(audio, self._logits)

    def __call__(self, audio: np.ndarray, threshold: float = THRESHOLD) -> np.ndarray:
        """[n] samples -> [n//HOP] bool speech decisions."""
        return self.frame_probs(audio) >= threshold


# ------------------------------------------------------------------ streaming


def _np_params(params: dict) -> dict:
    """The flax param tree as host numpy arrays."""

    def host(x):
        return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)

    out = {}
    for name in ("conv_d1", "conv_d2", "conv_d4"):
        out[name] = (host(params[name]["kernel"]), host(params[name]["bias"]))
    gru = params["GRUCell_0"]
    for g in ("ir", "iz", "in", "hr", "hz", "hn"):
        out[g] = (host(gru[g]["kernel"]), host(gru[g]["bias"]) if "bias" in gru[g] else None)
    out["out"] = (host(params["out"]["kernel"]), host(params["out"]["bias"]))
    return out


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(x, -60.0, 60.0)))


def np_conv_stack(p: dict, x: np.ndarray) -> np.ndarray:
    """[T, N_MELS] normalized features -> [T, hidden] conv-stack output
    (causal zero left-padding, identical to the network's convs)."""
    for name, d in (("conv_d1", 1), ("conv_d2", 2), ("conv_d4", 4)):
        k, b = p[name]  # [5, Cin, Cout]
        taps = k.shape[0]
        pad = (taps - 1) * d
        xp = np.concatenate([np.zeros((pad, x.shape[1]), np.float32), x], axis=0)
        T = x.shape[0]
        y = b + sum(xp[j * d: j * d + T] @ k[j] for j in range(taps))
        x = np.maximum(y, 0.0)
    return x


def np_gru_head(p: dict, x: np.ndarray,
                h0: Optional[np.ndarray] = None) -> tuple[np.ndarray, np.ndarray]:
    """[T, hidden] conv outputs -> ([T] logits, final GRU hidden); flax
    GRUCell semantics."""
    h = np.zeros(p["hr"][0].shape[0], np.float32) if h0 is None else h0
    w_out, b_out = p["out"]
    logits = np.empty(x.shape[0], np.float32)
    for t in range(x.shape[0]):
        xt = x[t]
        r = _sigmoid(xt @ p["ir"][0] + p["ir"][1] + h @ p["hr"][0])
        z = _sigmoid(xt @ p["iz"][0] + p["iz"][1] + h @ p["hz"][0])
        n = np.tanh(xt @ p["in"][0] + p["in"][1] + r * (h @ p["hn"][0] + p["hn"][1]))
        h = (1.0 - z) * n + z * h
        logits[t] = float(h @ w_out[:, 0] + b_out[0])
    return logits, h


def np_vadnet_forward(p: dict, x: np.ndarray) -> np.ndarray:
    """Numpy mirror of the network: [T, N_MELS] normalized features -> [T]
    logits."""
    return np_gru_head(p, np_conv_stack(p, x))[0]


class StreamingVad:
    """Host-side incremental VAD: O(new frames) per call, the trained net in
    numpy.

    Differences from the batch scorer: normalization uses a per-frame
    cumulative log-mel mean over the session so far (decisions are exactly
    chunk-size-invariant), and the GRU integrates from session start.

    State per instance: pending unframed samples, the last ``CTX``
    normalized feature rows for conv left-context, the GRU hidden, and the
    running mean.  ``reset()`` clears turn-local state but keeps the running
    level estimate.
    """

    #: conv-stack receptive field in frames: 4*(1+2+4) left taps
    CTX = 28

    def __init__(self, params: dict):
        self.p = params if "ir" in params else _np_params(params)
        self._mean_sum = np.zeros(N_MELS, np.float64)
        self._mean_n = 0
        self.reset(keep_level=True)

    @classmethod
    def make(cls) -> Optional["StreamingVad"]:
        """Fresh per-session instance over the checked-in weights (one numpy
        weight dict shared process-wide), or None without weights."""
        global _NP_PARAMS
        if _NP_PARAMS is None:
            if NeuralVAD._load_failed or not WEIGHTS_PATH.is_file():
                return None
            try:
                _NP_PARAMS = _np_params(msgpack_io.load(WEIGHTS_PATH))
            except Exception:
                return None
        return cls(_NP_PARAMS)

    def reset(self, keep_level: bool = True) -> None:
        self._pending = np.zeros(0, np.float32)
        self._ctx = np.zeros((0, N_MELS), np.float32)  # normalized rows, <= CTX
        self._h: Optional[np.ndarray] = None
        if not keep_level:
            self._mean_sum[:] = 0.0
            self._mean_n = 0

    def feed(self, samples: np.ndarray, threshold: float = THRESHOLD) -> np.ndarray:
        """Append samples; return bool decisions for newly completed frames
        (a frame completes once its full WIN window arrived)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size:
            self._pending = (np.concatenate([self._pending, samples])
                             if self._pending.size else samples)
        if self._pending.size < WIN:
            return np.zeros(0, bool)
        k = (self._pending.size - WIN) // HOP + 1
        frames = np.lib.stride_tricks.sliding_window_view(self._pending, WIN)[::HOP][:k]
        raw = _raw_logmel_np(frames)
        self._pending = self._pending[k * HOP:]

        # frame i is normalized by the mean of rows 0..i: a pure function of
        # the frame index, so normalized rows can be kept as conv context
        csum = np.cumsum(raw, axis=0, dtype=np.float64) + self._mean_sum
        counts = (np.arange(1, k + 1, dtype=np.float64) + self._mean_n)[:, None]
        x_new = raw - (csum / counts).astype(np.float32)
        self._mean_sum = csum[-1]
        self._mean_n += k

        # with fewer than CTX context rows they are all rows since session
        # start, so the conv stack's zero left-padding reproduces the batch
        # forward; once trimmed to CTX rows the receptive fields are covered
        x = np.concatenate([self._ctx, x_new], axis=0)
        conv_out = np_conv_stack(self.p, x)[-k:]
        logits, self._h = np_gru_head(self.p, conv_out, h0=self._h)

        self._ctx = x[-self.CTX:]
        thr_logit = float(np.log(threshold / (1.0 - threshold)))
        return logits >= thr_logit


_NP_PARAMS: Optional[dict] = None


def frame_vad_auto(audio: np.ndarray, sample_rate: int = SAMPLE_RATE,
                   device="cuda") -> tuple[np.ndarray, bool]:
    """Per-frame speech decisions by the neural VAD on ``device`` when its
    weights load, else by the energy / flatness heuristic.  Returns
    ``(decisions, trained)``: ``trained=False`` means the heuristic ran."""
    if sample_rate != SAMPLE_RATE:
        from tiny_audio_tpu_torch.utils.audio_io import resample

        audio = resample(np.asarray(audio, np.float32), sample_rate, SAMPLE_RATE)
    model = NeuralVAD.get(device)
    if model is not None:
        return model(audio), True
    from tiny_audio_tpu_torch.diarization import frame_vad

    return frame_vad(audio, SAMPLE_RATE), False
