"""Wav2Vec2-CTC acoustic model for forced alignment, in PyTorch.

Port of :class:`tiny_audio_tpu.models.wav2vec2.Wav2Vec2CTC` (the
WAV2VEC2_ASR_BASE_960H geometry): a 7-layer VALID conv feature extractor
without bias (total stride 320 -> 20 ms frames), a channel norm over real
frames on the first layer, exact (erf) GELU, the feature projection
(LayerNorm, Dense), a grouped convolutional position embedding (kernel 128,
16 groups), 12 post-LN transformer layers whose attention masks the pad
keys, and a 29-label character CTC head with an fp32 log-softmax.

Module names follow the flax tree (``conv_0``, ``conv_gn``, ``fp_ln``,
``layer_3_q``, ...), so :func:`tiny_audio_tpu_torch.bridge.load_flax_tower`
fills it from the JAX package's ``wav2vec2_aligner.msgpack``.  Its attention
is plain PyTorch (the JAX package computes it outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tiny_audio_tpu_torch.models.layers import MASK_VALUE

# torchaudio WAV2VEC2_ASR_BASE_960H label set (blank '-' first)
CTC_LABELS = (
    "-", "|", "E", "T", "A", "O", "N", "I", "H", "S", "R", "D", "L", "U",
    "M", "W", "C", "F", "G", "Y", "P", "B", "V", "K", "'", "X", "J", "Q", "Z",
)

# (out_channels, kernel, stride) per conv layer; total stride 320
CONV_LAYERS = [
    (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
    (512, 3, 2), (512, 2, 2), (512, 2, 2),
]
D_MODEL = 768
NUM_LAYERS = 12
NUM_HEADS = 12
FFN_DIM = 3072
POS_KERNEL = 128
POS_GROUPS = 16


def conv_frame_count(n_samples: int) -> int:
    """Real output frames for ``n_samples`` of audio through the VALID-conv
    feature extractor."""
    n = n_samples
    for _, k, s in CONV_LAYERS:
        n = (n - k) // s + 1
    return n


class _MaskedChannelNorm(nn.Module):
    """GroupNorm with one group per channel (statistics over time) computed
    over the real frames only: equal to the stock norm on unpadded input,
    exact under right-padding."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, frame_valid: torch.Tensor) -> torch.Tensor:
        """x [B, C, T]; frame_valid [T] bool."""
        m = frame_valid[None, None, :]
        denom = torch.clamp(frame_valid.sum(), min=1).to(x.dtype)
        mean = torch.where(m, x, 0).sum(dim=2, keepdim=True) / denom
        var = torch.where(m, (x - mean) ** 2, 0).sum(dim=2, keepdim=True) / denom
        return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight[:, None]
                + self.bias[:, None])


class Wav2Vec2CTC(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        cin = 1
        for i, (ch, k, s) in enumerate(CONV_LAYERS):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, ch, k, stride=s, bias=False,
                                                   device=device))
            cin = ch
        self.conv_gn = _MaskedChannelNorm(CONV_LAYERS[0][0], device=device)
        self.fp_ln = nn.LayerNorm(cin, eps=1e-5, device=device)
        self.fp_proj = nn.Linear(cin, D_MODEL, device=device)
        self.pos_conv = nn.Conv1d(D_MODEL, D_MODEL, POS_KERNEL, padding=POS_KERNEL // 2,
                                  groups=POS_GROUPS, device=device)
        self.enc_ln = nn.LayerNorm(D_MODEL, eps=1e-5, device=device)
        for i in range(NUM_LAYERS):
            for name, (n_in, n_out) in (("q", (D_MODEL, D_MODEL)), ("k", (D_MODEL, D_MODEL)),
                                        ("v", (D_MODEL, D_MODEL)), ("o", (D_MODEL, D_MODEL)),
                                        ("fc1", (D_MODEL, FFN_DIM)),
                                        ("fc2", (FFN_DIM, D_MODEL))):
                self.add_module(f"layer_{i}_{name}", nn.Linear(n_in, n_out, device=device))
            for name in ("ln1", "ln2"):
                self.add_module(f"layer_{i}_{name}", nn.LayerNorm(D_MODEL, eps=1e-5,
                                                                  device=device))
        self.ctc_head = nn.Linear(D_MODEL, len(CTC_LABELS), device=device)

    def _layer(self, i: int, name: str) -> nn.Module:
        return getattr(self, f"layer_{i}_{name}")

    def forward(self, waveform: torch.Tensor,
                n_samples: Optional[int] = None) -> torch.Tensor:
        """[B, S] float32 16 kHz audio -> [B, T, 29] log-probs (20 ms frames).

        ``n_samples``: the real sample count when ``waveform`` is
        right-padded to a length bucket.  Real frames' emissions equal the
        unpadded call's: the convs are VALID, the channel norm leaves pad
        frames out of its statistics, pad rows are zeroed before the
        positional conv (as its own zero padding would be), and attention
        masks pad keys.  Rows past ``conv_frame_count(n_samples)`` are
        garbage: slice them off.
        """
        x = waveform[:, None, :].to(torch.float32)  # [B, 1, S]
        n_real = waveform.shape[1] if n_samples is None else int(n_samples)
        for i, (_, k, s) in enumerate(CONV_LAYERS):
            x = getattr(self, f"conv_{i}")(x)
            n_real = (n_real - k) // s + 1
            if i == 0:
                x = self.conv_gn(x, torch.arange(x.shape[2], device=x.device) < n_real)
            x = F.gelu(x)

        x = x.transpose(1, 2)  # [B, T, C]
        b, t, _ = x.shape
        frame_valid = torch.arange(t, device=x.device) < n_real
        x = self.fp_proj(self.fp_ln(x))
        x = torch.where(frame_valid[None, :, None], x, 0)

        pos = self.pos_conv(x.transpose(1, 2))[:, :, :t]  # an even kernel gives T + 1
        x = self.enc_ln(x + F.gelu(pos).transpose(1, 2))

        hd = D_MODEL // NUM_HEADS
        key_mask = frame_valid[None, None, None, :]
        for i in range(NUM_LAYERS):
            q, k, v = (self._layer(i, n)(x).reshape(b, t, NUM_HEADS, hd).transpose(1, 2)
                       for n in ("q", "k", "v"))
            scores = (q @ k.transpose(-1, -2)) * hd ** -0.5
            probs = torch.softmax(torch.where(key_mask, scores, MASK_VALUE), dim=-1)
            out = (probs @ v).transpose(1, 2).reshape(b, t, D_MODEL)
            x = self._layer(i, "ln1")(x + self._layer(i, "o")(out))
            h = F.gelu(self._layer(i, "fc1")(x))
            x = self._layer(i, "ln2")(x + self._layer(i, "fc2")(h))

        logits = self.ctc_head(x)
        return torch.log_softmax(logits.to(torch.float32), dim=-1)
