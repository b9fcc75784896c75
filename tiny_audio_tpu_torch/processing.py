"""ASRProcessor: batched mel extraction on the model's device.

Port of the audio half of :class:`tiny_audio_tpu.processing.ASRProcessor`
(the bucket table is the port's own copy).  Mel lengths are padded to a few buckets, as in the JAX
package, so both packages see the same shapes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from tiny_audio_tpu_torch.config import DEFAULT_ENCODER_CONV_LAYERS, compute_encoder_output_length
from tiny_audio_tpu_torch.device import require_device
from tiny_audio_tpu_torch.ops import mel

# Default mel-frame buckets: 5 s steps up to the 30 s encoder window.
DEFAULT_MEL_BUCKETS = (500, 1000, 1500, 2000, 2500, 3000)


def bucket_frames(n_frames: int, buckets: Sequence[int] = DEFAULT_MEL_BUCKETS) -> int:
    for b in buckets:
        if n_frames <= b:
            return b
    # past the last bucket, continue its step pattern
    step = buckets[-1] - buckets[-2] if len(buckets) > 1 else buckets[-1]
    return buckets[-1] + int(math.ceil((n_frames - buckets[-1]) / step) * step)


class ASRProcessor:
    """Feature extractor for :class:`tiny_audio_tpu_torch.models.asr.ASRModel`:
    variable-length audio padded to the next mel bucket, on ``device`` (the
    CUDA device unless the caller asks for ``"cpu"``)."""

    def __init__(
        self,
        projector=None,
        num_mel_bins: int = 128,
        encoder_conv_layers: Optional[list] = None,
        mel_buckets: Sequence[int] = DEFAULT_MEL_BUCKETS,
        device="cuda",
    ):
        self.projector = projector
        self.num_mel_bins = num_mel_bins
        self.encoder_conv_layers = encoder_conv_layers or DEFAULT_ENCODER_CONV_LAYERS
        self.mel_buckets = tuple(mel_buckets)
        self.device = require_device(device)

    def extract_features(self, audio: Union[np.ndarray, Sequence[np.ndarray]]) -> dict:
        """Batch mel extraction with bucketed padding.

        Returns {"input_features": [B, mel, T] float32 tensor,
        "audio_attention_mask": [B, T] int32 tensor, both on the device,
        "mel_lengths": [B] numpy}.
        """
        if isinstance(audio, np.ndarray) and audio.ndim == 1:
            audio = [audio]
        arrays = [np.asarray(a, dtype=np.float32) for a in audio]
        lengths = np.array([a.shape[-1] for a in arrays])

        max_frames = int(math.ceil(lengths.max() / mel.HOP_LENGTH))
        n_samples = bucket_frames(max_frames, self.mel_buckets) * mel.HOP_LENGTH

        batch = np.zeros((len(arrays), n_samples), dtype=np.float32)
        for i, a in enumerate(arrays):
            n = min(a.shape[-1], n_samples)
            batch[i, :n] = a[:n]

        feats = mel.log_mel_spectrogram(
            torch.from_numpy(batch).to(self.device), num_mel_bins=self.num_mel_bins
        )
        n_frames = n_samples // mel.HOP_LENGTH
        clipped = torch.from_numpy(np.minimum(lengths, n_samples)).to(self.device)
        return {
            "input_features": feats,
            "audio_attention_mask": mel.frame_attention_mask(clipped, n_frames),
            "mel_lengths": np.minimum(np.ceil(lengths / mel.HOP_LENGTH).astype(int), n_frames),
        }

    def num_audio_tokens(self, mel_length) -> int:
        enc_len = compute_encoder_output_length(mel_length, self.encoder_conv_layers)
        if self.projector is None:
            return enc_len
        return self.projector.get_output_length(enc_len)
