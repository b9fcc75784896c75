"""ASRProcessor: batched mel extraction on the model's device and the
chat-prompt tokenization.

Port of :class:`tiny_audio_tpu.processing.ASRProcessor` (the bucket table is
the port's own copy): mel features on the device, per-sample ``<audio>``
token counts from the conv formula and the projector's output length, and
the chat-templated prompt.  Mel lengths are padded to a few buckets, as in
the JAX package, so both packages see the same shapes; ``whisper_mode`` pads
every clip to the 3,000-frame Whisper window instead.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from tiny_audio_tpu_torch.config import DEFAULT_ENCODER_CONV_LAYERS, compute_encoder_output_length
from tiny_audio_tpu_torch.device import require_device
from tiny_audio_tpu_torch.ops import mel
from tiny_audio_tpu_torch.tokenization import AUDIO_TOKEN

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
    """Feature extractor + tokenizer wrapper for
    :class:`tiny_audio_tpu_torch.models.asr.ASRModel`, with the JAX package's
    parameters in its order and ``device`` last: features land on ``device``
    (the CUDA device unless the caller asks for ``"cpu"``).

    ``whisper_mode`` pads every clip to the fixed 3,000-frame window (the
    reference's Whisper branch); otherwise variable-length bucketed padding
    (the GLM branch).
    """

    AUDIO_TOKEN = AUDIO_TOKEN
    TRANSCRIBE_PROMPT = "Transcribe the speech to text"

    def __init__(
        self,
        tokenizer,
        projector=None,
        num_mel_bins: int = 128,
        encoder_conv_layers: Optional[list] = None,
        whisper_mode: bool = False,
        mel_buckets: Sequence[int] = DEFAULT_MEL_BUCKETS,
        sampling_rate: int = 16000,
        device="cuda",
    ):
        self.tokenizer = tokenizer
        self.projector = projector
        self.num_mel_bins = num_mel_bins
        self.encoder_conv_layers = encoder_conv_layers or DEFAULT_ENCODER_CONV_LAYERS
        self.whisper_mode = whisper_mode
        self.mel_buckets = tuple(mel_buckets)
        self.sampling_rate = sampling_rate
        self.audio_token_id = tokenizer.audio_token_id
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

        if self.whisper_mode:
            n_samples = mel.N_SAMPLES
        else:
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

    def build_messages(
        self,
        num_audio_tokens: int,
        text: Optional[str] = None,
        system_prompt: Optional[str] = None,
        user_prompt: Optional[str] = None,
    ) -> list[dict]:
        """Chat messages of one sample: the user turn holds the audio
        placeholders and the prompt, the assistant turn the target text."""
        prompt = self.TRANSCRIBE_PROMPT if user_prompt is None else user_prompt
        if num_audio_tokens > 0:
            user_content = self.AUDIO_TOKEN * num_audio_tokens
            if prompt:
                user_content += " " + prompt
        else:
            user_content = prompt or ""
        messages = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": user_content})
        if text is not None:
            messages.append({"role": "assistant", "content": text})
        return messages

    def __call__(
        self,
        audio=None,
        text: Optional[str] = None,
        system_prompt: Optional[str] = None,
        user_prompt: Optional[str] = None,
    ) -> dict:
        """Process audio (and an optional target text) for inference or
        training: the token count comes from the batch's largest real mel
        length, the prompt holds that many placeholders.  ``input_ids`` and
        ``attention_mask`` are int32 ``[1, T]`` numpy, the features tensors
        on the processor's device."""
        result: dict = {}
        n_audio = 0
        if audio is not None:
            feats = self.extract_features(audio)
            result["input_features"] = feats["input_features"]
            result["audio_attention_mask"] = feats["audio_attention_mask"]
            real_mel = int(feats["audio_attention_mask"].sum(-1).max())
            n_audio = int(self.num_audio_tokens(real_mel))

        messages = self.build_messages(n_audio, text, system_prompt, user_prompt)
        ids = self.tokenizer.apply_chat_template(
            messages,
            tokenize=True,
            add_generation_prompt=(text is None),
            enable_thinking=False,
        )
        input_ids = np.asarray(ids, dtype=np.int32)[None, :]
        result["input_ids"] = input_ids
        result["attention_mask"] = np.ones_like(input_ids)
        return result
