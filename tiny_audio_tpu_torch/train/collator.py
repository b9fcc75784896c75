"""Training data collation: validity filters, mel features, label masking.

Re-designed equivalent of the reference ``DataCollator`` / label pipeline
(the reference's ``scripts/train.py:62-365``):

- ``normalize_label``: canonical transcript form — lowercase, corpus-marker
  and TEDLIUM-bracket stripping, percent canonicalization, whitespace collapse.
- validity filters with the same NaN-poisoning rationale: empty audio,
  non-finite samples, empty normalized label, > 30 s clips are dropped.
- chat-ML label masking with TRL ``DataCollatorForChatML`` semantics: only
  assistant-response tokens (incl. the stop token) are supervised; prompt,
  system, and audio positions are ``-100``.
- mel features come from the port's :class:`ASRProcessor` on the model's
  device, with bucketed padding.

Port of :mod:`tiny_audio_tpu.train.collator` (the port's own copy): the
same rows and seed give the same ids, labels and masks as the JAX package's
collator, and mel features within the mel front end's tolerance.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence

import numpy as np

from tiny_audio_tpu_torch.config import (
    DEFAULT_ENCODER_CONV_LAYERS,
    compute_encoder_output_length,
)
from tiny_audio_tpu_torch.processing import DEFAULT_MEL_BUCKETS, ASRProcessor

TRANSCRIBE_PROMPTS = ["Transcribe the speech to text"]
DESCRIBE_PROMPTS = ["Describe all the information you can hear"]

# ASR annotation markers that pollute train labels but are absent from eval
# splits (gigaspeech punctuation tags, TEDLIUM <unk>, EdAcc/Earnings22 noise
# tags — reference train.py:55-70).
_CORPUS_MARKER_RE = re.compile(
    r"\s*<("
    r"comma|period|exclamationpoint|questionmark|"
    r"sil|music|noise|other|unk|"
    r"overlap|laugh|dtmf|foreign|no-speech|lipsmack|"
    r"clear_throat|inaudible|crosstalk"
    r")>",
    re.IGNORECASE,
)
_TEDLIUM_BRACKET_RE = re.compile(r"\s*\[[^\]]*\]")
_WHITESPACE_RE = re.compile(r"\s+")

MAX_AUDIO_SECONDS = 30.0


def normalize_label(raw_text: str) -> str:
    """Canonicalize a training transcript label (reference train.py:79-97)."""
    text = (raw_text or "").strip().lower()
    text = _CORPUS_MARKER_RE.sub("", text)
    text = _TEDLIUM_BRACKET_RE.sub("", text)
    text = text.replace("%", " percent").replace("per cent", "percent")
    return _WHITESPACE_RE.sub(" ", text).strip()


def mask_labels_chatml(
    tokenizer,
    messages: list[dict],
    max_length: int = 2048,
) -> tuple[np.ndarray, np.ndarray]:
    """(input_ids, labels) for a full chat sample.

    TRL-DataCollatorForChatML semantics: the prompt prefix — everything the
    generation prompt would cover — is masked to -100; assistant-response
    tokens (incl. the closing stop token) are supervised.
    """
    prompt_msgs = [m for m in messages if m["role"] != "assistant"]
    prompt_ids = tokenizer.apply_chat_template(
        prompt_msgs, tokenize=True, add_generation_prompt=True, enable_thinking=False
    )
    full_ids = tokenizer.apply_chat_template(
        messages, tokenize=True, add_generation_prompt=False, enable_thinking=False
    )
    full_ids = np.asarray(full_ids, np.int32)[:max_length]
    labels = full_ids.copy()
    prefix = min(len(prompt_ids), len(full_ids))
    labels[:prefix] = -100
    return full_ids, labels


class DataCollator:
    """Collate raw dataset rows into a padded training batch: numpy
    ``input_ids``, ``attention_mask``, ``labels`` [B, T] int32 and
    ``audio_token_counts``, and the mel features as tensors on ``device``
    (the CUDA device unless the caller asks for ``"cpu"``).  The parameters
    are the JAX package's, in its order, with ``device`` last."""

    def __init__(
        self,
        tokenizer,
        projector,
        num_mel_bins: int = 128,
        sample_rate: int = 16000,
        system_prompt: Optional[str] = None,
        encoder_conv_layers: Optional[list] = None,
        whisper_mode: bool = False,
        max_length: int = 2048,
        pad_text_multiple: int = 64,
        mel_buckets: Optional[Sequence[int]] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.tokenizer = tokenizer
        self.projector = projector
        self.sample_rate = sample_rate
        self.system_prompt = system_prompt
        self.encoder_conv_layers = encoder_conv_layers or DEFAULT_ENCODER_CONV_LAYERS
        self.max_length = max_length
        self.pad_text_multiple = pad_text_multiple
        self.rng = np.random.default_rng(seed)
        self.processor = ASRProcessor(
            tokenizer,
            projector=projector,
            num_mel_bins=num_mel_bins,
            encoder_conv_layers=self.encoder_conv_layers,
            whisper_mode=whisper_mode,
            mel_buckets=tuple(mel_buckets or DEFAULT_MEL_BUCKETS),
            sampling_rate=sample_rate,
            device=device,
        )

    # ------------------------------------------------------------- validation

    def _extract_audio_arrays(self, features: list[dict]) -> tuple[list, list]:
        """Drop gradient-poisoning rows (reference train.py:273-308)."""
        audio_arrays, valid = [], []
        for f in features:
            try:
                audio = f["audio"]["array"] if isinstance(f.get("audio"), dict) else f.get("audio")
                if audio is None:
                    continue
                audio = np.asarray(audio, np.float32).squeeze()
                if audio.ndim > 1:
                    audio = audio.mean(axis=0)
                if audio.size == 0:
                    continue
                if not np.isfinite(audio).all():
                    continue
                # Silence-injected rows legitimately carry an empty label
                # (augmentation.py sets the flag); everything else with an
                # empty normalized label is an annotation-marker-only row.
                # SIFT rows train on sift_response, so judge THAT text —
                # gating them on the (possibly empty) transcript column
                # silently dropped valid SIFT samples.
                if f.get("task") == "sift":
                    label_src = f.get("sift_response") or f.get("text") or ""
                    if not label_src.strip():
                        continue
                elif not normalize_label(f.get("text") or "") and not f.get("silence"):
                    continue
                if audio.size / self.sample_rate > MAX_AUDIO_SECONDS:
                    continue
                audio_arrays.append(audio)
                valid.append(f)
            except Exception:
                continue
        if not audio_arrays:
            raise ValueError("No valid audio samples in batch")
        return audio_arrays, valid

    # ---------------------------------------------------------------- samples

    def _build_messages(self, feature: dict, num_audio_tokens: int) -> list[dict]:
        text = normalize_label(feature.get("text") or "")
        prompt = self.rng.choice(TRANSCRIBE_PROMPTS)
        return self.processor.build_messages(
            num_audio_tokens, text=text, system_prompt=self.system_prompt,
            user_prompt=str(prompt),
        )

    def __call__(self, features: list[dict]) -> dict[str, Any]:
        audio_arrays, valid = self._extract_audio_arrays(features)
        feats = self.processor.extract_features(audio_arrays)

        mel_lengths = np.asarray(feats["mel_lengths"])
        enc_lengths = compute_encoder_output_length(mel_lengths, self.encoder_conv_layers)
        token_counts = np.asarray(self.projector.get_output_length(enc_lengths))

        rows = []
        for f, n in zip(valid, token_counts):
            messages = self._build_messages(f, int(n))
            rows.append(mask_labels_chatml(self.tokenizer, messages, self.max_length))

        max_len = max(len(ids) for ids, _ in rows)
        max_len = -(-max_len // self.pad_text_multiple) * self.pad_text_multiple
        b = len(rows)
        pad_id = self.tokenizer.pad_token_id
        input_ids = np.full((b, max_len), pad_id, np.int32)
        labels = np.full((b, max_len), -100, np.int32)
        attn = np.zeros((b, max_len), np.int32)
        for i, (ids, lab) in enumerate(rows):
            input_ids[i, : len(ids)] = ids
            labels[i, : len(lab)] = lab
            attn[i, : len(ids)] = 1

        return {
            "input_ids": input_ids,
            "attention_mask": attn,
            "labels": labels,
            # mel features stay tensors on the device they were computed on
            "input_features": feats["input_features"],
            "audio_attention_mask": feats["audio_attention_mask"],
            "audio_token_counts": token_counts.astype(np.int32),
        }


class MultiTaskDataCollator(DataCollator):
    """ASR + SIFT multitask collation (reference train.py:351-365)."""

    def __init__(self, *args, **kwargs):
        kwargs["system_prompt"] = ""
        super().__init__(*args, **kwargs)

    def _build_messages(self, feature: dict, num_audio_tokens: int) -> list[dict]:
        if feature.get("task") == "sift":
            response = (feature.get("sift_response") or feature.get("text") or "").strip()
            prompt = str(self.rng.choice(DESCRIBE_PROMPTS))
        else:
            # full normalize_label, not bare lowercase: corpus markers
            # (<comma>, TEDLIUM brackets) must not become supervised output
            # in multitask runs any more than in the base collator
            response = normalize_label(feature.get("text") or "")
            prompt = str(self.rng.choice(TRANSCRIBE_PROMPTS))
        return self.processor.build_messages(
            num_audio_tokens, text=response, system_prompt=self.system_prompt,
            user_prompt=prompt,
        )
