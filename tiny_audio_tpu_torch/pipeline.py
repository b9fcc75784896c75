"""ASRPipeline: audio in -> transcript out, over the PyTorch model.

Port of :mod:`tiny_audio_tpu.pipeline`: input normalization (path / bytes /
ndarray / dict), long-form chunking, batch buckets, streaming, and
post-processing (EOS filtering, ``<think>``-tag stripping, trailing repetition
truncation), word timestamps (:mod:`.alignment`) and speaker diarization
(:mod:`.diarization`) on the model's device.  A failure of either is
reported in the result (``timestamp_error`` / ``diarization_error``), as in
the JAX package.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np

from tiny_audio_tpu_torch.processing import ASRProcessor
from tiny_audio_tpu_torch.utils.audio_io import read_wav, resample

_THINK_RE = re.compile(r"<think>.*?</think>\s*", flags=re.DOTALL)
_MIN_REPEATS = 3


def _strip_think(text: str) -> str:
    if "<think>" in text:
        return _THINK_RE.sub("", text).strip()
    return text


def truncate_repetitions(text: str, min_repeats: int = _MIN_REPEATS) -> str:
    """Collapse trailing repetitions to a single occurrence.

    Handles, in order:
    1. trailing repeated characters:   "no444444"   -> "no4"
    2. trailing repeated single words: "the the the" -> "the"
    3. trailing repeated 2..20-word phrases:
       "i am sorry i am sorry i am sorry" -> "i am sorry"

    A repetition only triggers at >= ``min_repeats`` consecutive occurrences
    at the very end of the string.
    """
    if not text:
        return text

    # 1. trailing character runs
    text = re.sub(rf"(.)\1{{{min_repeats - 1},}}$", r"\1", text)

    # 2. trailing single-word runs (case-insensitive), repeat until stable
    word_re = re.compile(rf"\b(\w+)(?:\s+\1){{{min_repeats - 1},}}\s*$", re.IGNORECASE)
    while word_re.search(text):
        text = word_re.sub(r"\1", text)

    # 3. trailing phrase runs
    words = text.split()
    if len(words) < min_repeats * 2:
        return text
    tail = words[-min_repeats * 2 :]
    if len(set(tail)) == len(tail):  # no duplicated word => no phrase repeat
        return text
    for phrase_len in range(2, min(21, len(words) // min_repeats + 1)):
        phrase = re.escape(" ".join(words[-phrase_len:]))
        m = re.match(
            rf"(^|.*?\s)({phrase})(?:\s+{phrase}){{{min_repeats - 1},}}\s*$",
            text,
            re.IGNORECASE,
        )
        if m:
            return (m.group(1) + m.group(2)).strip()
    return text


class ASRPipeline:
    """End-to-end transcription over a
    :class:`tiny_audio_tpu_torch.models.asr.ASRModel`."""

    #: encoder window: 30 s at 16 kHz
    MAX_CHUNK_SECONDS = 30.0
    #: max full-length chunks decoded per generate call (bounds the KV cache)
    LONGFORM_BATCH = 8
    #: transcribe_batch row-count buckets (serving dynamic batching)
    BATCH_BUCKETS = (1, 4, 16)

    def __init__(self, model, processor=None):
        self.model = model
        self.processor = processor or ASRProcessor(
            model.tokenizer,
            projector=model.projector,
            num_mel_bins=model.config.encoder.num_mel_bins,
            encoder_conv_layers=model.config.encoder_conv_layers,
            device=model.device,
        )
        self.tokenizer = model.tokenizer

    # ----------------------------------------------------------------- input

    @staticmethod
    def extract_audio(inputs: Any, target_rate: int = 16000) -> dict:
        """Normalize any supported input into {"array", "sampling_rate"}."""
        if isinstance(inputs, dict):
            array = inputs.get("array", inputs.get("raw"))
            if array is None:
                raise ValueError("dict input requires 'array' or 'raw'")
            rate = inputs.get("sampling_rate", target_rate)
        elif isinstance(inputs, (str, Path, bytes)):
            array, rate = read_wav(inputs)
        elif isinstance(inputs, np.ndarray):
            array, rate = inputs, target_rate
        else:
            raise TypeError(f"Unsupported input type: {type(inputs)}")
        array = np.asarray(array, dtype=np.float32).squeeze()
        if array.ndim > 1:
            array = array.mean(axis=0)
        if not np.isfinite(array).all():
            # NaN mel -> NaN logits -> confident junk: refuse the request
            raise ValueError("audio contains non-finite samples (NaN/Inf)")
        if rate != target_rate:
            array = resample(array, rate, target_rate)
            rate = target_rate
        return {"array": array, "sampling_rate": rate}

    # ------------------------------------------------------------------ main

    def __call__(
        self,
        inputs,
        return_timestamps: bool = False,
        return_speakers: bool = False,
        return_confidence: bool = False,
        user_prompt: Optional[str] = None,
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
        chunk_length_s: Optional[float] = None,
        **generate_kwargs,
    ) -> dict:
        """Transcribe one input of any length.  ``return_confidence`` adds
        ``result["confidence"]``: exp of the mean chosen-token
        log-probability under the raw model distribution (long-form: the
        unweighted mean over chunks)."""
        if return_speakers:
            return_timestamps = True

        audio = self.extract_audio(inputs)
        chunk_s = chunk_length_s or self.MAX_CHUNK_SECONDS
        chunk_samples = int(chunk_s * audio["sampling_rate"])

        # Long-form: fixed-window chunks decoded as one batch, so chunks
        # share the pass over the decoder weights.
        waveform = audio["array"]
        chunks = []
        for start in range(0, max(len(waveform), 1), chunk_samples):
            chunk = waveform[start : start + chunk_samples]
            if start > 0 and len(chunk) < int(0.2 * audio["sampling_rate"]):
                break  # ignore sub-200ms tails of long-form audio
            chunks.append(chunk)
        # equal-length chunks decode together; a shorter tail goes separately
        # so it does not inherit the batch-max placeholder count
        full, tail = chunks, []
        if len(chunks) > 1 and len(chunks[-1]) < len(chunks[0]):
            full, tail = chunks[:-1], chunks[-1:]
        groups = [
            full[i : i + self.LONGFORM_BATCH]
            for i in range(0, len(full), self.LONGFORM_BATCH)
        ]
        if tail:
            groups.append(tail)
        texts: list[str] = []
        chunk_logps: list[float] = []
        for group in groups:
            # pad the group to a power-of-2 batch (the same shapes as the JAX
            # package); the padded rows' outputs are dropped
            n_real = len(group)
            bucket = 1
            while bucket < n_real:
                bucket *= 2
            group = group + [np.zeros_like(group[0]) for _ in range(bucket - n_real)]
            feats = self.processor.extract_features(group)
            out = self.model.generate(
                feats["input_features"],
                feats["audio_attention_mask"],
                user_prompt=user_prompt,
                mel_length=int(np.max(feats["mel_lengths"])),
                return_scores=return_confidence,
                **generate_kwargs,
            )
            tokens = out[0] if return_confidence else out
            if return_confidence:
                chunk_logps.extend(float(s) for s in out[1][:n_real])
            texts.extend(self.postprocess_tokens(tokens[i]) for i in range(n_real))
        result = {"text": " ".join(t for t in texts if t).strip()}
        if return_confidence:
            result["confidence"] = float(np.exp(np.mean(chunk_logps)))
        device = self.model.device
        if return_timestamps:
            text = result["text"]
            result["words"] = []
            if text:
                try:
                    from tiny_audio_tpu_torch.alignment import ForcedAligner

                    result["words"] = ForcedAligner.align(
                        audio["array"], text, sample_rate=audio["sampling_rate"], device=device)
                except Exception as e:
                    result["timestamp_error"] = str(e)

        if return_speakers:
            try:
                from tiny_audio_tpu_torch.diarization import SpeakerDiarizer

                kwargs = {k: v for k, v in {"num_speakers": num_speakers,
                                            "min_speakers": min_speakers,
                                            "max_speakers": max_speakers}.items()
                          if v is not None}
                segments = SpeakerDiarizer.diarize(
                    audio["array"], sample_rate=audio["sampling_rate"], device=device, **kwargs)
                result["speaker_segments"] = segments
                if result.get("words"):
                    result["words"] = SpeakerDiarizer.assign_speakers_to_words(
                        result["words"], segments)
            except Exception as e:
                result["speaker_segments"] = []
                result["diarization_error"] = str(e)
        return result

    def transcribe_streaming(self, inputs, user_prompt: Optional[str] = None):
        """Yield live text fragments for audio of any length: short clips
        stream token by token; long-form audio chains
        :meth:`ASRModel.generate_streaming` across 30 s windows."""
        audio = self.extract_audio(inputs)
        feats = self.processor.extract_features([audio["array"]])
        yield from self.model.generate_streaming(
            feats["input_features"], feats["audio_attention_mask"],
            user_prompt=user_prompt,
        )

    def transcribe_batch(
        self,
        audios: list,
        user_prompt: Optional[str] = None,
        **generate_kwargs,
    ) -> list[str]:
        """Transcribe many short clips in one batched generate call (the
        serving-side dynamic-batching entry).  Clips longer than
        MAX_CHUNK_SECONDS are refused; the batch pads to BATCH_BUCKETS, and
        a larger one is split into bucket-sized sub-batches."""
        cap = self.BATCH_BUCKETS[-1]
        if len(audios) > cap:
            out: list[str] = []
            for i in range(0, len(audios), cap):
                out.extend(self.transcribe_batch(
                    audios[i:i + cap], user_prompt=user_prompt, **generate_kwargs
                ))
            return out
        arrays = []
        limit = int(self.MAX_CHUNK_SECONDS * 16000)
        for inputs in audios:
            audio = self.extract_audio(inputs)
            if len(audio["array"]) > limit:
                raise ValueError(
                    f"transcribe_batch takes clips <= {self.MAX_CHUNK_SECONDS}"
                    " s; route long-form inputs through __call__"
                )
            arrays.append(audio["array"])
        n_real = len(arrays)
        bucket = next(b for b in self.BATCH_BUCKETS if b >= n_real)
        longest = max(len(a) for a in arrays)
        arrays = arrays + [np.zeros(longest, np.float32) for _ in range(bucket - n_real)]
        feats = self.processor.extract_features(arrays)
        tokens = self.model.generate(
            feats["input_features"],
            feats["audio_attention_mask"],
            user_prompt=user_prompt,
            mel_length=int(np.max(feats["mel_lengths"])),
            **generate_kwargs,
        )
        return [self.postprocess_tokens(tokens[i]) for i in range(n_real)]

    # ----------------------------------------------------------- postprocess

    def postprocess_tokens(self, tokens: Union[np.ndarray, list]) -> str:
        """EOS filter -> decode -> think-strip -> repetition truncation."""
        eos = set(self.tokenizer.eos_token_ids) | {self.tokenizer.pad_token_id}
        ids = [int(t) for t in np.asarray(tokens).reshape(-1) if int(t) not in eos]
        text = self.tokenizer.decode(ids, skip_special_tokens=True).strip()
        text = _strip_think(text)
        return truncate_repetitions(text)
