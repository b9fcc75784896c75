"""Word-level timestamps by CTC forced alignment.

Port of :mod:`tiny_audio_tpu.alignment`: a character-CTC acoustic model
(:class:`~tiny_audio_tpu_torch.models.wav2vec2.Wav2Vec2CTC`) emits 20 ms
log-probs over a length-bucketed waveform, a Viterbi trellis
(:func:`~tiny_audio_tpu_torch.ops.ctc.ctc_trellis`, on the emission's
device) aligns the transcript's characters, and the aligned tokens are
grouped into words with the calibrated offsets.  Without aligner weights
(``ForcedAligner.load_weights``; ``ASRModel.from_pretrained`` attaches a
checkpoint's ``wav2vec2_aligner.msgpack``) words are spread uniformly over
the clip and tagged ``"fallback"``, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from tiny_audio_tpu_torch.bridge import load_flax_tower
from tiny_audio_tpu_torch.device import require_device
from tiny_audio_tpu_torch.models.wav2vec2 import CTC_LABELS, Wav2Vec2CTC, conv_frame_count
from tiny_audio_tpu_torch.ops.ctc import ctc_backtrack, ctc_trellis
from tiny_audio_tpu_torch.utils import msgpack_io

FRAME_STRIDE = 320  # samples per CTC frame at 16 kHz -> 20 ms
# calibrated systematic-bias offsets
START_OFFSET = 0.06
END_OFFSET = -0.03

#: waveform-length buckets of the emission forward (5 s steps to the 30 s
#: window); past the top the step pattern continues
SAMPLE_BUCKETS = tuple(f * 160 for f in (500, 1000, 1500, 2000, 2500, 3000))


def _bucket_samples(n: int) -> int:
    for b in SAMPLE_BUCKETS:
        if n <= b:
            return b
    step = SAMPLE_BUCKETS[-1] - SAMPLE_BUCKETS[-2]
    return SAMPLE_BUCKETS[-1] + int(math.ceil((n - SAMPLE_BUCKETS[-1]) / step) * step)


class ForcedAligner:
    """Process-wide aligner.  The weights (the flax tree, on the host) are
    kept once; the model is built on the device a call asks for, and rebuilt
    when a call asks for another one, so a CPU model never serves a CUDA
    request or the reverse."""

    _tree: Optional[dict] = None
    _model: Optional[Wav2Vec2CTC] = None
    _dictionary = {c: i for i, c in enumerate(CTC_LABELS)}

    @classmethod
    def load_weights(cls, path, device="cuda") -> None:
        """Load converted Wav2Vec2-CTC weights (a flax msgpack file) and
        build the model on ``device``."""
        tree = msgpack_io.load(path)
        model = cls._build(tree, require_device(device))
        cls._tree, cls._model = tree, model

    @staticmethod
    def _build(tree: dict, device: torch.device) -> Wav2Vec2CTC:
        model = Wav2Vec2CTC(device=device).eval()
        load_flax_tower(model, tree)
        return model

    @classmethod
    def has_model(cls) -> bool:
        return cls._tree is not None

    @classmethod
    def _model_on(cls, device) -> Wav2Vec2CTC:
        device = require_device(device)
        if cls._model is None or cls._model.ctc_head.weight.device != device:
            cls._model = cls._build(cls._tree, device)
        return cls._model

    # ------------------------------------------------------------------ core

    @classmethod
    @torch.inference_mode()
    def _emissions(cls, waveform: np.ndarray, device="cuda") -> torch.Tensor:
        """[n] samples -> [T, 29] log-probs on ``device``, from one forward
        over the waveform zero-padded to its length bucket (exact per real
        frame: see ``Wav2Vec2CTC.forward``)."""
        if cls._tree is None:
            raise RuntimeError("no aligner weights: ForcedAligner.load_weights first")
        model = cls._model_on(device)
        n = int(waveform.shape[-1])
        padded = np.zeros(_bucket_samples(n), np.float32)
        padded[:n] = waveform
        x = torch.from_numpy(padded[None, :]).to(model.ctc_head.weight.device)
        return model(x, n_samples=n)[0, : conv_frame_count(n)]

    @classmethod
    def tokenize_transcript(cls, text: str) -> list[int]:
        tokens = []
        for char in text.upper():
            if char in cls._dictionary:
                tokens.append(cls._dictionary[char])
            elif char == " ":
                tokens.append(cls._dictionary["|"])
        return tokens

    @classmethod
    def align_emissions(
        cls, emission: Union[np.ndarray, torch.Tensor], text: str, frame_duration: float
    ) -> list[dict]:
        """Align a transcript against an emission matrix (the trellis runs on
        the emission's device: a numpy emission on the CPU).

        Words whose characters all lie outside the CTC label set (digits,
        symbols) contribute no tokens: the span -> word pairing is built from
        the words that did tokenize, and each token-less word gets times
        interpolated between its neighbours, tagged ``"fallback": True``.
        """
        separator_id = cls._dictionary["|"]
        words = text.split()
        tokens: list[int] = []
        tokened_words: list[int] = []  # word index per token group, in order
        for i, w in enumerate(words):
            toks = [cls._dictionary[c] for c in w.upper() if c in cls._dictionary]
            if not toks:
                continue
            if tokens:
                tokens.append(separator_id)
            tokens.extend(toks)
            tokened_words.append(i)
        if not tokens:
            return []

        trellis, moved = ctc_trellis(torch.as_tensor(emission), torch.tensor(tokens))
        spans = ctc_backtrack(trellis.cpu().numpy(), moved.cpu().numpy(), np.asarray(tokens))

        by_idx: dict[int, dict] = {}
        group = 0
        cur_start = cur_end = None

        def flush(start, end):
            nonlocal group
            if group < len(tokened_words):
                idx = tokened_words[group]
                by_idx[idx] = {
                    "word": words[idx],
                    "start": max(0.0, start * frame_duration - START_OFFSET),
                    "end": max(0.0, end * frame_duration - END_OFFSET),
                }
            group += 1

        for token_id, start_f, end_f in spans:
            if token_id == separator_id:
                if cur_start is not None and cur_end is not None:
                    flush(cur_start, cur_end)
                cur_start = cur_end = None
            else:
                if cur_start is None:
                    cur_start = start_f
                cur_end = end_f
        if cur_start is not None and cur_end is not None:
            flush(cur_start, cur_end)

        clip_end = emission.shape[0] * frame_duration
        out: list[dict] = []
        for i, w in enumerate(words):
            if i in by_idx:
                out.append(by_idx[i])
            else:
                prev_end = out[-1]["end"] if out else 0.0
                next_start = next(
                    (by_idx[j]["start"] for j in range(i + 1, len(words)) if j in by_idx),
                    clip_end,
                )
                out.append({
                    "word": w, "start": prev_end,
                    "end": max(prev_end, next_start), "fallback": True,
                })
        return out

    @classmethod
    def align(cls, audio: np.ndarray, text: str, sample_rate: int = 16000,
              device="cuda") -> list[dict]:
        """Word-level timestamps for ``text`` against ``audio``, the model
        and the trellis on ``device``."""
        audio = np.asarray(audio, np.float32).squeeze()
        if sample_rate != 16000:
            from tiny_audio_tpu_torch.utils.audio_io import resample

            audio = resample(audio, sample_rate, 16000)

        if not cls.has_model():
            # no aligner weights: words spread evenly over the clip, tagged
            # so that callers cannot mistake them for an alignment
            words = text.split()
            if not words:
                return []
            per = len(audio) / 16000.0 / len(words)
            return [{"word": w, "start": i * per, "end": (i + 1) * per, "fallback": True}
                    for i, w in enumerate(words)]

        emission = cls._emissions(audio, device)
        return cls.align_emissions(emission, text, FRAME_STRIDE / 16000.0)
