"""Text normalization for WER scoring.

The port's copy of :mod:`tiny_audio_tpu.eval.normalizer`: Whisper's
``EnglishTextNormalizer`` (the port's own copy,
:mod:`tiny_audio_tpu_torch.eval.english_normalizer`, so ``transformers`` is
not needed) with the British->American map of
:mod:`tiny_audio_tpu_torch.eval.spelling`, plus the project's
canonicalizations, applied to hypothesis and reference alike so the metric
stays symmetric.
"""

from __future__ import annotations

import re

from tiny_audio_tpu_torch.eval.english_normalizer import EnglishTextNormalizer
from tiny_audio_tpu_torch.eval.spelling import load_spelling_map

# Project-specific fixes: the model emits "okay" where many references use
# "ok"; "all right"/"alright" and "kinda"/"kind of" vary by corpus convention.
_PROJECT_FIXES = [
    (re.compile(r"\bokay\b"), "ok"),
    (re.compile(r"\ball right\b"), "alright"),
    (re.compile(r"\bkinda\b"), "kind of"),
]


class TextNormalizer:
    """Symmetric WER normalizer: Whisper English normalization + fixes."""

    def __init__(self, spelling_path: str | None = None):
        self._whisper = EnglishTextNormalizer(load_spelling_map(spelling_path))

    def normalize(self, text: str) -> str:
        out = self._whisper(text or "")
        for pattern, repl in _PROJECT_FIXES:
            out = pattern.sub(repl, out)
        return re.sub(r"\s+", " ", out).strip()

    __call__ = normalize
