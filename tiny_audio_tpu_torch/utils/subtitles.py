"""Subtitle rendering (SRT / WebVTT) from aligned word timestamps.

The port's own copy of :mod:`tiny_audio_tpu.utils.subtitles`: pure
functions over the aligner's word dicts (``{"word", "start", "end"}`` in
seconds, :mod:`tiny_audio_tpu_torch.alignment`), behind ``ta-torch
transcribe --srt/--vtt``.

Cue segmentation: words accumulate into a cue until any of
  - the cue would exceed ``max_chars`` of text,
  - the cue would span more than ``max_duration_s``,
  - the inter-word gap exceeds ``max_gap_s`` (a natural pause).
"""

from __future__ import annotations

from typing import Sequence


def _cues(
    words: Sequence[dict],
    max_chars: int = 42,
    max_duration_s: float = 5.0,
    max_gap_s: float = 1.0,
) -> list[dict]:
    """Group word dicts into subtitle cues: {"start", "end", "text"}."""
    cues: list[dict] = []
    cur: list[dict] = []

    def flush():
        if cur:
            cues.append({
                "start": cur[0]["start"],
                "end": max(w["end"] for w in cur),
                "text": " ".join(w["word"] for w in cur),
            })
            cur.clear()

    for w in words:
        if not str(w.get("word", "")).strip():
            continue
        if cur:
            text_len = len(" ".join(x["word"] for x in cur)) + 1 + len(w["word"])
            too_long = text_len > max_chars
            too_slow = w["end"] - cur[0]["start"] > max_duration_s
            gap = w["start"] - cur[-1]["end"] > max_gap_s
            if too_long or too_slow or gap:
                flush()
        cur.append(w)
    flush()
    return cues


def _ts(seconds: float, sep: str) -> str:
    ms = max(0, int(round(seconds * 1000)))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def to_srt(words: Sequence[dict], **cue_kwargs) -> str:
    """SubRip text from aligned words (empty string for no words)."""
    blocks = []
    for i, cue in enumerate(_cues(words, **cue_kwargs), start=1):
        blocks.append(
            f"{i}\n{_ts(cue['start'], ',')} --> {_ts(cue['end'], ',')}\n"
            f"{cue['text']}\n"
        )
    return "\n".join(blocks)


def to_vtt(words: Sequence[dict], **cue_kwargs) -> str:
    """WebVTT text from aligned words (header-only for no words)."""
    lines = ["WEBVTT", ""]
    for cue in _cues(words, **cue_kwargs):
        lines.append(f"{_ts(cue['start'], '.')} --> {_ts(cue['end'], '.')}")
        lines.append(cue["text"])
        lines.append("")
    return "\n".join(lines)
