"""Tokenization layer: chat templating + tokenizer adapters.

The PyTorch port's own copy of :mod:`tiny_audio_tpu.tokenization` (the port
imports nothing of the JAX package).

The reference relies on HF ``AutoTokenizer`` + Qwen3's Jinja chat template
(``tiny_audio/asr_modeling.py:303-342,607-614``).  This module
provides:

- :class:`Qwen3ChatTemplate` — an explicit implementation of the Qwen3
  chat-template semantics used by the reference (``enable_thinking=False``:
  the generation prompt carries an empty ``<think>`` block).
- :class:`HFTokenizerAdapter` — wraps a local HF tokenizer when checkpoint
  files are available.
- :class:`ByteTokenizer` — a fully offline byte-level tokenizer with the same
  protocol, used by tests and smoke models (the reference analogously swaps
  SmolLM2 in its tests, SURVEY.md §4).

All adapters expose the small protocol the model layer needs: ``encode``,
``decode``, ``convert_tokens_to_ids``, ``apply_chat_template``,
``vocab_size``, ``audio_token_id``, ``eos_token_ids``, ``pad_token_id``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence

AUDIO_TOKEN = "<audio>"

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
ENDOFTEXT = "<|endoftext|>"
THINK_OPEN = "<think>"
THINK_CLOSE = "</think>"


@dataclass
class Qwen3ChatTemplate:
    """Qwen3 chat formatting with ``enable_thinking=False`` semantics.

    ``apply(messages, add_generation_prompt=True)`` renders::

        <|im_start|>system\\n{system}<|im_end|>\\n
        <|im_start|>user\\n{user}<|im_end|>\\n
        <|im_start|>assistant\\n<think>\\n\\n</think>\\n\\n

    matching the token stream the reference model was trained/evaluated with
    (asr_modeling.py:607-614; the Qwen3 tokenizer emits the empty think block
    when thinking is disabled).
    """

    enable_thinking: bool = False

    def render(self, messages: Sequence[dict], add_generation_prompt: bool) -> str:
        parts = []
        for m in messages:
            role, content = m["role"], m["content"]
            if role == "assistant" and not self.enable_thinking:
                # Non-thinking assistant turns carry the empty think block,
                # making the generation prompt a strict prefix of the full
                # render — required for clean chat-ML label masking.
                parts.append(
                    f"{IM_START}{role}\n{THINK_OPEN}\n\n{THINK_CLOSE}\n\n"
                    f"{content}{IM_END}\n"
                )
            else:
                parts.append(f"{IM_START}{role}\n{content}{IM_END}\n")
        if add_generation_prompt:
            gen = f"{IM_START}assistant\n"
            if not self.enable_thinking:
                gen += f"{THINK_OPEN}\n\n{THINK_CLOSE}\n\n"
            parts.append(gen)
        return "".join(parts)


class ByteTokenizer:
    """Offline byte-level tokenizer with Qwen-style special tokens.

    ids 0..255 are raw bytes; specials follow.  Deterministic, reversible,
    and dependency-free — the test-tier tokenizer.
    """

    SPECIALS = [ENDOFTEXT, IM_START, IM_END, THINK_OPEN, THINK_CLOSE, AUDIO_TOKEN]

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 256 + len(self.SPECIALS):
            raise ValueError("vocab_size too small for byte tokenizer")
        self._vocab_size = vocab_size
        self.special_to_id = {s: 256 + i for i, s in enumerate(self.SPECIALS)}
        self.id_to_special = {v: k for k, v in self.special_to_id.items()}
        self._special_re = re.compile(
            "(" + "|".join(re.escape(s) for s in self.SPECIALS) + ")"
        )
        self.chat_template = Qwen3ChatTemplate()

    # -- protocol -------------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    @property
    def audio_token_id(self) -> int:
        return self.special_to_id[AUDIO_TOKEN]

    @property
    def eos_token_ids(self) -> list[int]:
        return [self.special_to_id[IM_END], self.special_to_id[ENDOFTEXT]]

    @property
    def pad_token_id(self) -> int:
        return self.special_to_id[ENDOFTEXT]

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        return self.special_to_id.get(token)

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self.special_to_id:
                ids.append(self.special_to_id[part])
            else:
                ids.extend(part.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: list[str] = []
        buf = bytearray()
        for i in ids:
            i = int(i)
            if i in self.id_to_special:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not skip_special_tokens:
                    out.append(self.id_to_special[i])
            elif i < 256:
                buf.append(i)
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def apply_chat_template(
        self,
        messages: Sequence[dict],
        tokenize: bool = True,
        add_generation_prompt: bool = True,
        enable_thinking: bool = False,
    ):
        self.chat_template.enable_thinking = enable_thinking
        text = self.chat_template.render(messages, add_generation_prompt)
        return self.encode(text) if tokenize else text


class HFTokenizerAdapter:
    """Wrap a locally available HF tokenizer (real Qwen3 checkpoints)."""

    def __init__(self, hf_tokenizer):
        self.tok = hf_tokenizer
        # Add the audio token exactly like the reference (asr_modeling.py:320-332)
        existing = list(getattr(self.tok, "additional_special_tokens", None) or [])
        if AUDIO_TOKEN not in existing:
            self.tok.add_special_tokens(
                {"additional_special_tokens": existing + [AUDIO_TOKEN]}
            )
        if self.tok.pad_token is None or self.tok.pad_token_id == self.tok.eos_token_id:
            vocab = self.tok.get_vocab()
            for cand in ("<|finetune_right_pad_id|>", "<|endoftext|>", "<pad>"):
                if cand in vocab and vocab[cand] != self.tok.eos_token_id:
                    self.tok.pad_token = cand
                    break
            else:
                # No distinct pad token exists: pad == eos is SAFE in this
                # framework (labels are masked positionally by the collator,
                # never by pad id, and generate() tracks lengths in-loop,
                # documented tolerant of pad ∈ EOS), so fall back rather
                # than inventing a new token that would resize embeddings.
                if self.tok.pad_token is None:
                    self.tok.pad_token = self.tok.eos_token
        self.tok.padding_side = "right"

    @classmethod
    def from_pretrained(cls, path: str) -> "HFTokenizerAdapter":
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(path, trust_remote_code=True))

    @property
    def vocab_size(self) -> int:
        return len(self.tok)

    @property
    def audio_token_id(self) -> int:
        return self.tok.convert_tokens_to_ids(AUDIO_TOKEN)

    @property
    def eos_token_ids(self) -> list[int]:
        # Probe by vocab membership, not convert_tokens_to_ids (slow
        # tokenizers map unknown strings to unk, which must never join the
        # stop set).  Qwen-style turn/end tokens plus Gemma's
        # <end_of_turn>, plus whatever the tokenizer declares as EOS —
        # family-agnostic, matching the reference's "any text tower"
        # contract (asr_modeling.py:239-254).
        vocab = self.tok.get_vocab()
        ids = [vocab[t] for t in (IM_END, ENDOFTEXT, "<end_of_turn>")
               if t in vocab]
        if self.tok.eos_token_id is not None:
            ids.append(self.tok.eos_token_id)
        return list(dict.fromkeys(ids))

    @property
    def pad_token_id(self) -> int:
        return self.tok.pad_token_id

    def convert_tokens_to_ids(self, token: str):
        return self.tok.convert_tokens_to_ids(token)

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tok.decode(list(map(int, ids)), skip_special_tokens=skip_special_tokens)

    def apply_chat_template(
        self,
        messages,
        tokenize: bool = True,
        add_generation_prompt: bool = True,
        enable_thinking: bool = False,
    ):
        return self.tok.apply_chat_template(
            messages,
            tokenize=tokenize,
            add_generation_prompt=add_generation_prompt,
            enable_thinking=enable_thinking,
        )
