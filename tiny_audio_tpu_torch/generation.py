"""KV-cached greedy generation.

Port of :func:`tiny_audio_tpu.generation.generate_tokens` (greedy path):
prefill over the (possibly right-padded) prompt, then an eager Python decode
loop over a static-shape cache updated in place, with the repetition penalty,
EOS masking under ``min_new_tokens``, pad after EOS and optional per-row
scores.  Sampling, ``no_repeat_ngram_size >= 2`` and beams are not ported
yet (ROADMAP.md); a CUDA graph of the decode step is later work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from tiny_audio_tpu_torch.models.decoder import Qwen3Decoder


@dataclass(frozen=True)
class GenerationConfig:
    """Generation hyperparameters (same fields as the JAX package's)."""

    max_new_tokens: int = 128
    min_new_tokens: int = 0
    eos_token_ids: tuple[int, ...] = ()
    pad_token_id: int = 0
    repetition_penalty: float = 1.0
    do_sample: bool = False
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    num_beams: int = 1
    length_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    # Also return per-row mean log-probability of the chosen tokens under the
    # RAW model distribution (before penalty / EOS masking).
    return_scores: bool = False

    def __post_init__(self):
        if self.no_repeat_ngram_size == 1:
            raise ValueError(
                "no_repeat_ngram_size=1 bans every previously seen token; "
                "use repetition_penalty instead (sizes >= 2 are supported)"
            )

    @classmethod
    def from_asr_config(cls, cfg, eos_token_ids: Sequence[int], pad_token_id: int):
        return cls(
            max_new_tokens=cfg.max_new_tokens,
            min_new_tokens=cfg.min_new_tokens,
            eos_token_ids=tuple(eos_token_ids),
            pad_token_id=pad_token_id,
            repetition_penalty=cfg.repetition_penalty or 1.0,
            do_sample=cfg.do_sample,
            temperature=cfg.temperature,
            top_k=cfg.top_k,
            top_p=cfg.top_p,
            num_beams=cfg.num_beams or 1,
            length_penalty=cfg.length_penalty or 1.0,
            no_repeat_ngram_size=getattr(cfg, "no_repeat_ngram_size", 0) or 0,
        )


def check_supported(gen: GenerationConfig) -> None:
    """Raise for the decoding modes the port does not have yet."""
    for unsupported, what in (
        (gen.do_sample, "sampling"),
        (gen.num_beams > 1, "beam search"),
        (gen.no_repeat_ngram_size >= 2, "no_repeat_ngram_size"),
    ):
        if unsupported:
            raise NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md)")


def _apply_repetition_penalty(logits, seen, penalty: float):
    """HF semantics: for seen tokens, divide positive logits / multiply
    negative logits by the penalty."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


@torch.inference_mode()
def generate_tokens(
    decoder: Qwen3Decoder,
    inputs_embeds: torch.Tensor,
    input_ids: torch.Tensor,
    gen: GenerationConfig,
    prompt_len: Optional[int] = None,
):
    """Prefill + greedy decode loop.

    Args:
        decoder: the ``Qwen3Decoder``.
        inputs_embeds: [B, T, H] prompt embeddings (audio already spliced).
        input_ids: [B, T] prompt ids (repetition-penalty bookkeeping).
        gen: the GenerationConfig.
        prompt_len: number of REAL prompt rows when the prompt was
            right-padded to a bucket (rows ``prompt_len..T-1`` are padding,
            causally invisible to the real rows; decoding starts at
            ``prompt_len`` and overwrites them).  None means all T rows.

    Returns:
        (tokens [B, max_new_tokens] int32 — pad after EOS,
         lengths [B] int32 — generated length including the EOS token),
        plus [B] float32 mean chosen-token log-probability with
        ``gen.return_scores``.
    """
    check_supported(gen)
    cfg = decoder.cfg
    device = inputs_embeds.device
    b, t, _ = inputs_embeds.shape
    prompt_len = t if prompt_len is None else int(prompt_len)
    max_new = gen.max_new_tokens
    s = -(-(t + max_new) // 16) * 16
    cache = decoder.init_cache(b, s)

    # ---- prefill (fills the cache in place) ----
    # No key-padding mask: the pad rows lie after the real ones, so the
    # causal mask already hides them from every real row.
    positions = torch.arange(t, device=device).expand(b, t)
    logits = decoder(
        inputs_embeds, positions, cache=cache, cache_index=0,
        last_logit_index=prompt_len - 1,
    )
    last_logits = logits[:, 0].to(torch.float32)

    use_penalty = gen.repetition_penalty != 1.0
    seen = None
    if use_penalty:
        seen = torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=device)
        seen.scatter_(1, input_ids[:, :prompt_len].long(), True)
    eos_ids = torch.tensor(gen.eos_token_ids, dtype=torch.long, device=device)
    rows = torch.arange(b, device=device)

    def pick(logits_f32, step):
        if use_penalty:
            logits_f32 = _apply_repetition_penalty(logits_f32, seen, gen.repetition_penalty)
        if gen.min_new_tokens > 0 and len(gen.eos_token_ids) and step < gen.min_new_tokens:
            logits_f32 = logits_f32.index_fill(1, eos_ids, torch.finfo(torch.float32).min)
        return torch.argmax(logits_f32, dim=-1).to(torch.int32)

    def is_eos(tok):
        return torch.isin(tok.long(), eos_ids)

    tok = pick(last_logits, 0)
    finished = is_eos(tok)
    tokens = torch.full((b, max_new), gen.pad_token_id, dtype=torch.int32, device=device)
    tokens[:, 0] = tok
    lengths = torch.ones((b,), dtype=torch.int32, device=device)  # incl. the EOS
    if use_penalty:
        seen[rows, tok.long()] = True
    logp_sum = None
    if gen.return_scores:
        logp0 = torch.log_softmax(last_logits, dim=-1)
        logp_sum = logp0.gather(1, tok.long()[:, None])[:, 0]

    kv_index = torch.arange(s, device=device)
    step = 1
    while step < max_new and not bool(finished.all()):
        pos = prompt_len + step - 1  # position of the token being fed
        embeds = decoder.embed(tok[:, None])
        kv_valid = (kv_index < pos)[None, :].to(torch.int32)  # fresh row appended in attention
        logits = decoder(
            embeds, torch.full((b, 1), pos, dtype=torch.int32, device=device),
            step_kv_valid=kv_valid, cache=cache, cache_index=pos,
        )
        logits_f32 = logits[:, 0].to(torch.float32)
        tok = pick(logits_f32, step)
        tok = torch.where(finished, gen.pad_token_id, tok)  # finished rows emit pad
        tokens[:, step] = tok
        if gen.return_scores:
            logp = torch.log_softmax(logits_f32, dim=-1)
            logp_tok = logp.gather(1, tok.long()[:, None])[:, 0]
            logp_sum = logp_sum + torch.where(finished, 0.0, logp_tok)
        lengths = torch.where(finished, lengths, step + 1)
        finished = finished | is_eos(tok)
        if use_penalty:
            seen[rows, tok.long()] = True
        step += 1

    # rows still unfinished ran the full budget (loop-tracked: correct even
    # when pad_token_id is itself an EOS id, as with the byte tokenizer)
    lengths = torch.where(finished, lengths, max_new).to(torch.int32)
    if gen.return_scores:
        scores = logp_sum / torch.clamp(lengths, min=1).to(torch.float32)
        return tokens, lengths, scores
    return tokens, lengths
