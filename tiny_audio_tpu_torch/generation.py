"""KV-cached generation: greedy, sampling and beam search.

Port of :func:`tiny_audio_tpu.generation.generate_tokens`,
:func:`~tiny_audio_tpu.generation.stream_generate` and
:func:`~tiny_audio_tpu.generation.generate_beams`: prefill over the
(possibly right-padded) prompt, then an eager Python decode loop over a
static-shape cache updated in place, with the repetition penalty,
``no_repeat_ngram_size`` bans, EOS masking under ``min_new_tokens``, pad
after EOS and optional per-row scores.  Tokens are picked by argmax, or with
``do_sample`` drawn from the temperature / top-k / top-p filtered
distribution with the caller's ``torch.Generator`` (None: a generator on the
decode device seeded with 0 for each call, as the JAX package takes
``PRNGKey(0)``); nothing draws from the global RNG.

Each decode step takes one of two paths, as in the JAX package:

- fused (the default on the card): :func:`~tiny_audio_tpu_torch.ops.
  fused_decode.fused_decode_step`, one kernel per layer that appends the
  fresh K/V row to the cache and attends;
- module (``fused_decode=False``, and streaming): ``Qwen3Decoder.forward``,
  whose attention is the decode kernel over the stale cache, followed by a
  separate write of the fresh row.

Beam search takes either step (the JAX package's beams run the module step
only; both give the same tokens).  A CUDA graph of the decode step is later
work.

The continuous engine's device work (:mod:`tiny_audio_tpu_torch.continuous`)
is here too, with the JAX package's names: :func:`prefill_prompt_cache`,
:func:`init_slot_state`, :func:`insert_slots` and :func:`decode_chunk`, whose
steps give each slot its own length (the decoder's ``[B]`` cache index, the
decode kernels' per-row lengths) and read nothing back to the host inside a
chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import torch

from tiny_audio_tpu_torch.models.decoder import Qwen3Decoder
from tiny_audio_tpu_torch.models.layers import draw_for_rows
from tiny_audio_tpu_torch.ops.fused_decode import fused_decode_step
from tiny_audio_tpu_torch.utils.profiling import span, sync


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


def _apply_repetition_penalty(logits, seen, penalty: float):
    """HF semantics: for seen tokens, divide positive logits / multiply
    negative logits by the penalty."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _ban_repeated_ngrams(logits: torch.Tensor, all_tokens: torch.Tensor, cur_len: int,
                         n: int) -> torch.Tensor:
    """HF ``no_repeat_ngram_size`` semantics: ban every token that would
    complete an n-gram already present in the sequence.

    The trailing (n-1)-gram of ``all_tokens`` (the first ``cur_len`` ids are
    valid) is compared with every (n-1)-window; the token that followed each
    match, when already generated, gets ``finfo(float32).min``.  The context's
    start is clamped into ``[0, S - (n-1)]`` as ``dynamic_slice`` clamps it
    (while ``cur_len < n - 1`` no window is valid either).  Sentinel ids below
    0 never match and never ban; followers outside the vocabulary are dropped.

    Args:
        logits: [B, V] fp32 next-token logits.
        all_tokens: [B, S] int64 prompt + generated ids.
        cur_len: number of valid ids in ``all_tokens``.
        n: the n-gram size (>= 2).
    """
    b, smax = all_tokens.shape
    w = smax - (n - 1)
    start = min(max(cur_len - (n - 1), 0), w)
    ctx = all_tokens[:, start:start + n - 1]  # [B, n-1]
    windows = all_tokens.unfold(1, n - 1, 1)[:, :w]  # [B, w, n-1]
    match = (windows == ctx[:, None, :]).all(dim=-1)
    next_tok = all_tokens[:, n - 1:]  # [B, w]: the token after each window
    valid = (torch.arange(w, device=all_tokens.device) + (n - 1)) < cur_len
    vocab = logits.shape[-1]
    match &= (windows >= 0).all(dim=-1) & (next_tok >= 0) & (next_tok < vocab) & valid[None, :]
    hits = torch.zeros((b, vocab), dtype=torch.int32, device=logits.device)
    hits.scatter_add_(1, next_tok.clamp(0, vocab - 1), match.to(torch.int32))
    return logits.masked_fill(hits > 0, torch.finfo(torch.float32).min)


def _filter_logits(logits: torch.Tensor, gen: GenerationConfig) -> torch.Tensor:
    """The sampling distribution's logits, as the JAX package filters them:
    temperature (when set and not 1), then top-k (every logit below the k-th
    largest is -inf), then top-p (the smallest prefix of the sorted
    distribution whose mass before its last token is below ``top_p``; every
    logit at or above that prefix's last value survives, ties included, so at
    least one token stays)."""
    logits = logits.to(torch.float32)
    if gen.temperature and gen.temperature != 1.0:
        logits = logits / torch.tensor(gen.temperature, dtype=torch.float32,
                                       device=logits.device)
    if gen.top_k:
        kth = _sort_desc(logits)[0][:, gen.top_k - 1:gen.top_k]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if gen.top_p and gen.top_p < 1.0:
        sorted_logits = _sort_desc(logits)[0]
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs < gen.top_p).sum(dim=-1, keepdim=True)
        threshold = sorted_logits.gather(1, keep - 1)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return logits


def _select_token(logits: torch.Tensor, gen: GenerationConfig,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Argmax, or with ``do_sample`` one categorical draw per row from the
    filtered logits (Gumbel-max on uniforms from ``generator``, on the
    logits' device: no host sync)."""
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filtered = _filter_logits(logits, gen)
    # a dp rank draws the whole batch's uniforms and keeps its rows
    u = draw_for_rows(filtered.shape, lambda shape: torch.rand(
        shape, generator=generator, device=filtered.device))
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(filtered + gumbel, dim=-1).to(torch.int32)


def _sort_desc(x: torch.Tensor):
    """Descending sort along the last axis, the lower index first among ties
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _decode_generator(gen: GenerationConfig, generator: Optional[torch.Generator],
                      device: torch.device) -> Optional[torch.Generator]:
    """The caller's generator, or for sampling a fresh one on ``device``
    seeded with 0 (so repeated calls give the same tokens)."""
    if generator is None and gen.do_sample:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def _fused_decode_available(decoder: Qwen3Decoder) -> bool:
    """The fused decode path needs the card (the decoder's weights on CUDA)
    and no live LoRA: the JAX package's gate, with "on the TPU" read as "on
    the card".  The kernel takes every head_dim and GQA group of the decoders
    the JAX package supports; its wrapper raises for any other shape."""
    return decoder.embed_tokens.weight.is_cuda and decoder.cfg.lora_rank == 0


def _cache_len(t: int, max_new: int) -> int:
    return -(-(t + max_new) // 16) * 16


def _token_ring(gen: GenerationConfig, prompt_ids: torch.Tensor) -> Optional[torch.Tensor]:
    """[B, T + max_new] int64: the prompt ids then pads, where the n-gram
    bans read the sequence (None without ``no_repeat_ngram_size``)."""
    if gen.no_repeat_ngram_size < 2:
        return None
    pads = torch.full((prompt_ids.shape[0], gen.max_new_tokens), gen.pad_token_id,
                      dtype=torch.long, device=prompt_ids.device)
    return torch.cat([prompt_ids.long(), pads], dim=1)


def _step_logits(decoder: Qwen3Decoder, cur: torch.Tensor, pos: int, cache: dict,
                 kv_index: torch.Tensor, fused_decode: bool) -> torch.Tensor:
    if fused_decode:
        return fused_decode_step(decoder, cur, pos, cache)
    return _module_step(decoder, cur, pos, cache, kv_index)


@torch.inference_mode()
def generate_tokens(
    decoder: Qwen3Decoder,
    inputs_embeds: torch.Tensor,
    input_ids: torch.Tensor,
    gen: GenerationConfig,
    prompt_len: Optional[int] = None,
    fused_decode: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
):
    """Prefill + decode loop (greedy, or sampling with ``gen.do_sample``).

    Args:
        decoder: the ``Qwen3Decoder``.
        inputs_embeds: [B, T, H] prompt embeddings (audio already spliced).
        input_ids: [B, T] prompt ids (repetition-penalty and n-gram
            bookkeeping).
        gen: the GenerationConfig.
        prompt_len: number of REAL prompt rows when the prompt was
            right-padded to a bucket (rows ``prompt_len..T-1`` are padding,
            causally invisible to the real rows; decoding starts at
            ``prompt_len`` and overwrites them, and generated ids overwrite
            the pad ids of the n-gram ring from there).  None means all T rows.
        fused_decode: True for the fused decode step, False for the module
            step; None takes the fused step where it is available
            (:func:`_fused_decode_available`).
        generator: the sampling draws' generator (see the module docstring).

    Returns:
        (tokens [B, max_new_tokens] int32 — pad after EOS,
         lengths [B] int32 — generated length including the EOS token),
        plus [B] float32 mean chosen-token log-probability with
        ``gen.return_scores``.
    """
    if fused_decode is None:
        fused_decode = _fused_decode_available(decoder)
    device = inputs_embeds.device
    generator = _decode_generator(gen, generator, device)
    b, t, _ = inputs_embeds.shape
    prompt_len = t if prompt_len is None else int(prompt_len)
    max_new = gen.max_new_tokens
    s = _cache_len(t, max_new)
    cache = decoder.init_cache(b, s)

    # ---- prefill (fills the cache in place) and the first pick ----
    # No key-padding mask: the pad rows lie after the real ones, so the
    # causal mask already hides them from every real row.
    with span("prefill", rows=b):
        positions = torch.arange(t, device=device).expand(b, t)
        logits = decoder(
            inputs_embeds, positions, cache=cache, cache_index=0,
            last_logit_index=prompt_len - 1,
        )
        last_logits = logits[:, 0].to(torch.float32)

        seen = _prompt_seen(gen, input_ids, prompt_len, decoder.cfg.vocab_size)
        ring = _token_ring(gen, input_ids)
        with sync("eos_ids"):  # a copy from pageable host memory waits for the stream
            eos_ids = torch.tensor(gen.eos_token_ids, dtype=torch.long, device=device)

        def is_eos(tok):
            return torch.isin(tok.long(), eos_ids)

        tok = _pick(last_logits, gen, seen, 0, eos_ids, ring, prompt_len, generator)
        finished = is_eos(tok)
        tokens = torch.full((b, max_new), gen.pad_token_id, dtype=torch.int32, device=device)
        tokens[:, 0] = tok
        lengths = torch.ones((b,), dtype=torch.int32, device=device)  # incl. the EOS
        _mark_seen(seen, tok)
        if ring is not None:
            ring[:, prompt_len] = tok
        logp_sum = None
        if gen.return_scores:
            logp0 = torch.log_softmax(last_logits, dim=-1)
            logp_sum = logp0.gather(1, tok.long()[:, None])[:, 0]
        done = max_new <= 1 or _all_finished(finished)

    # each step ends with the read that decides whether the next one runs
    # (none after the last): the reads and tokens of a `while not all
    # finished` loop, each read inside the step whose work it waits for
    kv_index = torch.arange(s, device=device)
    step = 1
    while not done:
        with span("decode_step"):
            pos = prompt_len + step - 1  # position of the token being fed
            logits_f32 = _step_logits(decoder, tok, pos, cache, kv_index, fused_decode)
            tok = _pick(logits_f32, gen, seen, step, eos_ids, ring, prompt_len + step, generator)
            tok = torch.where(finished, gen.pad_token_id, tok)  # finished rows emit pad
            tokens[:, step] = tok
            if gen.return_scores:
                logp = torch.log_softmax(logits_f32, dim=-1)
                logp_tok = logp.gather(1, tok.long()[:, None])[:, 0]
                logp_sum = logp_sum + torch.where(finished, 0.0, logp_tok)
            lengths = torch.where(finished, lengths, step + 1)
            finished = finished | is_eos(tok)
            _mark_seen(seen, tok)
            if ring is not None:
                ring[:, prompt_len + step] = tok
            step += 1
            done = step >= max_new or _all_finished(finished)

    # rows still unfinished ran the full budget (loop-tracked: correct even
    # when pad_token_id is itself an EOS id, as with the byte tokenizer)
    lengths = torch.where(finished, lengths, max_new).to(torch.int32)
    if gen.return_scores:
        scores = logp_sum / torch.clamp(lengths, min=1).to(torch.float32)
        return tokens, lengths, scores
    return tokens, lengths


def _all_finished(finished: torch.Tensor) -> bool:
    """The decode loop's per-step host read: has every row ended?"""
    with sync("finished"):
        return bool(finished.all())


def _module_step(decoder: Qwen3Decoder, tok: torch.Tensor, pos: int, cache: dict,
                 kv_index: torch.Tensor) -> torch.Tensor:
    """One decode step through ``Qwen3Decoder.forward``: fp32 logits [B, V]."""
    b = tok.shape[0]
    kv_valid = (kv_index < pos)[None, :].to(torch.int32)  # fresh row appended in attention
    logits = decoder(
        decoder.embed(tok[:, None]),
        torch.full((b, 1), pos, dtype=torch.int32, device=tok.device),
        step_kv_valid=kv_valid, cache=cache, cache_index=pos,
    )
    return logits[:, 0].to(torch.float32)


def _prompt_seen(gen: GenerationConfig, input_ids: Optional[torch.Tensor], prompt_len: int,
                 vocab_size: int, device=None) -> Optional[torch.Tensor]:
    """[B, V] tokens seen in the real prompt rows, for the repetition
    penalty (None without one; all False without ``input_ids``)."""
    if gen.repetition_penalty == 1.0:
        return None
    if input_ids is None:
        return torch.zeros((1, vocab_size), dtype=torch.bool, device=device)
    seen = torch.zeros((input_ids.shape[0], vocab_size), dtype=torch.bool,
                       device=input_ids.device)
    return seen.scatter_(1, input_ids[:, :prompt_len].long(), True)


def _mark_seen(seen: Optional[torch.Tensor], tok: torch.Tensor) -> None:
    if seen is not None:
        seen[torch.arange(tok.shape[0], device=tok.device), tok.long()] = True


def _constrain(logits_f32: torch.Tensor, gen: GenerationConfig, seen: Optional[torch.Tensor],
               step: int, eos_ids: torch.Tensor, ring: Optional[torch.Tensor],
               cur_len: int) -> torch.Tensor:
    """The logits token ``step`` is picked from: repetition penalty, n-gram
    bans over the first ``cur_len`` ids of ``ring``, EOS masked while
    ``step < min_new_tokens``."""
    if seen is not None:
        logits_f32 = _apply_repetition_penalty(logits_f32, seen, gen.repetition_penalty)
    if ring is not None:
        logits_f32 = _ban_repeated_ngrams(logits_f32, ring, cur_len, gen.no_repeat_ngram_size)
    if gen.min_new_tokens > 0 and len(gen.eos_token_ids) and step < gen.min_new_tokens:
        logits_f32 = logits_f32.index_fill(1, eos_ids, torch.finfo(torch.float32).min)
    return logits_f32


def _pick(logits_f32: torch.Tensor, gen: GenerationConfig, seen: Optional[torch.Tensor],
          step: int, eos_ids: torch.Tensor, ring: Optional[torch.Tensor], cur_len: int,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """Token ``step`` of the generation: :func:`_constrain`, then
    :func:`_select_token`."""
    logits_f32 = _constrain(logits_f32, gen, seen, step, eos_ids, ring, cur_len)
    return _select_token(logits_f32, gen, generator)


@torch.inference_mode()
def stream_generate(
    decoder: Qwen3Decoder,
    inputs_embeds: torch.Tensor,
    input_ids: torch.Tensor,
    gen: GenerationConfig,
    prompt_len: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Iterator[int]:
    """Token-by-token generator at batch 1: prefill once, then one module
    decode step per token (greedy, or sampling with ``gen.do_sample``).  The
    only host sync per token is reading the token that feeds the stream; it
    stops at EOS or after ``gen.max_new_tokens`` tokens.  As in the JAX
    package, the fed token is written into the n-gram ring at its position
    just before the step's bans."""
    if inputs_embeds.shape[0] != 1:
        raise ValueError("streaming is defined for batch 1")
    device = inputs_embeds.device
    generator = _decode_generator(gen, generator, device)
    t = inputs_embeds.shape[1]
    plen = t if prompt_len is None else int(prompt_len)
    s = _cache_len(t, gen.max_new_tokens)
    cache = decoder.init_cache(1, s)
    kv_index = torch.arange(s, device=device)
    eos_ids = torch.tensor(gen.eos_token_ids, dtype=torch.long, device=device)

    positions = torch.arange(t, device=device)[None]
    logits = decoder(inputs_embeds, positions, cache=cache, cache_index=0,
                     last_logit_index=plen - 1)[:, 0].to(torch.float32)
    seen = _prompt_seen(gen, input_ids, plen, decoder.cfg.vocab_size)
    ring = _token_ring(gen, input_ids)
    tok = _pick(logits, gen, seen, 0, eos_ids, ring, plen, generator)
    _mark_seen(seen, tok)

    eos = set(gen.eos_token_ids)
    for step in range(gen.max_new_tokens):
        tok_host = int(tok[0])
        if tok_host in eos:
            return
        yield tok_host
        if step == gen.max_new_tokens - 1:
            return
        pos = plen + step
        if ring is not None:
            ring[:, pos] = tok
        logits = _module_step(decoder, tok, pos, cache, kv_index)
        tok = _pick(logits, gen, seen, step + 1, eos_ids, ring, pos + 1, generator)
        _mark_seen(seen, tok)


@torch.inference_mode()
def generate_beams(
    decoder: Qwen3Decoder,
    inputs_embeds: torch.Tensor,
    gen: GenerationConfig,
    input_ids: Optional[torch.Tensor] = None,
    fused_decode: Optional[bool] = None,
):
    """Length-normalized beam search with ``gen.num_beams`` beams.

    The JAX package's semantics: prefill once per row (the prompt is exact:
    its last row is the real last row), replicate the cache beam-major, seed
    the beams from the top-k of the first distribution; at each step every
    beam's candidates are its cumulative log-probability plus the step's
    log-softmax (after the repetition penalty, n-gram bans and EOS masking,
    as :func:`generate_tokens`), a finished beam may extend only with pad at
    zero cost (every other token at -1e30), and the top-k of the flat
    ``[B, K * V]`` candidates (lower index first among ties) become the new
    beams.  Every cache buffer (``k_scale`` and ``v_scale`` too under the
    int8 cache) is reordered by parent beam, over the rows written so far
    (the step has already appended the fresh row at ``pos``).  The final
    score is ``cum / length ** length_penalty`` and each row returns its
    best beam.

    Args:
        inputs_embeds: [B, T, H] prompt embeddings (audio already spliced).
        input_ids: optional [B, T] prompt ids: they seed the repetition
            penalty's seen set and the n-gram ring (without them the ring's
            prompt region holds -1, which never matches).
        fused_decode: as in :func:`generate_tokens`.

    Returns:
        (tokens [B, max_new_tokens] int32, pad after EOS; scores [B] float32).
    """
    if fused_decode is None:
        fused_decode = _fused_decode_available(decoder)
    device = inputs_embeds.device
    k = gen.num_beams
    b, t, _ = inputs_embeds.shape
    max_new = gen.max_new_tokens
    s = _cache_len(t, max_new)

    cache = decoder.init_cache(b, s)
    positions = torch.arange(t, device=device).expand(b, t)
    first = decoder(inputs_embeds, positions, cache=cache, cache_index=0,
                    last_logit_index=t - 1)[:, 0].to(torch.float32)
    vocab = first.shape[-1]
    seen = _prompt_seen(gen, input_ids, t, vocab, device)
    if seen is not None:
        seen = seen.expand(b, vocab)
    ring = None
    if gen.no_repeat_ngram_size >= 2:
        prompt = (input_ids.long() if input_ids is not None
                  else torch.full((b, t), -1, dtype=torch.long, device=device))
        ring = _token_ring(gen, prompt)
    eos_ids = torch.tensor(gen.eos_token_ids, dtype=torch.long, device=device)
    first = _constrain(first, gen, seen, 0, eos_ids, ring, t)
    cum, top_tok = _top_k(torch.log_softmax(first, dim=-1), k)  # [B, K]
    top_tok = top_tok.to(torch.int32)
    for name, buf in cache.items():
        cache[name] = buf.repeat_interleave(k, dim=1)

    def is_eos(tok):
        return torch.isin(tok.long(), eos_ids)

    beams = torch.arange(k, device=device)[None, :]
    rows = torch.arange(b, device=device)[:, None]
    tokens = torch.full((b, k, max_new), gen.pad_token_id, dtype=torch.int32, device=device)
    tokens[:, :, 0] = top_tok
    finished = is_eos(top_tok)
    lengths = torch.ones((b, k), dtype=torch.int32, device=device)
    if seen is not None:
        seen = seen[:, None, :].repeat(1, k, 1)
        seen[rows, beams, top_tok.long()] = True
    if ring is not None:
        ring = ring[:, None, :].repeat(1, k, 1)
        ring[:, :, t] = top_tok
    pad_only = torch.full((vocab,), -1e30, dtype=torch.float32, device=device)
    pad_only[gen.pad_token_id] = 0.0

    cur = top_tok
    kv_index = torch.arange(s, device=device)
    step = 1
    while step < max_new and not bool(finished.all()):
        pos = t + step - 1
        logits = _step_logits(decoder, cur.reshape(b * k), pos, cache, kv_index, fused_decode)
        logits = _constrain(
            logits, gen, None if seen is None else seen.reshape(b * k, vocab), step, eos_ids,
            None if ring is None else ring.reshape(b * k, -1), t + step)
        logprobs = torch.log_softmax(logits, dim=-1).reshape(b, k, vocab)
        logprobs = torch.where(finished[:, :, None], pad_only, logprobs)
        cum, idx = _top_k((cum[:, :, None] + logprobs).reshape(b, k * vocab), k)
        parent = idx // vocab
        tok = (idx % vocab).to(torch.int32)

        order = (rows * k + parent).reshape(-1)  # flat parent rows, beam-major
        tokens = tokens.reshape(b * k, max_new)[order].reshape(b, k, max_new)
        parent_finished = finished.gather(1, parent)
        parent_lengths = lengths.gather(1, parent)
        for buf in cache.values():
            buf[:, :, :pos + 1] = buf[:, order, :pos + 1]
        tok = torch.where(parent_finished, gen.pad_token_id, tok)
        tokens[:, :, step] = tok
        finished = parent_finished | is_eos(tok)
        lengths = torch.where(parent_finished, parent_lengths, parent_lengths + 1)
        if seen is not None:
            seen = seen.reshape(b * k, vocab)[order].reshape(b, k, vocab)
            seen[rows, beams, tok.long()] = True
        if ring is not None:
            ring = ring.reshape(b * k, -1)[order].reshape(b, k, -1)
            ring[:, :, t + step] = tok
        cur = tok
        step += 1

    scores = cum / lengths.to(torch.float32) ** gen.length_penalty
    best = torch.argmax(scores, dim=1)
    index = torch.arange(b, device=device)
    return tokens[index, best], scores[index, best]


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among ties, as ``jax.lax.top_k``."""
    values, indices = _sort_desc(x)
    return values[..., :k], indices[..., :k]


# ---------------------------------------------------------------------------
# Continuous batching (slot-based decode): the engine's device work
# ---------------------------------------------------------------------------
# The engine is tiny_audio_tpu_torch/continuous.py.  N persistent decode slots
# share one KV cache [L, N, S_max, Hkv, D]; each slot sits at its own length
# (``pos`` [N]), so a request joins as soon as a slot frees.  The step writes
# and reads each row at its own length: the decoder's ``[B]`` cache_index,
# and on the card the decode kernels' per-row lengths.


@torch.inference_mode()
def prefill_prompt_cache(decoder: Qwen3Decoder, inputs_embeds: torch.Tensor,
                         prompt_len: Optional[int] = None):
    """Prefill only: the greedy first token [B] int32 and the prompt's cache,
    ``ceil(T / 16) * 16`` rows (the engine scatters both into free slots).

    ``prompt_len``: the number of real prompt rows when the prompt was
    right-padded to a PROMPT_BUCKET multiple; the first token reads the
    logits at ``prompt_len - 1``, and the cache rows from ``prompt_len`` on
    stay masked by the slot's length until decode overwrites them."""
    b, t, _ = inputs_embeds.shape
    prompt_len = t if prompt_len is None else int(prompt_len)
    cache = decoder.init_cache(b, -(-t // 16) * 16)
    positions = torch.arange(t, device=inputs_embeds.device).expand(b, t)
    logits = decoder(inputs_embeds, positions, cache=cache, cache_index=0,
                     last_logit_index=prompt_len - 1)
    return torch.argmax(logits[:, 0].to(torch.float32), dim=-1).to(torch.int32), cache


def init_slot_state(decoder: Qwen3Decoder, n_slots: int, s_max: int, pad_token_id: int) -> dict:
    """A fresh engine state, every slot empty (finished): the cache, and per
    slot the current token, the next cache row (= its length), the prompt
    length and whether it is finished, all on the decoder's device."""
    device = decoder.embed_tokens.weight.device
    return {
        "cache": decoder.init_cache(n_slots, s_max),
        "cur": torch.full((n_slots,), pad_token_id, dtype=torch.int32, device=device),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "start": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "finished": torch.ones((n_slots,), dtype=torch.bool, device=device),
    }


@torch.inference_mode()
def insert_slots(state: dict, prompt_cache: dict, first_toks: torch.Tensor,
                 slot_ids: torch.Tensor, t_real: torch.Tensor,
                 first_finished: torch.Tensor) -> dict:
    """Scatter ``b`` prefilled requests into slots ``slot_ids`` [b]: each
    slot's first ``s_p`` cache rows (of every layer, scales too) from
    ``prompt_cache`` ([L, b, s_p, ...]), its token, length and prompt length
    ``t_real`` [b], and whether it finished at the prefill.  In place;
    returns ``state``."""
    s_p = prompt_cache["k"].shape[2]
    for name, buf in prompt_cache.items():
        state["cache"][name][:, slot_ids, :s_p] = buf
    state["cur"][slot_ids] = first_toks
    state["pos"][slot_ids] = t_real
    state["start"][slot_ids] = t_real
    state["finished"][slot_ids] = first_finished
    return state


@torch.inference_mode()
def decode_chunk(decoder: Qwen3Decoder, state: dict, gen: GenerationConfig, n_steps: int,
                 fused_decode: Optional[bool] = None):
    """``n_steps`` greedy decode steps over every slot; returns (state,
    tokens [N, n_steps] int32 on the device).  Finished and free slots emit
    pad and do not advance; a slot finishes on an EOS id, on its budget
    (``pos - start + 2 >= max_new_tokens``: the prefill gave its first
    token) or before its next row would pass the cache (``pos + 1 >=
    S_max``).  Nothing is read back to the host inside the chunk: the
    caller reads the tokens once.  ``fused_decode`` as in
    :func:`generate_tokens`: the fused step (kernel #4 appending each row at
    its own length) by default on the card, the module step (#3, then the
    per-row cache write) on request and elsewhere."""
    if fused_decode is None:
        fused_decode = _fused_decode_available(decoder)
    cache = state["cache"]
    s_max = cache["k"].shape[2]
    device = state["pos"].device
    eos_ids = torch.tensor(gen.eos_token_ids, dtype=torch.int32, device=device)
    kv_index = torch.arange(s_max, device=device)
    cur, pos, start, finished = state["cur"], state["pos"], state["start"], state["finished"]
    toks = []
    for _ in range(n_steps):
        if fused_decode:
            logits = fused_decode_step(decoder, cur, pos, cache)
        else:
            logits = decoder(decoder.embed(cur[:, None]), pos[:, None],
                             step_kv_valid=(kv_index[None, :] < pos[:, None]).to(torch.int32),
                             cache=cache, cache_index=pos)[:, 0].to(torch.float32)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        tok = torch.where(finished, gen.pad_token_id, tok)
        budget_done = pos - start + 2 >= gen.max_new_tokens
        overflow = pos + 1 >= s_max  # never write past the cache
        new_finished = finished | torch.isin(tok, eos_ids) | budget_done | overflow
        pos = torch.where(finished, pos, pos + 1)
        cur, finished = tok, new_finished
        toks.append(tok)
    state.update(cur=cur, pos=pos, finished=finished)
    return state, torch.stack(toks, dim=1)
