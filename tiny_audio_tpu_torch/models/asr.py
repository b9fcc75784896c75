"""ASRModel: audio encoder + projector + Qwen3 decoder, serving and training.

Port of the inference half of :class:`tiny_audio_tpu.models.asr.ASRModel`:
mel mask -> encoder -> projector -> row-aligned ``<audio>`` splice ->
KV-cached decode (greedy, sampling or beam search), batched
(:meth:`ASRModel.generate`) or streamed token by token
(:meth:`ASRModel.generate_streaming`); the opt-in int8 decode modes
(:meth:`ASRModel.enable_wq_decode`, :meth:`~ASRModel.enable_w8a8_head`,
:meth:`~ASRModel.enable_w8a8_decode`); the JAX package's checkpoint layout
(:meth:`ASRModel.save_pretrained`, :meth:`ASRModel.from_pretrained`, LoRA
adapters in ``adapter.msgpack``); and its training half:
:meth:`ASRModel.compute_loss` (frozen encoder under ``no_grad``, frame
dropout, projector and its aux loss, splice, causal decoder, shifted CE), with
``requires_grad`` following the optimizer's labels (frozen towers get no
gradient), LoRA on the decoder and gradient checkpointing.

On a ``(dp, tp)`` mesh (:meth:`ASRModel.place_on`, the JAX package's
``shard_params``): every rank holds its shard, and rank 0's calls of
:meth:`~ASRModel.generate`, :meth:`~ASRModel.generate_streaming`,
:meth:`~ASRModel.prompt_logits` and :meth:`~ASRModel.save_pretrained` run
on every rank (:mod:`tiny_audio_tpu_torch.parallel.launch`).  A batch is
split over dp (padded to a multiple of dp by repeating rows) and the tokens
gathered back; every rank of a dp row sees the full logits, so greedy picks,
sampling draws (each rank draws from the same seeded generator) and
``finished`` agree on every rank.  :meth:`~ASRModel.compute_loss` sums the
token losses and counts over dp before dividing, with the vocabulary-
parallel cross-entropy under tp.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from tiny_audio_tpu_torch.bridge import _flatten, _set, load_jax_params, state_dict_to_jax
from tiny_audio_tpu_torch.config import ASRConfig, compute_encoder_output_length
from tiny_audio_tpu_torch.device import require_device
from tiny_audio_tpu_torch.tokenization import AUDIO_TOKEN, ByteTokenizer, HFTokenizerAdapter
from tiny_audio_tpu_torch.utils import msgpack_io
from tiny_audio_tpu_torch.utils.profiling import span, sync
from tiny_audio_tpu_torch.generation import (
    GenerationConfig,
    generate_beams,
    generate_tokens,
    stream_generate,
)
from tiny_audio_tpu_torch.models.decoder import (
    Qwen3Decoder,
    head_kernel,
    quantize_decoder_w8a8,
    quantize_decoder_wq,
)
from tiny_audio_tpu_torch.models.encoder import AudioEncoder
from tiny_audio_tpu_torch.models.layers import (
    batch_rows,
    draw_for_rows,
    sinusoidal_positions,
    tp_reduce,
)
from tiny_audio_tpu_torch.models.projectors import create_projector
from tiny_audio_tpu_torch.ops.wq_head import quantize_head_w8a8
from tiny_audio_tpu_torch.parallel.launch import mesh_call, mesh_stream
from tiny_audio_tpu_torch.parallel.mesh import dp_rows, gather_params, shard_batch, shard_model

TRANSCRIBE_PROMPT = "Transcribe the speech to text"

#: generate-time prompts are right-padded to a multiple of this (same
#: bucketing as the JAX package, so both decode the same padded prompt)
PROMPT_BUCKET = 64

# stddev of a standard normal truncated to (-2, 2): flax's lecun_normal
# divides by it so the truncated draw keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def is_frozen(name: str, config: ASRConfig) -> bool:
    """Whether the ``ASRModel`` parameter ``name`` is frozen: the encoder
    always, the decoder but its LoRA leaves under ``freeze_language_model``,
    the projector under ``freeze_projector``."""
    tower = name.split(".", 1)[0]
    if tower == "encoder":
        return True
    if tower == "decoder":
        return config.freeze_language_model and "lora" not in name
    return config.freeze_projector


def split_lora(params: dict) -> tuple[dict, dict]:
    """Partition a JAX-layout params tree (nested dicts) into (base, lora)
    sub-trees: a leaf is LoRA when any key of its path contains "lora"."""
    base: dict = {}
    lora: dict = {}
    for path, leaf in _flatten(params):
        _set(lora if any("lora" in key for key in path) else base, path, leaf)
    return base, lora


def merge_lora(base: dict, lora: dict) -> dict:
    """The inverse of :func:`split_lora` (``lora`` leaves win)."""
    merged: dict = {}
    for tree in (base, lora):
        for path, leaf in _flatten(tree):
            _set(merged, path, leaf)
    return merged


def splice_audio(
    text_embeds: torch.Tensor,
    audio_token_mask: torch.Tensor,
    audio_embeds: torch.Tensor,
) -> torch.Tensor:
    """Row-aligned splice: j-th True position of row b <- audio_embeds[b, j]."""
    idx_in_row = torch.cumsum(audio_token_mask.to(torch.int64), dim=1) - 1
    idx_in_row = torch.clamp(idx_in_row, 0, audio_embeds.shape[1] - 1)
    gathered = torch.take_along_dim(audio_embeds, idx_in_row[:, :, None], dim=1)
    return torch.where(
        audio_token_mask[:, :, None].to(torch.bool),
        gathered.to(text_embeds.dtype),
        text_embeds,
    )


def filter_think_stream(chunks):
    """Incrementally strip ``<think>...</think>`` spans from a stream of text
    chunks.

    Tags are consumed in positional order, alternating with state: one chunk
    can contain ``</think>hi <think>``, and handling ``<think>`` first
    regardless of state would leak the buffered think content (plus a
    literal ``</think>``) to the client.
    """
    in_think = False
    buffer = ""
    for text in chunks:
        buffer += text
        while True:
            if in_think:
                if "</think>" not in buffer:
                    break
                in_think = False
                buffer = buffer.split("</think>", 1)[1]
            else:
                if "<think>" not in buffer:
                    break
                before, buffer = buffer.split("<think>", 1)
                if before:
                    yield before
                in_think = True
        if not in_think and buffer:
            # hold back a trailing partial '<think' prefix: the tag can be
            # split across decode chunks
            hold = 0
            for k in range(min(len("<think>") - 1, len(buffer)), 0, -1):
                if buffer.endswith("<think>"[:k]):
                    hold = k
                    break
            out, buffer = buffer[: len(buffer) - hold], buffer[len(buffer) - hold:]
            if out:
                yield out
    if buffer and not in_think:
        yield buffer  # a partial tag at stream end is real text


class ASRModel(nn.Module):
    """Encoder + projector + decoder on one device, or sharded over a mesh.

    ``ASRModel(config, tokenizer=None, params=None, seed=0, mesh=None,
    device=...)`` takes the JAX package's parameters in its order, with
    ``device`` last.  It builds the towers at the config's widths on
    ``device`` (the CUDA device unless the caller asks for ``"cpu"``) with
    random weights drawn from a ``torch.Generator`` seeded with ``seed``,
    following the JAX package's flax defaults (lecun-normal Dense/Conv
    kernels, zero biases, unit norms, flax's Embed init, sinusoidal encoder
    positions).  ``params``: a whole params tree in the JAX layout (numpy or
    tensor leaves) loaded in place of the random weights
    (:func:`tiny_audio_tpu_torch.bridge.load_jax_params`).  ``mesh``: the
    port's :class:`~tiny_audio_tpu_torch.parallel.mesh.Mesh`; the model is
    placed on it (:meth:`place_on`).  Load a checkpoint of the JAX package
    with :meth:`from_pretrained`.
    """

    TRANSCRIBE_PROMPT = TRANSCRIBE_PROMPT

    def __init__(
        self,
        config: ASRConfig,
        tokenizer=None,
        params: Optional[dict] = None,
        seed: int = 0,
        mesh=None,
        device="cuda",
    ):
        super().__init__()
        self.config = config
        self.device = require_device(device)
        dtype = torch.bfloat16 if config.model_dtype == "bfloat16" else torch.float32
        self.dtype = dtype
        dec_cfg = config.decoder
        if config.use_lora:
            dec_cfg = dataclasses.replace(
                dec_cfg, lora_rank=config.lora_rank, lora_alpha=float(config.lora_alpha),
                lora_targets=tuple(config.lora_target_modules))
        if config.gradient_checkpointing and not dec_cfg.gradient_checkpointing:
            dec_cfg = dataclasses.replace(dec_cfg, gradient_checkpointing=True)
        if config.kv_cache_dtype != dec_cfg.kv_cache_dtype:
            # non-default side wins; conflicting customizations are an error
            if dec_cfg.kv_cache_dtype == "bfloat16":
                dec_cfg = dataclasses.replace(dec_cfg, kv_cache_dtype=config.kv_cache_dtype)
            elif config.kv_cache_dtype != "bfloat16":
                raise ValueError(
                    "kv_cache_dtype disagrees between ASRConfig "
                    f"({config.kv_cache_dtype!r}) and DecoderConfig "
                    f"({dec_cfg.kv_cache_dtype!r})"
                )
        #: the mesh this model's shard is on (None: one device)
        self.mesh = None
        self.encoder = AudioEncoder(config.encoder, dtype=dtype, device=self.device)
        self.projector = create_projector(config, dtype=dtype, device=self.device)
        self.decoder = Qwen3Decoder(dec_cfg, dtype=dtype, device=self.device)
        self.tokenizer = tokenizer or ByteTokenizer(config.decoder.vocab_size)
        self.system_prompt = config.system_prompt
        self.gen_config = GenerationConfig.from_asr_config(
            config, self.tokenizer.eos_token_ids, self.tokenizer.pad_token_id
        )
        self.init_weights(seed)
        if params is not None:
            load_jax_params(self, params)
        self.freeze()
        if mesh is not None:
            self.place_on(mesh)

    def freeze(self) -> None:
        """``requires_grad`` off for the parameters :func:`is_frozen` names
        and on for the rest, which the optimizer trains.  The serving entry
        points run under ``inference_mode`` and build no graph."""
        for name, param in self.named_parameters():
            param.requires_grad_(not is_frozen(name, self.config))

    # ------------------------------------------------------------------ init

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (flax's default initializers)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def trunc_normal(w: torch.Tensor, fan_in: int) -> None:
            tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
            nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
            w.copy_(tmp * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))

        for module in self.modules():
            if isinstance(module, nn.Linear):
                trunc_normal(module.weight, module.in_features)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Conv1d):
                trunc_normal(module.weight, module.in_channels * module.kernel_size[0])
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                tmp = torch.empty(module.weight.shape, dtype=torch.float32, device=self.device)
                tmp.normal_(0.0, math.sqrt(1.0 / module.embedding_dim), generator=gen)
                module.weight.copy_(tmp)
        # the projector's own leaves, with the JAX initializers: stacked MoE
        # experts xavier_uniform / normal(0.01) with zero biases, QFormer's
        # queries normal(1.0)
        for name, param in self.projector.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            tmp = torch.empty(param.shape, dtype=torch.float32, device=self.device)
            if leaf == "experts_fc1_kernel":
                e, fan_in, fan_out = param.shape
                limit = math.sqrt(6.0 / (e * fan_in + e * fan_out))
                param.copy_(tmp.uniform_(-limit, limit, generator=gen))
            elif leaf == "experts_fc2_kernel":
                param.copy_(tmp.normal_(0.0, 0.01, generator=gen))
            elif leaf == "query":
                param.copy_(tmp.normal_(0.0, 1.0, generator=gen))
            elif leaf.startswith("experts_") and leaf.endswith("_bias"):
                param.zero_()
        # LoRA A ~ normal(0.02), B = 0 (the JAX initializers), drawn after the
        # towers so that a seed gives the same base weights with or without
        for name, param in self.decoder.named_parameters():
            if name.endswith("_lora_a"):
                tmp = torch.empty(param.shape, dtype=torch.float32, device=self.device)
                param.copy_(tmp.normal_(0.0, 0.02, generator=gen))
            elif name.endswith("_lora_b"):
                param.zero_()
        enc = self.config.encoder
        self.encoder.embed_positions.copy_(
            sinusoidal_positions(enc.max_source_positions, enc.d_model, device=self.device)
        )

    # ------------------------------------------------------- int8 decode modes

    @property
    def wq(self) -> Optional[dict]:
        """The int8 decode weights (``Qwen3Decoder.wq``); None = off.
        Setting it to None turns the int8 modes off, as in the JAX package."""
        return self.decoder.wq

    @wq.setter
    def wq(self, wq: Optional[dict]) -> None:
        self.decoder.wq = wq

    def _no_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise ValueError(f"{what}: the int8 decode weights are unsharded; "
                             "mesh serving stays bf16")

    def enable_wq_decode(self) -> None:
        """Opt-in weight-only int8 decode: every T == 1 layer projection and
        the one-position LM head read per-channel int8 weights (kernel #6);
        prefill keeps the bf16 weights.  A numerics trade, never a default."""
        self._no_mesh("enable_wq_decode")
        self.wq = quantize_decoder_wq(self.decoder)

    def enable_w8a8_head(self) -> None:
        """Opt-in W8A8 LM head for one-position logits (kernel #5, int8
        activations too).  Composes with :meth:`enable_wq_decode`: the W8A8
        head then takes precedence, the layers keep their mode."""
        self._no_mesh("enable_w8a8_head")
        wt_i8, scale = quantize_head_w8a8(head_kernel(self.decoder))
        wq = dict(self.wq) if self.wq is not None else {}
        wq["head_t_i8"], wq["head_w8a8_scale"] = wt_i8, scale
        self.wq = wq

    def enable_w8a8_decode(self) -> None:
        """Opt-in W8A8 for every T == 1 product, layer projections and the
        head (kernel #5); supersedes the two modes above."""
        self._no_mesh("enable_w8a8_decode")
        self.wq = quantize_decoder_w8a8(self.decoder)

    # ------------------------------------------------------------- audio path

    def _encode_audio(
        self,
        input_features,
        audio_attention_mask,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Mel -> encoder (frozen, under ``no_grad``) -> frame dropout (train
        mode, ``audio_token_dropout`` p > 0: frames kept with probability
        1 - p) -> projector.  Returns ([B, T_proj, llm_dim] audio embeds, the
        projector's 0-d fp32 aux loss).  Train-mode draws come from
        ``generator``."""
        dev = self.device
        with span("encode"):
            with torch.no_grad():
                hidden = self.encoder(torch.as_tensor(input_features, device=dev),
                                      frame_mask=torch.as_tensor(audio_attention_mask,
                                                                 device=dev))
            p = float(self.config.audio_token_dropout)
            if train and p > 0.0:
                keep = draw_for_rows(hidden.shape[:-1], lambda shape: torch.bernoulli(
                    torch.full(shape, 1.0 - p, device=dev), generator=generator))
                hidden = hidden * keep[..., None].to(hidden.dtype)
            return self.projector(hidden, train=train, generator=generator)

    def _splice_embeds(self, input_features, audio_attention_mask,
                       input_ids: torch.Tensor) -> torch.Tensor:
        """Encoder, projector and the prompt's token embeddings with the audio
        embeddings spliced in at its ``<audio>`` ids: a prefill's input."""
        audio_embeds, _ = self._encode_audio(input_features, audio_attention_mask)
        audio_mask = input_ids == self.tokenizer.audio_token_id
        return splice_audio(self.decoder.embed(input_ids), audio_mask, audio_embeds)

    # --------------------------------------------------------------- training

    def compute_loss(self, batch: dict, train: bool = True,
                     generator: Optional[torch.Generator] = None):
        """Causal-LM loss over the assistant tokens plus the projector's aux
        loss (the MoE router's in train mode, else 0), as the JAX package's
        ``compute_loss``.

        ``batch``: ``input_ids``, ``attention_mask``, ``labels`` [B, T]
        (-100 = unsupervised; numpy or tensors), ``input_features``
        [B, mel, Tm] and ``audio_attention_mask`` [B, Tm].  The audio goes
        through :meth:`_encode_audio` (the encoder frozen, as the JAX package
        stop-gradients its params and input; train-mode frame dropout,
        router jitter and QFormer dropout drawn from ``generator``).
        Returns ``(loss, {"ce_loss", "aux_loss", "num_label_tokens"})`` as
        0-d tensors.

        On a mesh every rank gets the whole batch and takes its dp rows
        (rows added to reach a multiple of dp carry no labels, and the
        random draws are those of the whole batch); the loss is the sum of
        the token losses over dp divided by their count over dp, the same on
        every rank, whose backward gives each rank its rows' share.
        """
        mesh = self.mesh
        if mesh is None or mesh.dp == 1:
            return self._loss(batch, train, generator, None)
        n = len(batch["input_ids"])
        start, stop, padded = dp_rows(n, mesh)
        local = shard_batch(batch, mesh)
        if stop > n:
            pad_rows = torch.arange(start, stop, device=local["labels"].device) >= n
            local["labels"] = torch.where(pad_rows[:, None], -100, local["labels"])
        with batch_rows((start, stop - start, padded)):
            return self._loss(local, train, generator, mesh.dp_axis)

    def _loss(self, batch: dict, train: bool, generator, dp) -> tuple:
        dev = self.device

        def as_long(x):
            if isinstance(x, torch.Tensor) and x.device.type == dev.type:
                # no host read: a card's tensor moves to the model's card, if another
                return torch.as_tensor(x, device=dev).long()
            with sync("batch"):  # a copy from pageable host memory waits for the stream
                return torch.as_tensor(x, device=dev).long()

        input_ids, labels, attn = (as_long(batch[key]) for key in
                                   ("input_ids", "labels", "attention_mask"))
        audio_embeds, aux = self._encode_audio(batch["input_features"],
                                               batch["audio_attention_mask"],
                                               train=train, generator=generator)

        text_embeds = self.decoder.embed(input_ids)
        inputs_embeds = splice_audio(text_embeds, input_ids == self.tokenizer.audio_token_id,
                                     audio_embeds)
        positions = torch.clamp(torch.cumsum(attn, dim=1) - 1, min=0)
        logits = self.decoder(inputs_embeds, positions, padding_mask=attn, vocab_parallel=True)

        with span("ce_loss"):
            # shift: predict token t+1 from position t
            shift_labels = labels[:, 1:]
            valid = shift_labels != -100
            safe_labels = torch.where(valid, shift_labels, 0)
            tp = self.decoder.tp
            if tp is None or tp.size == 1:
                logprobs = torch.log_softmax(logits[:, :-1].float(), dim=-1)
                token_ll = torch.gather(logprobs, -1, safe_labels[..., None])[..., 0]
            else:
                token_ll = self._vocab_parallel_ll(logits[:, :-1].float(), safe_labels)
            n_valid = valid.sum()
            if dp is None:
                ce = -(token_ll * valid).sum() / torch.clamp(n_valid, min=1)
            else:
                n_valid = dp.all_reduce(n_valid)
                ce = tp_reduce(-(token_ll * valid).sum() / torch.clamp(n_valid, min=1), dp)
        return ce + aux, {"ce_loss": ce, "aux_loss": aux, "num_label_tokens": n_valid}

    def _vocab_parallel_ll(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """log p(label) from this rank's vocabulary slice of the logits
        ``[B, T, V / tp]``: the max and the sum of exponentials, and the
        label's logit from the rank that holds it, reduced over tp (the full
        ``[B, T, V]`` is never gathered)."""
        tp = self.decoder.tp
        m = tp.all_reduce(logits.detach().amax(dim=-1), "max")
        sum_exp = tp_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
        local = labels - self.decoder.vocab_start
        inside = (local >= 0) & (local < logits.shape[-1])
        target = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
        target = tp_reduce(torch.where(inside, target, torch.zeros_like(target)), tp)
        return target - m - torch.log(sum_exp)

    def _num_audio_tokens(self, mel_length: int) -> int:
        enc_len = compute_encoder_output_length(
            int(mel_length), self.config.encoder_conv_layers
        )
        return int(self.projector.get_output_length(enc_len))

    def mel_window_frames(self) -> int:
        """Max mel frames one encoder pass accepts (3000 for the 30 s window)."""
        stride = 1
        for _, _, s in self.config.encoder_conv_layers:
            stride *= s
        return self.config.encoder.max_source_positions * stride

    def _bucket_prompt_len(self, t_real: int, n_audio: int) -> int:
        """Padded prompt length: next PROMPT_BUCKET multiple, clamped to the
        full-encoder-window prompt length (so a 30 s clip pads zero rows)."""
        t_max = t_real - n_audio + self._num_audio_tokens(self.mel_window_frames())
        bucketed = -(-t_real // PROMPT_BUCKET) * PROMPT_BUCKET
        return max(min(bucketed, t_max), t_real)

    def build_prompt_ids(
        self,
        num_audio_tokens: int,
        user_prompt: Optional[str] = None,
        system_prompt: Optional[str] = None,
    ) -> list[int]:
        """Chat-templated prompt with N audio placeholders."""
        prompt = self.TRANSCRIBE_PROMPT if user_prompt is None else user_prompt
        user_content = AUDIO_TOKEN * num_audio_tokens
        if prompt:
            user_content += " " + prompt
        messages = []
        sp = self.system_prompt if system_prompt is None else system_prompt
        if sp:
            messages.append({"role": "system", "content": sp})
        messages.append({"role": "user", "content": user_content})
        ids = self.tokenizer.apply_chat_template(
            messages, tokenize=True, add_generation_prompt=True, enable_thinking=False
        )
        return list(map(int, ids))

    # -------------------------------------------------------------- inference

    def _dp_split(self, *tensors: torch.Tensor):
        """This rank's dp rows of each ``[B, ...]`` tensor (the batch padded
        to a multiple of dp), and the ``(start, count, total)`` of
        :func:`batch_rows` (None on one device or dp = 1)."""
        mesh = self.mesh
        if mesh is None or mesh.dp == 1:
            return tensors, None
        n = tensors[0].shape[0]
        start, stop, padded = dp_rows(n, mesh)
        local = shard_batch(dict(enumerate(tensors)), mesh)
        return tuple(local[i] for i in range(len(tensors))), (start, stop - start, padded)

    def _dp_gather(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """Every dp row's rows of ``t`` back in batch order, the first ``n``."""
        mesh = self.mesh
        if mesh is None or mesh.dp == 1:
            return t
        return mesh.dp_axis.all_gather(t, 0)[:n]

    @mesh_call
    @torch.inference_mode()
    def generate(
        self,
        input_features,
        audio_attention_mask,
        user_prompt: Optional[str] = None,
        system_prompt: Optional[str] = None,
        mel_length: Optional[int] = None,
        fused_decode: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
        **overrides,
    ):
        """Transcribe a batch.  Returns generated token ids [B, max_new] as
        numpy (pad after EOS), prompt stripped; with ``return_scores=True``
        (a GenerationConfig override; greedy and sampling only) returns
        ``(tokens, scores)``.

        ``mel_length``: batch-max real mel frames when the caller knows it
        (the processor does), which saves a device->host sync.
        ``fused_decode``: the decode step's path (``generate_tokens``,
        ``generate_beams``); None takes the fused step on the card and the
        module step elsewhere.  ``generator``: the sampling draws' generator
        (None: seeded with 0 each call).  ``num_beams > 1`` runs beam search
        on the exact prompt in full precision: the int8 decode weights serve
        greedy and sampling only, as in the JAX package."""
        input_features = torch.as_tensor(input_features, device=self.device)
        audio_attention_mask = torch.as_tensor(audio_attention_mask, device=self.device)
        n_rows = input_features.shape[0]
        with span("generate", rows=n_rows):
            if mel_length is not None:
                real_mel = int(mel_length)
            else:
                with sync("mel_length"):
                    real_mel = int(audio_attention_mask.sum(dim=-1).max())
            (input_features, audio_attention_mask), rows = self._dp_split(
                input_features, audio_attention_mask)
            with batch_rows(rows):
                return self._generate(input_features, audio_attention_mask, real_mel, n_rows,
                                      user_prompt, system_prompt, fused_decode, generator,
                                      overrides)

    def _prompt(self, input_features, audio_attention_mask, ids: list, n_audio: int,
                pad_token_id: int, exact: bool = False):
        """A prefill's input: the prompt ``ids`` right-padded to a
        PROMPT_BUCKET multiple, as the JAX package pads it (pad rows are
        causally invisible to the real rows; ``exact`` keeps the prompt as it
        is, as beams do), its embeddings with the audio spliced in.  Returns
        (inputs_embeds, input_ids, real prompt length)."""
        b = input_features.shape[0]
        t_real = len(ids)
        t_pad = t_real if exact else self._bucket_prompt_len(t_real, n_audio)
        ids_np = np.full((b, t_pad), pad_token_id, np.int64)
        ids_np[:, :t_real] = ids
        with sync("prompt_ids"):  # a copy from pageable host memory waits for the stream
            input_ids = torch.from_numpy(ids_np).to(self.device)
        prompt_mask = torch.arange(t_pad, device=self.device)[None, :] < t_real

        audio_embeds, _ = self._encode_audio(input_features, audio_attention_mask)
        text_embeds = self.decoder.embed(input_ids)
        audio_mask = (input_ids == self.tokenizer.audio_token_id) & prompt_mask
        return splice_audio(text_embeds, audio_mask, audio_embeds), input_ids, t_real

    @mesh_call
    @torch.inference_mode()
    def prompt_logits(self, input_features, audio_attention_mask,
                      user_prompt: Optional[str] = None,
                      system_prompt: Optional[str] = None) -> np.ndarray:
        """The fp32 next-token logits ``[B, V]`` after the prompt, as numpy:
        the prefill's output that greedy ``generate`` picks its first token
        from (the same padded prompt and the same prefill)."""
        input_features = torch.as_tensor(input_features, device=self.device)
        audio_attention_mask = torch.as_tensor(audio_attention_mask, device=self.device)
        n_rows = input_features.shape[0]
        n_audio = self._num_audio_tokens(int(audio_attention_mask.sum(dim=-1).max()))
        ids = self.build_prompt_ids(n_audio, user_prompt, system_prompt)
        (input_features, audio_attention_mask), _ = self._dp_split(
            input_features, audio_attention_mask)
        inputs_embeds, _, t_real = self._prompt(input_features, audio_attention_mask, ids,
                                                n_audio, self.gen_config.pad_token_id)
        b, t, _ = inputs_embeds.shape
        cache = self.decoder.init_cache(b, -(-t // 16) * 16)
        positions = torch.arange(t, device=self.device).expand(b, t)
        logits = self.decoder(inputs_embeds, positions, cache=cache, cache_index=0,
                              last_logit_index=t_real - 1)[:, 0].float()
        return self._dp_gather(logits, n_rows).cpu().numpy()

    def _generate(self, input_features, audio_attention_mask, real_mel: int, n_rows: int,
                  user_prompt, system_prompt, fused_decode, generator, overrides):
        n_audio = self._num_audio_tokens(real_mel)
        ids = self.build_prompt_ids(n_audio, user_prompt, system_prompt)

        gen = dataclasses.replace(self.gen_config, **overrides) if overrides else self.gen_config
        beams = gen.num_beams > 1
        if gen.return_scores and beams:
            raise ValueError(
                "return_scores supports the greedy/sampling decode paths; "
                "beam search carries its own hypothesis scores"
            )

        inputs_embeds, input_ids, t_real = self._prompt(
            input_features, audio_attention_mask, ids, n_audio, gen.pad_token_id, exact=beams)

        def fetch(t: torch.Tensor) -> np.ndarray:
            with sync("fetch"):
                return self._dp_gather(t, n_rows).cpu().numpy()

        if beams:
            wq, self.wq = self.wq, None  # beams keep full precision
            try:
                tokens, _ = generate_beams(self.decoder, inputs_embeds, gen, input_ids=input_ids,
                                           fused_decode=fused_decode)
            finally:
                self.wq = wq
            return fetch(tokens)
        out = generate_tokens(self.decoder, inputs_embeds, input_ids, gen, prompt_len=t_real,
                              fused_decode=fused_decode, generator=generator)
        if gen.return_scores:
            tokens, _, scores = out
            return fetch(tokens), fetch(scores)
        return fetch(out[0])

    @mesh_stream
    @torch.inference_mode()
    def generate_streaming(
        self,
        input_features,
        audio_attention_mask,
        user_prompt: Optional[str] = None,
        system_prompt: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Yield decoded text fragments token by token (batch 1), with
        ``<think>`` blocks filtered out.  The model's generation config
        applies (sampling with ``do_sample``, drawn from ``generator``); the
        stream decodes token by token whatever ``num_beams`` is, as in the
        JAX package.

        Features longer than the encoder window are streamed window by
        window: each 30 s window is re-primed with a fresh prompt, and a
        window's first fragment gets a leading space after earlier text.
        """
        input_features = torch.as_tensor(input_features, device=self.device)
        audio_attention_mask = torch.as_tensor(audio_attention_mask, device=self.device)
        if input_features.shape[0] != 1:
            raise ValueError("streaming is defined for batch 1")

        window = self.mel_window_frames()
        n_frames_total = int(input_features.shape[-1])
        if n_frames_total > window:
            real = audio_attention_mask.sum(dim=0).cpu().numpy()  # [T] frames
            yielded_before = False
            for s in range(0, n_frames_total, window):
                if int(real[s:s + window].sum()) == 0:
                    continue  # fully padded tail window
                first_of_chunk = True
                for frag in self.generate_streaming(
                    input_features[:, :, s:s + window],
                    audio_attention_mask[:, s:s + window],
                    user_prompt, system_prompt, generator,
                ):
                    if first_of_chunk and yielded_before and frag and not frag[0].isspace():
                        frag = " " + frag
                    first_of_chunk = False
                    yielded_before = yielded_before or bool(frag)
                    yield frag
            return

        real_mel = int(audio_attention_mask.sum(dim=-1).max())
        n_audio = self._num_audio_tokens(real_mel)
        ids = self.build_prompt_ids(n_audio, user_prompt, system_prompt)
        gen = self.gen_config
        t_real = len(ids)
        t_pad = self._bucket_prompt_len(t_real, n_audio)
        ids_np = np.full((1, t_pad), gen.pad_token_id, np.int64)
        ids_np[0, :t_real] = ids
        input_ids = torch.from_numpy(ids_np).to(self.device)

        inputs_embeds = self._splice_embeds(input_features, audio_attention_mask, input_ids)

        def decoded_chunks():
            pending: list[int] = []
            for tok in stream_generate(self.decoder, inputs_embeds, input_ids, gen,
                                       prompt_len=t_real, generator=generator):
                pending.append(tok)
                text = self.tokenizer.decode(pending, skip_special_tokens=True)
                if text:
                    pending = []
                    yield text

        yield from filter_think_stream(decoded_chunks())

    # ----------------------------------------------------------------- mesh

    def place_on(self, mesh, build=None) -> "ASRModel":
        """Shard this model over ``mesh`` (rank 0's :class:`~tiny_audio_tpu_
        torch.parallel.mesh.Mesh`): each other rank builds the same model
        with ``build`` (``build(device) -> ASRModel``: :class:`Pretrained`,
        :class:`Seeded`; default :class:`SavedWeights`, this model written
        once to the mesh's temporary directory) and takes its shard, and this
        one takes its own in place.  Raises
        ``ValueError`` when tp does not divide what it splits, or when an int8
        decode mode is on (the int8 weights are unsharded).  Returns self."""
        from tiny_audio_tpu_torch.parallel.mesh import check_grid

        check_grid(self.config, mesh.tp)
        if self.mesh is not None:
            raise ValueError(f"the model is on a mesh already ({self.mesh})")
        if self.wq is not None:
            raise ValueError("an int8 decode mode is on: the int8 decode weights are "
                             "unsharded; mesh serving stays bf16 (set model.wq = None)")
        if build is None:
            build = SavedWeights.write(self, Path(mesh.spec.tmpdir) / f"model-{id(self)}")
        mesh.place(self, _ShardBuilder(build), local=lambda: shard_model(self, mesh))
        return self

    # ------------------------------------------------------------ persistence

    @mesh_call
    def save_pretrained(self, save_directory, save_towers: bool = True) -> None:
        """The JAX package's checkpoint: ``config.json``,
        ``projector.msgpack``, ``adapter.msgpack`` (the LoRA leaves, when
        LoRA is on), ``decoder.msgpack`` (the base decoder, unless the
        language model is frozen), ``towers.msgpack`` (encoder and base
        decoder) and ``tpu_metadata.json``, in flax's msgpack layout and the
        JAX params tree, so the JAX package's ``ASRModel.from_pretrained``
        loads it.  A sharded model gathers its parameters over tp and rank 0
        writes the single-device files."""
        values = None
        if self.mesh is not None:
            values = gather_params(self)
            if self.mesh.rank != 0:
                return
        save_dir = Path(save_directory)
        save_dir.mkdir(parents=True, exist_ok=True)
        self.config.save_pretrained(save_dir)
        params = state_dict_to_jax(self, values)
        dec_base, dec_lora = split_lora(params["decoder"])
        msgpack_io.save(save_dir / "projector.msgpack", params["projector"])
        if dec_lora:
            msgpack_io.save(save_dir / "adapter.msgpack", dec_lora)
        if not self.config.freeze_language_model:
            msgpack_io.save(save_dir / "decoder.msgpack", dec_base)
        if save_towers:
            msgpack_io.save(save_dir / "towers.msgpack",
                            {"encoder": params["encoder"], "decoder": dec_base})
        meta = {"framework": "tiny_audio_tpu", "format": "flax-msgpack"}
        (save_dir / "tpu_metadata.json").write_text(json.dumps(meta, indent=2))

    @classmethod
    def from_pretrained(cls, path, tokenizer=None, **kwargs) -> "ASRModel":
        """Load a checkpoint of the JAX package (or of :meth:`save_pretrained`)
        with neither flax nor msgpack: ``config.json``, then
        ``towers.msgpack``, ``decoder.msgpack`` and ``projector.msgpack``
        where present (a tower without a file keeps its random weights from
        ``seed``, as in the JAX package), and ``adapter.msgpack`` when the
        config has ``use_lora``.  ``tokenizer_config.json`` loads an HF
        tokenizer (needs ``transformers``).  ``wav2vec2_aligner.msgpack`` and
        ``ecapa_embedder.msgpack`` attach the aligner and the speaker
        embedder on the model's device (:meth:`_attach_aux_towers`).
        ``kwargs`` go to the constructor (``params``, ``seed``, ``mesh``,
        ``device``); a ``mesh`` takes the model once its files are loaded."""
        path = Path(path)
        config = ASRConfig.from_pretrained(path)
        if tokenizer is None and (path / "tokenizer_config.json").exists():
            tokenizer = HFTokenizerAdapter.from_pretrained(str(path))
        mesh = kwargs.pop("mesh", None)
        model = cls(config, tokenizer=tokenizer, **kwargs)
        params = {}
        if (path / "towers.msgpack").exists():
            params.update(msgpack_io.load(path / "towers.msgpack"))
        for tower in ("decoder", "projector"):
            if (path / f"{tower}.msgpack").exists():
                params[tower] = msgpack_io.load(path / f"{tower}.msgpack")
        if config.use_lora and (path / "adapter.msgpack").exists():
            params["decoder"] = merge_lora(params.get("decoder", {}),
                                           msgpack_io.load(path / "adapter.msgpack"))
        load_jax_params(model, params, require_all=False)
        cls._attach_aux_towers(path, model.device)
        if mesh is not None:
            model.place_on(mesh)
        return model

    @staticmethod
    def _attach_aux_towers(path, device) -> None:
        """Attach a checkpoint's aligner and speaker-embedder weights to their
        process singletons on ``device``: a fresh serving process only runs
        ``from_pretrained``, and without this word timestamps would take the
        uniform spread and diarization the synthetic embedder tier.  An
        unusable file is reported and skipped, as in the JAX package."""
        path = Path(path)
        aligner = path / "wav2vec2_aligner.msgpack"
        if aligner.exists():
            from tiny_audio_tpu_torch.alignment import ForcedAligner

            if not ForcedAligner.has_model():
                try:
                    ForcedAligner.load_weights(aligner, device=device)
                except Exception as e:  # keep serving up on a bad aux file
                    print(f"[asr] aligner weights unusable ({e}); "
                          "word timestamps will use the uniform fallback")
        ecapa = path / "ecapa_embedder.msgpack"
        if ecapa.exists():
            from tiny_audio_tpu_torch.diarization import EcapaEmbedder

            key = str(require_device(device))
            current = EcapaEmbedder._instances.get(key)
            if current is None or current.tier != "speechbrain":
                try:
                    EcapaEmbedder._instances[key] = EcapaEmbedder.from_converted(
                        ecapa, device=device)
                except Exception as e:
                    print(f"[asr] ecapa weights unusable ({e}); "
                          "diarization keeps the synthetic tier")


class SavedWeights:
    """``build(device)``: another model, written with :meth:`write` as a
    checkpoint (:meth:`ASRModel.save_pretrained`, an HF tokenizer's files
    beside it) and read back with
    :meth:`ASRModel.from_pretrained`, with that model's generation settings."""

    def __init__(self, path, gen_config: GenerationConfig, system_prompt):
        self.path, self.gen_config, self.system_prompt = str(path), gen_config, system_prompt

    @classmethod
    def write(cls, model: ASRModel, path) -> "SavedWeights":
        model.save_pretrained(path)
        if isinstance(model.tokenizer, HFTokenizerAdapter):
            model.tokenizer.tok.save_pretrained(str(path))
        return cls(path, model.gen_config, model.system_prompt)

    def __call__(self, device) -> ASRModel:
        model = ASRModel.from_pretrained(self.path, device=device)
        model.gen_config, model.system_prompt = self.gen_config, self.system_prompt
        return model


class Pretrained:
    """``build(device)``: :meth:`ASRModel.from_pretrained` of ``path``."""

    def __init__(self, path):
        self.path = str(path)

    def __call__(self, device) -> ASRModel:
        return ASRModel.from_pretrained(self.path, device=device)


class Seeded:
    """``build(device)``: ``ASRModel(config, seed=seed)`` (the same weights
    on every device of one kind)."""

    def __init__(self, config: ASRConfig, seed: int = 0):
        self.config, self.seed = config, seed

    def __call__(self, device) -> ASRModel:
        return ASRModel(self.config, seed=self.seed, device=device)


class _ShardBuilder:
    """A rank's shard: ``build`` on the rank's device, then ``shard_model``."""

    def __init__(self, build):
        self.build = build

    def __call__(self, mesh, objects) -> ASRModel:
        model = self.build(mesh.device)
        shard_model(model, mesh)
        return model
