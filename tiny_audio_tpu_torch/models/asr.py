"""ASRModel: audio encoder + projector + Qwen3 decoder, serving and training.

Port of the inference half of :class:`tiny_audio_tpu.models.asr.ASRModel`:
mel mask -> encoder -> projector -> row-aligned ``<audio>`` splice ->
KV-cached greedy decode, batched (:meth:`ASRModel.generate`) or streamed token
by token (:meth:`ASRModel.generate_streaming`); the opt-in int8 decode modes
(:meth:`ASRModel.enable_wq_decode`, :meth:`~ASRModel.enable_w8a8_head`,
:meth:`~ASRModel.enable_w8a8_decode`); the JAX package's checkpoint layout
(:meth:`ASRModel.save_pretrained`, :meth:`ASRModel.from_pretrained`, LoRA
adapters in ``adapter.msgpack``); and its training half:
:meth:`ASRModel.compute_loss` (frozen encoder under ``no_grad``, frame
dropout, projector and its aux loss, splice, causal decoder, shifted CE), with
``requires_grad`` following the optimizer's labels (frozen towers get no
gradient), LoRA on the decoder and gradient checkpointing.
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
from tiny_audio_tpu_torch.generation import (
    GenerationConfig,
    check_supported,
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
from tiny_audio_tpu_torch.models.layers import sinusoidal_positions
from tiny_audio_tpu_torch.models.projectors import create_projector
from tiny_audio_tpu_torch.ops.wq_head import quantize_head_w8a8

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
    """Encoder + projector + decoder on one device.

    ``ASRModel(config, tokenizer=None, seed=0, device=...)`` builds the
    towers at the config's widths with random weights drawn from a seeded
    ``torch.Generator`` on ``device`` (the CUDA device unless the caller
    asks for ``"cpu"``), following the JAX package's flax
    defaults (lecun-normal Dense/Conv kernels, zero biases, unit norms,
    flax's Embed init, sinusoidal encoder positions).  Load a checkpoint of
    the JAX package with :meth:`from_pretrained`, or a JAX params tree with
    :func:`tiny_audio_tpu_torch.bridge.load_jax_params`.
    """

    TRANSCRIBE_PROMPT = TRANSCRIBE_PROMPT

    def __init__(
        self,
        config: ASRConfig,
        tokenizer=None,
        seed: int = 0,
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
        self.encoder = AudioEncoder(config.encoder, dtype=dtype, device=self.device)
        self.projector = create_projector(config, dtype=dtype, device=self.device)
        self.decoder = Qwen3Decoder(dec_cfg, dtype=dtype, device=self.device)
        self.tokenizer = tokenizer or ByteTokenizer(config.decoder.vocab_size)
        self.system_prompt = config.system_prompt
        self.gen_config = GenerationConfig.from_asr_config(
            config, self.tokenizer.eos_token_ids, self.tokenizer.pad_token_id
        )
        self.init_weights(seed)
        self.freeze()

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

    def enable_wq_decode(self) -> None:
        """Opt-in weight-only int8 decode: every T == 1 layer projection and
        the one-position LM head read per-channel int8 weights (kernel #6);
        prefill keeps the bf16 weights.  A numerics trade, never a default."""
        self.wq = quantize_decoder_wq(self.decoder)

    def enable_w8a8_head(self) -> None:
        """Opt-in W8A8 LM head for one-position logits (kernel #5, int8
        activations too).  Composes with :meth:`enable_wq_decode`: the W8A8
        head then takes precedence, the layers keep their mode."""
        wt_i8, scale = quantize_head_w8a8(head_kernel(self.decoder))
        wq = dict(self.wq) if self.wq is not None else {}
        wq["head_t_i8"], wq["head_w8a8_scale"] = wt_i8, scale
        self.wq = wq

    def enable_w8a8_decode(self) -> None:
        """Opt-in W8A8 for every T == 1 product, layer projections and the
        head (kernel #5); supersedes the two modes above."""
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
        with torch.no_grad():
            hidden = self.encoder(torch.as_tensor(input_features, device=dev),
                                  frame_mask=torch.as_tensor(audio_attention_mask, device=dev))
        p = float(self.config.audio_token_dropout)
        if train and p > 0.0:
            keep = torch.bernoulli(torch.full(hidden.shape[:-1], 1.0 - p, device=dev),
                                   generator=generator)
            hidden = hidden * keep[..., None].to(hidden.dtype)
        return self.projector(hidden, train=train, generator=generator)

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
        """
        dev = self.device
        as_long = lambda x: torch.as_tensor(x, device=dev).long()  # noqa: E731
        input_ids, labels, attn = (as_long(batch[key]) for key in
                                   ("input_ids", "labels", "attention_mask"))
        audio_embeds, aux = self._encode_audio(batch["input_features"],
                                               batch["audio_attention_mask"],
                                               train=train, generator=generator)

        text_embeds = self.decoder.embed(input_ids)
        inputs_embeds = splice_audio(text_embeds, input_ids == self.tokenizer.audio_token_id,
                                     audio_embeds)
        positions = torch.clamp(torch.cumsum(attn, dim=1) - 1, min=0)
        logits = self.decoder(inputs_embeds, positions, padding_mask=attn)

        # shift: predict token t+1 from position t
        shift_labels = labels[:, 1:]
        valid = shift_labels != -100
        logprobs = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        safe_labels = torch.where(valid, shift_labels, 0)
        token_ll = torch.gather(logprobs, -1, safe_labels[..., None])[..., 0]
        n_valid = valid.sum()
        ce = -(token_ll * valid).sum() / torch.clamp(n_valid, min=1)
        return ce + aux, {"ce_loss": ce, "aux_loss": aux, "num_label_tokens": n_valid}

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

    @torch.inference_mode()
    def generate(
        self,
        input_features,
        audio_attention_mask,
        user_prompt: Optional[str] = None,
        system_prompt: Optional[str] = None,
        mel_length: Optional[int] = None,
        fused_decode: Optional[bool] = None,
        **overrides,
    ):
        """Transcribe a batch.  Returns generated token ids [B, max_new] as
        numpy (pad after EOS), prompt stripped; with ``return_scores=True``
        (a GenerationConfig override) returns ``(tokens, scores)``.

        ``mel_length``: batch-max real mel frames when the caller knows it
        (the processor does), which saves a device->host sync.
        ``fused_decode``: the decode step's path (``generate_tokens``); None
        takes the fused step on the card and the module step elsewhere."""
        input_features = torch.as_tensor(input_features, device=self.device)
        audio_attention_mask = torch.as_tensor(audio_attention_mask, device=self.device)
        b = input_features.shape[0]
        real_mel = (
            int(mel_length) if mel_length is not None
            else int(audio_attention_mask.sum(dim=-1).max())
        )
        n_audio = self._num_audio_tokens(real_mel)
        ids = self.build_prompt_ids(n_audio, user_prompt, system_prompt)

        gen = dataclasses.replace(self.gen_config, **overrides) if overrides else self.gen_config
        check_supported(gen)

        # Right-pad the prompt to a PROMPT_BUCKET multiple, as the JAX
        # package does; pad rows are causally invisible to the real rows.
        t_real = len(ids)
        t_pad = self._bucket_prompt_len(t_real, n_audio)
        ids_np = np.full((b, t_pad), gen.pad_token_id, np.int64)
        ids_np[:, :t_real] = ids
        input_ids = torch.from_numpy(ids_np).to(self.device)
        prompt_mask = torch.arange(t_pad, device=self.device)[None, :] < t_real

        audio_embeds, _ = self._encode_audio(input_features, audio_attention_mask)
        text_embeds = self.decoder.embed(input_ids)
        audio_mask = (input_ids == self.tokenizer.audio_token_id) & prompt_mask
        inputs_embeds = splice_audio(text_embeds, audio_mask, audio_embeds)
        out = generate_tokens(self.decoder, inputs_embeds, input_ids, gen, prompt_len=t_real,
                              fused_decode=fused_decode)
        if gen.return_scores:
            tokens, _, scores = out
            return tokens.cpu().numpy(), scores.cpu().numpy()
        return out[0].cpu().numpy()

    @torch.inference_mode()
    def generate_streaming(
        self,
        input_features,
        audio_attention_mask,
        user_prompt: Optional[str] = None,
        system_prompt: Optional[str] = None,
    ):
        """Yield decoded text fragments token by token (batch 1), with
        ``<think>`` blocks filtered out.

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
                    user_prompt, system_prompt,
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
        check_supported(gen)
        t_real = len(ids)
        t_pad = self._bucket_prompt_len(t_real, n_audio)
        ids_np = np.full((1, t_pad), gen.pad_token_id, np.int64)
        ids_np[0, :t_real] = ids
        input_ids = torch.from_numpy(ids_np).to(self.device)

        audio_embeds, _ = self._encode_audio(input_features, audio_attention_mask)
        text_embeds = self.decoder.embed(input_ids)
        audio_mask = input_ids == self.tokenizer.audio_token_id
        inputs_embeds = splice_audio(text_embeds, audio_mask, audio_embeds)

        def decoded_chunks():
            pending: list[int] = []
            for tok in stream_generate(self.decoder, inputs_embeds, input_ids, gen,
                                       prompt_len=t_real):
                pending.append(tok)
                text = self.tokenizer.decode(pending, skip_special_tokens=True)
                if text:
                    pending = []
                    yield text

        yield from filter_think_stream(decoded_chunks())

    # ------------------------------------------------------------ persistence

    def save_pretrained(self, save_directory, save_towers: bool = True) -> None:
        """The JAX package's checkpoint: ``config.json``,
        ``projector.msgpack``, ``adapter.msgpack`` (the LoRA leaves, when
        LoRA is on), ``decoder.msgpack`` (the base decoder, unless the
        language model is frozen), ``towers.msgpack`` (encoder and base
        decoder) and ``tpu_metadata.json``, in flax's msgpack layout and the
        JAX params tree, so the JAX package's ``ASRModel.from_pretrained``
        loads it."""
        save_dir = Path(save_directory)
        save_dir.mkdir(parents=True, exist_ok=True)
        self.config.save_pretrained(save_dir)
        params = state_dict_to_jax(self)
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
    def from_pretrained(cls, path, tokenizer=None, device="cuda") -> "ASRModel":
        """Load a checkpoint of the JAX package (or of :meth:`save_pretrained`)
        with neither flax nor msgpack: ``config.json``, then
        ``towers.msgpack``, ``decoder.msgpack`` and ``projector.msgpack``
        where present (a tower without a file keeps its seeded random
        weights, as in the JAX package), and ``adapter.msgpack`` when the
        config has ``use_lora``.  ``tokenizer_config.json`` loads an HF
        tokenizer (needs ``transformers``).  The aligner / speaker-embedder
        files are not ported (ROADMAP.md)."""
        path = Path(path)
        config = ASRConfig.from_pretrained(path)
        if tokenizer is None and (path / "tokenizer_config.json").exists():
            tokenizer = HFTokenizerAdapter.from_pretrained(str(path))
        model = cls(config, tokenizer=tokenizer, device=device)
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
        return model
