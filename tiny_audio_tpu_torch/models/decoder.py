"""Qwen3-style causal language model in PyTorch.

Port of :mod:`tiny_audio_tpu.models.decoder`: GQA + per-head QK RMSNorm +
RoPE (NeoX layout) + SwiGLU + pre-LN RMSNorm, tied embeddings by default,
plus the Llama (``qk_norm=False``) and Gemma-v1 (``rms_norm_offset``, GeGLU,
``embedding_normalizer``) knobs.  One module per layer.

KV cache: a dict of tensors ``[L, B, S, Hkv, D]`` (bf16, or int8 with fp32
per-entry scales ``[L, B, S, Hkv]``), updated IN PLACE: prefill writes its
post-rope K/V at ``cache_index``; a decode step attends over the stale cache
plus the fresh row (the decode attention kernel reads only the valid
prefix) and then writes that row, once per layer per step.

LoRA (``cfg.lora_rank > 0``): ``Qwen3Block.{name}_lora_a`` ``[K, r]`` and
``{name}_lora_b`` ``[r, N]`` (fp32) sit beside each target projection under
the JAX package's names and layout, and every product of that projection
(prefill, training, the decode step's int8 products) adds
``(h.float() @ a) @ b * alpha / r`` in its output dtype.  With
``cfg.gradient_checkpointing`` the blocks of a causal forward with grad
enabled run under ``torch.utils.checkpoint`` (the JAX package's ``nn.remat``).

Tensor parallelism (:func:`tiny_audio_tpu_torch.parallel.mesh.shard_model`):
a block keeps its rank's ``num_heads / tp`` query heads and KV heads (the
one KV head its query heads read when tp exceeds them); q/k/v/gate/up are
column-parallel, o/down row-parallel with one all-reduce each (LoRA's
``lora_b`` split with a column-parallel output, ``lora_a`` with a
row-parallel input, whose delta joins the partial sums before the reduce);
the embedding and the (tied) LM head hold the rank's vocabulary slice:
:meth:`Qwen3Decoder.embed` masks the ids outside it and all-reduces,
:meth:`Qwen3Decoder.logits` all-gathers the full ``[B, T, V]`` unless asked
for the rank's slice (the vocabulary-parallel loss).  The cache holds the
rank's KV heads.

Int8 decode weights: ``Qwen3Decoder.wq`` holds the JAX package's ``wq``
variables collection (:func:`quantize_decoder_wq`,
:func:`quantize_decoder_w8a8`; None = off).  One-position products read it
(every layer projection of a decode step, and the LM head on one position,
which includes the prefill's ``last_logit_index`` row): W8A8 (``*_t_i8``,
kernel #5) before weight-only (``*_i8``, kernel #6) before the bf16
weights, which stay and serve every other product.

:func:`convert_hf_qwen3` reads an HF causal-LM state dict (Qwen3, the Llama
family, Gemma v1) into the JAX package's params tree.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tiny_audio_tpu_torch.bridge import cast_leaf, host_array
from tiny_audio_tpu_torch.config import DecoderConfig
from tiny_audio_tpu_torch.models.layers import (
    RMSNorm,
    apply_rotary,
    rms_norm,
    rotary_embed,
    tp_copy,
    tp_gather,
    tp_reduce,
)
from tiny_audio_tpu_torch.ops.attention import causal_self_attention, decode_step_attention
from tiny_audio_tpu_torch.ops.decode_attention import write_cache_rows
from tiny_audio_tpu_torch.ops.wq_head import (
    quantize_head_w8a8,
    quantize_weight_w8a8,
    w8a8_matmul,
)
from tiny_audio_tpu_torch.ops.wq_matmul import NT, quantize_weight, wq_matmul

#: the block projections the int8 decode modes quantize
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
#: the row-parallel ones (their input is split over tp)
ROW_PARALLEL = ("o_proj", "down_proj")


def int8_matmul(x: torch.Tensor, wq: dict, name: str) -> Optional[torch.Tensor]:
    """``x [B, K]`` through the int8 weights ``name`` of ``wq`` (a layer's
    slice of the collection, or its head entries): W8A8 (``{name}_t_i8``)
    before weight-only (``{name}_i8``); None if ``wq`` has neither.  The
    activation goes in as bf16 and the result comes out bf16, as in the JAX
    package."""
    if f"{name}_t_i8" in wq:
        scale = wq["head_w8a8_scale" if name == "head" else f"{name}_t_scale"]
        return w8a8_matmul(x.to(torch.bfloat16), wq[f"{name}_t_i8"], scale)
    if f"{name}_i8" in wq:
        return wq_matmul(x.to(torch.bfloat16), wq[f"{name}_i8"], wq[f"{name}_scale"])
    return None


class Qwen3Block(nn.Module):
    def __init__(self, cfg: DecoderConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        hd = cfg.head_dim
        kw = dict(bias=False, dtype=dtype, device=device)
        offset = 1.0 if cfg.rms_norm_offset else 0.0
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, offset, device)
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.num_heads * hd, **kw)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, **kw)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, **kw)
        self.o_proj = nn.Linear(cfg.num_heads * hd, cfg.hidden_size, **kw)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, dtype=torch.float32, device=device))
            self.k_norm = nn.Parameter(torch.ones(hd, dtype=torch.float32, device=device))
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, offset, device
        )
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        if cfg.lora_rank > 0:
            for name in cfg.lora_targets:
                linear = getattr(self, name)
                self.register_parameter(f"{name}_lora_a", nn.Parameter(torch.zeros(
                    (linear.in_features, cfg.lora_rank), dtype=torch.float32, device=device)))
                self.register_parameter(f"{name}_lora_b", nn.Parameter(torch.zeros(
                    (cfg.lora_rank, linear.out_features), dtype=torch.float32, device=device)))
        #: this layer's slice of ``Qwen3Decoder.wq["layers"]`` (None = off)
        self.wq: Optional[dict] = None
        #: the tp axis of a sharded model (None: one device) and this
        #: rank's head counts
        self.tp = None
        self.num_heads, self.num_kv_heads = cfg.num_heads, cfg.num_kv_heads

    def shard_axes(self, mesh) -> None:
        """Take the rank's heads on ``mesh``'s tp axis (the weights were
        sliced by ``shard_model``)."""
        self.tp = mesh.tp_axis
        self.num_heads = self.cfg.num_heads // mesh.tp
        self.num_kv_heads = max(self.cfg.num_kv_heads // mesh.tp, 1)

    def dense(self, h: torch.Tensor, name: str, hc: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """Projection ``name`` of ``h [B, T, K]``: a decode step (T == 1)
        reads this layer's int8 weights when there are any, else the bf16
        ``nn.Linear``; plus the LoRA delta when ``name`` is a LoRA target.
        Under tp, ``hc`` is ``tp_copy(h)``, the input of a column-parallel
        product, and a row-parallel one returns this rank's partial sum."""
        hc = h if hc is None else hc
        y = None
        if self.wq is not None and h.shape[1] == 1:
            y = int8_matmul(hc[:, 0], self.wq, name)
            if y is not None:
                y = y[:, None].to(self.dtype)
        if y is None:
            y = getattr(self, name)(hc)
        if self.cfg.lora_rank > 0 and name in self.cfg.lora_targets:
            a, b = getattr(self, f"{name}_lora_a"), getattr(self, f"{name}_lora_b")
            u = h.float() @ a
            if name not in ROW_PARALLEL:
                u = tp_copy(u, self.tp)  # b holds this rank's output slice
            delta = u @ b * (self.cfg.lora_alpha / self.cfg.lora_rank)
            y = y + delta.to(y.dtype)
        return y

    def row(self, h: torch.Tensor, name: str) -> torch.Tensor:
        """A row-parallel projection: this rank's partial sum (LoRA's delta
        included) all-reduced over tp."""
        return tp_reduce(self.dense(h, name), self.tp)

    def forward(
        self,
        x: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        padding_mask: Optional[torch.Tensor],
        layer_cache: Optional[dict],
        cache_index: Union[int, torch.Tensor],
        step_kv_valid: Optional[torch.Tensor],
        kv_len=None,
    ) -> torch.Tensor:
        """One block.  ``layer_cache``: None (causal forward over x) or this
        layer's cache views; T > 1 is a prefill, T == 1 a decode step, whose
        attention reads the first ``kv_len`` cache rows (``cache_index`` as
        an int, or the same as a 0-d int32 tensor on the device) and which
        writes its row at ``cache_index``; a ``[B]`` int32 ``cache_index``
        (T == 1) gives each batch row its own row and length."""
        q, k, v = self.project_qkv(x, cos, sin)
        if layer_cache is not None and x.shape[1] == 1:
            out = decode_step_attention(
                q, layer_cache["k"], layer_cache["v"], step_kv_valid,
                fresh_k=k, fresh_v=v,
                k_scale=layer_cache.get("k_scale"), v_scale=layer_cache.get("v_scale"),
                kv_len=cache_index if kv_len is None else kv_len,
            )
        else:
            out = causal_self_attention(q, k, v, padding_mask)
        if layer_cache is not None:
            write_cache_rows(layer_cache, k, v, cache_index)
        return self.finish(x, out)

    def project_qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """Pre-LN RMSNorm, the Q/K/V projections, QK-norm and NeoX rope:
        q [B, T, Hq, D], k/v [B, T, Hkv, D]."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim
        h = self.input_layernorm(x)
        hc = tp_copy(h, self.tp)
        q = self.dense(h, "q_proj", hc).reshape(b, t, self.num_heads, hd)
        k = self.dense(h, "k_proj", hc).reshape(b, t, self.num_kv_heads, hd)
        v = self.dense(h, "v_proj", hc).reshape(b, t, self.num_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.rms_norm_eps)
            k = rms_norm(k, self.k_norm, cfg.rms_norm_eps)
        return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v

    def finish(self, x: torch.Tensor, attn_out: torch.Tensor) -> torch.Tensor:
        """The rest of the block after attention: output projection and
        residual, then the SwiGLU / GeGLU MLP with its pre-LN and residual."""
        b, t, _ = x.shape
        x = x + self.row(attn_out.reshape(b, t, -1), "o_proj")
        h = self.post_attention_layernorm(x)
        hc = tp_copy(h, self.tp)
        gate, up = self.dense(h, "gate_proj", hc), self.dense(h, "up_proj", hc)
        silu = self.cfg.hidden_activation == "silu"
        act = F.silu(gate) if silu else F.gelu(gate, approximate="tanh")
        return x + self.row(act * up, "down_proj")


class Qwen3Decoder(nn.Module):
    """Causal LM.  Call modes:

    - prefill: pass a cache from :meth:`init_cache` and ``cache_index=0``;
      the cache is filled in place;
    - decode: T == 1, ``cache_index`` = current length, ``step_kv_valid``
      marking the cache rows before it; ``cache_index`` as a ``[B]`` int32
      tensor (the continuous engine's slots, as the JAX decoder's array
      ``cache_index``) writes and reads each row at its own length;
    - no cache: causal forward over the inputs.
    """

    def __init__(self, cfg: DecoderConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, dtype=dtype, device=device
        )
        self.layers = nn.ModuleList(
            Qwen3Block(cfg, dtype, device) for _ in range(cfg.num_layers)
        )
        self.norm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, 1.0 if cfg.rms_norm_offset else 0.0, device
        )
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(
                cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype, device=device
            )
        self.wq = None
        #: the tp axis of a sharded model (None: one device), and the first
        #: id of this rank's vocabulary slice
        self.tp = None
        self.vocab_start = 0

    def shard_axes(self, mesh) -> None:
        """Take the rank's vocabulary slice on ``mesh``'s tp axis."""
        self.tp = mesh.tp_axis
        self.vocab_start = mesh.tp_rank * (self.cfg.vocab_size // mesh.tp)

    @property
    def num_kv_heads(self) -> int:
        """The KV heads this rank's cache holds."""
        return self.layers[0].num_kv_heads

    @property
    def wq(self) -> Optional[dict]:
        """The int8 decode weights, in the JAX package's collection layout
        (``{"layers": {name: [L, ...]}, "head_...": ...}``), or None."""
        return self._wq

    @wq.setter
    def wq(self, wq: Optional[dict]) -> None:
        self._wq = wq
        layers = None if wq is None else wq.get("layers")
        for i, layer in enumerate(self.layers):
            layer.wq = None if layers is None else {name: buf[i] for name, buf in layers.items()}

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.embed_tokens(input_ids)
        # vocabulary-parallel: ids outside this rank's slice embed to 0, and
        # the one rank that holds each id supplies it through the sum
        local = input_ids - self.vocab_start
        inside = (local >= 0) & (local < self.embed_tokens.num_embeddings)
        e = self.embed_tokens(torch.where(inside, local, 0))
        return tp_reduce(torch.where(inside[..., None], e, torch.zeros_like(e)), self.tp)

    def scale_inputs(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        """Embeddings in the compute dtype, times sqrt(hidden) for Gemma."""
        x = inputs_embeds.to(self.dtype)
        if self.cfg.embedding_normalizer:
            # scalar cast to the compute dtype first, as HF GemmaModel does
            x = x * torch.tensor(self.cfg.hidden_size ** 0.5, dtype=self.dtype)
        return x

    def logits(self, x: torch.Tensor, vocab_parallel: bool = False) -> torch.Tensor:
        """Final norm and the (tied) LM head.  One position reads the int8
        head of ``wq`` when there is one (bf16 logits, sliced to the
        vocabulary: the int8 head is padded).  Under tp the full ``[B, T, V]``
        is gathered from the ranks' slices, unless ``vocab_parallel`` asks
        for this rank's ``[B, T, V / tp]``."""
        x = self.norm(x)
        if self.wq is not None and x.shape[1] == 1:
            y = int8_matmul(x[:, 0], self.wq, "head")
            if y is not None:
                return y[:, None, : self.cfg.vocab_size]
        x = tp_copy(x, self.tp)
        if self.cfg.tie_word_embeddings:
            y = F.linear(x, self.embed_tokens.weight)
        else:
            y = self.lm_head(x)
        return y if vocab_parallel else tp_gather(y, self.tp)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        positions: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,
        step_kv_valid: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
        cache_index: Union[int, torch.Tensor] = 0,
        last_logit_index: Optional[int] = None,
        vocab_parallel: bool = False,
    ) -> torch.Tensor:
        """Returns logits [B, T', V] (T' = 1 with ``last_logit_index``;
        V / tp of them with ``vocab_parallel``, see :meth:`logits`)."""
        cfg = self.cfg
        cos, sin = rotary_embed(positions, cfg.head_dim, cfg.rope_theta)
        x = self.scale_inputs(inputs_embeds)
        kv_len = None
        if isinstance(cache_index, torch.Tensor):
            # per-row lengths, read by every layer from the device
            cache_index = kv_len = cache_index.to(device=x.device, dtype=torch.int32)
        elif cache is not None and x.shape[1] == 1 and x.is_cuda:
            # the decode kernel reads the prefix length from device memory:
            # one scalar per step, shared by every layer
            kv_len = torch.full((), cache_index, dtype=torch.int32, device=x.device)
        remat = cfg.gradient_checkpointing and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            layer_cache = None
            if cache is not None:
                layer_cache = {name: buf[i] for name, buf in cache.items()}
            if remat:
                x = checkpoint(layer, x, cos, sin, padding_mask, None, 0, None,
                               use_reentrant=False)
            else:
                x = layer(x, cos, sin, padding_mask, layer_cache, cache_index, step_kv_valid,
                          kv_len)
        if last_logit_index is not None:
            x = x[:, last_logit_index : last_logit_index + 1]
        return self.logits(x, vocab_parallel)

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        device = self.embed_tokens.weight.device
        shape = (cfg.num_layers, batch, max_len, self.num_kv_heads, cfg.head_dim)
        if cfg.kv_cache_dtype == "int8":
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            }
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=device),
            "v": torch.zeros(shape, dtype=self.dtype, device=device),
        }


def head_kernel(decoder: Qwen3Decoder) -> torch.Tensor:
    """The LM head as the JAX package's Dense kernel ``[hidden, vocab]``:
    the embedding's transpose when tied."""
    if decoder.cfg.tie_word_embeddings:
        return decoder.embed_tokens.weight.T
    return decoder.lm_head.weight.T


def _stacked_kernels(decoder: Qwen3Decoder, name: str) -> torch.Tensor:
    """Projection ``name`` of every layer as the JAX kernels ``[L, K, N]``."""
    return torch.stack([getattr(layer, name).weight.T for layer in decoder.layers])


@torch.no_grad()
def quantize_decoder_wq(decoder: Qwen3Decoder) -> dict:
    """The weight-only ``wq`` collection of the JAX package's
    ``quantize_decoder_wq``: ``{name}_i8 [L, K, N]`` and ``{name}_scale
    [L, N]`` for every block projection, and the head ``head_i8 [K, N_pad]``
    / ``head_scale`` padded to a multiple of ``NT`` columns (pad scales 0).
    The bf16 weights stay."""
    layers = {}
    for name in PROJECTIONS:
        layers[f"{name}_i8"], layers[f"{name}_scale"] = quantize_weight(
            _stacked_kernels(decoder, name))
    head_i8, head_scale = quantize_weight(head_kernel(decoder))
    pad = -head_i8.shape[1] % NT
    return {"layers": layers, "head_i8": F.pad(head_i8, (0, pad)),
            "head_scale": F.pad(head_scale, (0, pad))}


@torch.no_grad()
def quantize_decoder_w8a8(decoder: Qwen3Decoder) -> dict:
    """The W8A8 ``wq`` collection of the JAX package's
    ``quantize_decoder_w8a8``: ``{name}_t_i8 [L, N, K]`` and
    ``{name}_t_scale [L, N]`` for every block projection, and the W8A8
    head ``head_t_i8 [N_pad, K]`` / ``head_w8a8_scale``."""
    layers = {}
    for name in PROJECTIONS:
        layers[f"{name}_t_i8"], layers[f"{name}_t_scale"] = quantize_weight_w8a8(
            _stacked_kernels(decoder, name))
    head_t_i8, head_scale = quantize_head_w8a8(head_kernel(decoder))
    return {"layers": layers, "head_t_i8": head_t_i8, "head_w8a8_scale": head_scale}


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------


def convert_hf_qwen3(state_dict: dict, cfg: DecoderConfig,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """An HF causal-LM state dict (torch tensors or numpy) as the JAX
    package's decoder params tree of CPU tensors, layers stacked on axis 0:
    projections and embeddings in ``dtype``, the RMSNorm weights in float32.

    Covers Qwen3ForCausalLM and, with ``cfg.qk_norm=False``, the Llama
    family (LlamaForCausalLM, SmolLM2, Mistral: the same names without
    ``q_norm``/``k_norm``), and Gemma v1 (the same names again; its (1 + w)
    norms, GeGLU and embedding normalizer are :class:`DecoderConfig` knobs
    that ``decoder_kwargs_from_hf`` sets).  LoRA leaves are not part of an
    HF base checkpoint."""
    sd = state_dict

    def t(name, transpose=False, cast=None):
        w = host_array(sd[name])
        return cast_leaf(w.T if transpose else w, cast or dtype)

    def stack(fmt, transpose=False, cast=None):
        return torch.stack([t(fmt.format(i), transpose, cast) for i in range(cfg.num_layers)])

    p = "model.layers.{}."
    layers = {
        "input_layernorm": {"weight": stack(p + "input_layernorm.weight", cast=torch.float32)},
        "post_attention_layernorm": {
            "weight": stack(p + "post_attention_layernorm.weight", cast=torch.float32)},
    }
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        layers[name] = {"kernel": stack(p + f"self_attn.{name}.weight", transpose=True)}
    for name in ("gate_proj", "up_proj", "down_proj"):
        layers[name] = {"kernel": stack(p + f"mlp.{name}.weight", transpose=True)}
    if cfg.qk_norm:
        layers["q_norm"] = stack(p + "self_attn.q_norm.weight", cast=torch.float32)
        layers["k_norm"] = stack(p + "self_attn.k_norm.weight", cast=torch.float32)
    params = {
        "embed_tokens": {"embedding": t("model.embed_tokens.weight")},
        "layers": layers,
        "norm": {"weight": t("model.norm.weight", cast=torch.float32)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": t("lm_head.weight", transpose=True)}
    return params
