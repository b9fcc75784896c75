"""Audio projectors: the encoder -> LM bridge, all four kinds.

Port of :mod:`tiny_audio_tpu.models.projectors`:

- :class:`MLPProjector`: frame-stack k -> 2-layer MLP with RMS norms;
- :class:`MOSAProjector`: two strided convolutions, then a dense mixture of
  :class:`SimpleAdapter` experts weighted by a router's softmax;
- :class:`MoEProjector`: a shared expert plus top-k of stacked sparse
  experts, dispatched densely (every expert on every token, masked by the
  renormalized routing weight), with the router's load-balance and z losses;
- :class:`QFormerProjector`: learnable queries attending to fixed windows of
  the encoder output through post-LN :class:`QFormerBlock` layers.

Every projector is called as ``proj(x, train=False, generator=None)`` with
``x: [B, T, encoder_dim]`` and returns ``(out [B, T', llm_dim], aux)``, aux
a 0-d fp32 tensor (the MoE router's loss in train mode, else 0).  Train-mode
randomness (MoE's router jitter, QFormer's dropout) is drawn from
``generator`` only; train mode without one raises where a draw is needed.
Weights are kept in fp32 and cast to the compute dtype at use, as flax
``Dense(dtype=bf16, param_dtype=fp32)`` does; parameter names follow the
JAX params tree, so :mod:`tiny_audio_tpu_torch.bridge` carries them by name
(the stacked MoE experts keep flax's ``[E, in, out]`` layout).  The expert
products and QFormer's attention are plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tiny_audio_tpu_torch.config import ASRConfig
from tiny_audio_tpu_torch.models.layers import RMSNorm, attention

F32 = torch.float32


def frame_stack(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stack k adjacent frames along features, truncating the remainder.

    [B, T, D] -> [B, (T - k)//k + 1, D*k], contiguous (see
    :func:`_foldable`).
    """
    b, t, d = x.shape
    out_len = (t - k) // k + 1
    return _foldable(x[:, : out_len * k, :].reshape(b, out_len, d * k))


def _foldable(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous.  ``torch.matmul`` of a 3-D activation whose leading
    dimensions do not fold into rows runs one GEMM over a copy when the
    weight requires grad and a batched GEMM otherwise, which round
    differently on CUDA: the same weights then give outputs a few ulps apart
    in a frozen and in a trainable projector.  A contiguous activation always
    folds."""
    return x.contiguous()


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=F32, device=x.device)


def _need_generator(generator: Optional[torch.Generator], what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"train mode draws {what} from a torch.Generator; pass generator=")
    return generator


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale the kept
    values by 1 / (1 - rate), in x's dtype; the identity outside train mode."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.bernoulli(torch.full(x.shape, keep_prob, dtype=F32, device=x.device),
                           generator=_need_generator(generator, "dropout masks"))
    return torch.where(keep.to(torch.bool), x / keep_prob, torch.zeros_like(x))


class Dense(nn.Linear):
    """flax ``nn.Dense``: an fp32 ``nn.Linear`` applied in the compute dtype
    (weight and bias cast at use)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=F32, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class FlaxLayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (``scale``/``bias`` params, fp32): statistics in
    fp32 as E[x^2] - E[x]^2 clipped at 0, the normalized value in fp32, the
    result cast to the compute dtype."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=F32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=F32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(F32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


class MLPProjector(nn.Module):
    """Frame-stack + 2-layer MLP with RMS input/output norms."""

    def __init__(self, cfg: ASRConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        hidden = cfg.projector_hidden_dim or cfg.llm_dim
        in_dim = cfg.encoder_dim * cfg.projector_pool_stride
        self.linear_1 = Dense(in_dim, hidden, dtype, bias=False, device=device)
        self.norm = RMSNorm(hidden, 1e-6, device=device)
        self.linear_2 = Dense(hidden, cfg.llm_dim, dtype, bias=False, device=device)
        self.norm_2 = RMSNorm(cfg.llm_dim, 1e-6, device=device)

    def get_output_length(self, input_length):
        k = self.cfg.projector_pool_stride
        return (input_length - k) // k + 1

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.linear_1(frame_stack(x, self.cfg.projector_pool_stride))
        x = self.linear_2(F.gelu(self.norm(x)))  # exact erf form
        # output norm aligns the projector's RMS with the LM embeddings
        return self.norm_2(x), _zero_aux(x)


class SimpleAdapter(nn.Module):
    """2-layer GELU adapter (MOSA paper)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, dtype, device=device)
        self.fc2 = Dense(hidden_dim, output_dim, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class MOSAProjector(nn.Module):
    """Dense mixture of simple adapters (arXiv:2508.18998), conv downsampler."""

    ADAPTER_HIDDEN_DIM = 4096
    ROUTER_HIDDEN_DIM = 512
    CONV_KERNEL = 3
    CONV_STRIDE = 2
    CONV_PADDING = 1

    def __init__(self, cfg: ASRConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.num_experts = cfg.num_experts or 4
        feats = [cfg.encoder_dim, cfg.encoder_dim, cfg.llm_dim]
        for i in range(2):
            self.add_module(f"downsample_{i}", nn.Conv1d(
                feats[i], feats[i + 1], self.CONV_KERNEL, stride=self.CONV_STRIDE,
                padding=self.CONV_PADDING, dtype=F32, device=device))
        self.router_fc1 = Dense(cfg.llm_dim, self.ROUTER_HIDDEN_DIM, dtype, device=device)
        self.router_fc2 = Dense(self.ROUTER_HIDDEN_DIM, self.num_experts, dtype, device=device)
        # identity: a forward hook here reads the routing weights
        # (tiny_audio_tpu_torch.debug.check_router_health)
        self.router_probs = nn.Identity()
        for e in range(self.num_experts):
            self.add_module(f"expert_{e}", SimpleAdapter(
                cfg.llm_dim, self.ADAPTER_HIDDEN_DIM, cfg.llm_dim, dtype, device=device))

    def get_output_length(self, input_length):
        length = input_length
        for _ in range(2):
            length = (length + 2 * self.CONV_PADDING - self.CONV_KERNEL) // self.CONV_STRIDE + 1
        return length

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        dt = self.dtype
        x = x.to(dt).transpose(1, 2)  # channels first for Conv1d
        for i in range(2):
            conv = getattr(self, f"downsample_{i}")
            x = F.gelu(F.conv1d(x, conv.weight.to(dt), conv.bias.to(dt),
                                stride=self.CONV_STRIDE, padding=self.CONV_PADDING))
        x = _foldable(x.transpose(1, 2))
        logits = self.router_fc2(F.relu(self.router_fc1(x)))
        weights = self.router_probs(torch.softmax(logits.to(F32), dim=-1).to(dt))
        out = None
        for e in range(self.num_experts):
            term = getattr(self, f"expert_{e}")(x) * weights[..., e:e + 1]
            out = term if out is None else out + term
        return out, _zero_aux(x)


def moe_gate(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """Dense routing matrix [..., E] of fp32 router probabilities: the top-k
    weights renormalized (w / (sum + 1e-6)) at their experts, 0 elsewhere.
    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them (a
    stable descending sort)."""
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[..., :top_k], top_idx[..., :top_k]
    top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-6)
    return torch.zeros_like(probs).scatter_(-1, top_idx, top_w)


class MoEProjector(nn.Module):
    """Shared expert + top-k sparse experts (DeepSeek-style) with load-balance
    and z losses; dense dispatch over the stacked experts."""

    def __init__(self, cfg: ASRConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        e = cfg.num_experts
        in_dim = cfg.encoder_dim * cfg.projector_pool_stride
        out_dim = cfg.llm_dim
        hidden = cfg.projector_hidden_dim or out_dim
        self.norm = RMSNorm(in_dim, 1e-6, device=device)
        self.router = Dense(in_dim, e, dtype, bias=False, device=device)
        self.shared_expert = SimpleAdapter(in_dim, hidden, out_dim, dtype, device=device)
        self.router_probs = nn.Identity()  # a hook point, as MOSA's
        # flax's layout [E, in, out]: ASRModel.init_weights draws them
        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=F32, device=device))
        self.experts_fc1_kernel = param(e, in_dim, hidden)
        self.experts_fc1_bias = param(e, hidden)
        self.experts_fc2_kernel = param(e, hidden, out_dim)
        self.experts_fc2_bias = param(e, out_dim)

    def get_output_length(self, input_length):
        k = self.cfg.projector_pool_stride
        return (input_length - k) // k + 1

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        cfg, dt = self.cfg, self.dtype
        x = self.norm(frame_stack(x, cfg.projector_pool_stride)).to(dt)
        logits = self.router(x).to(F32)
        if train and cfg.router_jitter_noise > 0:
            eps = cfg.router_jitter_noise
            noise = torch.empty(logits.shape, dtype=F32, device=logits.device)
            noise.uniform_(1.0 - eps, 1.0 + eps,
                           generator=_need_generator(generator, "router jitter"))
            logits = logits * noise
        probs = self.router_probs(torch.softmax(logits, dim=-1))  # fp32 [B, T, E]
        gate = moe_gate(probs, cfg.num_experts_per_tok)

        shared = self.shared_expert(x)
        h = torch.einsum("bti,eih->bteh", x, self.experts_fc1_kernel.to(dt))
        h = F.gelu(h + self.experts_fc1_bias.to(dt)[None, None])
        eo = torch.einsum("bteh,eho->bteo", h, self.experts_fc2_kernel.to(dt))
        eo = eo + self.experts_fc2_bias.to(dt)[None, None]
        sparse = torch.einsum("bteo,bte->bto", eo, gate.to(dt))

        aux = _zero_aux(x)
        if train:
            e = cfg.num_experts
            prob_per_expert = probs.reshape(-1, e).mean(dim=0)
            balance = cfg.router_aux_loss_coef * torch.mean((prob_per_expert - 1.0 / e) ** 2) * e
            z = cfg.router_z_loss_coef * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
            aux = balance + z
        return shared + sparse, aux


class QFormerBlock(nn.Module):
    """BERT-style post-LN block: self-attention over the queries,
    cross-attention to the window's features, GELU FFN (BLIP-2's QFormer
    with query tokens only and a cross-attention in every layer)."""

    LN_EPS = 1e-12

    def __init__(self, hidden: int, num_heads: int, intermediate: int, dtype: torch.dtype,
                 dropout_rate: float = 0.1, device=None):
        super().__init__()
        self.hidden, self.num_heads, self.dropout_rate = hidden, num_heads, dropout_rate
        for prefix in ("self", "cross"):
            for part in ("q", "k", "v", "out"):
                self.add_module(f"{prefix}_{part}", Dense(hidden, hidden, dtype, device=device))
        for name in ("ln_self", "ln_cross", "ln_ffn"):
            self.add_module(name, FlaxLayerNorm(hidden, self.LN_EPS, dtype, device=device))
        self.ffn_in = Dense(hidden, intermediate, dtype, device=device)
        self.ffn_out = Dense(intermediate, hidden, dtype, device=device)

    def _mha(self, queries, keys, prefix, train, generator):
        b, tq, _ = queries.shape
        tk = keys.shape[1]
        hd = self.hidden // self.num_heads
        q = getattr(self, f"{prefix}_q")(queries).reshape(b, tq, self.num_heads, hd)
        k = getattr(self, f"{prefix}_k")(keys).reshape(b, tk, self.num_heads, hd)
        v = getattr(self, f"{prefix}_v")(keys).reshape(b, tk, self.num_heads, hd)
        out = attention(q, k, v).reshape(b, tq, self.hidden)
        out = getattr(self, f"{prefix}_out")(out)
        return dropout(out, self.dropout_rate, train, generator)

    def forward(self, q_states, enc_states, train: bool = False, generator=None):
        q_states = self.ln_self(q_states + self._mha(q_states, q_states, "self", train, generator))
        q_states = self.ln_cross(
            q_states + self._mha(q_states, enc_states, "cross", train, generator))
        ffn = self.ffn_out(F.gelu(self.ffn_in(q_states)))
        ffn = dropout(ffn, self.dropout_rate, train, generator)
        return self.ln_ffn(q_states + ffn)


class QFormerProjector(nn.Module):
    """Granite-style windowed QFormer with learnable queries.  The last
    window is zero-padded and its padding is attended unmasked, as in the
    JAX package."""

    def __init__(self, cfg: ASRConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        hidden = cfg.qformer_hidden_size or cfg.encoder_dim
        intermediate = cfg.qformer_intermediate_size or hidden * 4
        self.hidden = hidden
        if cfg.encoder_dim != hidden:
            self.encoder_proj = Dense(cfg.encoder_dim, hidden, dtype, bias=False, device=device)
        # normal(1.0) in ASRModel.init_weights
        self.query = nn.Parameter(torch.zeros((1, self.num_queries, hidden), dtype=F32,
                                              device=device))
        self.ln_embed = FlaxLayerNorm(hidden, QFormerBlock.LN_EPS, dtype, device=device)
        for i in range(cfg.qformer_num_layers):
            self.add_module(f"layer_{i}", QFormerBlock(
                hidden, cfg.qformer_num_heads, intermediate, dtype, device=device))
        self.linear = Dense(hidden, cfg.llm_dim, dtype, device=device)

    @property
    def num_queries(self) -> int:
        return self.cfg.qformer_window_size // self.cfg.downsample_rate

    def get_output_length(self, input_length):
        w = self.cfg.qformer_window_size
        nblocks = (input_length + w - 1) // w
        return nblocks * self.num_queries

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        cfg, dt, hidden = self.cfg, self.dtype, self.hidden
        window, nq = cfg.qformer_window_size, self.num_queries
        b, t, _ = x.shape
        x = x.to(dt)
        if hasattr(self, "encoder_proj"):
            x = self.encoder_proj(x)
        nblocks = math.ceil(t / window)
        x = F.pad(x, (0, 0, 0, nblocks * window - t)).reshape(b * nblocks, window, hidden)
        # the query embeds are layernormed and dropped out before the layers
        # (Blip2QFormerModel's embeddings stage)
        q_states = _foldable(self.ln_embed(self.query.to(dt)).expand(b * nblocks, nq, hidden))
        q_states = dropout(q_states, 0.1, train, generator)
        for i in range(cfg.qformer_num_layers):
            q_states = getattr(self, f"layer_{i}")(q_states, x, train=train, generator=generator)
        out = self.linear(q_states.reshape(b, nblocks * nq, hidden))
        return out, _zero_aux(out)


PROJECTOR_CLASSES = {
    "mlp": MLPProjector,
    "mosa": MOSAProjector,
    "moe": MoEProjector,
    "qformer": QFormerProjector,
}


def create_projector(cfg: ASRConfig, dtype: torch.dtype = torch.bfloat16, device=None):
    cls = PROJECTOR_CLASSES.get(cfg.projector_type)
    if cls is None:
        raise ValueError(
            f"Unknown projector_type: {cfg.projector_type}. "
            f"Valid options: {list(PROJECTOR_CLASSES)}"
        )
    return cls(cfg, dtype=dtype, device=device)
