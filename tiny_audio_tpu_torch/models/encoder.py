"""Whisper/GLM-ASR-style audio encoder in PyTorch.

Port of :mod:`tiny_audio_tpu.models.encoder`: a conv subsampling stack built
from ``EncoderConfig.conv_layers`` (a GELU after each conv), sinusoidal
positions, pre-LN transformer blocks with biased q/v projections (k has no
bias) and a final LayerNorm.  One module per layer.  Self-attention goes to
the encoder attention kernel for CUDA tensors
(:func:`tiny_audio_tpu_torch.ops.attention.encoder_self_attention`).  Under
tp a block keeps its rank's ``num_heads / tp`` heads: q/k/v and fc1 are
column-parallel (the q, v and fc1 biases split with them), out_proj and fc2
row-parallel with their whole biases added once after the all-reduce.

The HF converters (:func:`convert_hf_audio_encoder` and the functions it
uses) are the JAX package's: they build its params tree, which
:func:`tiny_audio_tpu_torch.bridge.load_jax_params` loads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tiny_audio_tpu_torch.bridge import cast_leaf, host_array
from tiny_audio_tpu_torch.config import EncoderConfig, compute_encoder_output_length
from tiny_audio_tpu_torch.models.layers import row_linear, sinusoidal_positions, tp_copy
from tiny_audio_tpu_torch.ops.attention import encoder_self_attention


class LayerNorm(nn.Module):
    """LayerNorm with fp32 params and fp32 statistics (population variance);
    the output is cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.to(torch.float32)
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        return (x * self.weight + self.bias).to(dtype)


def _gelu(x: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """GELU policy of the JAX encoder: "gelu" (auto) is the exact erf form
    in fp32 and the tanh form in bf16; "gelu_exact"/"gelu_tanh" force one."""
    if cfg.activation == "gelu_exact":
        approx = False
    elif cfg.activation == "gelu_tanh":
        approx = True
    else:
        approx = x.dtype == torch.bfloat16
    return F.gelu(x, approximate="tanh" if approx else "none")


class EncoderBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.self_attn_layer_norm = LayerNorm(d, cfg.layer_norm_eps, device=device)
        self.q_proj = nn.Linear(d, hd, **kw)
        self.k_proj = nn.Linear(d, hd, bias=False, **kw)
        self.v_proj = nn.Linear(d, hd, **kw)
        self.out_proj = nn.Linear(hd, d, **kw)
        self.final_layer_norm = LayerNorm(d, cfg.layer_norm_eps, device=device)
        self.fc1 = nn.Linear(d, cfg.ffn_dim, **kw)
        self.fc2 = nn.Linear(cfg.ffn_dim, d, **kw)
        #: the tp axis of a sharded model (None: one device), this rank's heads
        self.tp = None
        self.num_heads = cfg.num_heads

    def shard_axes(self, mesh) -> None:
        self.tp = mesh.tp_axis
        self.num_heads = self.cfg.num_heads // mesh.tp

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        h, hd = self.num_heads, cfg.head_dim

        residual = x
        x = tp_copy(self.self_attn_layer_norm(x), self.tp)
        # packed [B, T, H*D] straight from the projections; the reshape is a view
        q = self.q_proj(x).reshape(b, t, h, hd)
        k = self.k_proj(x).reshape(b, t, h, hd)
        v = self.v_proj(x).reshape(b, t, h, hd)
        out = encoder_self_attention(q, k, v, padding_mask)
        x = residual + row_linear(out.reshape(b, t, h * hd), self.out_proj, self.tp)

        residual = x
        x = tp_copy(self.final_layer_norm(x), self.tp)
        x = row_linear(_gelu(self.fc1(x), cfg), self.fc2, self.tp)
        return residual + x


class AudioEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        in_ch = cfg.num_mel_bins
        for i, (pad, kernel, stride) in enumerate(cfg.conv_layers):
            conv = nn.Conv1d(
                in_ch, cfg.d_model, kernel, stride=stride, padding=pad,
                dtype=dtype, device=device,
            )
            self.add_module(f"conv{i + 1}", conv)
            in_ch = cfg.d_model
        self.embed_positions = nn.Parameter(
            sinusoidal_positions(cfg.max_source_positions, cfg.d_model, device=device)
        )
        self.layers = nn.ModuleList(
            EncoderBlock(cfg, dtype, device) for _ in range(cfg.num_layers)
        )
        self.layer_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps, device=device)

    def forward(
        self, input_features: torch.Tensor, frame_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Encode mel features.

        Args:
            input_features: [B, num_mel_bins, T_mel] log-mel features.
            frame_mask: optional [B, T_mel] mask of real mel frames.

        Returns:
            [B, T_enc, d_model] hidden states (T_enc via the conv formula).
        """
        cfg = self.cfg
        x = input_features.to(self.dtype)  # channels-first, as conv1d takes it
        for i in range(len(cfg.conv_layers)):
            x = _gelu(getattr(self, f"conv{i + 1}")(x), cfg)
        x = x.transpose(1, 2).contiguous()  # [B, T_enc, d_model]
        t_enc = x.shape[1]
        x = x + self.embed_positions[:t_enc].to(self.dtype)[None]

        padding_mask = None
        if frame_mask is not None:
            enc_lengths = compute_encoder_output_length(frame_mask.sum(dim=-1), cfg.conv_layers)
            positions = torch.arange(t_enc, device=x.device)[None, :]
            padding_mask = (positions < enc_lengths[:, None]).to(torch.int32)

        for layer in self.layers:
            x = layer(x, padding_mask)
        return self.layer_norm(x)


# ---------------------------------------------------------------------------
# HF weight conversion: three checkpoint flavors, one params tree
#
#   whisper  -> WhisperModel.encoder           (keys ``[model.][encoder.]...``)
#   glm      -> GlmAsr full model .audio_tower (keys ``audio_tower....``; the
#               LM and projector keys of the full checkpoint are dropped)
#   generic  -> AutoModel                      (Whisper layout assumed; the
#               alias table below absorbs common renamings)
# ---------------------------------------------------------------------------

# Substring aliases normalizing GLM/Qwen2Audio-style tower naming onto the
# Whisper layout, applied after prefix stripping.
_ENCODER_KEY_ALIASES = [
    (".self_attn.o_proj.", ".self_attn.out_proj."),
    (".input_layernorm.", ".self_attn_layer_norm."),
    (".post_attention_layernorm.", ".final_layer_norm."),
    (".mlp.fc1.", ".fc1."),
    (".mlp.fc2.", ".fc2."),
    ("ln_post.", "layer_norm."),  # openai-whisper export naming
]


#: a block's projections: (params-tree name, Whisper name, has a bias)
WHISPER_PROJECTIONS = (
    ("q_proj", "self_attn.q_proj", True),
    ("k_proj", "self_attn.k_proj", False),
    ("v_proj", "self_attn.v_proj", True),
    ("out_proj", "self_attn.out_proj", True),
    ("fc1", "fc1", True),
    ("fc2", "fc2", True),
)


def detect_encoder_flavor(state_dict: dict) -> str:
    """'glm' | 'whisper' | 'generic' from the state dict's key shapes."""
    keys = list(state_dict)
    if any(k.startswith(("audio_tower.", "model.audio_tower.")) for k in keys):
        return "glm"
    if any(".self_attn." in k or k.startswith(("encoder.", "model.encoder.", "conv1."))
           for k in keys):
        return "whisper"
    return "generic"


def normalize_encoder_state_dict(state_dict: dict) -> dict:
    """Strip wrapper prefixes and rename aliased keys to the Whisper layout.
    Of a GLM-style full-model checkpoint only the ``audio_tower.*`` subtree
    stays."""
    flavor = detect_encoder_flavor(state_dict)
    out = {}
    for key, w in state_dict.items():
        key = key.removeprefix("model.")
        if flavor == "glm":
            if not key.startswith("audio_tower."):
                continue  # LM / projector keys of the full checkpoint
            key = key.removeprefix("audio_tower.")
            key = key.removeprefix("model.")  # nested wrapper, if any
        key = key.removeprefix("encoder.")
        for old, new in _ENCODER_KEY_ALIASES:
            if old in key:
                key = key.replace(old, new)
        # conv stacks exported as a list module: conv_layers.{i}./convs.{i}./conv.{i}.
        for stem in ("conv_layers.", "convs.", "conv."):
            if key.startswith(stem):
                i, rest = key[len(stem):].split(".", 1)
                key = f"conv{int(i) + 1}.{rest}"
                break
        out[key] = w
    return out


def convert_hf_audio_encoder(state_dict: dict, cfg: EncoderConfig,
                             dtype: torch.dtype = torch.bfloat16) -> dict:
    """Three-branch encoder conversion (whisper / GLM audio_tower / generic):
    the raw dict goes to :func:`convert_hf_whisper_encoder`, which
    normalizes it once."""
    return convert_hf_whisper_encoder(state_dict, cfg, dtype=dtype)


def convert_hf_whisper_encoder(state_dict: dict, cfg: EncoderConfig,
                               dtype: torch.dtype = torch.bfloat16) -> dict:
    """An HF WhisperEncoder state dict (torch tensors or numpy) as the JAX
    package's encoder params tree of CPU tensors: projections, convs and
    their biases in ``dtype``, the LayerNorms and ``embed_positions`` in
    float32.  Keys with or without an ``encoder.`` prefix; GLM
    ``audio_tower.*`` checkpoints are normalized first."""
    sd = {key: host_array(w) for key, w in normalize_encoder_state_dict(state_dict).items()}
    if "conv1.weight" not in sd or not any(k.startswith("layers.0.") for k in sd):
        raise KeyError(
            "unrecognized encoder state-dict layout after normalization; "
            f"sample keys: {sorted(sd)[:12]}"
        )

    def t(name, cast=None, conv=False, transpose=False):
        w = sd[name]
        if conv:  # torch Conv1d [out, in, k] -> flax [k, in, out]
            w = w.transpose(2, 1, 0)
        elif transpose:
            w = w.T
        return cast_leaf(w, cast or dtype)

    def stack(fmt, cast=None, transpose=False):
        return torch.stack([t(fmt.format(i), cast=cast, transpose=transpose)
                            for i in range(cfg.num_layers)])

    layers = {}
    for flax_name, hf_name, bias in WHISPER_PROJECTIONS:
        entry = {"kernel": stack("layers.{}." + hf_name + ".weight", transpose=True)}
        if bias:
            entry["bias"] = stack("layers.{}." + hf_name + ".bias")
        layers[flax_name] = entry
    for name in ("self_attn_layer_norm", "final_layer_norm"):
        layers[name] = {
            "weight": stack("layers.{}." + name + ".weight", cast=torch.float32),
            "bias": stack("layers.{}." + name + ".bias", cast=torch.float32),
        }

    params = {"layers": layers}
    for i in range(len(cfg.conv_layers)):
        params[f"conv{i + 1}"] = {
            "kernel": t(f"conv{i + 1}.weight", conv=True),
            "bias": t(f"conv{i + 1}.bias"),
        }
    params["embed_positions"] = t("embed_positions.weight", cast=torch.float32)
    params["layer_norm"] = {
        "weight": t("layer_norm.weight", cast=torch.float32),
        "bias": t("layer_norm.bias", cast=torch.float32),
    }
    return params
