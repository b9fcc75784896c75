"""Whisper/GLM-ASR-style audio encoder in PyTorch.

Port of :mod:`tiny_audio_tpu.models.encoder`: a conv subsampling stack built
from ``EncoderConfig.conv_layers`` (a GELU after each conv), sinusoidal
positions, pre-LN transformer blocks with biased q/v projections (k has no
bias) and a final LayerNorm.  One module per layer.  Self-attention goes to
the encoder attention kernel for CUDA tensors
(:func:`tiny_audio_tpu_torch.ops.attention.encoder_self_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tiny_audio_tpu_torch.config import EncoderConfig, compute_encoder_output_length
from tiny_audio_tpu_torch.models.layers import sinusoidal_positions
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

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        h, hd = cfg.num_heads, cfg.head_dim

        residual = x
        x = self.self_attn_layer_norm(x)
        # packed [B, T, H*D] straight from the projections; the reshape is a view
        q = self.q_proj(x).reshape(b, t, h, hd)
        k = self.k_proj(x).reshape(b, t, h, hd)
        v = self.v_proj(x).reshape(b, t, h, hd)
        out = encoder_self_attention(q, k, v, padding_mask)
        x = residual + self.out_proj(out.reshape(b, t, h * hd))

        residual = x
        x = self.final_layer_norm(x)
        x = self.fc2(_gelu(self.fc1(x), cfg))
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
