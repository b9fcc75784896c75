"""Audio projectors: the encoder -> LM bridge.

Port of the MLP projector of :mod:`tiny_audio_tpu.models.projectors`.  The
MOSA, MoE and QFormer projectors are not ported yet (ROADMAP.md, Queue 1).
Weights are kept in fp32 and cast to the compute dtype at use, as flax
``Dense(dtype=bf16, param_dtype=fp32)`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tiny_audio_tpu_torch.config import ASRConfig
from tiny_audio_tpu_torch.models.layers import RMSNorm


def frame_stack(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stack k adjacent frames along features, truncating the remainder.

    [B, T, D] -> [B, (T - k)//k + 1, D*k].
    """
    b, t, d = x.shape
    out_len = (t - k) // k + 1
    return x[:, : out_len * k, :].reshape(b, out_len, d * k)


class MLPProjector(nn.Module):
    """Frame-stack + 2-layer MLP with RMS input/output norms."""

    def __init__(self, cfg: ASRConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        hidden = cfg.projector_hidden_dim or cfg.llm_dim
        kw = dict(bias=False, dtype=torch.float32, device=device)
        self.linear_1 = nn.Linear(cfg.encoder_dim * cfg.projector_pool_stride, hidden, **kw)
        self.norm = RMSNorm(hidden, 1e-6, device=device)
        self.linear_2 = nn.Linear(hidden, cfg.llm_dim, **kw)
        self.norm_2 = RMSNorm(cfg.llm_dim, 1e-6, device=device)

    def get_output_length(self, input_length):
        k = self.cfg.projector_pool_stride
        return (input_length - k) // k + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = frame_stack(x, self.cfg.projector_pool_stride).to(self.dtype)
        x = F.linear(x, self.linear_1.weight.to(self.dtype))
        x = F.gelu(self.norm(x))  # exact erf form
        x = F.linear(x, self.linear_2.weight.to(self.dtype))
        # output norm aligns the projector's RMS with the LM embeddings
        return self.norm_2(x)


def create_projector(cfg: ASRConfig, dtype: torch.dtype = torch.bfloat16, device=None):
    if cfg.projector_type == "mlp":
        return MLPProjector(cfg, dtype=dtype, device=device)
    if cfg.projector_type in ("mosa", "moe", "qformer"):
        raise NotImplementedError(
            f"projector_type {cfg.projector_type!r} is not ported to PyTorch yet "
            "(queued in ROADMAP.md)"
        )
    raise ValueError(
        f"Unknown projector_type: {cfg.projector_type}. "
        "Valid options: ['mlp', 'mosa', 'moe', 'qformer']"
    )
