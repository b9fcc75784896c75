"""ECAPA-TDNN speaker encoder at speechbrain's inference semantics.

Port of :class:`tiny_audio_tpu.models.ecapa.EcapaTDNN`: reflect-padded
"same" convolutions, eval BatchNorm (running statistics as buffers), Res2Net
chunk chaining, SE blocks, multi-layer feature aggregation and attentive
statistics pooling with global context.  Module names follow the flax tree,
so :func:`tiny_audio_tpu_torch.bridge.load_flax_tower` fills it from the
JAX package's files.  The tensors run channels-first (``[B, C, T]``) inside;
the interface is ``[B, T, n_mels] -> [B, embed_dim]`` as in the JAX package.
:func:`convert_speechbrain_ecapa` reads speechbrain's checkpoint into that
tree, the running statistics into the BatchNorm buffers.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tiny_audio_tpu_torch.bridge import cast_leaf, host_array


class BatchNorm1dEval(nn.Module):
    """Eval-mode BatchNorm over the channel axis (dim 1):
    ``(x - mean) * rsqrt(var + eps) * weight + bias``."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                * self.weight.view(shape) + self.bias.view(shape))


class TDNNBlock(nn.Module):
    """Conv1d ("same", reflect padding) -> ReLU -> BatchNorm."""

    def __init__(self, cin: int, out: int, kernel: int = 1, dilation: int = 1, device=None):
        super().__init__()
        self.pad = (kernel - 1) * dilation // 2
        self.conv = nn.Conv1d(cin, out, kernel, dilation=dilation, device=device)
        self.norm = BatchNorm1dEval(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad:
            x = F.pad(x, (self.pad, self.pad), mode="reflect")
        return self.norm(torch.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    """Chunk the channels into ``scale`` groups and chain TDNNs, each fed the
    previous group's output added to its own chunk."""

    def __init__(self, channels: int, out: int, scale: int, kernel: int, dilation: int,
                 device=None):
        super().__init__()
        self.scale = scale
        width, hidden = channels // scale, out // scale
        for i in range(scale - 1):
            self.add_module(f"block_{i}", TDNNBlock(width, hidden, kernel, dilation, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, self.scale, dim=1)
        outs = [chunks[0]]
        for i in range(1, self.scale):
            inp = chunks[i] if i == 1 else chunks[i] + outs[-1]
            outs.append(getattr(self, f"block_{i - 1}")(inp))
        return torch.cat(outs, dim=1)


class SERes2NetBlock(nn.Module):
    """tdnn1 -> Res2Net -> tdnn2 -> squeeze-excitation, plus the residual."""

    def __init__(self, channels: int, scale: int, se_channels: int, kernel: int,
                 dilation: int, device=None):
        super().__init__()
        self.tdnn1 = TDNNBlock(channels, channels, 1, 1, device)
        self.res2net_block = Res2NetBlock(channels, channels, scale, kernel, dilation, device)
        self.tdnn2 = TDNNBlock(channels, channels, 1, 1, device)
        self.se_conv1 = nn.Conv1d(channels, se_channels, 1, device=device)
        self.se_conv2 = nn.Conv1d(se_channels, channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        s = torch.relu(self.se_conv1(h.mean(dim=2, keepdim=True)))
        s = torch.sigmoid(self.se_conv2(s))
        return h * s + x


class EcapaTDNN(nn.Module):
    """speechbrain ECAPA_TDNN: [B, T, n_mels] -> [B, embed_dim].

    ``channels`` follows speechbrain's list convention; the voxceleb
    checkpoint uses (1024, 1024, 1024, 1024, 3072).
    """

    def __init__(
        self,
        channels: Sequence[int] = (512, 512, 512, 512, 1536),
        embed_dim: int = 192,
        kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1),
        dilations: Sequence[int] = (1, 2, 3, 4, 1),
        attention_channels: int = 128,
        res2net_scale: int = 8,
        se_channels: int = 128,
        n_mels: int = 80,
        device=None,
    ):
        super().__init__()
        ch = tuple(channels)
        self.embed_dim = embed_dim
        self.blocks_0 = TDNNBlock(n_mels, ch[0], kernel_sizes[0], dilations[0], device)
        for i in range(1, 4):
            self.add_module(f"blocks_{i}", SERes2NetBlock(
                ch[i], res2net_scale, se_channels, kernel_sizes[i], dilations[i], device))
        self.mfa = TDNNBlock(sum(ch[1:4]), ch[-1], kernel_sizes[-1], dilations[-1], device)
        self.asp_tdnn = TDNNBlock(3 * ch[-1], attention_channels, 1, 1, device)
        self.asp_conv = nn.Conv1d(attention_channels, ch[-1], 1, device=device)
        self.asp_bn = BatchNorm1dEval(2 * ch[-1], device=device)
        self.fc = nn.Linear(2 * ch[-1], embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.blocks_0(x.transpose(1, 2))
        feats = []
        for i in range(1, 4):
            h = getattr(self, f"blocks_{i}")(h)
            feats.append(h)
        h = self.mfa(torch.cat(feats, dim=1))

        # attentive statistics pooling with global context
        eps = 1e-12
        mean_g = h.mean(dim=2, keepdim=True)
        std_g = torch.sqrt(torch.clamp(((h - mean_g) ** 2).mean(dim=2, keepdim=True), min=eps))
        attn_in = torch.cat([h, mean_g.expand_as(h), std_g.expand_as(h)], dim=1)
        a = self.asp_conv(torch.tanh(self.asp_tdnn(attn_in)))
        w = torch.softmax(a, dim=2)
        mu = (w * h).sum(dim=2)
        sd = torch.sqrt(torch.clamp((w * (h - mu[:, :, None]) ** 2).sum(dim=2), min=eps))
        pooled = self.asp_bn(torch.cat([mu, sd], dim=1))
        return self.fc(pooled)


# ---------------------------------------------------------------------------
# speechbrain checkpoint conversion
# ---------------------------------------------------------------------------


def convert_speechbrain_ecapa(state_dict: dict) -> tuple[dict, "EcapaTDNN"]:
    """speechbrain ``embedding_model.ckpt`` state dict -> (flax tree of fp32
    CPU tensors, :class:`EcapaTDNN` on the CPU).

    speechbrain nests the torch modules under ``.conv`` / ``.norm``
    (``blocks.0.conv.conv.weight``); a BatchNorm's ``running_mean`` and
    ``running_var`` become the tree's ``mean`` and ``var``, which
    :func:`tiny_audio_tpu_torch.bridge.load_flax_tower` puts in the
    module's buffers.  The widths (channels, embedding, Res2Net scale, SE and
    attention channels) come from the shapes, so the 512- and 1024-channel
    releases both convert."""
    sd = {k.removeprefix("embedding_model."): host_array(v) for k, v in state_dict.items()}

    def f32(a):
        return cast_leaf(a, torch.float32)

    def conv(name):  # torch [out, in, k] -> flax [k, in, out]
        p = {"kernel": f32(sd[f"{name}.weight"].transpose(2, 1, 0))}
        if f"{name}.bias" in sd:
            p["bias"] = f32(sd[f"{name}.bias"])
        return p

    def bn(name):
        return {"scale": f32(sd[f"{name}.weight"]), "bias": f32(sd[f"{name}.bias"]),
                "mean": f32(sd[f"{name}.running_mean"]), "var": f32(sd[f"{name}.running_var"])}

    def tdnn(name):
        return {"conv": conv(f"{name}.conv.conv"), "norm": bn(f"{name}.norm.norm")}

    params: dict = {"blocks_0": tdnn("blocks.0")}
    n_res2net = 0
    while f"blocks.1.res2net_block.blocks.{n_res2net}.conv.conv.weight" in sd:
        n_res2net += 1
    for i in (1, 2, 3):
        params[f"blocks_{i}"] = {
            "tdnn1": tdnn(f"blocks.{i}.tdnn1"),
            "tdnn2": tdnn(f"blocks.{i}.tdnn2"),
            "res2net_block": {f"block_{j}": tdnn(f"blocks.{i}.res2net_block.blocks.{j}")
                              for j in range(n_res2net)},
            "se_conv1": conv(f"blocks.{i}.se_block.conv1.conv"),
            "se_conv2": conv(f"blocks.{i}.se_block.conv2.conv"),
        }
    params["mfa"] = tdnn("mfa")
    params["asp_tdnn"] = tdnn("asp.tdnn")
    params["asp_conv"] = conv("asp.conv.conv")
    params["asp_bn"] = bn("asp_bn.norm")
    fc_w = sd["fc.conv.weight"]  # [embed, 2 * C, 1]
    fc = {"kernel": f32(fc_w[:, :, 0].T)}
    if "fc.conv.bias" in sd:
        fc["bias"] = f32(sd["fc.conv.bias"])
    params["fc"] = fc

    c0 = sd["blocks.0.conv.conv.weight"].shape[0]
    c_last = sd["mfa.conv.conv.weight"].shape[0]
    module = EcapaTDNN(
        channels=(c0, c0, c0, c0, c_last),
        embed_dim=fc_w.shape[0],
        attention_channels=sd["asp.tdnn.conv.conv.weight"].shape[0],
        res2net_scale=n_res2net + 1,
        se_channels=sd["blocks.1.se_block.conv1.conv.weight"].shape[0],
    )
    return params, module
