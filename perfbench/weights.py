"""Seeded weights of a configuration, made by the benchmark on the device.

The tree is the layout that ``ASRModel(cfg, params=...)`` loads (the JAX
package's params tree: Dense kernels ``[in, out]``, Conv kernels
``[k, in, out]``, layers stacked on axis 0) and that the plain reference
(``reference.py``) reads.  Each stacked leaf is one draw from a
``torch.Generator`` on the device, in the dtype it is served in: bf16
towers, fp32 projector (its master weights), fp32 norms, biases and
positions.  The same seed gives the same tree on the same device.
"""

from __future__ import annotations

import math

import torch

#: std of biases and of the deviation of norm weights from 1: small, but
#: not 0, so that the comparison sees a bias or a norm weight misapplied
SMALL = 0.02


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's sinusoidal positions ``[length, channels]`` (sin, then cos)."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    scaled = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1).float()


class _Draw:
    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = device

    def normal(self, shape, std: float, dtype, mean: float = 0.0) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=dtype)
        return x.mul_(std).add_(mean) if mean else x.mul_(std)

    def kernel(self, shape, fan_in: int, dtype) -> torch.Tensor:
        return self.normal(shape, 1.0 / math.sqrt(fan_in), dtype)


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The whole model's tree from ``seed`` (``cfg``: a configuration file's
    dict).  ``dtype``: the towers' type (bf16 as served; the tests' tiny
    models may ask for fp32)."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    d, f, le = enc["d_model"], enc["ffn_dim"], enc["num_layers"]
    h, inter, ld = dec["hidden_size"], dec["intermediate_size"], dec["num_layers"]
    hd, nq, nkv = dec["head_dim"], dec["num_heads"], dec["num_kv_heads"]
    f32 = torch.float32
    r = _Draw(seed, device)

    def dense(n_in, n_out, layers=None, bias=True, kdtype=dtype):
        lead = () if layers is None else (layers,)
        out = {"kernel": r.kernel(lead + (n_in, n_out), n_in, kdtype)}
        if bias:
            out["bias"] = r.normal(lead + (n_out,), SMALL, kdtype)
        return out

    def norm(dim, layers=None, bias=False):
        lead = () if layers is None else (layers,)
        out = {"weight": r.normal(lead + (dim,), SMALL, f32, mean=1.0)}
        if bias:
            out["bias"] = r.normal(lead + (dim,), SMALL, f32)
        return out

    encoder = {
        "conv1": {"kernel": r.kernel((3, enc["num_mel_bins"], d), 3 * enc["num_mel_bins"],
                                     dtype),
                  "bias": r.normal((d,), SMALL, dtype)},
        "conv2": {"kernel": r.kernel((3, d, d), 3 * d, dtype), "bias": r.normal((d,), SMALL, dtype)},
        "embed_positions": sinusoids(enc["max_source_positions"], d).to(device),
        "layers": {
            "self_attn_layer_norm": norm(d, le, bias=True),
            "q_proj": dense(d, d, le),
            "k_proj": dense(d, d, le, bias=False),
            "v_proj": dense(d, d, le),
            "out_proj": dense(d, d, le),
            "final_layer_norm": norm(d, le, bias=True),
            "fc1": dense(d, f, le),
            "fc2": dense(f, d, le),
        },
        "layer_norm": norm(d, bias=True),
    }
    stride = cfg["projector_pool_stride"]
    projector = {
        "linear_1": dense(d * stride, h, bias=False, kdtype=f32),
        "norm": norm(h),
        "linear_2": dense(h, h, bias=False, kdtype=f32),
        "norm_2": norm(h),
    }
    decoder = {
        "embed_tokens": {"embedding": r.normal((dec["vocab_size"], h), 1.0 / math.sqrt(h), dtype)},
        "layers": {
            "input_layernorm": norm(h, ld),
            "q_proj": dense(h, nq * hd, ld, bias=False),
            "k_proj": dense(h, nkv * hd, ld, bias=False),
            "v_proj": dense(h, nkv * hd, ld, bias=False),
            "o_proj": dense(nq * hd, h, ld, bias=False),
            "q_norm": r.normal((ld, hd), SMALL, f32, mean=1.0),
            "k_norm": r.normal((ld, hd), SMALL, f32, mean=1.0),
            "post_attention_layernorm": norm(h, ld),
            "gate_proj": dense(h, inter, ld, bias=False),
            "up_proj": dense(h, inter, ld, bias=False),
            "down_proj": dense(inter, h, ld, bias=False),
        },
        "norm": norm(h),
    }
    return {"encoder": encoder, "projector": projector, "decoder": decoder}


def leaves(tree: dict, prefix: tuple = ()):
    """``(path, tensor)`` of every leaf."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def count(tree: dict) -> int:
    """Elements of every leaf."""
    return sum(t.numel() for _, t in leaves(tree))
