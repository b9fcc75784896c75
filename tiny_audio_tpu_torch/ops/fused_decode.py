"""One decode step in which the attention kernel owns the cache write.

Port of :func:`tiny_audio_tpu.ops.fused_decode.fused_decode_step`: every
layer runs the block's own math (pre-LN RMSNorm, QK-norm, NeoX rope,
SwiGLU / GeGLU, via ``Qwen3Block.project_qkv`` and ``Qwen3Block.finish``),
and its attention is :func:`~tiny_audio_tpu_torch.ops.decode_attention.
decode_attention_update`, which appends the fresh K/V row at ``pos`` to the
layer's cache in place (int8-quantized for an int8 cache) and attends over
the prefix plus that row: one launch per layer where the module path has
the attention kernel plus the separate quantize-and-store ops.

The projections and the LM head go through the same ``Qwen3Block.dense``
and ``Qwen3Decoder.logits`` as the module step, so under an int8 decode
mode (``Qwen3Decoder.wq``) both steps read the same int8 weights and give
the same logits.

The cache is the decoder's own ``[L, B, S, Hkv, D]`` (scales
``[L, B, S, Hkv]``); a layer's view is already the kernel's memory, so no
``flatten_cache`` is needed.  The step works in the decoder's dtype (bf16
for the models served on the card, which is the dtype the JAX step forces).
"""

from __future__ import annotations

from typing import Union

import torch

from tiny_audio_tpu_torch.models.decoder import Qwen3Decoder
from tiny_audio_tpu_torch.models.layers import rotary_embed
from tiny_audio_tpu_torch.ops.decode_attention import decode_attention_update


@torch.inference_mode()
def fused_decode_step(
    decoder: Qwen3Decoder,
    cur: torch.Tensor,
    pos: Union[int, torch.Tensor],
    cache: dict,
) -> torch.Tensor:
    """Feed tokens ``cur`` [B] at position ``pos`` (= the cache row written
    and the valid prefix length) through every layer; returns fp32 logits
    [B, V].  ``cache`` is updated in place.  ``pos`` is one int for the
    batch, or a ``[B]`` int32 tensor on ``cur``'s device (the continuous
    engine's slots): each row then takes its own rope position, its own
    prefix length and its own append row, with no host read."""
    cfg = decoder.cfg
    b = cur.shape[0]
    device = cur.device
    if isinstance(pos, torch.Tensor):
        positions, kv_len = pos.view(b, 1), pos
    else:
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=device)
        # one device scalar per step, read by every layer's kernel
        kv_len = torch.full((), pos, dtype=torch.int32, device=device) if cur.is_cuda else pos
    cos, sin = rotary_embed(positions, cfg.head_dim, cfg.rope_theta)
    quantized = "k_scale" in cache
    x = decoder.scale_inputs(decoder.embed(cur[:, None]))
    for i, layer in enumerate(decoder.layers):
        q, k, v = layer.project_qkv(x, cos, sin)
        out = decode_attention_update(
            q[:, 0], cache["k"][i], cache["v"][i], k[:, 0], v[:, 0], kv_len,
            k_scale=cache["k_scale"][i] if quantized else None,
            v_scale=cache["v_scale"][i] if quantized else None,
        )
        x = layer.finish(x, out[:, None])
    return decoder.logits(x)[:, 0].to(torch.float32)
