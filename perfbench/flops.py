"""The yardstick's arithmetic: operations and bytes from shapes, and peaks.

A kernel's least time is the larger of its operations over the bf16 peak
and its bytes over the HBM rate.  Operations count what the used outputs
need (a masked key, a causal upper triangle and padding that no output uses
are left out); bytes count each input that a used output needs read once
and each used output written once (rows of padding neither).  Model FLOPs count the useful work of the real audio and text,
products and attention, never padding or recomputation.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, dense, at the full 700 W power limit (data sheet)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2
F32 = 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


# ------------------------------------------------------------ kernels

def encoder_attention(b: int, t: int, heads: int, d: int, key_lens) -> tuple[float, float]:
    """#1: bidirectional attention over ``t`` frames, each row's keys masked
    past its length (every query row's output is used)."""
    flops = sum(4.0 * heads * d * t * min(k, t) for k in key_lens)
    nbytes = 4.0 * b * t * heads * d * BF16 + b * t * 4
    return flops, nbytes


def prefill_attention(b: int, t: int, hq: int, hkv: int, d: int, lens=None,
                      stats: bool = False) -> tuple[float, float]:
    """#2: causal attention over ``b`` rows padded to ``t`` positions;
    ``lens`` the rows' valid positions (the padding after them masked and
    its outputs unused), default ``t``.  With ``stats`` the kernel also
    writes the softmax statistics (fp32 m and l)."""
    lens = [t] * b if lens is None else lens
    rows = float(sum(lens))
    flops = sum(4.0 * hq * d * n * (n + 1) / 2 for n in lens)
    nbytes = (2.0 * rows * hq * d + 2.0 * rows * hkv * d) * BF16
    if stats:
        nbytes += 2.0 * hq * rows * F32
    return flops, nbytes


def prefill_attention_backward(b: int, t: int, hq: int, hkv: int, d: int,
                               lens) -> tuple[float, float]:
    """#2b and #2c together: from q, k, v, dout and the statistics (m, l,
    delta), dq, dk and dv; five products of the forward's size (the scores
    recomputed once, dP, dV, dK, dQ)."""
    fwd, _ = prefill_attention(b, t, hq, hkv, d, lens)
    rows = float(sum(lens))
    reads = (2.0 * rows * hq * d + 2.0 * rows * hkv * d) * BF16 + 3.0 * hq * rows * F32
    writes = (rows * hq * d + 2.0 * rows * hkv * d) * BF16
    return 2.5 * fwd, reads + writes


def decode_attention_update(b: int, kv_len: int, hq: int, hkv: int, d: int) -> tuple[float, float]:
    """#4: one decode step of one layer over an int8 cache with fp32 scales:
    reads ``kv_len`` cached rows, the fresh row, q; writes out and appends
    the fresh row (int8 and its scales)."""
    flops = 4.0 * b * hq * d * (kv_len + 1)
    cache = 2.0 * b * kv_len * hkv * (d + F32)
    nbytes = (cache + b * hq * d * BF16 * 2 + 2.0 * b * hkv * d * BF16
              + 2.0 * b * hkv * (d + F32))
    return flops, nbytes


# ------------------------------------------------------------ model FLOPs

def encoder_flops(cfg: dict, mel_frames: int) -> float:
    """One row's encoder forward over its real mel frames."""
    e = cfg["encoder"]
    d, f, mels = e["d_model"], e["ffn_dim"], e["num_mel_bins"]
    t = (mel_frames - 1) // 2 + 1
    convs = 2.0 * mel_frames * 3 * mels * d + 2.0 * t * 3 * d * d
    layer = 2.0 * t * 4 * d * d + 2.0 * t * 2 * d * f + 4.0 * t * t * d
    return convs + e["num_layers"] * layer


def projector_flops(cfg: dict, n_tokens: int) -> float:
    """One row's MLP projector forward for ``n_tokens`` audio tokens."""
    d, h = cfg["encoder"]["d_model"], cfg["decoder"]["hidden_size"]
    return 2.0 * n_tokens * (cfg["projector_pool_stride"] * d * h + h * h)


def decoder_layer_params(cfg: dict) -> int:
    c = cfg["decoder"]
    h, hd = c["hidden_size"], c["head_dim"]
    return h * hd * (2 * c["num_heads"] + 2 * c["num_kv_heads"]) + 3 * h * c["intermediate_size"]


def attention_flops(cfg: dict, queries: int, first_key_count: int) -> float:
    """Causal attention of ``queries`` positions over all layers, the first
    seeing ``first_key_count`` keys and each next one one more."""
    c = cfg["decoder"]
    keys = queries * first_key_count + queries * (queries - 1) / 2
    return c["num_layers"] * 4.0 * c["num_heads"] * c["head_dim"] * keys


def head_flops(cfg: dict, positions: int) -> float:
    c = cfg["decoder"]
    return 2.0 * positions * c["hidden_size"] * c["vocab_size"]


def serve_row_flops(cfg: dict, mel_frames: int, prompt_len: int, new_tokens: int) -> float:
    """One request served: encoder, projector, the prefill of its prompt
    (logits of the last position only) and ``new_tokens - 1`` decode steps."""
    t_enc = (mel_frames - 1) // 2 + 1
    n_audio = (t_enc - 4) // 4 + 1
    layers = cfg["decoder"]["num_layers"]
    lin = 2.0 * layers * decoder_layer_params(cfg)
    prefill = lin * prompt_len + attention_flops(cfg, prompt_len, 1) + head_flops(cfg, 1)
    steps = new_tokens - 1
    decode = (lin * steps + attention_flops(cfg, steps, prompt_len + 1) + head_flops(cfg, steps))
    return encoder_flops(cfg, mel_frames) + projector_flops(cfg, n_audio) + prefill + decode


def train_row_flops(cfg: dict, mel_frames: int, seq_len: int) -> float:
    """One training row of stage 1: the frozen encoder forward, the projector
    forward and its weights' gradient, the decoder forward over ``seq_len``
    positions with logits at each, and the decoder's input-gradient backward
    (products once more, attention twice more, the head once more)."""
    t_enc = (mel_frames - 1) // 2 + 1
    n_audio = (t_enc - 4) // 4 + 1
    layers = cfg["decoder"]["num_layers"]
    lin = 2.0 * layers * decoder_layer_params(cfg) * seq_len
    attn = attention_flops(cfg, seq_len, 1)
    head = head_flops(cfg, seq_len)
    decoder = (lin + attn + head) + (lin + 2 * attn + head)
    return encoder_flops(cfg, mel_frames) + 2 * projector_flops(cfg, n_audio) + decoder
