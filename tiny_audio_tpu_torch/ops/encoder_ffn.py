"""The encoder block's fused MLP: a CUDA kernel for Hopper and its plain version.

Counterpart of ``tiny_audio_tpu/ops/encoder_ffn.py``.  Replaces its TPU
kernel ``_ffn_impl`` (``encoder_ffn.py:115``, pallas_call ``:124``), behind
``encoder_ffn_tpu`` and ``fused_ffn``: fc1 -> tanh GELU -> fc2 with the
``[M, F]`` intermediate kept on the chip.

The weights are in ``nn.Linear``'s layout, as the port's ``EncoderBlock``
holds them (``models/encoder.py``): w1 ``[F, D]``, w2 ``[D, F]`` (the JAX
function takes the flax kernels ``[D, F]`` and ``[F, D]``; ``bridge.py``
transposes every Dense kernel the same way).

Three formulas:

- :func:`naive_ffn`, the JAX package's oracle and the backward's formula:
  every operand cast to ``dtype``, h rounded to ``dtype`` before the GELU;
- :func:`encoder_ffn_plain`, the kernel's own formula and its plain version:
  both products accumulate in fp32, h stays fp32 through the GELU and g is
  rounded to x's dtype once before the second product;
- the kernel (``csrc/encoder_ffn.cu``, ``ta_encoder_ffn``), bf16 only.

Gradient: as the JAX package's custom VJP recomputes through ``naive_ffn``
(``tiny_audio_tpu/ops/encoder_ffn.py:103-108``), :class:`EncoderFFN`'s
backward recomputes :func:`naive_ffn` in x's dtype and differentiates it;
there is no backward kernel, as there is no backward Pallas kernel.

No path of the port calls this module: the encoder's MLP runs unfused in
``EncoderBlock.forward``, as the JAX encoder never calls ``fused_ffn``.
On a CPU tensor :func:`encoder_ffn` runs :func:`encoder_ffn_plain`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops.mel import full_fp32_matmul

BF = 64           # the kernel walks F in blocks of 64
MAX_D = 1280      # its [32, D] fp32 partial output lives in registers
GELU_C = 0.7978845608028654  # sqrt(2 / pi)


def gelu_tanh_f32(h: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, written as the JAX package writes it."""
    return 0.5 * h * (1.0 + torch.tanh(GELU_C * (h + 0.044715 * h * h * h)))


def naive_ffn(x, w1, b1, w2, b2, dtype):
    """The unfused formula with nn.Dense's promotion (operands cast to
    ``dtype`` before each product, h rounded to ``dtype``), tanh GELU in
    fp32: the JAX oracle and the backward's formula."""
    x = x.to(dtype)
    h = x @ w1.to(dtype).T + b1.to(dtype)
    g = gelu_tanh_f32(h.to(torch.float32)).to(dtype)
    return g @ w2.to(dtype).T + b2.to(dtype)


def encoder_ffn_plain(x, w1, b1, w2, b2):
    """The kernel's formula: x [M, D], w1 [F, D], b1 [F], w2 [D, F], b2 [D];
    fp32 sums, fp32 h through the GELU, g rounded to x's dtype, output in
    x's dtype."""
    f32 = torch.float32
    with full_fp32_matmul():
        h = x.to(f32) @ w1.to(f32).T + b1.to(f32)
        g = gelu_tanh_f32(h).to(x.dtype).to(f32)
        return (g @ w2.to(f32).T + b2.to(f32)).to(x.dtype)


def fused_ffn_applicable(d_model: int, ffn_dim: int) -> bool:
    """The kernel's shape constraints: d_model a multiple of 128 up to 1280
    (16 warps of 8-column mma tiles, a [32, d_model] fp32 accumulator in
    registers) and ffn_dim a multiple of 64."""
    return d_model % 128 == 0 and 0 < d_model <= MAX_D and ffn_dim % BF == 0 and ffn_dim > 0


def _check_cuda_inputs(x, w1, b1, w2, b2) -> None:
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"encoder FFN kernel takes bfloat16, got {name} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 2:
        raise ValueError(f"x must be [M, D], got {tuple(x.shape)}")
    m, d = x.shape
    f = w1.shape[0]
    if w1.shape != (f, d) or w2.shape != (d, f) or b1.shape != (f,) or b2.shape != (d,):
        raise ValueError(f"weights must be w1 [F, D], b1 [F], w2 [D, F], b2 [D] for D={d}: "
                         f"{tuple(w1.shape)} {tuple(b1.shape)} {tuple(w2.shape)} {tuple(b2.shape)}")
    if not fused_ffn_applicable(d, f):
        raise ValueError(f"encoder FFN kernel takes d_model a multiple of 128 up to {MAX_D} "
                         f"and ffn_dim a multiple of {BF}, got ({d}, {f})")
    if x.data_ptr() % 16 or w2.data_ptr() % 8 or w1.data_ptr() % 4:
        raise ValueError("x must be 16-byte aligned, w2 8-byte and w1 4-byte")
    if m == 0:
        raise ValueError("encoder FFN kernel needs at least one row")


def encoder_ffn(x, w1, b1, w2, b2):
    """``bf16(gelu_tanh(x @ w1.T + b1)) @ w2.T + b2`` with fp32 h and sums.

    x: [M, D]; w1: [F, D]; b1: [F]; w2: [D, F]; b2: [D].  Returns [M, D] in
    x's dtype.  Ragged M is the kernel's to mask; nothing is padded.
    """
    if not x.is_cuda:
        return encoder_ffn_plain(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return EncoderFFN.apply(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)


class EncoderFFN(torch.autograd.Function):
    """Kernel #8 forward; the backward recomputes :func:`naive_ffn` in x's
    dtype and differentiates it (no backward kernel, as in the JAX package)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _launch(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in saved]
            out = naive_ffn(*leaves, dtype=saved[0].dtype)
            return torch.autograd.grad(out, leaves, dout)


def _launch(x, w1, b1, w2, b2) -> torch.Tensor:
    _check_cuda_inputs(x, w1, b1, w2, b2)
    m, d = x.shape
    out = torch.empty_like(x)
    kernels.launch(
        "ta_encoder_ffn", x.device,
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), m, d, w1.shape[0],
    )
    encoder_ffn.launches += 1
    return out


def fused_ffn(x, w1, b1, w2, b2, dtype):
    """[B, T, D] -> [B, T, D] through :func:`encoder_ffn`, every operand cast
    to ``dtype`` (the counterpart of ``tiny_audio_tpu/ops/encoder_ffn.py:153``,
    which pads B*T to its row tile; the kernel masks the ragged rows)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(dtype).contiguous()
    out = encoder_ffn(x2, *(t.to(dtype).contiguous() for t in (w1, b1, w2, b2)))
    return out.reshape(shape)


#: kernel launches since the last reset (CPU calls never count)
encoder_ffn.launches = 0
