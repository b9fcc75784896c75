"""The encoder block's fused MLP: a CUDA kernel for Hopper and its plain version.

Counterpart of ``tiny_audio_tpu/ops/encoder_ffn.py``.  Replaces its TPU
kernel ``_ffn_impl`` (``encoder_ffn.py:115``, pallas_call ``:124``), behind
``encoder_ffn_tpu`` and ``fused_ffn``: fc1 -> tanh GELU -> fc2, which keeps
the ``[M, F]`` intermediate in VMEM (the Hopper kernel passes it through L2).

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
- the kernel (``csrc/encoder_ffn.cu``, ``ta_encoder_ffn``), bf16 only: one
  persistent launch of TMA + ``wgmma`` GEMM tiles, phase 1 writing
  ``g = bf16(gelu(x w1^T + b1))`` into a scratch ``[M, F]`` tensor that
  phase 2 reads back from L2 (``out = g w2^T + b2``), in the queue order
  of :func:`ffn_tile_plan`.

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

import dataclasses

import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops.mel import full_fp32_matmul

BK = 64           # the kernel's products step through D and F 64 deep
BM, BN = 128, 256  # rows and columns of one output tile
#: row blocks between a block's phase-1 tiles and its phase-2 tiles in the
#: queue, at most (the kernel's ``LAG``): the phase-2 tiles then rarely wait
#: for their g
FFN_LAG = 8
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
    """The kernel's shape constraints: d_model a multiple of 128 (the JAX
    gate's) and ffn_dim a multiple of 64 (the products' 64-deep steps; the
    JAX kernel's 512-wide ffn blocks are not needed here)."""
    return d_model > 0 and d_model % 128 == 0 and ffn_dim > 0 and ffn_dim % BK == 0


@dataclasses.dataclass(frozen=True)
class FfnPlan:
    """The kernel's queue of output tiles for one call (shapes only)."""

    rows: int   # row blocks of BM
    n1: int     # phase-1 tiles a row block (g's column blocks of BN)
    n2: int     # phase-2 tiles a row block (out's column blocks of BN)
    lag: int    # min(FFN_LAG, rows)
    total: int

    def tiles(self) -> list[tuple[int, int, int]]:
        """(phase, row block, column block) in the order the blocks claim
        them: the phase-1 tiles of row blocks 0 .. lag - 1, then for each
        i >= lag row block i's phase-1 tiles followed by row block
        i - lag's phase-2 tiles, then the last lag row blocks' phase-2
        tiles (``csrc/encoder_ffn.cu``'s ``tile_of``)."""
        order = []
        for step in range(self.rows + self.lag):
            if step < self.rows:
                order += [(1, step, c) for c in range(self.n1)]
            if step >= self.lag:
                order += [(2, step - self.lag, c) for c in range(self.n2)]
        return order


def ffn_tile_plan(m: int, d: int, f: int) -> FfnPlan:
    """The queue ``ta_encoder_ffn`` walks for x [m, d] and ffn width f: a
    phase-2 tile of a row block comes after all of that block's phase-1
    tiles (it waits for them to finish, and they wait on nothing),
    ``FFN_LAG`` row blocks later where there are that many."""
    rows = -(-m // BM)
    n1, n2 = -(-f // BN), -(-d // BN)
    return FfnPlan(rows, n1, n2, min(FFN_LAG, rows), rows * (n1 + n2))


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
        raise ValueError(f"encoder FFN kernel takes d_model a multiple of 128 "
                         f"and ffn_dim a multiple of {BK}, got ({d}, {f})")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
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
    f = w1.shape[0]
    plan = ffn_tile_plan(m, d, f)
    out = torch.empty_like(x)
    g = torch.empty((m, f), dtype=x.dtype, device=x.device)  # phase 1 -> phase 2, via L2
    counters = kernels.counter_buffer(x.device, 2 + plan.rows)
    kernels.launch(
        "ta_encoder_ffn", x.device,
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), g.data_ptr(), counters.data_ptr(), m, d, f,
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
