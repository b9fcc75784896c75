"""The Hopper kernel wrappers: device rules here, kernel vs plain on the card.

This file imports no jax, so it also runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

On a machine without a CUDA GPU the ``cuda`` tests skip.
"""

import pytest
import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops import attention as tattn
from tiny_audio_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    decode_attention_split_plain,
    decode_attention_update,
    decode_attention_update_plain,
    split_plan,
)
from tiny_audio_tpu_torch.ops.encoder_attention import (
    encoder_attention,
    encoder_attention_plain,
)
from tiny_audio_tpu_torch.ops.encoder_ffn import (
    EncoderFFN,
    encoder_ffn,
    encoder_ffn_plain,
    fused_ffn,
    naive_ffn,
)
from tiny_audio_tpu_torch.ops.mel import log_mel_spectrogram
from tiny_audio_tpu_torch.ops.mel_fused import log_mel_spectrogram_fused
from tiny_audio_tpu_torch.ops.prefill_attention import (
    attention_delta,
    prefill_attention,
    prefill_attention_backward_plain,
    prefill_attention_bwd_dkv,
    prefill_attention_bwd_dq,
    prefill_attention_forward,
    prefill_attention_plain,
    prefill_attention_stats_plain,
)
from tiny_audio_tpu_torch.ops.encoder_attention_variants import (
    MODES,
    SAME_FUNCTION,
    encoder_attention_variant,
    encoder_attention_variant_plain,
)
from tiny_audio_tpu_torch.ops.wq_head import w8a8_matmul, w8a8_matmul_plain
from tiny_audio_tpu_torch.ops.wq_head_variants import a8_matmul, a8t_matmul, wq_matmul_pipe
from tiny_audio_tpu_torch.ops.wq_matmul import (
    WQ_ATOL,
    WQ_RTOL,
    quantize_weight,
    wq_matmul,
    wq_matmul_plain,
)
from tiny_audio_tpu_torch.tools import bench_encoder_attention

torch.set_num_threads(1)
# bf16 kernel vs plain version on the same inputs: both round P and the
# output to bf16 (chip_smoke.py states the derivation)
KERNEL_ATOL, KERNEL_RTOL = 1e-2, 2.0**-6
# A backward kernel's gradient is held against the plain backward in fp32:
# its error may be at most BWD_ERR_RATIO times the bf16 plain backward's own
# error against the fp32 one, plus BWD_FLOOR of the gradient's largest
# magnitude (one bf16 ulp near the top of a binade) for gradients so small
# that the bf16 plain version happens to round exactly.
BWD_ERR_RATIO, BWD_FLOOR = 2.0, 2.0**-8
# Where the exact gradient is 0 by cancellation (one key: dS = dP - delta),
# the residue of dP - delta, each an fp32 sum of the same D products taken in
# another order: 2**-20 of |delta| is 8 ulps at the top of its binade.
DS_RESIDUE = 2.0**-20
# An fp32 kernel (CUDA-core FMAs) against its plain version in fp32: sums in
# other orders and exp2 of the log2-scaled score for exp differ by a few fp32
# ulps a term; FP32_TOL of the largest |want| (at least 1) bounds a row's sum.
FP32_TOL = 1e-4
# The forward's row statistics against prefill_attention_stats_plain (fp32
# from the same bf16 inputs): m is one score, the same bf16 products summed
# in fp32 in another order, a few fp32 ulps of sum |q_i k_i| (<= ~1e-4 in
# log2 units here; a padding row's MASK_VALUE within STATS_RTOL); l is an
# fp32 sum of at most 1,500 terms <= 1 in another order (n 2^-24 < 1e-4).
STATS_M_ATOL, STATS_RTOL = 1e-3, 1e-4
# Sequence lengths at the Hopper design's edges: its 64-row warpgroup tiles,
# its 128-key stages and 64-column swizzle boxes, and the paths' ragged T.
EDGE_T = (1, 63, 64, 65, 127, 128, 129, 468, 1500)


def test_cpu_calls_launch_no_kernel():
    encoder_attention.launches = prefill_attention.launches = 0
    x = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    tattn.encoder_self_attention(x, x, x, torch.ones((1, 8), dtype=torch.int32))
    tattn.causal_self_attention(x, x, x, torch.ones((1, 8), dtype=torch.int32))
    assert encoder_attention.launches == 0 and prefill_attention.launches == 0


def test_prefill_stats_plain_reproduce_the_plain_output():
    """m and l of prefill_attention_stats_plain rebuild the plain forward:
    out = sum_k exp2(x_k - m) v_k / l, with padding keys inside a row.  In a
    row of padding the kernels weight the visible keys uniformly: m is
    MASK_VALUE and l counts them (the plain forward, whose causal mask also
    scores MASK_VALUE, averages all T keys there: such rows are don't-care)."""
    gen = torch.Generator().manual_seed(4)
    b, t, hq, hkv, d = 2, 37, 4, 2, 16
    q, k, v = (torch.randn(shape, generator=gen) for shape in
               ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    mask = torch.ones((b, t), dtype=torch.int32)
    mask[0, 5:9] = 0
    mask[1] = 0
    m, l = prefill_attention_stats_plain(q, k, mask)
    assert m.shape == l.shape == (b, hq, t) and m.dtype == l.dtype == torch.float32
    assert (m[1] < -1e38).all() and torch.equal(l[1], torch.arange(1, t + 1.0).expand(hq, t))
    kk = k.repeat_interleave(hq // hkv, dim=2)
    x = torch.einsum("bqhd,bkhd->bhqk", q, kk) * (d ** -0.5 * 1.4426950408889634)
    x = x.masked_fill(~mask.bool()[:, None, None, :], -0.7 * torch.finfo(torch.float32).max)
    x = x.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp2(x - m[..., None]) / l[..., None]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.repeat_interleave(hq // hkv, dim=2))
    torch.testing.assert_close(out[0], prefill_attention_plain(q, k, v, mask)[0],
                               atol=1e-5, rtol=1e-5)


@pytest.fixture
def pretend_cuda(monkeypatch, tmp_path):
    """CPU tensors that report ``is_cuda`` and no CUDA toolkit: a wrapper
    must then take the kernel route and raise, never run the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a real GPU is present; the kernel tests below cover it")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    kernels.build.cache_clear()
    kernels.library.cache_clear()
    yield
    kernels.build.cache_clear()
    kernels.library.cache_clear()


def test_cuda_grad_paths_never_fall_back(pretend_cuda):
    """With grad, a CUDA tensor takes the autograd functions, whose forward
    and backward launch kernels: they raise here, never run the plain version."""
    y = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, requires_grad=True)
    prefill_attention.launches = 0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        prefill_attention(y, y, y, None)
    x = torch.zeros((1, 8, 2 * 64), dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        encoder_attention(x, x, x, None, 2)
    stats = torch.zeros((1, 2, 8))
    z = y.detach()
    prefill_attention_bwd_dkv.launches = prefill_attention_bwd_dq.launches = 0
    for fn in (prefill_attention_bwd_dkv, prefill_attention_bwd_dq):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fn(z, z, z, None, z, stats, stats, stats)
        with pytest.raises(ValueError, match="delta"):
            fn(z, z, z, None, z, stats, stats, stats[..., :4])
        with pytest.raises(RuntimeError, match="nvcc not found"):  # the fp32 instance
            f = z.float()
            fn(f, f, f, None, f, stats, stats, stats)
        with pytest.raises(ValueError, match="head_dim"):
            w = z[..., :48].contiguous()
            fn(w, w, w, None, w, stats, stats, stats)
    assert prefill_attention.launches == 0
    assert prefill_attention_bwd_dkv.launches == prefill_attention_bwd_dq.launches == 0


def test_cuda_tensor_never_falls_back(pretend_cuda):
    encoder_attention.launches = prefill_attention.launches = 0
    x = torch.zeros((1, 8, 2 * 64), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        encoder_attention(x, x, x, None, 2)
    y = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        prefill_attention(y, y, y, None)
    # fp32 and head_dim 16 reach the launch; fp16 and head_dim 48 are refused
    with pytest.raises(RuntimeError, match="nvcc not found"):
        encoder_attention(x.float(), x.float(), x.float(), None, 8)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        z = y[..., :16].float().contiguous()
        prefill_attention(z, z, z, None)
    with pytest.raises(TypeError):
        encoder_attention(x.half(), x.half(), x.half(), None, 2)
    with pytest.raises(ValueError, match="head_dim"):
        z = y[..., :48].contiguous()
        prefill_attention(z, z, z, None)
    with pytest.raises(ValueError, match="contiguous"):
        prefill_attention(y.transpose(1, 2), y.transpose(1, 2), y.transpose(1, 2), None)
    assert encoder_attention.launches == 0 and prefill_attention.launches == 0

    decode_attention.launches = decode_attention_update.launches = 0
    q = torch.zeros((2, 4, 128), dtype=torch.bfloat16)
    fresh = torch.zeros((2, 2, 128), dtype=torch.bfloat16)
    cache = torch.zeros((2, 32, 2, 128), dtype=torch.int8)
    scale = torch.ones((2, 32, 2), dtype=torch.float32)
    for fn in (decode_attention, decode_attention_update):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fn(q, cache, cache, fresh, fresh, 5, scale, scale)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fn(q, cache.to(torch.bfloat16), cache.to(torch.bfloat16), fresh, fresh, 5)
        with pytest.raises(RuntimeError, match="nvcc not found"):  # fp32 over int8
            fn(q.float(), cache, cache, fresh.float(), fresh.float(), 5, scale, scale)
        with pytest.raises(RuntimeError, match="nvcc not found"):  # fp32 over fp32, D = 16
            f = lambda t: t[..., :16].float().contiguous()  # noqa: E731
            fn(f(q), f(cache), f(cache), f(fresh), f(fresh), 5)
        with pytest.raises(TypeError):
            fn(q.half(), cache, cache, fresh.half(), fresh.half(), 5, scale, scale)
        with pytest.raises(TypeError):  # an fp32 model's cache is fp32 or int8, not bf16
            fn(q.float(), cache.to(torch.bfloat16), cache.to(torch.bfloat16), fresh.float(),
               fresh.float(), 5)
        with pytest.raises(ValueError, match="head_dim"):
            fn(q[..., :48].contiguous(), cache[..., :48].contiguous(),
               cache[..., :48].contiguous(), fresh[..., :48].contiguous(),
               fresh[..., :48].contiguous(), 5, scale, scale)
        with pytest.raises(ValueError, match="query heads per KV head"):  # group 5
            fn(torch.zeros((2, 10, 128), dtype=torch.bfloat16), cache, cache, fresh, fresh,
               5, scale, scale)
    assert decode_attention.launches == 0 and decode_attention_update.launches == 0

    w8a8_matmul.launches = wq_matmul.launches = 0
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    scale = torch.ones(96, dtype=torch.float32)
    wt, w = torch.zeros((96, 64), dtype=torch.int8), torch.zeros((64, 96), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        w8a8_matmul(x, wt, scale)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wq_matmul(x, w, scale)
    with pytest.raises(TypeError):
        w8a8_matmul(x.float(), wt, scale)
    with pytest.raises(TypeError):
        wq_matmul(x, w.float(), scale)
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a8_matmul(x[:, :40].contiguous(), wt[:, :40].contiguous(), scale)
    with pytest.raises(ValueError):
        wq_matmul(x, wt, scale)  # [N, K] is not the [K, N] layout
    assert w8a8_matmul.launches == 0 and wq_matmul.launches == 0


def test_bench_variants_never_fall_back(pretend_cuda):
    """Kernels #9a-#9d on CUDA tensors: the launch is attempted and raises
    here; shapes and modes the kernels do not take raise first; no launch
    is counted."""
    encoder_attention_variant.launches = 0
    wq_matmul_pipe.launches = a8_matmul.launches = a8t_matmul.launches = 0
    x = torch.zeros((1, 256, 2 * 64), dtype=torch.bfloat16)
    for mode in ("fp32", "packed2"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            encoder_attention_variant(x, x, x, None, 2, mode, 2)
    with pytest.raises(ValueError, match="mode"):
        encoder_attention_variant(x, x, x, None, 2, "exp2", 2)
    with pytest.raises(ValueError, match="multiple of 256"):
        y = x[:, :200].contiguous()
        encoder_attention_variant(y, y, y, None, 2, "fp32", 2)
    with pytest.raises(ValueError, match="hg"):
        encoder_attention_variant(x, x, x, None, 2, "fp32", 3)
    with pytest.raises(TypeError):
        encoder_attention_variant(x.float(), x.float(), x.float(), None, 2, "fp32", 2)
    xb = torch.zeros((4, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 256), dtype=torch.int8)
    scale = torch.ones(256)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wq_matmul_pipe(xb, w, scale, 256)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        a8_matmul(xb, w, scale, 128)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        a8t_matmul(xb, w.T.contiguous(), scale, 128)
    with pytest.raises(ValueError, match="multiple of 32"):
        wq_matmul_pipe(xb, w, scale, 250)
    with pytest.raises(ValueError, match="rows"):
        wq_matmul_pipe(torch.zeros((49, 64), dtype=torch.bfloat16), w, scale, 256)
    with pytest.raises(ValueError):
        a8_matmul(xb, w.T.contiguous(), scale, 128)  # [N, K] is not #9c's layout
    with pytest.raises(ValueError, match="multiple of 16"):
        a8_matmul(xb, w, scale, 120)  # misaligned 16-byte weight loads
    with pytest.raises(ValueError, match="multiple of 64"):
        a8t_matmul(xb, w.T.contiguous(), scale, 96)
    assert encoder_attention_variant.launches == 0
    assert wq_matmul_pipe.launches == a8_matmul.launches == a8t_matmul.launches == 0


def test_stress_inputs_tell_the_plain_shifts_apart():
    """On scores of std 40 the plain versions of the shifts that cancel on
    unit-scale scores compute different functions: nomax overflows, qnorm's
    bound zeros every row; only the reciprocal pairs stay together."""
    lines = []
    result = bench_encoder_attention.modes_apart("cpu", out=lines.append)
    assert set(result) == set(SAME_FUNCTION[0]) and len(lines) == len(result)
    assert all(r["apart"] and r["own"] == 0.0 for r in result.values()), result
    assert "nan=0.00%" not in lines[SAME_FUNCTION[0].index("nomax")]
    assert "zero=100.00%" in lines[SAME_FUNCTION[0].index("qnorm")]


def _ffn_operands(m, d, f, dtype=torch.bfloat16, device="cpu", seed=0, requires_grad=False):
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = ((m, d), (f, d), (f,), (d, f), (d,))
    scales = (1.0, d ** -0.5, 0.1, f ** -0.5, 0.1)
    return [(torch.randn(s, generator=g, device=device) * c).to(dtype).requires_grad_(requires_grad)
            for s, c in zip(shapes, scales)]


@pytest.mark.parametrize("grad", [False, True])
def test_front_end_and_ffn_never_fall_back(pretend_cuda, grad, monkeypatch):
    """Kernels #7 and #8 on a CUDA tensor, with and without grad: the launch
    is attempted and raises here, the plain versions never run, wrong dtypes
    raise TypeError, and no launch is counted."""
    from tiny_audio_tpu_torch.ops import encoder_ffn as ffn_module
    from tiny_audio_tpu_torch.ops import mel_fused as mel_module

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor ran the plain version")

    monkeypatch.setattr(ffn_module, "encoder_ffn_plain", plain_called)
    monkeypatch.setattr(ffn_module, "naive_ffn", plain_called)
    monkeypatch.setattr(mel_module, "log_mel_spectrogram", plain_called)
    monkeypatch.setattr(mel_module, "log_spec_from_padded", plain_called)
    encoder_ffn.launches = log_mel_spectrogram_fused.launches = 0
    ops = _ffn_operands(40, 256, 512, requires_grad=grad)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        encoder_ffn(*ops)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_ffn(ops[0].reshape(4, 10, 256), *ops[1:], torch.bfloat16)
    with pytest.raises(TypeError):
        encoder_ffn(*(t.float() for t in ops))
    with pytest.raises(TypeError):
        encoder_ffn(ops[0], ops[1].float(), *ops[2:])
    with pytest.raises(ValueError, match="multiple of 128"):
        small = _ffn_operands(40, 200, 512, requires_grad=grad)
        encoder_ffn(*small)
    with pytest.raises(ValueError, match="w1"):
        encoder_ffn(ops[0], ops[3], ops[2], ops[1], ops[4])  # [D, F] is not nn.Linear's w1
    audio = torch.zeros((2, 16000), requires_grad=grad)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        log_mel_spectrogram_fused(audio, num_mel_bins=80)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        log_mel_spectrogram_fused(torch.zeros((1, 160), dtype=torch.int16))
    with pytest.raises(TypeError):
        log_mel_spectrogram_fused(torch.zeros((1, 16000), dtype=torch.complex64))
    with pytest.raises(ValueError, match="mel bins"):
        log_mel_spectrogram_fused(torch.zeros((1, 16000)), num_mel_bins=100)
    assert encoder_ffn.launches == 0 and log_mel_spectrogram_fused.launches == 0


def test_ffn_and_variant_refuse_misaligned_inputs_before_any_build(pretend_cuda):
    """#8 and #9a on CUDA tensors off a 16-byte boundary (their TMA maps'
    base) or not contiguous: a ValueError before the kernels are built, and
    no launch counted."""
    encoder_ffn.launches = encoder_attention_variant.launches = 0
    ops = _ffn_operands(64, 256, 512)
    shifted = torch.empty(64 * 256 + 1, dtype=torch.bfloat16)[1:].view(64, 256)
    for i, t in enumerate(ops):
        off = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
        off.copy_(t)
        with pytest.raises(ValueError, match="16-byte"):
            encoder_ffn(*ops[:i], off, *ops[i + 1:])
    with pytest.raises(ValueError, match="contiguous"):
        encoder_ffn(torch.cat([shifted, shifted], 1)[:, ::2], *ops[1:])
    x = torch.zeros((1, 256, 2 * 64), dtype=torch.bfloat16)
    off = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    for args in ((off, x, x), (x, off, x), (x, x, off)):
        with pytest.raises(ValueError, match="aligned"):
            encoder_attention_variant(*args, None, 2, "fp32", 2)
    with pytest.raises(ValueError, match="multiple of 256 up to"):
        y = torch.zeros((1, 65536 + 256, 64), dtype=torch.bfloat16)
        encoder_attention_variant(y, y, y, None, 1, "fp32", 1)
    assert encoder_ffn.launches == 0 and encoder_attention_variant.launches == 0


def test_front_end_carries_a_gradient_on_a_cuda_tensor(pretend_cuda, monkeypatch):
    """The launch writes into a tensor with no grad_fn; with grad, LogMel
    wraps it and its backward recomputes the plain formula, so the gradient
    reaches the audio and equals autograd through the plain mel.  The launch
    is replaced by the plain formula run without grad, as the kernel's output
    is."""
    from tiny_audio_tpu_torch.ops import mel_fused as mel_module
    from tiny_audio_tpu_torch.ops.mel import log_spec_from_padded

    def launch_without_grad(padded, n_frames, mels):
        with torch.no_grad():
            out = log_spec_from_padded(padded, n_frames, mels)
        log_mel_spectrogram_fused.launches += 1
        return out

    monkeypatch.setattr(mel_module, "launch_log_mel", launch_without_grad)
    log_mel_spectrogram_fused.launches = 0
    g = torch.Generator().manual_seed(3)
    audio = (torch.randn((2, 3200), generator=g) * 0.1).requires_grad_(True)
    out = log_mel_spectrogram_fused(audio, num_mel_bins=80)
    assert log_mel_spectrogram_fused.launches == 1 and out.requires_grad
    dout = torch.randn(out.shape, generator=g)
    out.backward(dout)
    ref = audio.detach().clone().requires_grad_(True)
    log_mel_spectrogram(ref, 80).backward(dout)
    torch.testing.assert_close(audio.grad, ref.grad)
    with torch.no_grad():
        assert not log_mel_spectrogram_fused(audio, num_mel_bins=80).requires_grad
    assert log_mel_spectrogram_fused.launches == 2


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels are built with nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, valid):
    torch.testing.assert_close(
        got[valid].float(), want[valid].float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL
    )


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(2, 1500, 20, 64), (4, 1500, 20, 64), (1, 77, 2, 64), (3, 64, 4, 64)]
                         + [(2, t, 2, 64) for t in EDGE_T if t != 1500])
def test_encoder_kernel_matches_plain(cuda_device, b, t, h, d):
    """#1 at the flagship's head_dim (the Hopper design): right padding in
    the last row, padding inside a 128-key tile of the first, no mask, and a
    row of padding keys; T at the design's tile and box edges."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((b, t, h * d), generator=g, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, t), dtype=torch.int32, device=cuda_device)
    mask[-1, t // 2:] = 0
    if b > 1:
        mask[0, 5:9] = 0
    before = encoder_attention.launches
    got = encoder_attention(q, k, v, mask, h)
    assert encoder_attention.launches == before + 1
    _close(got, encoder_attention_plain(q, k, v, mask, h), mask.bool())
    # no mask, and a fully masked row: the plain version's uniform average
    _close(encoder_attention(q, k, v, None, h), encoder_attention_plain(q, k, v, None, h),
           torch.ones_like(mask, dtype=torch.bool))
    mask[0] = 0
    got = encoder_attention(q, k, v, mask, h)
    assert torch.isfinite(got).all()
    _close(got, encoder_attention_plain(q, k, v, mask, h), torch.ones_like(mask, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,hq,hkv,d", [(2, 468, 16, 8, 128), (4, 468, 16, 8, 128), (1, 130, 4, 4, 128), (2, 64, 8, 2, 128),
                                         (2, 200, 9, 3, 64), (1, 67, 8, 1, 64), (2, 150, 8, 2, 256), (1, 33, 4, 4, 256)]
                         + [(2, t, 4, 2, 128) for t in EDGE_T]
                         + [(2, t, 2 * group, 2, 128) for t in (129, 468) for group in (1, 8)]
                         + [(2, t, 4, 2, 64) for t in (1, 64, 65, 129)])
def test_prefill_kernel_matches_plain(cuda_device, b, t, hq, hkv, d):
    """#2, the serving launch and the forward with statistics (m and l
    against prefill_attention_stats_plain): right padding in the last row
    (all of it when T <= 30), padding inside a 128-key tile of the first, and
    no mask; T at the Hopper design's tile and box edges, GQA groups 1, 2, 8."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((b, t, hq, d), generator=g, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((b, t, hkv, d), generator=g, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    mask = torch.ones((b, t), dtype=torch.int32, device=cuda_device)
    mask[-1, t - 30:] = 0
    if b > 1:
        mask[0, 5:9] = 0
    before = prefill_attention.launches
    got = prefill_attention(q, k, v, mask)
    assert prefill_attention.launches == before + 1
    _close(got, prefill_attention_plain(q, k, v, mask), mask.bool())
    _close(prefill_attention(q, k, v, None), prefill_attention_plain(q, k, v, None),
           torch.ones_like(mask, dtype=torch.bool))
    out, m, l = prefill_attention_forward(q, k, v, mask)
    _close(out, prefill_attention_plain(q, k, v, mask), mask.bool())
    _stats_close(m, l, *prefill_attention_stats_plain(q, k, mask))


def _stats_close(m, l, want_m, want_l):
    torch.testing.assert_close(m, want_m, atol=STATS_M_ATOL, rtol=STATS_RTOL)
    torch.testing.assert_close(l, want_l, atol=0.0, rtol=STATS_RTOL)


def _prefill_inputs(device, b, t, hq, hkv, d, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn((b, t, hq, d), generator=g, device=device) * 2).to(torch.bfloat16)
    k, v, = (torch.randn((b, t, hkv, d), generator=g, device=device).to(torch.bfloat16)
             for _ in range(2))
    dout = torch.randn((b, t, hq, d), generator=g, device=device).to(torch.bfloat16)
    mask = torch.ones((b, t), dtype=torch.int32, device=device)
    mask[-1, t - t // 3:] = 0  # the last row right-padded
    if b > 1:
        mask[0, 5:9] = 0  # padding inside a row too
    return q, k, v, dout, mask


def _bwd_close(name, got, want32, ref16):
    want32 = want32.float()
    err = (got.float() - want32).abs().max().item()
    ref_err = (ref16.float() - want32).abs().max().item()
    limit = BWD_ERR_RATIO * ref_err + BWD_FLOOR * want32.abs().max().item()
    assert torch.isfinite(got).all(), name
    assert err <= limit, f"{name}: error {err} against fp32, bf16 plain {ref_err}, limit {limit}"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "group,d,t",
    [(g, d, 131) for g in (1, 2, 3, 4, 8) for d in (64, 128, 256)]
    # the Hopper design's tile edges (64-row tiles, 128-key dkv blocks)
    + [(g, d, t) for g in (1, 2, 8) for d in (64, 128) for t in (1, 63, 64, 65, 512)])
def test_prefill_backward_kernels_match_plain(cuda_device, group, d, t):
    """dkv and dq at every (GQA group, head_dim), ragged T, padding keys
    inside and at the end of a row, against the plain backward; at head_dim
    64 and 128 also at T on and around the tile edges."""
    b, hkv = 2, 2
    seed = group + d + (t != 131) * t  # the T = 131 cases keep their seed
    q, k, v, dout, mask = _prefill_inputs(cuda_device, b, t, group * hkv, hkv, d, seed)
    before = (prefill_attention.launches, prefill_attention_bwd_dkv.launches,
              prefill_attention_bwd_dq.launches)
    out, m, l = prefill_attention_forward(q, k, v, mask)
    _close(out, prefill_attention_plain(q, k, v, mask), torch.ones_like(mask, dtype=torch.bool))
    _stats_close(m, l, *prefill_attention_stats_plain(q, k, mask))
    delta = attention_delta(out, dout)
    dk, dv = prefill_attention_bwd_dkv(q, k, v, mask, dout, m, l, delta)
    dq = prefill_attention_bwd_dq(q, k, v, mask, dout, m, l, delta)
    assert (prefill_attention.launches, prefill_attention_bwd_dkv.launches,
            prefill_attention_bwd_dq.launches) == tuple(n + 1 for n in before)
    want = prefill_attention_backward_plain(*(x.float() for x in (q, k, v)), mask, dout.float())
    ref = prefill_attention_backward_plain(q, k, v, mask, dout)
    for name, got, w, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want, ref):
        if t == 1 and name != "dv":
            # One key: P = 1 and dS = dP - delta, which the plain backward
            # cancels to exactly 0.  The kernels take delta from
            # attention_delta, a torch sum of the D products dO * O that the
            # tensor cores sum in another order for dP, so dS is a residue of
            # a few fp32 ulps of delta: |dS| <= DS_RESIDUE * |delta|, times
            # scale, the other operand and, for dk, the group's heads.
            other = k if name == "dq" else q
            limit = (d ** -0.5 * DS_RESIDUE * delta.abs().max().item()
                     * other.float().abs().max().item() * (1 if name == "dq" else group))
            assert torch.isfinite(got).all(), name
            assert got.float().abs().max().item() <= limit, f"{name} at T = 1: {got.abs().max()}"
            continue
        _bwd_close(name, got, w, r)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("checkpointed", [False, True])
def test_prefill_attention_autograd_on_card(cuda_device, checkpointed, d):
    """Gradients through prefill_attention launch the forward with
    statistics and both backward kernels, also when torch.utils.checkpoint
    recomputes the forward.  Batch row 1 is all padding: every query sees
    only MASK_VALUE scores, so the kernels weight its visible keys uniformly
    (the plain version, whose causal mask also scores MASK_VALUE, averages
    over all T keys there: such rows are don't-care on the path) and its
    gradient is known in closed form: dv_j = sum over the group's heads and
    rows r >= j of dO_r / (r + 1), dq = dk = 0.  With m + log(l) fused, the
    backward's P would be 1, not 1 / (r + 1), in that row."""
    from torch.utils.checkpoint import checkpoint

    b, t, hq, hkv = 3, 96, 16, 8
    q, k, v, dout, mask = _prefill_inputs(cuda_device, b, t, hq, hkv, d, 5)
    mask[1] = 0
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (prefill_attention.launches, prefill_attention_bwd_dkv.launches,
              prefill_attention_bwd_dq.launches)
    if checkpointed:
        out = checkpoint(prefill_attention, *leaves, mask, use_reentrant=False)
    else:
        out = prefill_attention(*leaves, mask)
    assert out.grad_fn is not None
    out.backward(dout)
    forwards = 2 if checkpointed else 1
    assert (prefill_attention.launches, prefill_attention_bwd_dkv.launches,
            prefill_attention_bwd_dq.launches) == (before[0] + forwards, before[1] + 1,
                                                   before[2] + 1)
    real = [0, 2]
    want = prefill_attention_backward_plain(*(x[real].float() for x in (q, k, v)), mask[real],
                                            dout[real].float())
    ref = prefill_attention_backward_plain(*(x[real] for x in (q, k, v)), mask[real], dout[real])
    for name, leaf, w, r in zip(("dq", "dk", "dv"), leaves, want, ref):
        _bwd_close(name, leaf.grad[real], w, r)
    weights = 1.0 / torch.arange(1, t + 1, device=cuda_device, dtype=torch.float32)
    share = dout[1].float() * weights[:, None, None]  # [T, Hq, D]
    dv_pad = share.flip(0).cumsum(0).flip(0).reshape(t, hkv, hq // hkv, d).sum(2)
    torch.testing.assert_close(leaves[2].grad[1].float(), dv_pad, atol=3e-2, rtol=2.0**-6)
    assert not leaves[0].grad[1].any() and not leaves[1].grad[1].any()


@pytest.mark.cuda
def test_encoder_attention_carries_a_gradient_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, t, h, d = 2, 150, 4, 64
    q, k, v, dout = (torch.randn((b, t, h * d), generator=g, device=cuda_device)
                     .to(torch.bfloat16) for _ in range(4))
    mask = torch.ones((b, t), dtype=torch.int32, device=cuda_device)
    mask[1, 100:] = 0
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = encoder_attention.launches
    out = encoder_attention(*leaves, mask, h)
    assert encoder_attention.launches == before + 1 and out.grad_fn is not None
    out.backward(dout)
    with torch.enable_grad():
        ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
        encoder_attention_plain(*ref, mask, h).backward(dout)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r.grad)  # the same plain recompute


def _decode_inputs(device, b, s, hkv, quantized, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa: E731
    q = (randn(b, 2 * hkv, 128) * 2).to(torch.bfloat16)
    fresh_k, fresh_v = (randn(b, hkv, 128).to(torch.bfloat16) for _ in range(2))
    if quantized:
        ck, cv = (torch.randint(-127, 128, (b, s, hkv, 128), generator=g, device=device)
                  .to(torch.int8) for _ in range(2))
        ks, vs = ((randn(b, s, hkv).abs() * 0.02 + 1e-3) for _ in range(2))
    else:
        ck, cv = (randn(b, s, hkv, 128).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    return q, ck, cv, fresh_k, fresh_v, ks, vs


def _split_kv_lens(b, s, hkv, group, d, dtype):
    """kv_len at the edges of the split the decode kernels take at this
    shape: none, one row, either side of the first split's end, the last row."""
    rows = split_plan(b, s, hkv, group, d, dtype).rows
    return sorted(n for n in {0, 1, rows - 1, rows, rows + 1, s - 1} if n < s)


def _counters_zero(device):
    torch.cuda.synchronize()
    return not any(buf.any() for buf in kernels.counter_buffers(device))


# (B, kv_len) of the path's shape (S 608, Hkv 8, group 2, D 128): a stream,
# the path's batch and the JAX bench's, each at the split's edges and at the
# path's steps
DECODE_POINTS = sorted({(b, n) for b in (1, 4, 48)
                        for n in (*_split_kv_lens(b, 608, 8, 2, 128, torch.int8),
                                  255, 256, 468, 595)})


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("b,kv_len", DECODE_POINTS)
def test_decode_kernel_matches_plain(cuda_device, quantized, b, kv_len):
    s, hkv = 608, 8
    q, ck, cv, fk, fv, ks, vs = _decode_inputs(cuda_device, b, s, hkv, quantized, kv_len)
    if not quantized:  # rows past kv_len are never read
        ck[:, kv_len:] = float("nan")
        cv[:, kv_len:] = float("nan")
    else:
        ks[:, kv_len:] = float("nan")
        vs[:, kv_len:] = float("nan")
    before = decode_attention.launches
    got = decode_attention(q, ck, cv, fk, fv, kv_len, ks, vs)
    # the same launch with kv_len as a device scalar, and twice more: the
    # splits merge in split order, so every run gives the same bits
    kv_t = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    again = [decode_attention(q, ck, cv, fk, fv, kv_t, ks, vs) for _ in range(3)]
    assert decode_attention.launches == before + 4
    want = decode_attention_plain(q, ck, cv, fk, fv, kv_len, ks, vs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    torch.testing.assert_close(got.float(), decode_attention_split_plain(
        q, ck, cv, fk, fv, kv_len, ks, vs).float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    assert all(torch.equal(got, x) for x in again)
    assert _counters_zero(q.device)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("b,kv_len", sorted({(b, n) for b in (1, 4, 48) for n in (
    *_split_kv_lens(b, 608, 8, 2, 128, torch.int8), 256, 595)}))
def test_decode_update_kernel_matches_plain(cuda_device, quantized, b, kv_len):
    s, hkv = 608, 8
    q, ck, cv, fk, fv, ks, vs = _decode_inputs(cuda_device, b, s, hkv, quantized, 7 + kv_len)
    clone = lambda x: None if x is None else x.clone()  # noqa: E731
    mine = [clone(x) for x in (ck, cv, ks, vs)]
    ref = [clone(x) for x in (ck, cv, ks, vs)]
    before = decode_attention_update.launches
    got = decode_attention_update(q, mine[0], mine[1], fk, fv, kv_len, mine[2], mine[3])
    assert decode_attention_update.launches == before + 1
    want = decode_attention_update_plain(q, ref[0], ref[1], fk, fv, kv_len, ref[2], ref[3])
    torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    # the written row: the same bytes and scales as quantize_kv's; the rest untouched
    for got_buf, want_buf in zip(mine, ref):
        if got_buf is not None:
            assert torch.equal(got_buf, want_buf)
    # appending the same row again writes the same bytes and gives the same bits
    again = [decode_attention_update(q, mine[0], mine[1], fk, fv, kv_len, mine[2], mine[3])
             for _ in range(2)]
    assert all(torch.equal(got, x) for x in again)
    for got_buf, want_buf in zip(mine, ref):
        if got_buf is not None:
            assert torch.equal(got_buf, want_buf)
    assert _counters_zero(q.device)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("b", [1, 4, 48])
def test_decode_kernels_graph_replay_advances_kv_len(cuda_device, quantized, b):
    """#4 then #3 captured once in a CUDA graph with a device kv_len that the
    graph advances (468 -> 469 -> 470, #4 appending each time): each replay
    gives the bits of the same calls made eagerly, and the caches end equal."""
    s, hkv, start = 608, 8, 468
    q, ck, cv, fk, fv, ks, vs = _decode_inputs(cuda_device, b, s, hkv, quantized, 31 + b)
    clone = lambda x: None if x is None else x.clone()  # noqa: E731
    graph_bufs = [clone(x) for x in (ck, cv, ks, vs)]
    eager_bufs = [clone(x) for x in (ck, cv, ks, vs)]
    kv_t = torch.tensor(start, dtype=torch.int32, device=cuda_device)
    warm = [clone(x) for x in (ck, cv, ks, vs)]  # a first call outside the capture
    decode_attention_update(q, warm[0], warm[1], fk, fv, kv_t, warm[2], warm[3])
    decode_attention(q, warm[0], warm[1], fk, fv, kv_t, warm[2], warm[3])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out4 = decode_attention_update(q, graph_bufs[0], graph_bufs[1], fk, fv, kv_t,
                                       graph_bufs[2], graph_bufs[3])
        out3 = decode_attention(q, graph_bufs[0], graph_bufs[1], fk, fv, kv_t,
                                graph_bufs[2], graph_bufs[3])
        kv_t.add_(1)
    for step in range(3):
        graph.replay()
        want4 = decode_attention_update(q, eager_bufs[0], eager_bufs[1], fk, fv, start + step,
                                        eager_bufs[2], eager_bufs[3])
        want3 = decode_attention(q, eager_bufs[0], eager_bufs[1], fk, fv, start + step,
                                 eager_bufs[2], eager_bufs[3])
        torch.cuda.synchronize()
        assert torch.equal(out4, want4) and torch.equal(out3, want3), step
    assert int(kv_t) == start + 3
    for got_buf, want_buf in zip(graph_bufs, eager_bufs):
        if got_buf is not None:
            assert torch.equal(got_buf.view(torch.uint8), want_buf.view(torch.uint8))
    assert _counters_zero(q.device)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
def test_decode_graph_survives_a_larger_grid(cuda_device, quantized, monkeypatch):
    """A graph captured at B = 1 keeps its merge counters' address: a later
    call at B = 48 that needs more counters (the first buffer made as small
    as B = 1's grid) gets a new buffer and frees none, so the graph, replayed
    after the freed memory would have been reused, still gives the eager
    calls' bits and leaves every counter zero."""
    monkeypatch.setattr(kernels, "_counters", {})
    monkeypatch.setattr(kernels, "COUNTERS_MIN", 1)
    s, hkv, kv_len = 608, 8, 468
    q, ck, cv, fk, fv, ks, vs = _decode_inputs(cuda_device, 1, s, hkv, quantized, 5)
    kv_t = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    decode_attention(q, ck, cv, fk, fv, kv_t, ks, vs)  # a first call outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, ck, cv, fk, fv, kv_t, ks, vs)
    big = _decode_inputs(cuda_device, 48, s, hkv, quantized, 6)
    decode_attention(big[0], *big[1:5], kv_len, *big[5:])
    assert len(kernels.counter_buffers(q.device)) == 2
    # small allocations that would take a freed counter buffer's memory
    filler = [torch.full((64,), 7, dtype=torch.int32, device=cuda_device) for _ in range(64)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attention(q, ck, cv, fk, fv, kv_len, ks, vs))
    assert all(int(x[0]) == 7 for x in filler)
    assert _counters_zero(q.device)


def _decode_shape_check(device, b, group, d, dtype, quantized, seed, close):
    """#3 and #4 at one (B, group, head_dim, dtype, cache) over S = 96 rows,
    at kv_len 77 and the split's edges, NaN planted at and past kv_len; the
    appended row bitwise the plain version's, a second run bitwise the
    first, the merge counters zero afterwards."""
    s, hkv = 96, 2
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa: E731
    q = (randn(b, group * hkv, d) * 2).to(dtype)
    fk, fv = (randn(b, hkv, d).to(dtype) for _ in range(2))
    if quantized:
        ck0, cv0 = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=device)
                    .to(torch.int8) for _ in range(2))
        ks0, vs0 = (randn(b, s, hkv).abs() * 0.02 + 1e-3 for _ in range(2))
    else:
        ck0, cv0 = (randn(b, s, hkv, d).to(dtype) for _ in range(2))
        ks0 = vs0 = None
    clone = lambda x: None if x is None else x.clone()  # noqa: E731
    for kv_len in sorted({77, *_split_kv_lens(b, s, hkv, group, d, ck0.dtype)}):
        ck, cv, ks, vs = (clone(x) for x in (ck0, cv0, ks0, vs0))
        if quantized:
            ks[:, kv_len:] = float("nan")
            vs[:, kv_len:] = float("nan")
        else:
            ck[:, kv_len:] = float("nan")
            cv[:, kv_len:] = float("nan")
        before = (decode_attention.launches, decode_attention_update.launches)
        got = decode_attention(q, ck, cv, fk, fv, kv_len, ks, vs)
        assert got.dtype == dtype and torch.isfinite(got).all(), kv_len
        close("decode_attention", got, decode_attention_plain(q, ck, cv, fk, fv, kv_len, ks, vs))
        assert torch.equal(got, decode_attention(q, ck, cv, fk, fv, kv_len, ks, vs)), kv_len
        mine = [clone(x) for x in (ck, cv, ks, vs)]
        ref = [clone(x) for x in (ck, cv, ks, vs)]
        got = decode_attention_update(q, mine[0], mine[1], fk, fv, kv_len, mine[2], mine[3])
        close("decode_attention_update", got, decode_attention_update_plain(
            q, ref[0], ref[1], fk, fv, kv_len, ref[2], ref[3]))
        assert (decode_attention.launches, decode_attention_update.launches) == \
            (before[0] + 2, before[1] + 1)
        for got_buf, want_buf in zip(mine, ref):
            if got_buf is not None:
                assert torch.equal(got_buf.view(torch.uint8), want_buf.view(torch.uint8)), kv_len
    assert _counters_zero(q.device)


def _bf16_close(name, got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL,
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("group,d", [(g, d) for g in (1, 2, 3, 4, 8) for d in (64, 128, 256)])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("b", [1, 2, 48])
def test_decode_kernels_every_group_and_head_dim(cuda_device, group, d, quantized, b):
    """Both decode kernels at every (GQA group, head_dim) they take, NaN
    planted at and past kv_len, at the split's edges; the appended row is
    bitwise quantize_kv's."""
    # B = 2 keeps the seed these cases had with one batch size
    _decode_shape_check(cuda_device, b, group, d, torch.bfloat16, quantized,
                        group * 1000 + d + (b != 2) * b, _bf16_close)


# the decode step's products: the flagship's layer projections and its head,
# and ragged N for the narrow and the wide tiling
MATMUL_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024),
                 (1024, 151936), (96, 300), (64, 40001)]


def _matmul_inputs(device, b, k, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((b, k), generator=g, device=device) * 2).to(torch.bfloat16)
    w = torch.randint(-127, 128, (n, k), generator=g, device=device).to(torch.int8)
    scale = torch.rand(n, generator=g, device=device) * 0.01
    return x, w, scale


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4, 16, 19, 48, 64])
@pytest.mark.parametrize("k,n", MATMUL_SHAPES)
def test_w8a8_kernel_matches_plain_bitwise(cuda_device, b, k, n):
    x, wt, scale = _matmul_inputs(cuda_device, b, k, n, seed=b + n)
    x[0] = 0.0  # an all-zero row takes the 1e-12 guard
    before = w8a8_matmul.launches
    got = w8a8_matmul(x, wt, scale)
    assert w8a8_matmul.launches == before + 1
    want = w8a8_matmul_plain(x, wt, scale)
    assert got.shape == (b, n) and torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4, 16, 19, 48, 64])
@pytest.mark.parametrize("k,n", MATMUL_SHAPES + [(64, 301)])
def test_wq_kernel_matches_plain(cuda_device, b, k, n):
    """fp32 sums in another order than cuBLAS's: within WQ_ATOL + WQ_RTOL."""
    x, wt, scale = _matmul_inputs(cuda_device, b, k, n, seed=3 * b + n)
    w = wt.T.contiguous()
    before = wq_matmul.launches
    got = wq_matmul(x, w, scale)
    assert wq_matmul.launches == before + 1
    want = wq_matmul_plain(x, w, scale)
    torch.testing.assert_close(got.float(), want.float(), atol=WQ_ATOL, rtol=WQ_RTOL)
    assert _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 48])
@pytest.mark.parametrize("k,n", MATMUL_SHAPES)
def test_int8_kernels_repeat_and_replay_bitwise(cuda_device, b, k, n):
    """#5 and #6 sum in a fixed order (the splits merged in split order):
    three runs, and a CUDA graph of both replayed twice, give the same bits,
    and every merge counter is back at zero."""
    x, wt, scale = _matmul_inputs(cuda_device, b, k, n, seed=5 * b + n)
    w = wt.T.contiguous()
    calls = (lambda: w8a8_matmul(x, wt, scale), lambda: wq_matmul(x, w, scale))
    eager = [call() for call in calls]
    for _ in range(2):
        assert all(torch.equal(call().view(torch.int16), want.view(torch.int16))
                   for call, want in zip(calls, eager))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = [call() for call in calls]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(got.view(torch.int16), want.view(torch.int16))
                   for got, want in zip(replayed, eager))
    assert _counters_zero(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [65, 130])
def test_int8_kernels_take_more_rows_than_a_launch(cuda_device, b):
    """Past 64 rows the wrappers launch once per 64 rows: each launch's rows
    still match the plain versions (#5 bitwise)."""
    k, n = 1024, 2048
    x, wt, scale = _matmul_inputs(cuda_device, b, k, n, seed=b)
    before = (w8a8_matmul.launches, wq_matmul.launches)
    got5, got6 = w8a8_matmul(x, wt, scale), wq_matmul(x, wt.T.contiguous(), scale)
    launches = -(-b // 64)
    assert (w8a8_matmul.launches, wq_matmul.launches) == (before[0] + launches,
                                                          before[1] + launches)
    assert torch.equal(got5.view(torch.int16), w8a8_matmul_plain(x, wt, scale).view(torch.int16))
    torch.testing.assert_close(got6.float(), wq_matmul_plain(x, wt.T.contiguous(), scale).float(),
                               atol=WQ_ATOL, rtol=WQ_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [4, 8])
def test_wq_kernel_takes_a_weight_off_16_byte_alignment(cuda_device, offset):
    """A contiguous weight view ``offset`` bytes past a 16-byte boundary, at
    an N that takes the wide tiling's 16-byte loads when aligned."""
    k, n = 64, 40960
    x, wt, scale = _matmul_inputs(cuda_device, 4, k, n, seed=offset)
    buf = torch.empty(k * n + 16, dtype=torch.int8, device=cuda_device)
    w = buf[offset:offset + k * n].view(k, n)
    w.copy_(wt.T)
    assert w.is_contiguous() and w.data_ptr() % 16 == offset
    got = wq_matmul(x, w, scale)
    torch.cuda.synchronize()
    want = wq_matmul_plain(x, w, scale)
    torch.testing.assert_close(got.float(), want.float(), atol=WQ_ATOL, rtol=WQ_RTOL)


# the fused encoder FFN (#8): the flagship layer, ragged M, and the widths it takes
FFN_SHAPES = [(6000, 1280, 5120), (1, 1280, 5120), (77, 1280, 5120), (333, 384, 1536),
              (64, 128, 256), (100, 512, 2048), (45, 1024, 4096), (31, 768, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,f", FFN_SHAPES)
def test_encoder_ffn_kernel_matches_plain(cuda_device, m, d, f):
    """bf16: kernel and plain version both round g and the output to bf16
    after fp32 sums in other orders (chip_smoke.py states the tolerance)."""
    ops = _ffn_operands(m, d, f, device=cuda_device, seed=m + d)
    before = encoder_ffn.launches
    got = encoder_ffn(*ops)
    assert encoder_ffn.launches == before + 1
    want = encoder_ffn_plain(*ops)
    assert got.shape == (m, d) and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    # A g that flips its bf16 rounding moves ~1 output in 100 by an ulp at
    # F = 5120 (98.4% bitwise equal on the card); the naive formula, which
    # rounds h first, agrees on about a third.
    assert (got == want).float().mean().item() >= 0.95


@pytest.mark.cuda
def test_fused_ffn_on_card_is_the_encoder_layout(cuda_device):
    """fused_ffn on [B, T, D] with the nn.Linear weights of an encoder
    block: ragged B*T, one launch."""
    from torch import nn

    b, t, d, f = 3, 151, 1280, 5120
    fc1 = nn.Linear(d, f, dtype=torch.bfloat16, device=cuda_device)
    fc2 = nn.Linear(f, d, dtype=torch.bfloat16, device=cuda_device)
    x = torch.randn((b, t, d), device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        before = encoder_ffn.launches
        got = fused_ffn(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias, torch.bfloat16)
        assert encoder_ffn.launches == before + 1
        want = encoder_ffn_plain(x.reshape(-1, d), fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    torch.testing.assert_close(got.reshape(-1, d).float(), want.float(),
                               atol=KERNEL_ATOL, rtol=KERNEL_RTOL)


@pytest.mark.cuda
def test_encoder_ffn_carries_a_gradient_on_card(cuda_device):
    """EncoderFFN: kernel forward, backward = naive_ffn recomputed in bf16,
    so the gradients equal autograd through naive_ffn bitwise."""
    ops = _ffn_operands(300, 1280, 5120, device=cuda_device, seed=7, requires_grad=True)
    dout = torch.randn((300, 1280), device=cuda_device).to(torch.bfloat16)
    before = encoder_ffn.launches
    out = encoder_ffn(*ops)
    assert encoder_ffn.launches == before + 1
    assert type(out.grad_fn).__name__ == EncoderFFN.__name__ + "Backward"
    out.backward(dout)
    ref = [t.detach().clone().requires_grad_(True) for t in ops]
    naive_ffn(*ref, dtype=torch.bfloat16).backward(dout)
    for leaf, r in zip(ops, ref):
        assert torch.equal(leaf.grad, r.grad)


# #8's Hopper design at its tile edges (rows of 128, columns of 256) and at
# widths past 1,280, which the first design's register accumulator refused
FFN_EDGE_SHAPES = [(127, 1280, 5120), (128, 1280, 5120), (129, 1280, 5120), (6001, 1280, 5120),
                   (129, 128, 512), (300, 1536, 6144), (257, 2048, 1024), (1, 1536, 64),
                   (200, 1280, 5184)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,f", FFN_EDGE_SHAPES)
def test_encoder_ffn_kernel_edges_and_wide(cuda_device, m, d, f):
    """Ragged M (rows past M read as zeros and never stored), D = 128 and
    above 1,280, F not a multiple of the 256-wide tile: one launch, the
    plain version's values and at least 95% of its bytes."""
    ops = _ffn_operands(m, d, f, device=cuda_device, seed=m + d + f)
    before = encoder_ffn.launches
    got = encoder_ffn(*ops)
    assert encoder_ffn.launches == before + 1
    want = encoder_ffn_plain(*ops)
    assert got.shape == (m, d) and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    assert (got == want).float().mean().item() >= 0.95


@pytest.mark.cuda
def test_encoder_ffn_repeats_and_replays_bitwise(cuda_device):
    """The tile queue and its counters: a second launch and a CUDA graph
    replayed twice give the first launch's bytes, and every launch leaves
    the counters zero (no host memset between launches)."""
    ops = _ffn_operands(1000, 1280, 5120, device=cuda_device, seed=11)
    first = encoder_ffn(*ops)
    second = encoder_ffn(*ops)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = encoder_ffn(*ops)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, first)
    assert torch.equal(second, first)
    assert all(int(buf.abs().sum()) == 0 for buf in kernels.counter_buffers(cuda_device))


@pytest.mark.cuda
def test_encoder_ffn_refuses_misaligned_or_strided(cuda_device):
    """TMA reads 16-byte-aligned, contiguous operands: anything else raises
    before a launch, and nothing falls back to the plain version."""
    ops = _ffn_operands(64, 256, 512, device=cuda_device, seed=3)
    before = encoder_ffn.launches
    shifted = torch.empty(64 * 256 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(64, 256)
    shifted.copy_(ops[0])
    with pytest.raises(ValueError, match="16-byte"):
        encoder_ffn(shifted, *ops[1:])
    with pytest.raises(ValueError, match="contiguous"):
        encoder_ffn(ops[0], ops[3].T, *ops[2:3], ops[1].T, ops[4])
    with pytest.raises(ValueError, match="contiguous"):
        encoder_ffn(torch.cat([ops[0], ops[0]], 1)[:, ::2], *ops[1:])
    assert encoder_ffn.launches == before


# the fused log-mel front end (#7): T ragged against the kernel's 32-frame tile
# at both mel counts (3,000, 100, 33, 1,001, 101 frames), the edge shapes, and
# the narrowest and widest filterbanks (8 mels: bands of up to 99 bins)
MEL_CASES = [(4, 480000, 128), (4, 480000, 80), (2, 16000, 80), (2, 48000, 128),
             (3, 40960, 128), (1, 160, 80), (2, 160 * 33, 128), (5, 160 * 1001, 80),
             (3, 160 * 101, 128), (2, 48000, 8), (1, 160 * 97, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,mels", MEL_CASES)
def test_log_mel_kernel_matches_plain(cuda_device, b, n, mels):
    """fp32 on both sides: the kernel's FFT vs cuBLAS's fp32 DFT products;
    on noise every bin is well above the floor, so the JAX tests' 5e-4 after
    the log holds."""
    g = torch.Generator(device=cuda_device).manual_seed(n + mels)
    audio = torch.randn((b, n), generator=g, device=cuda_device) * 0.1
    before = log_mel_spectrogram_fused.launches
    got = log_mel_spectrogram_fused(audio, num_mel_bins=mels)
    assert log_mel_spectrogram_fused.launches == before + 1
    want = log_mel_spectrogram(audio, num_mel_bins=mels)
    assert got.shape == (b, mels, n // 160) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=5e-4, rtol=0)


@pytest.mark.cuda
def test_log_mel_kernel_silence_and_int16(cuda_device):
    """Silence (every bin at the 1e-10 floor, then the max - 8 clamp) and
    int16 PCM cast as is, as the plain mel takes it."""
    silent = torch.zeros((2, 32000), device=cuda_device)
    torch.testing.assert_close(log_mel_spectrogram_fused(silent, 80),
                               log_mel_spectrogram(silent, 80), atol=0, rtol=0)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    pcm = (torch.randn((2, 16000), generator=g, device=cuda_device) * 3000).to(torch.int16)
    torch.testing.assert_close(log_mel_spectrogram_fused(pcm, 128),
                               log_mel_spectrogram(pcm, 128), atol=5e-4, rtol=0)


@pytest.mark.cuda
def test_log_mel_kernel_carries_a_gradient_on_card(cuda_device):
    """LogMel: kernel forward, backward = the plain formula recomputed, so the
    audio's gradient matches autograd through the plain mel (on noise no bin
    sits at the max - 8 clamp, where the two forwards could pick differently)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    audio = (torch.randn((2, 32000), generator=g, device=cuda_device) * 0.1).requires_grad_(True)
    dout = torch.randn((2, 80, 200), generator=g, device=cuda_device)
    before = log_mel_spectrogram_fused.launches
    out = log_mel_spectrogram_fused(audio, num_mel_bins=80)
    assert log_mel_spectrogram_fused.launches == before + 1 and out.requires_grad
    out.backward(dout)
    ref = audio.detach().clone().requires_grad_(True)
    log_mel_spectrogram(ref, 80).backward(dout)
    scale = ref.grad.abs().max().item()
    torch.testing.assert_close(audio.grad, ref.grad, atol=1e-4 * scale, rtol=1e-4)


# ------------------------------------- fp32 and head_dim 16 / 32 on the card


def _fp32_close(name, got, want):
    err = (got.float() - want.float()).abs().max().item()
    limit = FP32_TOL * max(want.float().abs().max().item(), 1.0)
    assert torch.isfinite(got).all(), name
    assert err <= limit, f"{name}: error {err} against the fp32 plain version, limit {limit}"


# (dtype, head_dim) instances each kernel gained: bf16 at 16 and 32, fp32 at all
NEW_INSTANCES = [(torch.bfloat16, 16), (torch.bfloat16, 32)] + \
    [(torch.float32, d) for d in (16, 32, 64, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(dt, d) for dt, d in NEW_INSTANCES if d <= 64])
def test_encoder_kernel_new_instances_match_plain(cuda_device, dtype, d):
    """#1 in fp32 and at head_dim 16/32: output in q's dtype; a fully masked
    row averages the keys uniformly, as the plain version does."""
    b, t, h = 3, 150, 4
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = (torch.randn((b, t, h * d), generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    mask = torch.ones((b, t), dtype=torch.int32, device=cuda_device)
    mask[1, 90:] = 0
    mask[2] = 0
    before = encoder_attention.launches
    got = encoder_attention(q, k, v, mask, h)
    assert encoder_attention.launches == before + 1 and got.dtype == dtype
    want = encoder_attention_plain(q, k, v, mask, h)
    if dtype == torch.float32:
        _fp32_close("encoder_attention", got, want)
    else:
        _close(got, want, torch.ones_like(mask, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype,d", NEW_INSTANCES)
def test_prefill_kernels_new_instances_match_plain(cuda_device, dtype, d, group):
    """#2 (serving launch and with statistics), #2b and #2c in fp32 and at
    head_dim 16/32, every GQA group; fp32 gradients against autograd through
    the fp32 plain version, bf16 ones by the bf16 criterion above."""
    b, t, hkv = 2, 131, 2
    q, k, v, dout, mask = (x.to(dtype) if x.is_floating_point() else x
                           for x in _prefill_inputs(cuda_device, b, t, group * hkv, hkv, d,
                                                    group + d))
    if dtype == torch.float32:  # fp32 values, not bf16 ones widened
        gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + group)
        q, k, v, dout = (torch.randn(x.shape, generator=gen, device=cuda_device)
                         for x in (q, k, v, dout))
    before = (prefill_attention.launches, prefill_attention_bwd_dkv.launches,
              prefill_attention_bwd_dq.launches)
    serve = prefill_attention(q, k, v, mask)
    out, m, l = prefill_attention_forward(q, k, v, mask)
    delta = attention_delta(out, dout)
    dk, dv = prefill_attention_bwd_dkv(q, k, v, mask, dout, m, l, delta)
    dq = prefill_attention_bwd_dq(q, k, v, mask, dout, m, l, delta)
    assert (prefill_attention.launches, prefill_attention_bwd_dkv.launches,
            prefill_attention_bwd_dq.launches) == (before[0] + 2, before[1] + 1, before[2] + 1)
    want_out = prefill_attention_plain(q, k, v, mask)
    valid = torch.ones_like(mask, dtype=torch.bool)
    want = prefill_attention_backward_plain(*(x.float() for x in (q, k, v)), mask, dout.float())
    if dtype == torch.float32:
        _fp32_close("forward", serve, want_out)
        _fp32_close("forward with statistics", out, want_out)
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            _fp32_close(name, got, w)
    else:
        _close(serve, want_out, valid)
        _close(out, want_out, valid)
        ref = prefill_attention_backward_plain(q, k, v, mask, dout)
        for name, got, w, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want, ref):
            _bwd_close(name, got, w, r)


@pytest.mark.cuda
def test_prefill_attention_fp32_autograd_on_card(cuda_device):
    """An fp32 leaf takes the fp32 instances through PrefillAttention."""
    b, t, hq, hkv, d = 2, 70, 4, 2, 16
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=cuda_device)
                     for shape in ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, hq, d)))
    mask = torch.ones((b, t), dtype=torch.int32, device=cuda_device)
    mask[1, 50:] = 0
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = prefill_attention_bwd_dq.launches
    prefill_attention(*leaves, mask).backward(dout)
    assert prefill_attention_bwd_dq.launches == before + 1
    want = prefill_attention_backward_plain(q, k, v, mask, dout)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        _fp32_close(name, leaf.grad, w)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("dtype,d", NEW_INSTANCES)
@pytest.mark.parametrize("b", [1, 2, 48])
def test_decode_kernels_new_instances_match_plain(cuda_device, dtype, d, quantized, group, b):
    """#3 and #4 in fp32 (over an fp32 or an int8 cache) and at head_dim
    16/32, NaN planted at and past kv_len, at the split's edges; the
    appended row is bitwise the plain version's (quantize_kv's bytes and
    scales, or the fresh row)."""
    close = _fp32_close if dtype == torch.float32 else _bf16_close
    _decode_shape_check(cuda_device, b, group, d, dtype, quantized,
                        group * 1000 + d + 7 + (b != 2) * b, close)


# ------------------------------------------------ #9a-#9d, the bench variants


def _variant_inputs(device, b, t, h, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, t, h * 64), generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    mask = torch.ones((b, t), dtype=torch.int32, device=device)
    mask[0, t - 100:] = 0
    mask[-1, t // 2:] = 0
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_encoder_attention_variant_kernel_matches_plain(cuda_device, mode):
    """#9a under every mode against its plain version (the tolerance of
    tools/bench_encoder_attention.py), at hg 2 and 4; its outputs differ
    from its own plain version in few elements and from every other mode's
    (outside its SAME_FUNCTION group) in many."""
    b, t, h = 2, 512, 4
    q, k, v, mask = _variant_inputs(cuda_device, b, t, h, MODES.index(mode))
    plains = {m: encoder_attention_variant_plain(q, k, v, mask, h, m) for m in MODES}
    want = plains[mode]
    for hg in (2, 4):
        before = encoder_attention_variant.launches
        got = encoder_attention_variant(q, k, v, mask, h, mode, hg)
        assert encoder_attention_variant.launches == before + 1
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), atol=bench_encoder_attention.ATOL,
                                   rtol=bench_encoder_attention.RTOL)
        apart = bench_encoder_attention.apart(got, mode, plains, mask.bool()[..., None],
                                              SAME_FUNCTION)
        assert apart["apart"], apart


@pytest.mark.cuda
def test_stress_inputs_tell_the_shifts_apart_on_card(cuda_device):
    """The modes whose shifts cancel on unit-scale scores, each against
    every plain version of its group on scores of std 40."""
    before = encoder_attention_variant.launches
    result = bench_encoder_attention.modes_apart(cuda_device, out=lambda line: None)
    assert encoder_attention_variant.launches == before + len(SAME_FUNCTION[0])
    assert all(r["apart"] for r in result.values()), result


@pytest.mark.cuda
def test_packed2_kernel_is_shift_post_bitwise(cuda_device):
    """Two heads a block (packed2) do each head's shift_post arithmetic."""
    q, k, v, mask = _variant_inputs(cuda_device, 2, 768, 6, 3)
    for hg in (2, 6):
        packed = encoder_attention_variant(q, k, v, mask, 6, "packed2", hg)
        assert torch.equal(packed, encoder_attention_variant(q, k, v, mask, 6, "shift_post", hg))


@pytest.mark.cuda
def test_fp32_variant_is_kernel_1s_function(cuda_device):
    q, k, v, mask = _variant_inputs(cuda_device, 2, 1536, 20, 5)
    got = encoder_attention_variant(q, k, v, mask, 20, "fp32", 10)
    _close(got, encoder_attention(q, k, v, mask, 20), torch.ones_like(mask, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_encoder_attention_variant_kernel_at_the_sweeps_hg(cuda_device, mode):
    """#9a at the tool's sweep of heads a block (hg 4, 10 and 20 of H = 20):
    hg only sets the heads a block walks, so each is the mode's output, and
    packed2 is shift_post bitwise at each."""
    b, t, h = 2, 512, 20
    q, k, v, mask = _variant_inputs(cuda_device, b, t, h, 40 + MODES.index(mode))
    plains = {m: encoder_attention_variant_plain(q, k, v, mask, h, m) for m in MODES}
    outs = []
    for hg in (4, 10, 20):
        got = encoder_attention_variant(q, k, v, mask, h, mode, hg)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), plains[mode].float(),
                                   atol=bench_encoder_attention.ATOL,
                                   rtol=bench_encoder_attention.RTOL)
        apart = bench_encoder_attention.apart(got, mode, plains, mask.bool()[..., None],
                                              SAME_FUNCTION)
        assert apart["apart"], apart
        if mode == "packed2":
            assert torch.equal(got, encoder_attention_variant(q, k, v, mask, h, "shift_post", hg))
        outs.append(got)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_encoder_attention_variant_refuses_misaligned_or_strided(cuda_device):
    """TMA reads 16-byte-aligned, contiguous q/k/v: anything else raises
    before a launch, with no fallback."""
    q, k, v, mask = _variant_inputs(cuda_device, 1, 256, 2, 9)
    before = encoder_attention_variant.launches
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        encoder_attention_variant(shifted, k, v, mask, 2, "fp32", 2)
    with pytest.raises(ValueError, match="contiguous"):
        encoder_attention_variant(q, torch.cat([k, k], 2)[..., ::2], v, mask, 2, "fp32", 2)
    assert encoder_attention_variant.launches == before


# (B, K, N) of the LM head at the bench's batch, a small one, a ragged N
HEAD_SHAPES = [(48, 1024, 151936), (8, 256, 4096), (5, 64, 1040)]


def _head_inputs(device, b, k, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((b, k), generator=g, device=device) * 2).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=device) * 0.02).to(torch.bfloat16)
    w_i8, scale = quantize_weight(w)
    return x, w_i8, scale


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n", HEAD_SHAPES)
def test_wq_matmul_pipe_kernel_matches_plain(cuda_device, b, k, n):
    """#9b within #6's tolerance at each chunk width of the sweep and a
    narrow one."""
    x, w_i8, scale = _head_inputs(cuda_device, b, k, n, n)
    want = wq_matmul_plain(x, w_i8, scale)
    for nc in (8192, 16384, 512):
        before = wq_matmul_pipe.launches
        got = wq_matmul_pipe(x, w_i8, scale, nc)
        assert wq_matmul_pipe.launches == before + 1 and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), atol=WQ_ATOL, rtol=WQ_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n", HEAD_SHAPES + [(17, 1024, 151936), (1, 2048, 4096)])
def test_wq_matmul_pipe_kernel_is_repeatable_and_replays_bitwise(cuda_device, b, k, n):
    """#9b sums in one fixed order (no split, no atomics): two calls and a
    CUDA graph replay on a new x give the same bits as eager calls."""
    x, w_i8, scale = _head_inputs(cuda_device, b, k, n, n + 2)
    first = wq_matmul_pipe(x, w_i8, scale)
    assert torch.equal(first.view(torch.int16), wq_matmul_pipe(x, w_i8, scale, 512).view(torch.int16))
    xg = x.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = wq_matmul_pipe(xg, w_i8, scale)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static.view(torch.int16), first.view(torch.int16))
    xg.copy_(x.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static.view(torch.int16),
                       wq_matmul_pipe(x.flip(0), w_i8, scale).view(torch.int16))


# #9c at the bench shape for every row count its instances take, at ragged N
# (the head's last 128-channel tile part-filled; a narrow product with K split)
# and past 64 rows (two launches)
A8_SHAPES = HEAD_SHAPES + [(b, 1024, 151936) for b in (1, 4, 17, 64)] + [
    (17, 1024, 151936 - 112), (48, 1024, 1040), (64, 1024, 4096), (130, 256, 4112)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n", A8_SHAPES)
def test_a8_kernels_are_plain_bitwise(cuda_device, b, k, n):
    """#9c ([K, N] weight) and #9d ([N, K]) equal their plain versions bit
    for bit: integer sums, the same epilogue order; both launch once per 64
    rows (kinds of the split design) and replay from a CUDA graph on a new x."""
    x, w_i8, scale = _head_inputs(cuda_device, b, k, n, n + 1)
    wt_i8 = w_i8.T.contiguous()
    want = w8a8_matmul_plain(x, wt_i8, scale)  # #5's function
    launches = -(-b // 64)
    for nt in (2048, 4096, 8192, 64):
        before = (a8_matmul.launches, a8t_matmul.launches)
        got_c, got_d = a8_matmul(x, w_i8, scale, nt), a8t_matmul(x, wt_i8, scale, nt)
        assert (a8_matmul.launches, a8t_matmul.launches) == (before[0] + launches,
                                                             before[1] + launches)
        assert torch.equal(got_c, want) and torch.equal(got_d, want)
    for fn, w in ((a8_matmul, w_i8), (a8t_matmul, wt_i8)):
        xg = x.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fn(xg, w, scale)
        xg.copy_(x.flip(0))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static.view(torch.int16),
                           w8a8_matmul_plain(x.flip(0), wt_i8, scale).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlp", "mosa", "moe", "qformer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_projector_output_ignores_requires_grad(cuda_device, kind, dtype):
    """On the card a 3-D activation that does not fold into rows takes a
    batched GEMM when the weight is frozen and one GEMM over a copy when it
    trains, and the two round differently: the projectors keep every
    product's activation contiguous, so a frozen and a trainable projector
    with the same weights give the same bits."""
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.projectors import create_projector

    cfg = tiny_test_config(projector_type=kind)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    proj = create_projector(cfg, dtype=dtype, device=cuda_device)
    x = torch.randn((8, 251, cfg.encoder_dim), generator=gen, device=cuda_device).to(dtype)
    outs = []
    for flag in (True, False, True):
        proj.requires_grad_(flag)
        with torch.no_grad():
            outs.append(proj(x)[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
