"""Kernels #9a-#9d: the port's plain versions against the TPU bench scripts'
own Pallas kernels, run in interpret mode on the CPU, and the two bench
entry points of the port at small shapes.

The scripts (``scripts/bench_encoder_attention.py``, ``scripts/bench_wq_head.py``)
are imported from their files and their shape globals set with monkeypatch;
nothing in them is edited.  Inputs are made once with numpy and handed to
both sides as the same bf16 values.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tiny_audio_tpu.ops.wq_matmul import quantize_weight as jax_quantize_weight
from tiny_audio_tpu_torch.ops.encoder_attention_variants import (
    MODES,
    encoder_attention_variant,
    encoder_attention_variant_plain,
)
from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops.wq_head import quantize_act, w8a8_matmul_plain
from tiny_audio_tpu_torch.ops.wq_head_variants import a8_matmul, a8t_matmul, wq_matmul_pipe
from tiny_audio_tpu_torch.ops.wq_matmul import (
    SPLIT_MAX_ROWS,
    fills_card,
    int8_split_plan,
    quantize_weight,
    split_units,
    wq_matmul_plain,
)
from tiny_audio_tpu_torch.tools import bench_encoder_attention, bench_wq_head

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)

# port against the Pallas kernel, per element on real rows: both round to
# bf16 (spacing at most 2**-7 of a value) after fp32 sums taken in other
# orders, so an output may sit one bf16 ulp away (REL); ABS covers outputs
# near zero, where a flipped bf16 rounding of a probability or a product
# term moves the sum by more than its own spacing.
REL, ABS = 2.0**-7, 2.0**-10
# Mode "bf16" only: XLA on the CPU computes with excess precision and elides
# the rounding of exp's bf16 result before the fp32 sum (it keeps the
# rounding of s - m), so the interpreted kernel's probabilities differ from
# the formula's bf16 p by up to 2**-8 of each; their sum over the keys moves
# an output by up to ~2**-9 (measured), hence ABS_BF16_EXP for that mode.
ABS_BF16_EXP = 2.0**-8
# Modes "rcp" and "tilemax_rcp": Pallas interprets pl.reciprocal(approx=True)
# as a reciprocal in bf16 (relative error up to 2**-9), the kernel as
# rcp.approx.ftz.f32 and the plain version exactly; the scaled probabilities
# then round to bf16 differently, which moved outputs by up to 2**-8
# (measured), hence ABS_RCP for those two modes.
ABS_RCP = 2.0**-7
# the encoder shape (B, T, H, D), hg, and the int8 shapes x [8, 256], w [256, 4096]
ENC_SHAPE = (2, 512, 4, 64)
ENC_HG = 2
XB, XK, WN = 8, 256, 4096


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def enc_script():
    return _load("bench_encoder_attention")


@pytest.fixture(scope="module")
def wq_script():
    return _load("bench_wq_head")


def _bf16_pair(x: np.ndarray):
    """The same bf16 values as a torch tensor and a jax array."""
    t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.fixture(scope="module")
def enc_inputs():
    b, t, h, d = ENC_SHAPE
    rng = np.random.default_rng(0)
    q, k, v = (_bf16_pair(rng.standard_normal((b, t, h * d))) for _ in range(3))
    lengths = rng.integers(t // 2, t, b)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.int32)
    return q, k, v, mask


def _close(got: np.ndarray, want: np.ndarray, real: np.ndarray, what: str,
           abs_tol: float = ABS) -> None:
    got, want = got[real], want[real]
    err = np.abs(got - want)
    limit = REL * np.abs(want) + abs_tol
    assert np.all(err <= limit), f"{what}: max error {err.max()} (worst excess {(err - limit).max()})"


@pytest.mark.parametrize("mode", MODES)
def test_variant_plain_matches_the_scripts_pallas_kernel(enc_script, enc_inputs, monkeypatch, mode):
    b, t, h, d = ENC_SHAPE
    for name, value in zip("BTHD", ENC_SHAPE):
        monkeypatch.setattr(enc_script, name, value)
    (qt, qj), (kt, kj), (vt, vj), mask = enc_inputs
    with pltpu.force_tpu_interpret_mode():
        ref = enc_script.build(ENC_HG, mode)(qj, kj, vj, jnp.asarray(mask[:, None, :]))
        ref = np.asarray(jax.device_get(ref).astype(jnp.float32))
    got = encoder_attention_variant(qt, kt, vt, torch.from_numpy(mask), h, mode, ENC_HG)
    real = np.broadcast_to(mask.astype(bool)[..., None], ref.shape)
    abs_tol = {"bf16": ABS_BF16_EXP, "rcp": ABS_RCP, "tilemax_rcp": ABS_RCP}.get(mode, ABS)
    _close(got.float().numpy(), ref, real, mode, abs_tol)


def test_packed2_is_shift_post(enc_inputs):
    """Block-diagonal packing adds exact zeros: packed2's formula is
    shift_post's per head, to the rounding of its 128-wide sums."""
    b, t, h, d = ENC_SHAPE
    (qt, _), (kt, _), (vt, _), mask = enc_inputs
    m = torch.from_numpy(mask)
    packed = encoder_attention_variant_plain(qt, kt, vt, m, h, "packed2")
    post = encoder_attention_variant_plain(qt, kt, vt, m, h, "shift_post")
    real = np.broadcast_to(mask.astype(bool)[..., None], packed.shape)
    _close(packed.float().numpy(), post.float().numpy(), real, "packed2 vs shift_post")
    assert (packed == post).float().mean() > 0.99


# #9a's passes over the keys by mode, in units of one product over all keys
# (S = Q K^T, or P.V): a mode that normalises before P.V needs a
# denominator pass, an exact or 256-row max a max pass; qnorm's K-norm
# pre-pass reads only K.
VARIANT_UNITS = {"shift_post": 2, "packed2": 2, "qnorm_post": 2,
                 "fp32_post": 3, "tilemax_post": 3, "nomax": 3, "shift": 3, "qnorm": 3,
                 "fp32": 4, "bf16": 4, "rcp": 4, "tilemax": 4, "tilemax_rcp": 4}


@pytest.mark.parametrize("mode", MODES)
def test_variant_pass_count(mode):
    from tiny_audio_tpu_torch.ops.encoder_attention_variants import variant_passes, variant_units

    passes = variant_passes(mode)
    assert variant_units(mode) == VARIANT_UNITS[mode]
    assert passes[-1] == "pv" and len(set(passes)) == len(passes)
    assert ("knorm" in passes) == mode.startswith("qnorm")
    assert ("max" in passes) == (mode in ("fp32", "bf16", "rcp", "fp32_post") or
                                 mode.startswith("tilemax"))
    assert ("den" in passes) == (not mode.endswith("_post") and mode != "packed2")
    # the order the kernel runs them in: each needs what the one before gives
    order = ("knorm", "max", "den", "pv")
    assert list(passes) == sorted(passes, key=order.index)


def test_variant_plain_rejects_unknown_mode_and_ragged_tilemax(enc_inputs):
    (qt, _), (kt, _), (vt, _), mask = enc_inputs
    with pytest.raises(ValueError, match="mode"):
        encoder_attention_variant_plain(qt, kt, vt, None, 4, "softmax")
    with pytest.raises(ValueError, match="256"):
        encoder_attention_variant_plain(qt[:, :300], kt[:, :300], vt[:, :300], None, 4,
                                        "tilemax")


@pytest.fixture(scope="module")
def wq_inputs():
    rng = np.random.default_rng(1)
    xt, xj = _bf16_pair(rng.standard_normal((XB, XK)) * 2.0)
    wt, wj = _bf16_pair(rng.standard_normal((XK, WN)) * 0.02)
    w_i8, scale = (np.asarray(a) for a in jax_quantize_weight(wj))
    port_i8, port_scale = quantize_weight(wt)
    assert np.array_equal(port_i8.numpy(), w_i8) and np.array_equal(port_scale.numpy(), scale)
    return (xt, xj), (torch.from_numpy(w_i8.copy()), jnp.asarray(w_i8)), \
        (torch.from_numpy(scale.copy()), jnp.asarray(scale))


def _as_f32(x) -> np.ndarray:
    return np.asarray(jax.device_get(x).astype(jnp.float32))


@pytest.mark.parametrize("nc,nt", [(2048, 512), (4096, 1024)])
def test_pipe_plain_matches_the_scripts_pallas_kernel(wq_script, wq_inputs, nc, nt):
    (xt, xj), (wt, wj), (st, sj) = wq_inputs
    with pltpu.force_tpu_interpret_mode():
        ref = _as_f32(wq_script.build_pipe(nc, nt)(xj, wj, sj))
    got = wq_matmul_pipe(xt, wt, st, nc)  # the port's kernel has no tile width nt
    assert torch.equal(got, wq_matmul_plain(xt, wt, st))
    _close(got.float().numpy(), ref, np.ones(ref.shape, bool), f"pipe nc={nc} nt={nt}")


@pytest.mark.parametrize("nt", [1024, 2048])
def test_a8_plain_is_the_scripts_pallas_kernel_bitwise(wq_script, wq_inputs, nt):
    (xt, xj), (wt, wj), (st, sj) = wq_inputs
    with pltpu.force_tpu_interpret_mode():
        ref = _as_f32(wq_script.build_a8(nt)(xj, wj, sj))
    assert np.array_equal(a8_matmul(xt, wt, st, nt).float().numpy(), ref)


@pytest.mark.parametrize("nt", [1024, 2048])
def test_a8t_plain_is_the_scripts_pallas_kernel_bitwise(wq_script, wq_inputs, nt):
    (xt, xj), (wt, wj), (st, sj) = wq_inputs
    w_t = wt.T.contiguous()
    with pltpu.force_tpu_interpret_mode():
        ref = _as_f32(wq_script.build_a8t(nt)(xj, jnp.asarray(w_t.numpy()), sj))
    got = a8t_matmul(xt, w_t, st, nt)
    assert np.array_equal(got.float().numpy(), ref)
    assert torch.equal(got, w8a8_matmul_plain(xt, w_t, st))  # #5's function
    assert torch.equal(got, a8_matmul(xt, wt, st, nt))  # one function, two layouts


# ------------------------------------- #9c's split design, replayed in numpy
#
# csrc/int8_matmul.cu, split_matmul_kernel<A8, NT, 4, ...>: a unit (a tile of
# 128 channels x a split of K) streams stages of 32 k rows x 128 channel
# bytes, chunk c of row r at r * 128 + 16 (c ^ 2 ((r / 8) % 4)); warp wn,
# lane (g, t) reads the words of rows 8t + q (q < 8) at its 4 channels 32 wn
# + 4g .. + 3 and transposes each 4 x 4 bytes with __byte_perm; MMA tile mt's
# rows g and g + 8 are channels 4g + mt and 4g + 2 + mt; the batch is the
# MMA's 8 columns, its B registers the 8 bytes of x_i8 at k 8t .. 8t + 7.

A8_PRMT = (0x5140, 0x7362, 0x5410, 0x7632)


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm(a, b, sel) on uint32 arrays (selector nibbles < 8)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * j)) & 7] << (8 * j) for j in range(4))


def _transpose4x4(w0, w1, w2, w3):
    lo01, hi01 = _byte_perm(w0, w1, A8_PRMT[0]), _byte_perm(w0, w1, A8_PRMT[1])
    lo23, hi23 = _byte_perm(w2, w3, A8_PRMT[0]), _byte_perm(w2, w3, A8_PRMT[1])
    return [_byte_perm(lo01, lo23, A8_PRMT[2]), _byte_perm(lo01, lo23, A8_PRMT[3]),
            _byte_perm(hi01, hi23, A8_PRMT[2]), _byte_perm(hi01, hi23, A8_PRMT[3])]


def _bytes(words):
    """uint32 words [...] -> their 4 bytes as int8 [..., 4], byte 0 first."""
    return np.stack([((words >> (8 * i)) & 0xFF).astype(np.uint8) for i in range(4)],
                    -1).view(np.int8)


def _a8_replay(x_i8, w_i8, plan):
    """The int32 sums [B, N] of #9c's kernel for ``plan``, as its threads
    form them: stage layout, word loads, byte transposes, MMA fragments."""
    b, k = x_i8.shape
    n = w_i8.shape[1]
    rows = -(-b // 8) * 8
    g, t = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")  # a warp's lanes
    sums = np.zeros((rows, n), np.int64)
    for n0, n1, k0, k1 in split_units(plan, k, n):
        xs = np.zeros((rows, plan.split_k), np.int8)  # the split's x_i8 in shared memory
        xs[:b, :k1 - k0] = x_i8[:, k0:k1]
        for st in range(-(-(k1 - k0) // 32)):
            kb = k0 + 32 * st
            stage = np.zeros(32 * 128, np.uint8)
            for r in range(32):  # 8 copies of 16 bytes a k row, zero past K and N
                for c in range(8):
                    src = np.zeros(16, np.int8)
                    if kb + r < k and n0 + 16 * c < n:
                        src = w_i8[kb + r, n0 + 16 * c:n0 + 16 * c + 16]
                    off = r * 128 + 16 * (c ^ (((r >> 3) & 3) << 1))
                    stage[off:off + 16] = src.view(np.uint8)
            words = stage.view("<u4")
            for wn in range(4):
                wv = [words[((8 * t + q) * 128 + 16 * ((2 * wn + (g >> 2)) ^ (t << 1))
                             + 4 * (g & 3)) // 4].astype(np.int64) for q in range(8)]
                lo, hi = _transpose4x4(*wv[:4]), _transpose4x4(*wv[4:])
                for mt in range(2):
                    regs = [lo[mt], lo[2 + mt], hi[mt], hi[2 + mt]]  # [8 g, 4 t] each
                    a = np.zeros((16, 32), np.int64)  # the MMA's A: rows x logical k
                    for j, reg in enumerate(regs):
                        by = _bytes(reg)  # [g, t, i]
                        for i in range(4):
                            a[(g + 8 * (j & 1)).ravel(), (4 * t + i + 16 * (j >> 1)).ravel()] = \
                                by[..., i].ravel()
                    for nt in range(rows // 8):  # B: x_i8 rows 8 nt + g, k 8t .. 8t + 7
                        bm = np.zeros((32, 8), np.int64)
                        for gg in range(8):
                            for tt in range(4):
                                row = xs[nt * 8 + gg, 32 * st + 8 * tt:32 * st + 8 * tt + 8]
                                bm[4 * tt:4 * tt + 4, gg] = row[:4]  # b0: logical k 4t + i
                                bm[16 + 4 * tt:20 + 4 * tt, gg] = row[4:]  # b1: 16 + 4t + i
                        c = a @ bm  # [16 rows, 8 columns]
                        for e in range(4):  # C element e of lane (g, t) -> (channel, batch row)
                            r_ = g + 8 * (e >> 1)
                            col = 2 * t + (e & 1)
                            ch = n0 + 32 * wn + 4 * g + 2 * (e >> 1) + mt
                            ok = ch < n
                            sums[(nt * 8 + col)[ok], ch[ok]] += c[r_[ok], col[ok]]
    return sums[:b]


@pytest.mark.parametrize("b", [1, 8, 17, 48, 64])
def test_a8_kernel_replay_is_the_plain_version_bitwise(b):
    """#9c's byte transposes and its shared k order, replayed: the int32 sums
    equal the exact product, and after the epilogue (float(acc) * sx * scale,
    fp32, rounded to bf16) the output is w8a8_matmul_plain's bit for bit.  N
    is ragged (the last 128-channel tile holds 16), K splits where the tiles
    are few."""
    k, n = 256, 1040
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal((b, k)) * 2.0).to(torch.bfloat16)
    w_i8, scale = quantize_weight(torch.from_numpy(rng.standard_normal((k, n)) * 0.02))
    x_i8, sx = quantize_act(x)
    plan = int8_split_plan(b, k, n, "a8")
    assert plan.warps_n == 4 and plan.tile_n == 128 and plan.tiles * 128 > n
    sums = _a8_replay(x_i8.numpy(), w_i8.numpy(), plan)
    assert np.array_equal(sums, x_i8.numpy().astype(np.int64) @ w_i8.numpy().astype(np.int64))
    acc = torch.from_numpy(sums.astype(np.int32)).to(torch.float32)
    got = ((acc * sx) * scale[None, :]).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16),
                       w8a8_matmul_plain(x, w_i8.T, scale).view(torch.int16))


def test_a8_kernel_uses_the_replayed_selectors():
    """The kernel's 4 x 4 byte transpose uses the selectors replayed above."""
    src = (REPO / "tiny_audio_tpu_torch" / "csrc" / "int8_matmul.cu").read_text()
    body = src[src.index("void transpose4x4"):src.index("template <int KIND, int NT, int WN, bool SHALLOW>\n__global__")]
    assert [int(v, 16) for v in re.findall(r"0x([0-9a-fA-F]{4})\)", body)] == \
        [A8_PRMT[0], A8_PRMT[1], A8_PRMT[0], A8_PRMT[1]] + [A8_PRMT[2], A8_PRMT[3]] * 2


@pytest.mark.parametrize("b", [1, 4, 17, 48, 64])
@pytest.mark.parametrize("k,n", [(1024, 151936), (1024, 151936 - 112), (1024, 1040),
                                 (256, 4096), (64, 256), (4096, 16)])
def test_a8_plan_covers_every_channel_once(b, k, n):
    """#9c's units (tiles of 128 channels x splits of K, the kernel's
    decode) cover every (channel, k) of the product exactly once, start on
    32-k stages, and fill the card at the bench shape with one split."""
    plan = int8_split_plan(b, k, n, "a8")
    assert plan.warps_n == 4 and plan.tile_n == 128 and plan.tile_k == 32
    assert plan.split_k % 32 == 0 and plan.tiles == -(-n // 128)
    cover = np.zeros((n, -(-k // 32)), np.int64)  # (channel, 32-k stage)
    for n0, n1, k0, k1 in split_units(plan, k, n):
        assert k0 % 32 == 0 and n0 % 128 == 0 and n0 < n1 and k0 < k1
        cover[n0:n1, k0 // 32:-(-k1 // 32)] += 1
    assert (cover == 1).all()
    if (k, n) == (1024, 151936):
        assert plan.splits == 1 and plan.units == 1187 and fills_card(plan)


@pytest.mark.parametrize("b,k,n", [(1, 64, 300), (4, 40, 256), (65, 64, 256), (4, 64, 0)])
def test_a8_plan_refuses_what_the_kernel_cannot_take(b, k, n):
    """N or K off a multiple of 16, or more rows than one launch takes."""
    assert int8_split_plan(b, k, n, "a8") is None


@pytest.fixture
def recorded_a8(monkeypatch):
    """CPU tensors that report ``is_cuda`` and a kernel library that records
    each launch instead of running it."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "launch", lambda name, device, *args: calls.append((name, args)))
    monkeypatch.setattr(kernels, "_counters", {})
    a8_matmul.launches = 0
    yield calls
    a8_matmul.launches = 0


@pytest.mark.parametrize("b,k,n", [(48, 1024, 151936), (17, 256, 1040), (130, 256, 304)])
def test_a8_launches_follow_the_plan(recorded_a8, b, k, n):
    """#9c on a CUDA tensor: quantize_act outside the kernel, then one launch
    per 64 rows with the plan's arrangement and split, x_i8 / sx / out
    offset to the launch's rows, scratch and counters only with a split; the
    script's nt changes nothing."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((b, k))).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    scale = torch.ones(n)
    out = a8_matmul(x, w, scale, 2048)
    assert out.shape == (b, n) and out.dtype == torch.bfloat16
    first = [args for _, args in recorded_a8]
    recorded_a8.clear()
    a8_matmul(x, w, scale, 8192)
    assert [args[7:] for _, args in recorded_a8] == [args[7:] for args in first]
    rows = [(r0, min(b, r0 + SPLIT_MAX_ROWS)) for r0 in range(0, b, SPLIT_MAX_ROWS)]
    assert len(first) == len(rows) and a8_matmul.launches == 2 * len(rows)
    for (r0, r1), args in zip(rows, first):
        plan = int8_split_plan(r1 - r0, k, n, "a8")
        assert args[7:] == (r1 - r0, k, n, 4, plan.split_k)
        assert args[2:4] == (w.data_ptr(), scale.data_ptr())
        assert args[1] - first[0][1] == 4 * r0 and args[0] - first[0][0] == k * r0
        assert args[4] - out.data_ptr() == 2 * n * r0
        assert (args[5] != 0) == (args[6] != 0) == (plan.splits > 1)


def test_script_quantize_act_is_the_ports(wq_script, wq_inputs):
    from tiny_audio_tpu_torch.ops.wq_head import quantize_act

    (xt, xj), _, _ = wq_inputs
    x_i8, sx = wq_script.quantize_act(xj)
    p_i8, p_sx = quantize_act(xt)
    assert np.array_equal(p_i8.numpy(), np.asarray(x_i8))
    assert np.array_equal(p_sx.numpy(), np.asarray(sx))


def test_bench_encoder_attention_entry_point_on_cpu(capsys):
    result = bench_encoder_attention.main(
        ["--device", "cpu", "--batch", "2", "--frames", "256", "--heads", "4", "--hg", "2",
         "--fp32-hg", "4", "--reps", "1", "--oracle-batch", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    names = [f"loop-{m}(hg=2)" for m in MODES] + ["loop-fp32(hg=4)"]
    assert lines[0].startswith("shape B=2 T=256 H=4 D=64") and lines[0].endswith("device=cpu")
    assert [ln.split()[0] for ln in lines[1:1 + len(names)]] == names
    assert all("ms/layer-call" in ln and "fp64 oracle" in ln for ln in lines[1:-1])
    assert lines[-3].startswith("encoder_attention (#1)") and lines[-2].startswith("sdpa")
    assert lines[-1].startswith("fastest: loop-")
    for name in names:  # on the CPU every variant is its plain version
        r = result["variants"][name]
        assert r["within"] and r["finite"] and r["max_abs_err_fp64"] < 1e-2


def test_bench_wq_head_entry_point_on_cpu(capsys):
    result = bench_wq_head.main(
        ["--device", "cpu", "--batch", "8", "--k", "256", "--n", "4096", "--nc", "2048",
         "--a8-nt", "1024", "2048", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    names = ["bf16 dot", "wq shipped (#6)", "w8a8 shipped (#5)", "pipe nc=2048",
             "a8 nt=1024", "a8 nt=2048", "a8t nt=1024", "a8t nt=2048"]
    assert lines[0].startswith("LM-head shape B=8 K=256 N=4096")
    timed, numerics = lines[1:1 + len(names)], lines[1 + len(names):-1]
    assert [ln.split("  ")[0].strip() for ln in timed] == names
    assert all("GB/s int8-bytes" in ln for ln in timed)
    assert len(numerics) == len(names) and all("argmax-agree=" in ln for ln in numerics)
    assert lines[-1].startswith("fastest: ")
    for name in names[1:]:
        r = result["products"][name]
        assert r["within"] and r["finite"] and r["rel_err"] < 0.05 and r["argmax_agree"] == 1.0


def test_bench_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_encoder_attention.main(["--batch", "1", "--frames", "256", "--heads", "2",
                                      "--hg", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_wq_head.main(["--batch", "2", "--k", "64", "--n", "256"])
