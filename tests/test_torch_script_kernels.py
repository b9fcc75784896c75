"""Kernels #9a-#9d: the port's plain versions against the TPU bench scripts'
own Pallas kernels, run in interpret mode on the CPU, and the two bench
entry points of the port at small shapes.

The scripts (``scripts/bench_encoder_attention.py``, ``scripts/bench_wq_head.py``)
are imported from their files and their shape globals set with monkeypatch;
nothing in them is edited.  Inputs are made once with numpy and handed to
both sides as the same bf16 values.
"""

import importlib.util
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
from tiny_audio_tpu_torch.ops.wq_head import w8a8_matmul_plain
from tiny_audio_tpu_torch.ops.wq_head_variants import a8_matmul, a8t_matmul, wq_matmul_pipe
from tiny_audio_tpu_torch.ops.wq_matmul import quantize_weight, wq_matmul_plain
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
