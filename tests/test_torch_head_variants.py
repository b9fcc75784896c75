"""Kernels #9b and #9d without a card: #9d's split plan (the ``"a8t"`` kind)
and its launches, and #9b's TMA-fed pipe replayed in numpy (its tile walk,
the 128-byte swizzle undone in its reads, the int8 -> bf16 RS fragments and
the epilogue's index map), with the kernel sources held to what is replayed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tiny_audio_tpu_torch import kernels
from tiny_audio_tpu_torch.ops import wq_head_variants as variants
from tiny_audio_tpu_torch.ops.wq_head_variants import (
    PIPE_BOX_K,
    PIPE_MAX_ROWS,
    PIPE_UNIT_N,
    a8t_matmul,
    pipe_plan,
    pipe_tiles,
)
from tiny_audio_tpu_torch.ops.wq_matmul import (
    SPLIT_MAX_ROWS,
    WQ_ATOL,
    WQ_RTOL,
    fills_card,
    int8_split_plan,
    split_units,
    wq_matmul_plain,
)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "tiny_audio_tpu_torch" / "csrc"
HEAD = (1024, 151936)


# ------------------------------------------------ #9d: the "a8t" split plan

@pytest.mark.parametrize("b", [1, 4, 17, 48, 64])
@pytest.mark.parametrize("k,n", [HEAD, (1024, 151936 - 112), (1024, 1040), (256, 4096),
                                 (64, 256), (4096, 16), (384, 4112)])
def test_a8t_plan_covers_every_channel_once(b, k, n):
    """#9d's units (tiles of 32 channel rows x splits of K, the kernel's
    decode) cover every (channel, 32-k stage) of the product exactly once,
    start their splits on 128-k stages, and fill the card at the bench shape
    with one split."""
    plan = int8_split_plan(b, k, n, "a8t")
    assert plan.warps_n == 1 and plan.tile_n == 32 and plan.tile_k == 128
    assert plan.split_k % 128 == 0 and plan.tiles == -(-n // 32)
    cover = np.zeros((n, -(-k // 32)), np.int64)  # (channel, 32-k stage)
    for n0, n1, k0, k1 in split_units(plan, k, n):
        assert k0 % 128 == 0 and n0 % 32 == 0 and n0 < n1 and k0 < k1
        cover[n0:n1, k0 // 32:-(-k1 // 32)] += 1
    assert (cover == 1).all()
    assert (plan.splits > 1) == (plan.scratch > 0) == (plan.counters > 0)
    if (k, n) == HEAD:
        assert plan.splits == 1 and plan.units == 4748 and fills_card(plan)


@pytest.mark.parametrize("b,k,n", [(1, 64, 300), (4, 40, 256), (65, 64, 256), (4, 64, 0),
                                   (0, 64, 256), (4, 24, 32)])
def test_a8t_plan_refuses_what_the_kernel_cannot_take(b, k, n):
    """N or K off a multiple of 16, or more rows than one launch takes."""
    assert int8_split_plan(b, k, n, "a8t") is None


def test_a8t_plan_is_the_w8a8_arrangement_on_given_x():
    """#9d cuts its launches as #5 does (the same [N, K] stage): one warp
    across 32 channels, the same split where #5 takes the shape."""
    for b, k, n in [(48, 1024, 151936), (4, 1024, 2048), (4, 3072, 1024), (64, 256, 4096)]:
        assert int8_split_plan(b, k, n, "a8t") == int8_split_plan(b, k, n, "w8a8")


@pytest.fixture
def recorded(monkeypatch):
    """CPU tensors that report ``is_cuda`` and a kernel library that records
    each launch instead of running it."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "launch", lambda name, device, *args: calls.append((name, args)))
    monkeypatch.setattr(kernels, "_counters", {})
    a8t_matmul.launches = variants.wq_matmul_pipe.launches = 0
    yield calls
    a8t_matmul.launches = variants.wq_matmul_pipe.launches = 0


@pytest.mark.parametrize("b,k,n", [(48, 1024, 151936), (17, 256, 1040), (130, 256, 304),
                                   (4, 3072, 1024)])
def test_a8t_launches_follow_the_plan(recorded, b, k, n):
    """#9d on a CUDA tensor: quantize_act outside the kernel, then one launch
    per 64 rows with the plan's arrangement and split, x_i8 / sx / out
    offset to the launch's rows, scratch and counters only with a split; the
    script's nt changes nothing."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((b, k))).to(torch.bfloat16)
    wt = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    scale = torch.ones(n)
    out = a8t_matmul(x, wt, scale, 2048)
    assert out.shape == (b, n) and out.dtype == torch.bfloat16
    first = [args for name, args in recorded]
    assert {name for name, _ in recorded} == {"ta_a8t_matmul"}
    recorded.clear()
    a8t_matmul(x, wt, scale, 8192)
    assert [args[7:] for _, args in recorded] == [args[7:] for args in first]
    rows = [(r0, min(b, r0 + SPLIT_MAX_ROWS)) for r0 in range(0, b, SPLIT_MAX_ROWS)]
    assert len(first) == len(rows) and a8t_matmul.launches == 2 * len(rows)
    for (r0, r1), args in zip(rows, first):
        plan = int8_split_plan(r1 - r0, k, n, "a8t")
        assert args[7:] == (r1 - r0, k, n, 1, plan.split_k)
        assert args[2:4] == (wt.data_ptr(), scale.data_ptr())
        assert args[1] - first[0][1] == 4 * r0 and args[0] - first[0][0] == k * r0
        assert args[4] - out.data_ptr() == 2 * n * r0
        assert (args[5] != 0) == (args[6] != 0) == (plan.splits > 1)


def test_a8t_is_a_kind_of_the_split_kernel():
    """#9d's entry point launches split_matmul_kernel's A8T kind, whose
    products are #5's (the [N, K] stage, no transposes) on given x_i8 and
    sx (no amax prologue, no cluster), and the first design is gone."""
    src = (CSRC / "int8_matmul.cu").read_text()
    assert "constexpr int A8T = 3;" in src
    assert "a8t_matmul_kernel" not in src and "A8Args" not in src
    entry = src[src.index("int ta_a8t_matmul("):]
    entry = entry[:entry.index("\n}\n")]
    assert "launch_split_design(\n      A8T," in entry
    assert "if (kind == A8T) return launch_rows<A8T, 1>(a, s);" in src
    assert "if constexpr (KIND == W8A8 || KIND == A8T) {" in src  # #5's products
    assert "KIND == W8A8 || KIND == A8T) return row * 128 + ((c ^ ((row & 3) << 1)) * 16)" in src
    assert "constexpr bool GIVEN = KIND == A8 || KIND == A8T;" in src
    assert "if constexpr (KIND == W8A8) {\n    // quantize_act's amax" in src
    assert "if (KIND != W8A8 || a.B <= AMAX_SHARE_ROWS || a.splits == 1)" in src  # no cluster


# ------------------------------------------------- #9b, replayed in numpy
#
# csrc/int8_matmul_variants.cu, wq_pipe_sm90<NB>: persistent blocks walk
# tiles (block i: tiles i, i + grid, ...), the first ``pairs`` of them 256
# channels wide, the rest 128; a tile's weight comes as stages of one or two
# TMA boxes of [64 k rows][128 channel bytes] side by side, the 128-byte
# swizzle putting 16-byte chunk c of row r at chunk c ^ (r % 8); consumer
# warpgroup c (idle on a single tile's unit 1), warp w, lane (g, t) reads
# 32-bit words at its channel bytes col = 128c + 32w + 4g of k rows 16s + 2t
# + {0, 1, 8, 9} (k16 step s of the box) and forms the RS A fragments of its
# two m64 products by i8x2_to_bf16x2: product m, a0 (row g: channel col +
# 2m, k 2t, 2t+1), a1 (row g + 8: channel col + 2m + 1), a2 / a3 the same at
# k 2t + 8, 2t + 9.  x is the K-major B operand in natural k order;
# acc[m][4j + 2h + e] is channel col + 2m + h at batch row 8j + 2t + e.

PRMT_MASKS = (0x007F007F, 0x00800080, 0x43004300)


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm(a, b, sel) on uint32 arrays (selector nibbles < 8)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * j)) & 7] << (8 * j) for j in range(4))


def _bf16_bits_to_f64(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


def _i8x2_to_bf16x2(j, lo, hi):
    """mma_bf16.cuh's i8x2_to_bf16x2<j>: the two bf16 halves as float64
    (low half first), bf16(mag) - bf16(off), exact."""
    two = _byte_perm(lo, hi, j | ((4 + j) << 8))
    mag = (two & PRMT_MASKS[0]) | PRMT_MASKS[2]
    off = (two & PRMT_MASKS[1]) | PRMT_MASKS[2]
    return (_bf16_bits_to_f64(mag & 0xFFFF) - _bf16_bits_to_f64(off & 0xFFFF),
            _bf16_bits_to_f64(mag >> 16) - _bf16_bits_to_f64(off >> 16))


def _pipe_offset(row, col):
    return (col >> 7) * PIPE_BOX_K * 128 + row * 128 + ((((col >> 4) & 7) ^ (row & 7)) << 4) \
        + (col & 15)


def _tma_stage(w_i8, n0, units, k0):
    """The stage the producer's TMA box loads leave in shared memory: box u
    of [64 k rows][128 channels] at (n0 + 128 u, k0), 128-byte swizzle,
    zeros past K and N."""
    k, n = w_i8.shape
    stage = np.zeros(2 * PIPE_BOX_K * 128, np.uint8)
    for u in range(units):
        for r in range(min(PIPE_BOX_K, k - k0)):
            row = np.zeros(128, np.uint8)
            part = w_i8[k0 + r, n0 + 128 * u:n0 + 128 * u + 128].view(np.uint8)
            row[:part.size] = part
            for c in range(8):
                dst = u * PIPE_BOX_K * 128 + r * 128 + ((c ^ (r & 7)) << 4)
                stage[dst:dst + 16] = row[16 * c:16 * c + 16]
    return stage


def _pipe_replay(x, w_i8, plan):
    """The fp32 sums [B, N] of #9b's kernel for ``plan`` as its threads form
    them (float64 here: every term and sum below is exact for integer x),
    and how many fragment elements carried each weight (k, channel)."""
    b, k = x.shape
    n = w_i8.shape[1]
    g, t = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")  # a warp's lanes
    out = np.full((b, n), np.nan)
    seen = np.zeros((k, n), np.int64)
    xp = np.zeros((plan.nb, plan.boxes * PIPE_BOX_K))  # x's boxes: rows past B, k past K zero
    xp[:b, :k] = x
    for tiles in pipe_tiles(plan):
        for n0, units in tiles:
            acc = np.zeros((2, 4, 2, 8, 4, plan.nb // 2))  # [c][w][m][g][t][NB / 2]
            for kb in range(plan.boxes):
                stage = _tma_stage(w_i8, n0, units, kb * PIPE_BOX_K)
                for c in range(units):  # warpgroup c; the other is idle on a single
                    for w in range(4):
                        col = 128 * c + 32 * w + 4 * g
                        a = np.zeros((2, 16, PIPE_BOX_K))  # [m][the warp's 16 M rows][k]
                        for s in range(PIPE_BOX_K // 16):
                            v = []
                            for q in range(4):
                                row = 16 * s + 2 * t + (q & 1) + 8 * (q >> 1)
                                off = _pipe_offset(row, col)
                                v.append(sum(stage[off + i].astype(np.uint32) << (8 * i)
                                             for i in range(4)))
                            for m in range(2):
                                frags = [_i8x2_to_bf16x2(2 * m, v[0], v[1]),
                                         _i8x2_to_bf16x2(2 * m + 1, v[0], v[1]),
                                         _i8x2_to_bf16x2(2 * m, v[2], v[3]),
                                         _i8x2_to_bf16x2(2 * m + 1, v[2], v[3])]
                                for j, (lo, hi) in enumerate(frags):  # the m16n8k16 A layout
                                    kk = 16 * s + 2 * t + 8 * (j >> 1)
                                    a[m, g + 8 * (j & 1), kk] = lo
                                    a[m, g + 8 * (j & 1), kk + 1] = hi
                        for m in range(2):
                            for r_ in range(16):  # M row r_: channel col + 2m + r_ // 8
                                ch = n0 + 128 * c + 32 * w + 4 * (r_ % 8) + 2 * m + r_ // 8
                                kk = kb * PIPE_BOX_K + np.arange(PIPE_BOX_K)
                                if ch < n:
                                    ok = kk < k
                                    assert np.array_equal(a[m, r_, ok], w_i8[kk[ok], ch])
                                    assert not a[m, r_, ~ok].any()
                                    seen[kk[ok], ch] += 1
                            d = a[m] @ xp[:, kb * PIPE_BOX_K:(kb + 1) * PIPE_BOX_K].T  # [16, NB]
                            for j in range(plan.nb // 8):  # accumulator layout of m64nNk16
                                for e in range(4):
                                    acc[c, w, m, :, :, 4 * j + e] += \
                                        d[g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)]
            for c in range(units):
                for w in range(4):
                    col = 128 * c + 32 * w + 4 * g
                    for m in range(2):
                        for j in range(plan.nb // 8):
                            for e in range(2):
                                bb = 8 * j + 2 * t + e
                                for h in range(2):
                                    ch = n0 + col + 2 * m + h
                                    ok = (bb < b) & (ch < n)
                                    assert np.isnan(out[bb[ok], ch[ok]]).all()  # written once
                                    out[bb[ok], ch[ok]] = acc[c, w, m, :, :, 4 * j + 2 * h + e][ok]
    return out, seen


@pytest.mark.parametrize("b,k,n,sms", [(1, 64, 256, 3), (5, 192, 1040, 3), (17, 80, 384, 2),
                                       (48, 128, 640, 2), (3, 64, 1296, 4)])
def test_pipe_replay_is_the_exact_product(b, k, n, sms):
    """#9b's tile walk covers every channel once, its fragments carry every
    weight of the product exactly once (int8 -> bf16 exact, the swizzle
    undone, pair and single tiles), and the epilogue writes every output
    once: on integer x the replayed sums are x @ w exactly, and through the
    fp32 epilogue they are within #6's tolerance of wq_matmul_plain."""
    rng = np.random.default_rng(b * k + n)
    plan = pipe_plan(b, k, n, sms)
    assert plan is not None and plan.grid == min(sms, plan.tiles)
    walked = [t for tiles in pipe_tiles(plan) for t in tiles]
    assert len({n0 for n0, _ in walked}) == plan.tiles and sum(u for _, u in walked) == plan.units
    w_i8 = rng.integers(-127, 128, (k, n), dtype=np.int8)
    xi = rng.integers(-8, 9, (b, k)).astype(np.float64)
    sums, seen = _pipe_replay(xi, w_i8, plan)
    assert (seen == 1).all()
    assert np.array_equal(sums, xi @ w_i8.astype(np.float64))
    scale = torch.from_numpy(rng.uniform(1e-3, 2e-3, n).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, k)) * 2).to(torch.bfloat16)
    got, _ = _pipe_replay(x.double().numpy(), w_i8, plan)
    got = (torch.from_numpy(got).to(torch.float32) * scale).to(torch.bfloat16)
    want = wq_matmul_plain(x, torch.from_numpy(w_i8), scale)
    torch.testing.assert_close(got.float(), want.float(), atol=WQ_ATOL, rtol=WQ_RTOL)


@pytest.mark.parametrize("units", [1, 2, 9, 131, 132, 133, 263, 264, 265, 300, 1187, 2000])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_pipe_tiles_cover_the_channels_evenly(units, sms):
    """Pair tiles first, then singles: every 128-channel unit once, in
    order, and no block takes more than ceil(units / blocks) units (at the
    head: 528 pairs and 131 singles, 9 units a block but one)."""
    plan = pipe_plan(48, 1024, 128 * units, sms)
    blocks = min(units, sms)
    assert plan.grid == min(plan.tiles, sms) and plan.tiles == units - plan.pairs
    per_block = [sum(u for _, u in tiles) for tiles in pipe_tiles(plan)]
    assert max(per_block) == -(-units // blocks) and sum(per_block) == units
    starts = sorted((n0, u) for tiles in pipe_tiles(plan) for n0, u in tiles)
    edge = 0
    for n0, u in starts:
        assert n0 == edge
        edge += 128 * u
    assert edge == 128 * units
    if (units, sms) == (1187, 132):
        assert (plan.pairs, plan.tiles) == (528, 659) and sorted(per_block)[:2] == [8, 9]


def test_pipe_conversion_is_exact_for_every_int8():
    """i8x2_to_bf16x2's mask, OR and subtraction give every int8 exactly,
    from any byte of a 32-bit word."""
    v = np.arange(-128, 128).astype(np.int8).view(np.uint8).astype(np.uint32)
    words = [v | (v[::-1] << 8) | (np.roll(v, 1) << 16) | (np.roll(v, 7) << 24),
             np.roll(v, 3) | (v << 8) | (v[::-1] << 16) | (np.roll(v, 5) << 24)]
    for j in range(4):
        a, b = _i8x2_to_bf16x2(j, *words)
        assert np.array_equal(a, ((words[0] >> (8 * j)) & 0xFF).astype(np.uint8).view(np.int8))
        assert np.array_equal(b, ((words[1] >> (8 * j)) & 0xFF).astype(np.uint8).view(np.int8))


def test_pipe_reads_hit_distinct_banks():
    """A warp's 32-bit reads of one k row pair slot (rows 16s + 2t + p or +
    8) hit 32 distinct banks: no bank conflict."""
    g, t = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    for c in range(2):
        for w in range(4):
            for s in range(4):
                for q in range(4):
                    row = 16 * s + 2 * t + (q & 1) + 8 * (q >> 1)
                    word = _pipe_offset(row, 128 * c + 32 * w + 4 * g) // 4
                    assert len({int(wd) % 32 for wd in word.ravel()}) == 32


@pytest.mark.parametrize("b,k,n", [(48, 1024, 151936), (48, 1664, 4096), (1, 4096, 256),
                                   (16, 64, 16), (33, 1008, 4112)])
def test_pipe_plan_fits_the_card(b, k, n):
    """A block's shared memory (x whole, the ring, the barriers) fits 227
    KB; the ring holds 4-8 stages of 16 KB; one block an SM."""
    plan = pipe_plan(b, k, n)
    nb = 16 if b <= 16 else 32 if b <= 32 else 48
    assert plan.nb == nb and plan.boxes == -(-k // 64) and plan.units == -(-n // 128)
    assert 4 <= plan.stages <= 8 and plan.smem <= 227 * 1024
    assert plan.smem == plan.boxes * nb * 128 + plan.stages * 16384 + 8 * (1 + 2 * plan.stages) \
        + 1024
    assert plan.grid == min(plan.tiles, 132)
    if (b, k, n) == (48, 1024, 151936):
        assert plan.units == 1187 and plan.stages == 8 and plan.smem == 230536


@pytest.mark.parametrize("b,k,n", [(49, 64, 256), (0, 64, 256), (4, 40, 256), (4, 64, 200),
                                   (48, 1680, 256), (4, 64, 0)])
def test_pipe_plan_refuses_what_the_kernel_cannot_take(b, k, n):
    """More than 48 rows, K or N off a multiple of 16, or an x too large to
    stay in shared memory beside 4 stages (K > 1,664 at 48 rows)."""
    assert pipe_plan(b, k, n) is None


def test_pipe_refuses_x_past_shared_memory(recorded):
    """The wrapper raises before any launch where the plan refuses K."""
    x = torch.zeros((48, 1680), dtype=torch.bfloat16)
    w = torch.zeros((1680, 256), dtype=torch.int8)
    with pytest.raises(ValueError, match="shared memory"):
        variants.wq_matmul_pipe(x, w, torch.ones(256), 8192)
    assert recorded == [] and variants.wq_matmul_pipe.launches == 0


@pytest.mark.parametrize("b", [1, 17, 48])
def test_pipe_launches_once_whatever_nc(recorded, b):
    """#9b on a CUDA tensor: one launch of ta_wq_matmul_pipe with the
    tensors' pointers and shapes; nc is passed through and sets nothing."""
    x = torch.zeros((b, 256), dtype=torch.bfloat16)
    w = torch.zeros((256, 1040), dtype=torch.int8)
    scale = torch.ones(1040)
    for nc in (8192, 16384, 32):
        out = variants.wq_matmul_pipe(x, w, scale, nc)
        name, args = recorded[-1]
        assert name == "ta_wq_matmul_pipe" and out.shape == (b, 1040)
        assert args == (x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), b, 256,
                        1040, nc)
    assert variants.wq_matmul_pipe.launches == 3


def _function_body(src: str, signature: str) -> str:
    body = src[src.index(signature):]
    return body[:body.index("\n}\n")]


def test_pipe_kernel_uses_the_replayed_layout():
    """The kernel source schedules, reads, converts and stores as replayed
    above, with the plan's constants."""
    src = (CSRC / "int8_matmul_variants.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert (consts["UNIT_N"], consts["BOX_K"], consts["MAX_STAGES"], consts["MIN_STAGES"],
            consts["SMEM_LIMIT"], consts["MAX_ROWS"], consts["CONSUMERS"]) == \
        (str(PIPE_UNIT_N), str(PIPE_BOX_K), "128 * 1024 / STAGE_BYTES",
         str(variants.PIPE_MIN_STAGES), "227 * 1024", str(PIPE_MAX_ROWS), "2")
    assert "constexpr int STAGE_BYTES = BOX_K * TILE_N;" in src and \
        "constexpr int TILE_N = CONSUMERS * UNIT_N;" in src
    assert variants.PIPE_STAGE_BYTES == 2 * PIPE_BOX_K * PIPE_UNIT_N
    assert "(col >> 7) * BOX_BYTES + row * 128 + ((((col >> 4) & 7) ^ (row & 7)) << 4) + " \
           "(col & 15);" in _function_body(src, "int pipe_offset(")
    frag = _function_body(src, "void box_fragments(")
    assert "const int row = 16 * s + 2 * t + (q & 1) + 8 * (q >> 1);" in frag
    assert "*reinterpret_cast<const uint32_t*>(st + pipe_offset(row, col))" in frag
    assert re.findall(r"fr\[s\]\[(\d)\]\[(\d)\] = i8x2_to_bf16x2<(\d)>\(v\[(\d)\], v\[(\d)\]\)",
                      frag) == [("0", "0", "0", "0", "1"), ("0", "1", "1", "0", "1"),
                                ("0", "2", "0", "2", "3"), ("0", "3", "1", "2", "3"),
                                ("1", "0", "2", "0", "1"), ("1", "1", "3", "0", "1"),
                                ("1", "2", "2", "2", "3"), ("1", "3", "3", "2", "3")]
    assert "const int col = UNIT_N * c + 32 * w + 4 * g;" in src
    assert "const int b = 8 * j + 2 * t + e;" in src
    assert "y[m] = ta::pack_bf16(__fmul_rn(acc[m][4 * j + e], sc[2 * m]),\n" \
           "                                   __fmul_rn(acc[m][4 * j + 2 + e], sc[2 * m + 1]));" \
        in src
    assert "n0 = i < a.pairs ? TILE_N * i : TILE_N * a.pairs + UNIT_N * (i - a.pairs);" in src
    assert "const int pairs = std::min(per_block / 2 * blocks, units / 2);" in src
    assert "for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x)" in src
    assert "sm90::tma_load_2d(ring + slot * STAGE_BYTES + u * BOX_BYTES, &w_map, &full[slot],\n" \
           "                              n0 + u * UNIT_N, kb * BOX_K);" in src
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in (CSRC / "sm90.cuh").read_text()
    helper = _function_body((CSRC / "mma_bf16.cuh").read_text(), "uint32_t i8x2_to_bf16x2(")
    assert "__byte_perm(lo, hi, J | ((4 + J) << 8))" in helper
    assert [int(m, 16) for m in re.findall(r"0x([0-9A-F]{8})u", helper)] == \
        [PRMT_MASKS[0], PRMT_MASKS[2], PRMT_MASKS[1], PRMT_MASKS[2]]
    assert "wq_matmul_pipe_kernel" not in src and "cp_async" not in src
