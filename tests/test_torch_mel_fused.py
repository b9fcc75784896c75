"""The port's fused log-mel entry point (ops/mel_fused.py) vs the JAX
package's Pallas kernel in interpret mode, on the CPU, at the shapes of
tests/test_mel_pallas.py; and the kernel's constants and frame indexing,
replayed in numpy, against the port's plain mel."""

import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tiny_audio_tpu.ops.mel_pallas import TILE_T, log_mel_spectrogram_pallas
from tiny_audio_tpu_torch.ops import mel as tmel
from tiny_audio_tpu_torch.ops import mel_fused

torch.set_num_threads(1)
HOP = tmel.HOP_LENGTH


@pytest.mark.parametrize(
    "batch,n_samples,mels,silent",
    [
        (2, 16000, 80, False),          # 1 s, whisper-base bins, one partial tile
        (2, 48000, 128, False),         # 3 s, large-v3 bins
        (2, TILE_T * HOP, 128, False),  # exactly one TPU tile
        (2, 480000, 128, False),        # 30 s window
        (1, 32000, 80, True),           # silence: every bin at the floor
        (2, 160, 80, False),            # fewer than 201 samples: constant padding
    ],
)
def test_matches_jax_pallas_kernel(batch, n_samples, mels, silent):
    rng = np.random.default_rng(0)
    if silent:
        audio = np.zeros((batch, n_samples), np.float32)
    else:
        audio = (rng.standard_normal((batch, n_samples)) * 0.1).astype(np.float32)
    want = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(audio), num_mel_bins=mels,
                                                 interpret=True))
    mel_fused.log_mel_spectrogram_fused.launches = 0
    got = mel_fused.log_mel_spectrogram_fused(torch.from_numpy(audio), num_mel_bins=mels)
    assert mel_fused.log_mel_spectrogram_fused.launches == 0  # a CPU tensor launches nothing
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def _table(mels):
    table, band, weights = mel_fused.kernel_constants(mels)
    return table.astype(np.float64) @ np.array([1.0, 1j]), band, weights  # float2 -> complex


def _fft_replay(frames, table):
    """The kernel's transform of frames [..., 400] in float64, step by step:
    z[n] = w[2n] x[2n] + i w[2n + 1] x[2n + 1]; radix-8 DFTs over n1 (n = 25
    n1 + n2) times W200^(n2 k1); 25-point DFTs over n2 as 5 x 5 (n2 = 5 p +
    q: 5-point DFTs over p, times W25^(q r), 5-point DFTs over q), so that
    Z[k1 + 8 (r + 5 s)]; then X[k] = A[k] + W400^k B[k] for k < 200 and
    X[200] = Re Z[0] - Im Z[0].  Every twiddle comes from the table."""
    n1s, n2s = mel_fused.FFT_N1, mel_fused.FFT_N2
    window = table[mel_fused.TAB_WINDOW:mel_fused.TAB_WINDOW + mel_fused.FFT_LEN]
    pairs = frames.reshape(*frames.shape[:-1], mel_fused.FFT_LEN, 2)
    z = window.real * pairs[..., 0] + 1j * window.imag * pairs[..., 1]
    w8 = table[mel_fused.TAB_W8] ** np.arange(8)  # W8^j, j < 8, from W8^1
    dft8 = w8[np.outer(np.arange(8), np.arange(8)) % 8]
    stage = table[mel_fused.TAB_STAGE:mel_fused.TAB_STAGE + 200].reshape(n1s, n2s)  # [k1, n2]
    w25 = table[mel_fused.TAB_W25:mel_fused.TAB_W25 + 25].reshape(5, 5)  # [q, r]
    w5 = np.concatenate([[1.0], table[mel_fused.TAB_W5:mel_fused.TAB_W5 + 2]])
    w5 = np.concatenate([w5, np.conj(w5[2:0:-1])])  # W5^j, j < 5: W5^3, W5^4 conjugate
    w5 = w5[np.outer(np.arange(5), np.arange(5)) % 5]
    v = z.reshape(*z.shape[:-1], n1s, n2s)  # [..., n1, n2]
    y = np.einsum("kn,...nm->...km", dft8, v) * stage  # [..., k1, n2]
    u = y.reshape(*y.shape[:-1], 5, 5)  # [..., k1, p, q]
    u = np.einsum("rp,...pq->...rq", w5, u) * w25.T  # [..., k1, r, q]
    u = np.einsum("sq,...rq->...rs", w5, u)  # [..., k1, r, s]: bin k1 + 8 (r + 5 s)
    zf = np.zeros(z.shape, complex)
    k1, r, s_ = np.meshgrid(np.arange(n1s), np.arange(5), np.arange(5), indexing="ij")
    zf[..., (k1 + n1s * (r + 5 * s_)).ravel()] = u.reshape(*u.shape[:-3], -1)
    k = np.arange(mel_fused.FFT_LEN)
    partner = np.conj(zf[..., (-k) % mel_fused.FFT_LEN])
    a, b = (zf + partner) / 2, (zf - partner) / 2j
    post = table[mel_fused.TAB_POST:mel_fused.TAB_POST + mel_fused.FFT_LEN]
    x = np.concatenate([a + post * b, (zf[..., :1].real - zf[..., :1].imag)], axis=-1)
    return x  # [..., 201]


def _frames(audio):
    padded = tmel.pad_audio(torch.from_numpy(audio)).numpy().astype(np.float64)
    n_frames = audio.shape[1] // HOP
    starts = np.arange(n_frames)[:, None] * HOP + np.arange(tmel.N_FFT)[None, :]
    return padded[:, starts]  # [B, T, 400]: frame t is the 400 samples at t * hop


@pytest.mark.parametrize("mels,n_samples", [
    pytest.param(mels, n, id=f"{mels}{label}") for label, n in (
        ("", 16000 + 7 * HOP), ("-ragged_tile", (3 * mel_fused.FRAME_TILE + 5) * HOP))
    for mels in (80, 128)])
def test_kernel_layout_replayed_in_numpy(mels, n_samples):
    """The kernel's plan in float64: the frame packing, the radix index maps,
    the window and twiddle tables, the real-FFT split and the banded
    filterbank.  The transform against np.fft.rfft of the windowed frames,
    the features against the plain mel at 1e-5 (T = 107 and, in the
    ragged_tile case, 101 frames: neither a multiple of the frame tile)."""
    rng = np.random.default_rng(mels + n_samples)
    audio = (rng.standard_normal((2, n_samples)) * 0.1).astype(np.float32)
    table, band, weights = _table(mels)
    frames = _frames(audio)
    spec = _fft_replay(frames, table)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(tmel.N_FFT) / tmel.N_FFT)
    want_spec = np.fft.rfft(frames * window, axis=-1)
    scale = np.abs(want_spec).max()
    np.testing.assert_allclose(spec, want_spec, rtol=0, atol=1e-6 * scale)
    power = spec.real ** 2 + spec.imag ** 2  # [B, T, 201]
    mel = np.zeros(power.shape[:-1] + (mels,))
    for m, (first, count) in enumerate(band):  # the gather over each mel's band
        mel[..., m] = power[..., first:first + count] @ weights[m, :count].astype(np.float64)
    log_spec = np.log10(np.maximum(mel, 1e-10)).transpose(0, 2, 1)
    got = tmel.normalize_log_spec(torch.from_numpy(log_spec)).numpy()
    want = tmel.log_mel_spectrogram(torch.from_numpy(audio), mels).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mels", range(8, mel_fused.MAX_MELS + 1, 8))
def test_banded_filterbank_is_the_dense_one(mels):
    """Each mel's band (first bin, count, weights) rebuilds the dense fp32
    filterbank [201, mels] exactly: every nonzero weight inside a band,
    nothing past a band's count."""
    _, band, weights = mel_fused.kernel_constants(mels)
    assert band.dtype == np.int32 and weights.dtype == np.float32
    assert weights.shape == (mels, -(-band[:, 1].max() // 4) * 4)  # 16-byte rows
    assert mels * (8 + 4 * weights.shape[1]) <= 4 * (31 * 160 + 400)  # the kernel's audio run
    dense = np.zeros((mel_fused.N_FREQ, mels), np.float32)
    for m, (first, count) in enumerate(band):
        assert 0 <= first and first + count <= mel_fused.N_FREQ
        dense[first:first + count, m] = weights[m, :count]
        assert not weights[m, count:].any()
    assert np.array_equal(dense, tmel.mel_filter_bank(mel_fused.N_FREQ, mels).astype(np.float32))


def test_tables_are_float64_rounded_once():
    """Every table entry is the float64 value rounded to fp32 once: the
    window, W200^(n2 k1), W25^(q r), W400^k, W8 and W5."""
    table = mel_fused.kernel_constants(80)[0]
    assert table.dtype == np.float32 and table.shape == (mel_fused.TAB_LEN, 2)
    n = np.arange(tmel.N_FFT)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * n / tmel.N_FFT)
    assert np.array_equal(table[:200].ravel(), window.astype(np.float32))
    k1, n2 = np.divmod(np.arange(200), 25)
    for offset, size, j in ((mel_fused.TAB_STAGE, 200, k1 * n2),
                            (mel_fused.TAB_W25, 25, (np.arange(25) // 5) * (np.arange(25) % 5)),
                            (mel_fused.TAB_POST, 400, np.arange(200)),
                            (mel_fused.TAB_W8, 8, np.array([1])),
                            (mel_fused.TAB_W5, 5, np.array([1, 2]))):
        ang = -2 * np.pi * j / size
        got = table[offset:offset + len(j)]
        assert np.array_equal(got[:, 0], np.cos(ang).astype(np.float32))
        assert np.array_equal(got[:, 1], np.sin(ang).astype(np.float32))


def test_kernel_literals_are_the_tables():
    """csrc/mel.cu's butterfly constants H, C1, S1, C2, S2 are, as fp32, the
    table's W8^1 = (H, -H), W5^1 = (C1, -S1) and W5^2 = (C2, -S2), and its
    W25 literals the table's W25^(q r)."""
    src = (Path(mel_fused.__file__).resolve().parent.parent / "csrc" / "mel.cu").read_text()
    lit = {name: np.float32(float(value)) for name, value in
           re.findall(r"constexpr float (H|C1|S1|C2|S2) = (-?[0-9.]+)f;", src)}
    table = mel_fused.kernel_constants(80)[0]
    w8, w51, w52 = table[mel_fused.TAB_W8], table[mel_fused.TAB_W5], table[mel_fused.TAB_W5 + 1]
    assert set(lit) == {"H", "C1", "S1", "C2", "S2"}
    assert (lit["H"], -lit["H"]) == tuple(w8)
    assert (lit["C1"], -lit["S1"]) == tuple(w51) and (lit["C2"], -lit["S2"]) == tuple(w52)
    body = src[src.index("float2 W25[17] = {"):]
    w25 = np.array(re.findall(r"\{(-?[0-9.e-]+)f, (-?[0-9.e-]+)f\}", body[:body.index("};")]),
                   np.float64).astype(np.float32)
    assert w25.shape == (17, 2)
    for q in range(1, 5):
        for r in range(1, 5):  # the kernel's W25[q r] is the table's W25^(q r)
            assert tuple(w25[q * r]) == tuple(table[mel_fused.TAB_W25 + 5 * q + r])
