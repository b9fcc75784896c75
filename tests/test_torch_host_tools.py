"""The port's host-side tools against numpy and the JAX package.

- ``native``: the port's own ctypes binding of ``native/ta_audio.cpp``,
  built into ``build/native/<hash>/``: each function against the numpy
  code it stands in for and bitwise against the JAX package's binding of
  the same source; ``TA_DISABLE_NATIVE=1`` and a missing source give None.
  Skipped only where ``g++`` is missing.
- ``utils/subtitles``, ``devtools`` and ``analysis``: the JAX package's
  outputs on the same inputs.
- ``hub.stage_artifact``: the staged checkpoint alone on ``PYTHONPATH``
  imports the staged package and transcribes (with speakers: the staged
  VAD and ECAPA weights) on the CPU in a subprocess, as the repo's package
  does.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from tiny_audio_tpu import native as jax_native
from tiny_audio_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent
SR = 16000
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the library")


def _wav_bytes(audio: np.ndarray, sampwidth: int = 2, channels: int = 1,
               rate: int = SR) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sampwidth)
        w.setframerate(rate)
        scale = 32767 if sampwidth == 2 else 2147483647
        data = (np.clip(audio, -1, 1) * scale).astype(np.int16 if sampwidth == 2 else np.int32)
        if channels > 1:
            data = np.repeat(data[:, None], channels, axis=1)
        w.writeframes(data.tobytes())
    return buf.getvalue()


@needs_gxx
def test_library_builds_into_its_hashed_dir():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.parent == REPO / "build" / "native"
    assert native.build() == path  # a second call reuses the build


@needs_gxx
@pytest.mark.parametrize("sampwidth,channels", [(2, 1), (4, 1), (2, 2)])
def test_wav_decode_is_the_stdlib_and_jaxs(sampwidth, channels):
    audio = np.random.default_rng(0).uniform(-0.5, 0.5, 1000).astype(np.float32)
    data = _wav_bytes(audio, sampwidth, channels)
    out, rate = native.wav_decode(data)
    want, want_rate = jax_native.wav_decode(data)
    assert rate == want_rate == SR
    np.testing.assert_array_equal(out, want)
    with wave.open(io.BytesIO(data), "rb") as w:
        raw = w.readframes(w.getnframes())
    dtype, scale = (np.int16, 32768.0) if sampwidth == 2 else (np.int32, 2147483648.0)
    oracle = np.frombuffer(raw, dtype).astype(np.float32) / scale
    if channels > 1:
        oracle = oracle.reshape(-1, channels).mean(axis=1)
    np.testing.assert_allclose(out, oracle, atol=1e-6)
    assert native.wav_decode(b"not a wav at all") is None


@needs_gxx
def test_read_wav_decodes_natively_as_the_fallback_does(tmp_path, monkeypatch):
    from tiny_audio_tpu_torch.utils.audio_io import read_wav

    audio = (np.sin(np.linspace(0, 10, 500)) * 0.3).astype(np.float32)
    (tmp_path / "x.wav").write_bytes(_wav_bytes(audio))
    calls = []
    real = native.wav_decode
    monkeypatch.setattr(native, "wav_decode", lambda data: calls.append(1) or real(data))
    out, rate = read_wav(tmp_path / "x.wav")
    assert calls and rate == SR
    monkeypatch.setattr(native, "wav_decode", lambda data: None)  # the stdlib path
    fallback, _ = read_wav(tmp_path / "x.wav")
    np.testing.assert_array_equal(out, fallback)


@needs_gxx
@pytest.mark.parametrize("n,orig,target", [(16000, 16000, 8000), (1000, 8000, 16000),
                                           (147, 44100, 24000), (161, 22050, 16000),
                                           (100, 16000, 16000)])
def test_resample_is_jaxs(n, orig, target):
    audio = np.sin(np.arange(n, dtype=np.float32) * 0.05)
    out = native.resample(audio, orig, target)
    np.testing.assert_array_equal(out, jax_native.resample(audio, orig, target))
    assert len(out) == (n * target + orig - 1) // orig


@needs_gxx
def test_fft_convolve_is_numpys_and_jaxs():
    from tiny_audio_tpu_torch.train import augmentation

    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    k = rng.standard_normal(64).astype(np.float32)
    out = native.fft_convolve(a, k)
    np.testing.assert_array_equal(out, jax_native.fft_convolve(a, k))
    oracle = np.convolve(a.astype(np.float64), k.astype(np.float64))[: len(a)]
    np.testing.assert_allclose(out, oracle, atol=1e-3)
    np.testing.assert_array_equal(augmentation._fft_convolve(a, k), out)  # wired in


@needs_gxx
def test_mix_at_snr_is_numpys_and_jaxs():
    from tiny_audio_tpu_torch.train.augmentation import _mix_at_snr

    sig = (0.3 * np.sin(np.linspace(0, 60, 2000))).astype(np.float32)
    noise = np.random.default_rng(0).standard_normal(500).astype(np.float32)
    out = native.mix_at_snr(sig, noise, 12.0)
    np.testing.assert_array_equal(out, jax_native.mix_at_snr(sig, noise, 12.0))
    np.testing.assert_allclose(out, _mix_at_snr(sig, noise, 12.0), atol=1e-4)


@needs_gxx
def test_vad_features_are_numpys_and_jaxs():
    from tiny_audio_tpu_torch import diarization

    rng = np.random.default_rng(0)
    audio = rng.standard_normal(256 * 20).astype(np.float32) * 0.1
    energy, flat = native.vad_features(audio, 256)
    want_e, want_f = jax_native.vad_features(audio, 256)
    np.testing.assert_array_equal(energy, want_e)
    np.testing.assert_array_equal(flat, want_f)
    frames = audio.reshape(20, 256)
    power = (np.abs(np.fft.rfft(frames * np.hanning(256), axis=1)) + 1e-10) ** 2
    np.testing.assert_allclose(energy, 10 * np.log10(np.mean(frames**2, axis=1) + 1e-10),
                               atol=1e-3)
    np.testing.assert_allclose(flat, np.exp(np.mean(np.log(power), axis=1))
                               / np.mean(power, axis=1), atol=1e-3)
    assert native.vad_features(audio[:100], 256)[0].shape == (0,)
    # frame_vad takes the native features, as the JAX package's does
    t = np.arange(SR) / SR
    clip = np.concatenate([np.zeros(SR // 2, np.float32),
                           (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)])
    from tiny_audio_tpu.diarization import frame_vad as jax_frame_vad

    np.testing.assert_array_equal(diarization.frame_vad(clip), jax_frame_vad(clip))


def test_disabled_or_missing_native_returns_none(monkeypatch, tmp_path):
    """``TA_DISABLE_NATIVE=1`` (or no source) keeps every function at None
    and the callers on numpy."""
    from tiny_audio_tpu_torch.utils.audio_io import read_wav

    audio = (np.sin(np.linspace(0, 10, 500)) * 0.3).astype(np.float32)
    data = _wav_bytes(audio)
    for setup in ("env", "no_source"):
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        if setup == "env":
            monkeypatch.setenv("TA_DISABLE_NATIVE", "1")
        else:
            monkeypatch.delenv("TA_DISABLE_NATIVE", raising=False)
            monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
        assert not native.available()
        x = np.ones(64, np.float32)
        assert native.wav_decode(data) is None and native.resample(x, SR, 8000) is None
        assert native.fft_convolve(x, x[:4]) is None and native.mix_at_snr(x, x, 3.0) is None
        assert native.vad_features(x, 16) is None
        out, rate = read_wav(data)
        assert rate == SR and out.shape == (500,)


# ----------------------------------------------------------- subtitles


_WORDS = [
    [],
    [{"word": "hello", "start": 0.0, "end": 0.4}, {"word": "world", "start": 0.5, "end": 0.9}],
    [{"word": f"w{i}", "start": i * 0.3, "end": i * 0.3 + 0.25} for i in range(40)],
    [{"word": "a", "start": 0.0, "end": 0.2}, {"word": " ", "start": 0.2, "end": 0.3},
     {"word": "after", "start": 3.0, "end": 3.4}, {"word": "x" * 50, "start": 3.5, "end": 9.9},
     {"word": "late", "start": 3725.5, "end": 3726.1234}],
]


@pytest.mark.parametrize("index", range(len(_WORDS)))
@pytest.mark.parametrize("kwargs", [{}, {"max_chars": 10, "max_duration_s": 1.0,
                                         "max_gap_s": 0.2}])
def test_subtitles_are_jaxs(index, kwargs):
    from tiny_audio_tpu.utils import subtitles as jax_subtitles
    from tiny_audio_tpu_torch.utils import subtitles

    words = _WORDS[index]
    assert subtitles.to_srt(words, **kwargs) == jax_subtitles.to_srt(words, **kwargs)
    assert subtitles.to_vtt(words, **kwargs) == jax_subtitles.to_vtt(words, **kwargs)


# ----------------------------------------------------------- devtools


_SOURCES = {
    "bad.py": ("import pickle, subprocess, os, yaml, tempfile, torch\n"
               "def used():\n    return eval('1')\n"
               "def unused_helper():\n    pass\n"
               "class Orphan:\n    pass\n"
               "x = pickle.loads(b'')\nsubprocess.run('ls', shell=True)\nos.system('ls')\n"
               "yaml.load('a')\nyaml.load('a', Loader=yaml.SafeLoader)\ntempfile.mktemp()\n"
               "torch.load('f')\ntorch.load('f', weights_only=True)\nexec('pass')\nused()\n"),
    "good.py": '"""Documented."""\n\n\ndef main():\n    """Entry."""\n    return 1\n',
    "broken.py": "def (:\n",
}


def test_devtools_are_jaxs(tmp_path):
    from tiny_audio_tpu import devtools as jax_devtools
    from tiny_audio_tpu_torch import devtools

    for name, src in _SOURCES.items():
        (tmp_path / name).write_text(src)
    assert [str(f) for f in devtools.security_scan([tmp_path])] == \
        [str(f) for f in jax_devtools.security_scan([tmp_path])]
    (tmp_path / "broken.py").unlink()
    ours, theirs = devtools.docstring_coverage([tmp_path]), \
        jax_devtools.docstring_coverage([tmp_path])
    assert ours[0] == theirs[0] and [str(f) for f in ours[1]] == [str(f) for f in theirs[1]]
    assert [str(f) for f in devtools.dead_code([tmp_path])] == \
        [str(f) for f in jax_devtools.dead_code([tmp_path])]
    assert any("unused_helper" in str(f) for f in devtools.dead_code([tmp_path]))


def test_the_ports_package_passes_its_security_scan(tmp_path):
    """A module's ``.eval()`` on a call's result is no builtin ``eval``
    (the JAX package's copy flags it); the builtin still is."""
    from tiny_audio_tpu_torch import devtools

    (tmp_path / "m.py").write_text("net = Net().eval()\nmodel.eval()\neval('1')\n")
    assert [f.line for f in devtools.security_scan([tmp_path])] == [3]
    findings = devtools.security_scan([REPO / "tiny_audio_tpu_torch"])
    assert not findings, [str(f) for f in findings]


# ----------------------------------------------------------- analysis


def _results(path: Path, rows) -> Path:
    blocks = []
    for i, (gt, pred, wer) in enumerate(rows):
        blocks.append(f"Sample {i} - WER: {wer:.2f}%\nGround Truth: {gt}\nPrediction: {pred}\n")
    path.write_text(("-" * 80 + "\n").join(blocks))
    return path


_ROWS_A = [("the cat sat", "the cat sat", 0.0),
           ("pay $5 on may 3 at 8 am", "pay five on may three", 60.0),
           ("twenty percent of ten", "twenty of often", 50.0),
           ("i am here at noon", "", 100.0),
           ("first in 1999", "first in 1999", 0.0)]
_ROWS_B = [("the cat sat", "a cat sat", 33.33),
           ("i am here at noon", "i am here at noon", 0.0),
           ("only in b", "only in b", 0.0)]


def test_analysis_is_jaxs(tmp_path):
    from tiny_audio_tpu import analysis as jax_analysis
    from tiny_audio_tpu_torch import analysis

    a = _results(tmp_path / "a.txt", _ROWS_A)
    b = _results(tmp_path / "b.txt", _ROWS_B)
    assert analysis.parse_results_file(a) == jax_analysis.parse_results_file(a)
    for threshold in (0.0, 50.0, 100.0):
        assert analysis.high_wer(a, threshold) == jax_analysis.high_wer(a, threshold)
    assert analysis.entity_errors(a) == jax_analysis.entity_errors(a)
    assert analysis.compare_models(a, b) == jax_analysis.compare_models(a, b)
    for gt, _, _ in _ROWS_A:
        assert analysis.extract_entities(gt) == jax_analysis.extract_entities(gt)
    (tmp_path / "run1_model_ds").mkdir()
    (tmp_path / "run1_model_ds" / "results.txt").write_text("")
    assert analysis.find_latest_results(str(tmp_path), "model") == \
        jax_analysis.find_latest_results(str(tmp_path), "model")


# ----------------------------------------------------------- hub staging


_STAGED_SCRIPT = r"""
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
import tiny_audio_tpu_torch
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.pipeline import ASRPipeline

ckpt = sys.argv[1]
rng = np.random.default_rng(0)
t = np.arange(3 * 16000) / 16000
audio = (0.3 * np.sin(2 * np.pi * 180 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)
         + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
pipe = ASRPipeline(ASRModel.from_pretrained(ckpt, device="cpu"))
result = pipe(audio, return_speakers=True)
print(json.dumps({"package": tiny_audio_tpu_torch.__file__, "text": result["text"],
                  "segments": result["speaker_segments"],
                  "error": result.get("diarization_error")}))
"""


def test_staged_artifact_imports_and_transcribes_alone(tmp_path):
    from tiny_audio_tpu_torch import hub
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel

    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 8
    ckpt = tmp_path / "ckpt"
    ASRModel(cfg, seed=0, device="cpu").save_pretrained(ckpt)
    hub.stage_artifact(ckpt)
    staged = ckpt / "tiny_audio_tpu_torch"
    for rel in ("kernels.py", "device.py", "bridge.py", "utils/msgpack_io.py",
                "csrc/attention_sm90.cu", "csrc/sm90.cuh", "data/vad_weights.msgpack",
                "data/ecapa_synthetic.msgpack", "models/asr.py", "pipeline.py"):
        assert (staged / rel).is_file(), rel
    assert (ckpt / ".gitattributes").is_file() and (ckpt / "README.md").is_file()
    assert not (staged / "train").exists()  # only what serving reaches

    def run(pythonpath: Path) -> dict:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(pythonpath)
        proc = subprocess.run([sys.executable, "-c", _STAGED_SCRIPT, str(ckpt)],
                              cwd=tmp_path, env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    alone, repo = run(ckpt), run(REPO)
    assert alone["package"].startswith(str(staged))
    assert repo["package"].startswith(str(REPO / "tiny_audio_tpu_torch"))
    assert alone["error"] is None and alone["segments"]
    assert {k: alone[k] for k in ("text", "segments")} == \
        {k: repo[k] for k in ("text", "segments")}


def test_stage_artifact_refuses_a_non_checkpoint(tmp_path):
    from tiny_audio_tpu_torch import hub

    with pytest.raises(FileNotFoundError):
        hub.stage_artifact(tmp_path)
