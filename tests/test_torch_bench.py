"""The port's bench (``tiny_audio_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU.

On the tiny fp32 towers with an int8 KV cache: the int16 batch is bitwise
the JAX bench's draw; the int16 front end computes what the JAX bench's
jitted front end computes (features within ``MEL_ATOL``, the frame mask
equal); a lap's tokens, the latency clip's tokens and the first streamed
token equal the JAX package's ``generate`` and ``stream_generate`` on the
same input (the splice within ``EMBED_TOL``); ``measure`` returns the JAX
bench's line, keys read from ``bench.py`` itself; ``main`` reads the JAX
bench's four environment variables; without a card the module refuses and
prints no line, and it imports with jax and the JAX package blocked.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_audio_tpu import generation as jax_generation
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.ops import mel as jax_mel
from tiny_audio_tpu_torch import bench
from tiny_audio_tpu_torch import config as port_config
from tiny_audio_tpu_torch.models.asr import ASRModel

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
#: fp32 log-mel features of the two packages (tests/test_torch_mel.py's limit)
MEL_ATOL = 1e-4
#: fp32 prefill embeddings after the tiny encoder, projector and splice
EMBED_TOL = 1e-4
#: the tiny towers' clips: the encoder's window is 512 mel frames
CLIP_S, LATENCY_S = 5.0, 2.0
BATCH = 2
NEW_TOKENS = 8


@pytest.fixture(scope="module")
def models():
    """The JAX model (seed 2: its tiny towers print text) and the port's
    built from its params, int8 KV, fp32."""
    cfg = tiny_test_config(model_dtype="float32", kv_cache_dtype="int8")
    cfg.max_new_tokens = NEW_TOKENS
    jm = JaxASRModel(cfg, seed=2)
    tm = ASRModel(port_config.ASRConfig.from_dict(cfg.to_dict()),
                  params=jax.tree.map(np.asarray, jm.params), device="cpu")
    return jm, tm


def _jax_frontend(jm, pcm: np.ndarray):
    """The JAX bench's jitted front end (``bench.py:164-169``) on ``pcm``."""
    n_frames = pcm.shape[1] // jax_mel.HOP_LENGTH
    audio = jnp.asarray(pcm).astype(jnp.float32) / 32768.0
    feats = jax_mel.log_mel_spectrogram(audio, num_mel_bins=jm.config.encoder.num_mel_bins)
    lengths = jnp.asarray(np.full((pcm.shape[0],), pcm.shape[1]))
    return feats, jax_mel.frame_attention_mask(lengths, n_frames), n_frames


def _port_inputs(pcm: np.ndarray):
    lengths, n_frames = bench.frame_inputs(pcm.shape[0], pcm.shape[1], "cpu")
    return torch.from_numpy(pcm), lengths, n_frames


def _jax_bench_line_keys() -> tuple[list, list]:
    """The keys of the ``result`` dict that ``bench.py``'s ``main`` prints,
    and of its ``extra``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result":
            top = [k.value for k in node.value.keys]
            extra = node.value.values[top.index("extra")]
            return top, [k.value for k in extra.keys]
    raise AssertionError("bench.py has no result dict")


def test_pcm_batch_is_the_jax_benchs_draw():
    n_samples = int(CLIP_S * 16000)
    rng = np.random.default_rng(0)
    want = (np.clip(rng.standard_normal((3, n_samples)) * 0.1, -1, 1) * 32767).astype(np.int16)
    got = bench.pcm_batch(3, CLIP_S)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert bench.pcm_batch(1, 30.0).shape == (1, 480000)


def test_int16_frontend_is_the_jax_benchs(models):
    jm, tm = models
    pcm = bench.pcm_batch(BATCH, CLIP_S)
    feats_j, mask_j, n_frames = _jax_frontend(jm, pcm)
    pcm_t, lengths, frames = _port_inputs(pcm)
    assert frames == n_frames == int(CLIP_S * 16000) // jax_mel.HOP_LENGTH
    feats, mask = bench.frontend(tm, pcm_t, lengths, frames)
    assert pcm_t.dtype == torch.int16
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_j), rtol=0, atol=MEL_ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "module"])
def test_lap_tokens_equal_jax_generate(models, fused):
    jm, tm = models
    pcm = bench.pcm_batch(BATCH, CLIP_S)
    feats_j, mask_j, n_frames = _jax_frontend(jm, pcm)
    want = np.asarray(jm.generate(feats_j, mask_j, mel_length=n_frames))
    got = bench.transcribe(tm, *_port_inputs(pcm), fused_decode=fused)
    assert got.shape == (BATCH, NEW_TOKENS)
    np.testing.assert_array_equal(got, want)


def test_latency_clip_tokens_equal_jax_generate(models):
    jm, tm = models
    clip = bench.pcm_batch(BATCH, CLIP_S)[:1, :int(LATENCY_S * 16000)]
    feats_j, mask_j, n_frames = _jax_frontend(jm, clip)
    want = np.asarray(jm.generate(feats_j, mask_j, mel_length=n_frames))
    got = bench.transcribe(tm, *_port_inputs(clip))
    assert got.shape == (1, NEW_TOKENS)
    np.testing.assert_array_equal(got, want)


def test_streaming_prompt_splice_and_first_token_equal_jax(models):
    jm, tm = models
    clip = bench.pcm_batch(BATCH, CLIP_S)[:1, :int(LATENCY_S * 16000)]
    feats_j, mask_j, n_frames = _jax_frontend(jm, clip)
    ids = jm.build_prompt_ids(jm._num_audio_tokens(n_frames))
    input_ids = bench.stream_prompt(tm, n_frames)
    assert input_ids.shape == (1, len(ids))  # unpadded
    assert input_ids[0].tolist() == list(ids)
    ids_j = jnp.asarray(np.array(ids, np.int32)[None, :])
    embeds_j = jm._splice_embeds_jit(jm.params, feats_j, mask_j, ids_j)
    with torch.inference_mode():
        embeds = tm._splice_embeds(torch.from_numpy(np.array(feats_j)),
                                   torch.from_numpy(np.array(mask_j)), input_ids)
    np.testing.assert_allclose(embeds.numpy(), np.asarray(embeds_j), rtol=EMBED_TOL,
                               atol=EMBED_TOL)
    want = next(jax_generation.stream_generate(jm.decoder, jm.decoder_variables(), embeds_j,
                                               ids_j, jm.gen_config))
    seconds, got = bench.first_token(tm, *_port_inputs(clip))
    assert seconds > 0
    assert got == int(want)


def _line_consistent(line: dict, clip_s: float) -> None:
    """``value`` is ``batch * clip_s / wall`` for a wall that rounds to
    ``wall_s_per_batch`` (3 decimals), itself rounded to 2; ``vs_baseline``
    is the same rtfx / 100 rounded to 3 decimals, as the JAX bench computes
    it (so within 5e-4 + 5e-5 of ``value / 100``)."""
    extra = line["extra"]
    audio_s = extra["batch"] * clip_s
    wall = extra["wall_s_per_batch"]
    lo, hi = audio_s / (wall + 5e-4), audio_s / max(wall - 5e-4, 1e-9)
    assert lo - 5e-3 <= line["value"] <= hi + 5e-3
    assert abs(line["vs_baseline"] - line["value"] / 100) <= 5e-4 + 5e-5 + 1e-12


def test_measure_returns_the_jax_benchs_line(models):
    _, tm = models
    logged = []
    line = bench.measure(tm, BATCH, clip_s=CLIP_S, latency_s=LATENCY_S, iters=1, reps=1,
                         init_s=1.25, log=logged.append)
    top, extra = _jax_bench_line_keys()
    assert list(line) == top
    assert list(line["extra"]) == extra
    assert line["metric"] == f"rtfx_e2e_{CLIP_S:g}s_b{BATCH}_decode{NEW_TOKENS}"
    assert line["unit"] == "audio_s/s/chip"
    assert line["value"] > 0
    _line_consistent(line, CLIP_S)
    e = line["extra"]
    assert (e["batch"], e["init_s"], e["kv_cache_dtype"], e["wq_decode"], e["backend"]) == \
        (BATCH, 1.2, "int8", False, "cpu")
    assert e["p50_utterance_latency_s"] > 0 and e["streaming_ttfb_s"] >= 0
    assert e["warmup_total_s"] >= e["compile_s"] >= 0
    json.dumps(line)
    # CPU tensors take the plain versions: the launches line counts none
    assert len(logged) == 1 and logged[0].startswith("launches ")
    counts = json.loads(logged[0][len("launches "):])
    assert list(counts) == ["laps", "latency", "stream"]
    assert all(set(c) == set(bench.PATH_KERNELS) and not any(c.values())
               for c in counts.values())


def test_the_line_follows_the_jax_metric_name():
    """At the defaults the metric is the JAX bench's name."""
    assert f"rtfx_e2e_{bench.CLIP_S:g}s_b48_decode128" == "rtfx_e2e_30s_b48_decode128"
    assert (bench.ITERS, bench.REPS, bench.LATENCY_S) == (5, 5, 10.0)
    assert port_config.ASRConfig().max_new_tokens == 128


ENV_CASES = {
    "defaults": ({}, {"batch": 48, "kv_cache_dtype": "int8", "wq_decode": False}, []),
    "bf16_kv": ({"TA_BENCH_KV": "bfloat16", "TA_BENCH_BATCH": "2"},
                {"batch": 2, "kv_cache_dtype": "bfloat16", "wq_decode": False}, []),
    "wq": ({"TA_WQ_DECODE": "1", "TA_BENCH_BATCH": "2"},
           {"batch": 2, "kv_cache_dtype": "int8", "wq_decode": True}, ["enable_wq_decode"]),
    "w8a8": ({"TA_W8A8_DECODE": "1", "TA_BENCH_BATCH": "2"},
             {"batch": 2, "kv_cache_dtype": "int8", "wq_decode": True}, ["enable_w8a8_decode"]),
    "batch": ({"TA_BENCH_BATCH": "3"},
              {"batch": 3, "kv_cache_dtype": "int8", "wq_decode": False}, []),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_main_reads_the_jax_benchs_environment(monkeypatch, capsys, case):
    """``main`` on the tiny towers (the flagship's config swapped for them,
    short clips, one lap): each variable acts as in the JAX bench."""
    env, want, enabled = ENV_CASES[case]
    for name in ("TA_BENCH_KV", "TA_BENCH_BATCH", "TA_WQ_DECODE", "TA_W8A8_DECODE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)

    def tiny():
        cfg = port_config.tiny_test_config(model_dtype="float32")
        cfg.max_new_tokens = NEW_TOKENS
        return cfg

    monkeypatch.setattr(bench, "ASRConfig", tiny)
    monkeypatch.setattr(bench, "CLIP_S", 2.0)
    monkeypatch.setattr(bench, "LATENCY_S", 1.0)
    monkeypatch.setattr(bench, "ITERS", 1)
    monkeypatch.setattr(bench, "REPS", 1)
    calls = []
    for mode in ("enable_wq_decode", "enable_w8a8_decode"):
        real = getattr(ASRModel, mode)

        def spy(self, _real=real, _mode=mode):
            _real(self)
            calls.append((_mode, sorted(self.wq)))

        monkeypatch.setattr(ASRModel, mode, spy)
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("launches ") and len(lines) == 2
    line = json.loads(lines[-1])
    assert {k: line["extra"][k] for k in want} == want
    assert line["metric"] == f"rtfx_e2e_2s_b{want['batch']}_decode{NEW_TOKENS}"
    assert [mode for mode, _ in calls] == enabled
    for mode, keys in calls:  # the int8 weights each mode installs
        assert keys == {"enable_wq_decode": ["head_i8", "head_scale", "layers"],
                        "enable_w8a8_decode": ["head_t_i8", "head_w8a8_scale", "layers"]}[mode]


def test_main_takes_no_option_but_the_device(capsys):
    with pytest.raises(SystemExit):
        bench.main(["--batch", "4"])
    assert "--device" in capsys.readouterr().err


def test_module_without_a_card_refuses_and_prints_no_line():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "tiny_audio_tpu_torch.bench"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not any(ln.lstrip().startswith("{") for ln in proc.stdout.splitlines())
    assert "value" not in proc.stdout


_NO_JAX_SCRIPT = r"""
import sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "tiny_audio_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, BlockJax())
import torch
from tiny_audio_tpu_torch import bench
from tiny_audio_tpu_torch.config import tiny_test_config
from tiny_audio_tpu_torch.models.asr import ASRModel

torch.set_num_threads(1)
cfg = tiny_test_config(kv_cache_dtype="int8")
cfg.max_new_tokens = 4
line = bench.measure(ASRModel(cfg, seed=0, device="cpu"), 1, clip_s=1.0, latency_s=0.5,
                     iters=1, reps=1)
assert line["value"] > 0 and line["extra"]["backend"] == "cpu", line
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "tiny_audio_tpu")]
print("OK")
"""


def test_bench_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
