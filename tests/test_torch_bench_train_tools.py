"""The port's training measurement tools against the JAX package, on the CPU.

``tools/bench_train_stages.py`` (``scripts/bench_train_stages.py``): its
stage table is the script's; on the tiny fp32 towers (5 s clips: the tiny
encoder's window is 512 frames) its synthetic batch is the one the JAX
child builds with the JAX processor (ids and labels exactly, features
within ``MEL_ATOL``); for each stage, with the stage's overrides on
``tiny_test_config`` and the JAX parameters carried across, the trainable
count equals the one the JAX child counts from its optimizer labels and the
first step's loss equals JAX ``make_train_step``'s within ``LOSS_RTOL``.
Neither package draws anything in these steps: ``audio_token_dropout`` and
``lora_dropout`` are 0 and the MLP projector has no dropout, so the
generator and the PRNG key are unused.  The parent's subprocess path runs
here with ``--tiny``; a stage that fails gives its error entry and a
non-zero exit.

``tools/bench_host_pipeline.py`` (``scripts/bench_host_pipeline.py``): its
rows are the script's, bitwise; ``batch_iterator`` over its transform and
collator yields the JAX ``batch_iterator``'s batches over the JAX chain
(ids and labels exactly, features within ``MEL_ATOL``) with 0 and 4
workers; a run with ``--device-rate`` prints the script's lines with that
rate and its source.
"""

import importlib.util
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch.bridge import load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.config import compute_encoder_output_length
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.tools import bench_host_pipeline, bench_train_stages

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
#: fp32 log-mel features of the two packages (tests/test_torch_mel.py's limit)
MEL_ATOL = 1e-4
#: a first step's fp32 loss: the same sums in another order (test_torch_train)
LOSS_RTOL = 1e-4
CLIP_S = bench_train_stages.TINY_CLIP_S
RESULT_KEYS = {"stage", "batch", "step_ms", "samples_per_s", "compile_s", "trainable_params_m",
               "loss", "peak_hbm_gb", "hbm_limit_gb"}


def _script(name: str):
    """A JAX script as a module (their module level imports no JAX)."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_stage(overrides: dict):
    """The JAX child's model on the tiny fp32 towers: ``tiny_test_config``
    with the stage's overrides set and ``__post_init__`` run again."""
    cfg = tiny_test_config(model_dtype="float32")
    for key, value in overrides.items():
        setattr(cfg, key, value)
    cfg.__post_init__()
    return JaxASRModel(cfg, seed=0)


def _port_stage(jm, overrides: dict):
    cfg = bench_train_stages.stage_config(
        overrides, PortASRConfig.from_dict(tiny_test_config(model_dtype="float32").to_dict()))
    assert cfg.to_dict() == PortASRConfig.from_dict(jm.config.to_dict()).to_dict()
    tm = ASRModel(cfg, seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return tm


def _jax_child_batch(jm, b: int) -> dict:
    """``scripts/bench_train_stages.py``'s child, lines 86-108, at ``CLIP_S``."""
    cfg = jm.config
    rng = np.random.default_rng(0)
    proc = JaxASRProcessor(jm.tokenizer, projector=jm.projector,
                           num_mel_bins=cfg.encoder.num_mel_bins)
    audio = [(0.1 * rng.standard_normal(int(CLIP_S * 16000))).astype(np.float32)
             for _ in range(b)]
    feats = proc.extract_features(audio)
    n = int(proc.num_audio_tokens(int(feats["mel_lengths"][0])))
    row = np.asarray(
        proc.tokenizer.apply_chat_template(
            proc.build_messages(n, text="the quick brown fox jumps over the dog"),
            tokenize=True, add_generation_prompt=False,
        ),
        np.int32,
    )
    input_ids = np.tile(row, (b, 1))
    lab = np.where(input_ids == proc.tokenizer.pad_token_id, -100, input_ids)
    return {
        "input_ids": jnp.asarray(input_ids),
        "attention_mask": jnp.ones_like(jnp.asarray(input_ids)),
        "labels": jnp.asarray(lab),
        "input_features": jnp.asarray(feats["input_features"]),
        "audio_attention_mask": jnp.asarray(feats["audio_attention_mask"]),
    }


# --------------------------------------------------------- bench_train_stages


def test_stages_are_the_scripts():
    assert bench_train_stages.STAGES == _script("bench_train_stages").STAGES


def test_synthetic_batch_is_the_jax_childs():
    jm = _jax_stage({})
    tm = _port_stage(jm, {})
    b = bench_train_stages.STAGES["stage1_projector"]["batch"]
    want = _jax_child_batch(jm, b)
    got = bench_train_stages.synthetic_batch(tm, b, CLIP_S)
    assert got.keys() == want.keys()
    for key in ("input_ids", "attention_mask", "labels", "audio_attention_mask"):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape and (g == w).all(), key
    # one tiled row holds no padding, so its labels are its ids
    assert torch.equal(got["labels"], got["input_ids"])
    n_frames = int(CLIP_S * 16000) // 160
    assert int((got["input_ids"][0] == tm.tokenizer.audio_token_id).sum()) == int(
        tm.projector.get_output_length(
            compute_encoder_output_length(n_frames, tm.config.encoder_conv_layers)))
    np.testing.assert_allclose(got["input_features"].numpy(), np.asarray(want["input_features"]),
                               atol=MEL_ATOL)


@pytest.mark.parametrize("name", list(bench_train_stages.STAGES))
def test_stage_trainable_count_and_first_loss_match_jax(name):
    """The JAX child's count (leaves whose label is not ``frozen``) and the
    loss of its jitted ``make_train_step``'s first step, against the tool's
    ``stage_step`` on its own batch."""
    from tiny_audio_tpu.train.optim import (
        OptimizerConfig as JaxOpt,
        build_optimizer as jax_build,
        make_train_step as jax_make_train_step,
    )

    spec = bench_train_stages.STAGES[name]
    jm = _jax_stage(spec["overrides"])
    tm = _port_stage(jm, spec["overrides"])
    assert tm.config.audio_token_dropout == 0.0 and tm.config.lora_dropout == 0.0
    tx, labels = jax_build(jm.config, JaxOpt(total_steps=100, decoder_learning_rate=1e-4),
                           jm.params)
    step = jax.jit(jax_make_train_step(jm, tx, labels))
    _, _, want_loss, _, _ = step(jm.params, tx.init(jm.params), _jax_child_batch(jm, spec["batch"]),
                                 jax.random.PRNGKey(0))
    want_trainable = sum(
        pv.size for (_, pv), (_, lv) in zip(jax.tree_util.tree_leaves_with_path(jm.params),
                                            jax.tree_util.tree_leaves_with_path(labels))
        if lv != "frozen")

    train_step, n_trainable = bench_train_stages.stage_step(tm)
    assert n_trainable == want_trainable > 0
    loss, _ = train_step(bench_train_stages.synthetic_batch(tm, spec["batch"], CLIP_S),
                         torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)


def test_parent_runs_each_stage_in_a_child(monkeypatch, capsys):
    """``python -m ...bench_train_stages --device cpu --tiny``: a child per
    stage, each ``RESULT`` with the script's keys, the list printed last."""
    monkeypatch.delenv("TA_STAGE", raising=False)
    bench_train_stages.main(["--device", "cpu", "--tiny"])
    lines = capsys.readouterr().out.strip().splitlines()
    results = json.loads(lines[-1])
    assert [r["stage"] for r in results] == list(bench_train_stages.STAGES)
    for r in results:
        assert set(r) == RESULT_KEYS, r
        assert r["batch"] == 6 and r["step_ms"] > 0 and np.isfinite(r["loss"])
        assert r["peak_hbm_gb"] == r["hbm_limit_gb"] == 0.0
    for name in bench_train_stages.STAGES:
        assert any(ln.startswith(f"[stages] {name}: kernels none (cpu); ") for ln in lines)
    counts = {}
    for name, spec in bench_train_stages.STAGES.items():
        _, counts[name] = bench_train_stages.stage_step(_port_stage(_jax_stage(spec["overrides"]),
                                                                    spec["overrides"]))
    assert [r["trainable_params_m"] for r in results] == [
        round(counts[name] / 1e6, 2) for name in bench_train_stages.STAGES]


def test_a_failed_stage_gives_its_error_entry_and_a_nonzero_exit(monkeypatch, capsys):
    stages = {"stage1_projector": bench_train_stages.STAGES["stage1_projector"],
              "stage9_broken": {"overrides": {"projector_type": "no_such_projector"}, "batch": 2}}
    monkeypatch.setattr(bench_train_stages, "STAGES", stages)
    monkeypatch.setenv("TA_STAGE", "stage")
    with pytest.raises(SystemExit) as exc:
        bench_train_stages.main(["--device", "cpu", "--tiny"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    results = json.loads(out.strip().splitlines()[-1])
    assert results[0]["stage"] == "stage1_projector" and "error" not in results[0]
    assert results[1] == {"stage": "stage9_broken", "error": "rc=1"}
    assert "stage9_broken FAILED (rc=1)" in out and "no_such_projector" in out


def test_the_stage_filter_selects_by_substring(monkeypatch, capsys):
    monkeypatch.setenv("TA_STAGE", "stage2")
    bench_train_stages.main(["--device", "cpu", "--tiny"])
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["stage"] for r in results] == ["stage2_lora"]


def test_the_card_is_the_default():
    """Both tools run on the card unless ``--device cpu`` is asked for: with
    no card they raise instead of falling back to the CPU."""
    assert inspect.signature(bench_train_stages.run_stages).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_train_stages.main([])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_host_pipeline.main(["--device-rate", "1"])


# -------------------------------------------------------- bench_host_pipeline


def test_rows_are_the_scripts():
    script = _script("bench_host_pipeline")
    for n, seconds in ((3, 15.0), (5, 0.5)):
        want, got = script.build_rows(n, seconds), bench_host_pipeline.build_rows(n, seconds)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert g["text"] == w["text"] and g["audio"]["sampling_rate"] == 16000
            assert g["audio"]["array"].dtype == np.float32
            assert g["audio"]["array"].tobytes() == w["audio"]["array"].tobytes()


def _jax_chain():
    """The script's chain in the JAX package (``bench_host_pipeline.py:61-84``)."""
    from tiny_audio_tpu.config import ASRConfig
    from tiny_audio_tpu.models.projectors import create_projector
    from tiny_audio_tpu.tokenization import ByteTokenizer
    from tiny_audio_tpu.train.augmentation import (
        AugmentationPipeline,
        NoiseAugmentation,
        RIRAugmentation,
    )
    from tiny_audio_tpu.train.collator import DataCollator

    cfg = ASRConfig()
    tokenizer = ByteTokenizer(cfg.decoder.vocab_size)
    transform = AugmentationPipeline(rir=RIRAugmentation(p=1.0), noise=NoiseAugmentation(),
                                     silence_injection_prob=0.05)
    collator = DataCollator(tokenizer, create_projector(cfg), num_mel_bins=cfg.encoder.num_mel_bins,
                            system_prompt=cfg.system_prompt)
    return transform, collator


@pytest.mark.parametrize("workers", [0, 4])
def test_pipeline_batches_match_jax(workers):
    from tiny_audio_tpu.train.trainer import batch_iterator as jax_batch_iterator
    from tiny_audio_tpu_torch.train.trainer import batch_iterator

    rows = bench_host_pipeline.build_rows(14, 1.5)
    jt, jc = _jax_chain()
    tt, tc = bench_host_pipeline.build_chain("cpu")
    want = list(jax_batch_iterator(rows, jc, 6, epochs=1, transform=jt, transform_workers=workers))
    got = list(batch_iterator(rows, tc, 6, epochs=1, transform=tt, transform_workers=workers))
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert g.keys() == w.keys()
        for key in ("input_ids", "attention_mask", "labels", "audio_token_counts"):
            assert g[key].dtype == np.asarray(w[key]).dtype, key
            assert g[key].tobytes() == np.asarray(w[key]).tobytes(), key
        assert (g["audio_attention_mask"].numpy() == np.asarray(w["audio_attention_mask"])).all()
        np.testing.assert_allclose(g["input_features"].numpy(), np.asarray(w["input_features"]),
                                   atol=MEL_ATOL)


@pytest.mark.parametrize("rate,verdict", [(1e-6, "OK"), (1e9, "INPUT-BOUND")])
def test_main_prints_the_scripts_lines_against_the_given_rate(capsys, rate, verdict):
    bench_host_pipeline.main(["--rows", "6", "--seconds", "1", "--workers", "2", "--device", "cpu",
                              "--device-rate", str(rate)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "collator device: cpu"
    assert lines[1].startswith("augment: ") and lines[1].endswith(" ms/sample)")
    assert lines[2].startswith("collate: ") and lines[2].endswith(" ms/sample)")
    pipeline = lines[3:]
    assert [ln.split(":")[0] for ln in pipeline] == [f"pipeline workers={w}" for w in (0, 2, 4, 8)]
    for ln in pipeline:
        assert ln.endswith(f" samples/s (device needs {rate} from --device-rate) {verdict}"), ln
        assert float(ln.split(":")[1].split()[0]) > 0


def test_measure_returns_each_rate_and_verdict():
    rows = bench_host_pipeline.build_rows(6, 1.0)
    transform, collator = bench_host_pipeline.build_chain("cpu")
    logged = []
    out = bench_host_pipeline.measure(rows, transform, collator, 6, 0, 1e-6, "given",
                                      log=logged.append)
    assert set(out["pipeline"]) == {0, 4, 8} and len(logged) == 5
    assert out["augment"] > 0 and out["collate"] > 0
    assert all(v["verdict"] == "OK" and v["samples_per_s"] > 0 for v in out["pipeline"].values())


# ------------------------------------------------------- defaults on the card


def test_dryrun_and_init_vadnet_default_to_the_card():
    from tiny_audio_tpu_torch.parallel import dryrun
    from tiny_audio_tpu_torch.tools import train_vad

    assert inspect.signature(dryrun.run).parameters["device"].default == "cuda"
    assert inspect.signature(train_vad.init_vadnet).parameters["device"].default == "cuda"
    net = train_vad.init_vadnet(0, device="cpu")
    assert all(p.device.type == "cpu" for p in net.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_vad.init_vadnet(0)
