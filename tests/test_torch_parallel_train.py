"""Multi-GPU training in the port on the CPU: the Trainer over ``(dp, tp)`` grids.

Grids of CPU rank processes (gloo) against the single-device Trainer on the
same global batch (``per_device_batch_size * dp`` rows, the same rows in the
same order), all from the JAX model's initial parameters: a stage-1 step
with the MoE projector at (dp=2, tp=2) and a stage-2 LoRA step at tp = 2 and
tp = 4 (the tiny decoder's 2 KV heads each held by two ranks) give the same
``loss``, ``ce_loss``, ``aux_loss`` and ``grad_norm`` within 1e-5 (relative:
fp32 sums over dp and tp run in another order than one device's), and the
same trained leaves: all but 0.1% of the entries within 1e-6, every entry
within lr / 10 = 1e-4.  (Adam's first step moves an entry by ~lr whatever
its gradient's size, so an entry whose gradient is near 0, where the
rounding of another summation order is a large part of it, moves by a
visibly different fraction of lr; a gradient of the wrong sign would move it
2 lr away.)

The same grid steps are held, at the same tolerances, against the JAX
package's Trainer on the same grid of the 8-device virtual CPU mesh
(``tests/conftest.py``), so that a fault both of the port's paths share (the
dp padding, the router statistics' dp sums, the vocabulary-parallel
cross-entropy) shows.  A checkpoint written under tp is the single-device
one and loads on one device bitwise; the dryrun passes.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tiny_audio_tpu.config import tiny_test_config as jax_tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu_torch.bridge import load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.config import tiny_test_config
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.parallel import mesh as port_mesh
from tiny_audio_tpu_torch.train.collator import DataCollator
from tiny_audio_tpu_torch.train.data import synthetic_dataset
from tiny_audio_tpu_torch.train.optim import OptimizerConfig
from tiny_audio_tpu_torch.train.trainer import Trainer, TrainingConfig
from tiny_audio_tpu_torch.utils import msgpack_io

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
#: relative tolerance of the step's metrics; the trained leaves' bound for
#: all but PARAM_SHARE of their entries, and for every entry
METRIC_RTOL, PARAM_ATOL, PARAM_SHARE, PARAM_MAX = 1e-5, 1e-6, 1e-3, LR / 10
STAGES = {
    "stage1_moe": {"projector_type": "moe"},
    # the router's jitter is drawn from each package's own generator, so
    # the step against the JAX package's runs without it
    "stage1_moe_no_jitter": {"projector_type": "moe", "router_jitter_noise": 0.0},
    "stage2_lora": {"use_lora": True, "lora_rank": 4},
}


@functools.lru_cache(maxsize=None)
def _jax_init(stage: str) -> dict:
    """The JAX model's initial parameters of ``stage`` (numpy leaves)."""
    jm = JaxASRModel(jax_tiny_test_config(model_dtype="float32", **STAGES[stage]), seed=0)
    return jax.tree.map(np.asarray, jm.params)


def _rows():
    return synthetic_dataset(12, seed=0, min_s=0.3, max_s=0.8)


def _run(stage: str, out: Path, dp: int = 1, tp: int = 1, steps: int = 1, **kw):
    """A Trainer run of ``steps`` on a global batch of 4 rows from the JAX
    model's initial parameters; returns (its logged records, the trainer)."""
    cfg = tiny_test_config(model_dtype="float32", **STAGES[stage])
    model = ASRModel(cfg, seed=1, device="cpu")
    load_jax_params(model, _jax_init(stage))
    collator = DataCollator(model.tokenizer, model.projector, num_mel_bins=80, device="cpu")
    config = TrainingConfig(
        output_dir=str(out), max_steps=steps, per_device_batch_size=4 // dp, logging_steps=1,
        save_steps=steps, eval_steps=0, dataloader_workers=0, dp=dp, tp=tp,
        optimizer=OptimizerConfig(learning_rate=LR, lr_scheduler_type="constant"), **kw)
    trainer = Trainer(model, config, _rows(), collator)
    try:
        trainer.train()
    except BaseException:
        trainer.close()
        raise
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    return records, trainer


def _run_jax(stage: str, out: Path, dp: int, tp: int, monkeypatch) -> list:
    """The JAX package's Trainer on the same grid of the virtual CPU mesh
    (its first ``dp * tp`` devices), from the same parameters on the same
    rows: one step on a global batch of 4; returns its logged records."""
    from tiny_audio_tpu.parallel import mesh as jax_mesh
    from tiny_audio_tpu.train import trainer as jtrain
    from tiny_audio_tpu.train.collator import DataCollator as JaxCollator

    make = jax_mesh.make_mesh
    monkeypatch.setattr(jax_mesh, "make_mesh", lambda dp=None, tp=1, devices=None: make(
        dp, tp, devices if devices is not None else jax.devices()[:dp * tp]))
    jm = JaxASRModel(jax_tiny_test_config(model_dtype="float32", **STAGES[stage]), seed=1)
    jm.params = jax.tree.map(jax.numpy.asarray, _jax_init(stage))
    config = jtrain.TrainingConfig(
        output_dir=str(out), max_steps=1, per_device_batch_size=4 // dp, logging_steps=1,
        save_steps=1, eval_steps=0, dataloader_workers=0, dp=dp, tp=tp,
        optimizer=jtrain.OptimizerConfig(learning_rate=LR, lr_scheduler_type="constant"))
    trainer = jtrain.Trainer(jm, config, _rows(),
                             JaxCollator(jm.tokenizer, jm.projector, num_mel_bins=80))
    assert trainer.mesh.shape == {"dp": dp, "tp": tp}
    trainer.train()
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def _leaves(model_dir: Path) -> dict:
    from tiny_audio_tpu_torch.bridge import _flatten

    out = {}
    for name in ("projector.msgpack", "adapter.msgpack"):
        if (model_dir / name).exists():
            out.update({(name, *p): v for p, v in _flatten(msgpack_io.load(model_dir / name))})
    return out


def _check_same_step(one, grid, one_dir, grid_dir):
    assert len(one) == len(grid)
    for a, b in zip(one, grid):
        for key in ("loss", "ce_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(b[key], a[key], rtol=METRIC_RTOL, atol=1e-12, err_msg=key)
    want, got = _leaves(one_dir / "model"), _leaves(grid_dir / "model")
    assert want.keys() == got.keys() and want
    diffs = torch.cat([(torch.as_tensor(got[p]) - torch.as_tensor(want[p])).abs().flatten()
                       for p in want])
    assert float(diffs.max()) <= PARAM_MAX, float(diffs.max())
    assert int((diffs > PARAM_ATOL).sum()) <= PARAM_SHARE * diffs.numel()


def test_stage1_dp2_tp2_step_matches_one_device(tmp_path, monkeypatch):
    """One stage-1 step of the MoE projector at (dp=2, tp=2): each dp rank
    takes 2 of the 4 rows, the router loss reduces its sums over dp, the
    gradients over dp; the experts are split over tp.  It matches the
    port's single-device step, and without the router's jitter the JAX
    package's Trainer at (2, 2)."""
    one, t1 = _run("stage1_moe", tmp_path / "one")
    grid, trainer = _run("stage1_moe", tmp_path / "grid", dp=2, tp=2)
    try:
        assert trainer.mesh.shape == {"dp": 2, "tp": 2}
        assert trainer.model.projector.experts_fc1_kernel.shape[0] == 2
        _check_same_step(one, grid, tmp_path / "one", tmp_path / "grid")
        # an odd batch: 3 rows over dp = 2, the added row carries no labels
        rows = synthetic_dataset(3, seed=1, min_s=0.3, max_s=0.8)
        batch = trainer.collator(rows)
        want = t1._rank.eval_metrics(t1._put_batch(batch))
        got = trainer._rank.eval_metrics(trainer._put_batch(batch))
        assert got["num_label_tokens"] == want["num_label_tokens"]
        for key in ("ce_loss", "aux_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL, err_msg=key)
    finally:
        trainer.close()
    assert port_mesh._ACTIVE is None
    grid, trainer = _run("stage1_moe_no_jitter", tmp_path / "grid0", dp=2, tp=2)
    trainer.close()
    jax_grid = _run_jax("stage1_moe_no_jitter", tmp_path / "jax", 2, 2, monkeypatch)
    _check_same_step(jax_grid, grid, tmp_path / "jax", tmp_path / "grid0")


@pytest.mark.parametrize("tp", [2, 4])
def test_stage2_lora_step_matches_one_device(tmp_path, monkeypatch, tp):
    """One stage-2 step (LoRA on every projection, the decoder frozen) at
    tp = 2 and tp = 4: lora_b splits with column-parallel outputs, lora_a
    with row-parallel inputs; at tp = 4 the KV projections' gradients are
    summed over the ranks that hold their head.  It matches the port's
    single-device step and the JAX package's Trainer at the same tp."""
    one, _ = _run("stage2_lora", tmp_path / "one")
    grid, trainer = _run("stage2_lora", tmp_path / "grid", tp=tp)
    try:
        block = trainer.model.decoder.layers[0]
        assert block.o_proj_lora_a.shape[0] == 64 // tp
        _check_same_step(one, grid, tmp_path / "one", tmp_path / "grid")
        jax_grid = _run_jax("stage2_lora", tmp_path / "jax", 1, tp, monkeypatch)
        _check_same_step(jax_grid, grid, tmp_path / "jax", tmp_path / "grid")
    finally:
        trainer.close()


def test_checkpoint_written_under_tp_loads_on_one_device(tmp_path):
    """A stage-2 run at tp = 2 writes the single-device checkpoint: the
    trainable leaves of state.pt and of model/ are full tensors, model/
    loads on one device bitwise, and a single-device Trainer resumes from
    the grid's state.pt to the grid's parameters and moments."""
    _, trainer = _run("stage2_lora", tmp_path / "grid", tp=2, steps=2)
    try:
        gathered = trainer._rank.checkpoint_state()
    finally:
        trainer.close()
    written = torch.load(tmp_path / "grid" / "checkpoints" / "2" / "state.pt",
                         weights_only=True)
    assert written["step"] == 2
    for name, value in gathered["params"].items():
        assert torch.equal(written["params"][name], value), name
    loaded = ASRModel.from_pretrained(tmp_path / "grid" / "model", device="cpu")
    params = dict(loaded.named_parameters())
    for name, value in written["params"].items():
        assert params[name].shape == value.shape and torch.equal(params[name], value), name

    cfg = tiny_test_config(model_dtype="float32", **STAGES["stage2_lora"])
    collator = DataCollator(loaded.tokenizer, loaded.projector, num_mel_bins=80, device="cpu")
    config = TrainingConfig(output_dir=str(tmp_path / "grid"), max_steps=2,
                            resume_from_checkpoint=True, dataloader_workers=0)
    single = Trainer(ASRModel(cfg, seed=3, device="cpu"), config, [], collator)
    assert single.mesh is None and single._maybe_resume() == 2
    for name, value in written["params"].items():
        assert torch.equal(single.optimizer.params[name].detach(), value), name
    for key in ("mu", "nu"):
        for name, value in written["opt_state"][key].items():
            assert torch.equal(single.optimizer.state[key][name], value), (key, name)


def test_dryrun_on_four_cpu_ranks():
    """``python -m tiny_audio_tpu_torch.parallel.dryrun 4 --device cpu``:
    train, token-exact generate, checkpoint cycle and serving at (2, 2) and
    at tp = 4."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "tiny_audio_tpu_torch.parallel.dryrun", "4", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok = [line for line in proc.stdout.splitlines() if line.startswith("dryrun OK")]
    assert ok == ["dryrun OK: mesh=(dp=2, tp=2) on gloo ['cpu']",
                  "dryrun OK: mesh=(dp=1, tp=4) on gloo ['cpu']"], proc.stdout[-2000:]
    assert proc.stdout.count("ckpt OK") == 2 and proc.stdout.count("serve OK") == 2


def test_trainer_grid_defaults(tmp_path):
    """dp defaults to one on the CPU (the card count over tp on the card, as
    in the JAX package's Trainer), so the default stays one device; a tp
    that does not divide the heads raises before any rank starts."""
    cfg = tiny_test_config(model_dtype="float32")
    model = ASRModel(cfg, seed=0, device="cpu")
    trainer = Trainer(model, TrainingConfig(output_dir=str(tmp_path), dataloader_workers=0),
                      [], None)
    assert trainer.mesh is None
    with pytest.raises(ValueError, match=r"tp=3 does not divide the decoder query heads \(4\)"):
        Trainer(model, dataclasses.replace(trainer.config, tp=3), [], None)
