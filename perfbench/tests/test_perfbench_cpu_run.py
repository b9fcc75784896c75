"""The whole path on the CPU at the tiny widths through the harness's own
code: sound runs are correct, each fault a cell can have makes ``correct``
false, and the control fails the limits.  The card-only case is ``cuda``."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import cell, control, run, trace


def last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run_cpu(workload: str, capsys, trace_flag: int = 0, seed: int = 2147483701) -> dict:
    assert run.main(["--workload", workload, "--seed", str(seed), "--seconds", "1",
                     "--trace", str(trace_flag), "--device", "cpu"]) == 0
    return last_line(capsys)


@pytest.mark.parametrize("workload,trace_flag", [("tiny.serve", 0), ("tiny.serve", 1),
                                                 ("tiny.train", 0)])
def test_a_sound_run_is_correct_and_names_no_device_metric(copy, capsys, workload, trace_flag):
    result = run_cpu(workload, capsys, trace_flag)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert result["metrics"] == {} and result["device"]["platform"] == "cpu"
    lap = cell.load_lap(cell.load_workload(workload)["lap"])
    if not trace_flag:
        assert set(result["cpu_readings"]) == set(lap.END_TO_END)
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def alter_a_token(monkeypatch):
    from tiny_audio_tpu_torch import generation

    select = generation._select_token

    def altered(logits, gen, generator):
        tok = select(logits, gen, generator).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok

    monkeypatch.setattr(generation, "_select_token", altered)


def leave_state_unchanged(monkeypatch):
    from tiny_audio_tpu_torch.train import optim

    monkeypatch.setattr(optim.GroupedAdamW, "step", lambda self, grads: True)


def drop_half_the_batch(monkeypatch):
    from tiny_audio_tpu_torch.models.asr import ASRModel

    loss = ASRModel.compute_loss

    def half(self, batch, train=True, generator=None):
        n = len(batch["input_ids"])
        return loss(self, {k: v[: n // 2] for k, v in batch.items()}, train, generator)

    monkeypatch.setattr(ASRModel, "compute_loss", half)


@pytest.mark.parametrize("workload,fault", [
    ("tiny.serve", alter_a_token),
    ("tiny.train", leave_state_unchanged),
    ("tiny.train", drop_half_the_batch),
])
def test_a_broken_timed_path_is_not_correct(copy, capsys, monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run_cpu(workload, capsys)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_fails_the_limits(copy, seed):
    """The reference in fp8 put in the program's place, and for training the
    planted half-batch fault, read over the limits; the program under them."""
    for workload, run_seed in (("tiny.serve", control.serve_seed),
                               ("tiny.train", control.train_seed)):
        spec = cell.load_workload(workload)
        limits = spec["check"]["limits"]
        out = run_seed(spec, cell.load_config(spec["config"]), seed, torch.device("cpu"), True)
        assert all(out[name] <= limit for name, limit in limits.items())
        assert any(out[f"control_fp8.{name}"] > limit for name, limit in limits.items())
        if workload == "tiny.train":
            assert any(out[f"fault_half_batch.{name}"] > limit for name, limit in limits.items())


@pytest.mark.cuda
def test_the_recorder_reads_device_events_by_unit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda")
    x = torch.randn(256, 256, device=device)
    rec = trace.Recorder(device)
    rec.start()
    for _ in range(2):
        rec.marker()
        y = x @ x
    rec.stop()
    units = trace.split_units(rec.events())
    assert len(units) == 2 and all(len(u.events) >= 2 for u in units)
    assert 0 < trace.union_s([e for u in units for e in u.events]) <= trace.window_s(units)
    assert np.isfinite(float(y.sum()))
