"""The port's ``utils/profiling.py`` against the JAX package's.

``StageTimer`` must give the JAX class's ``summary()`` and ``dump()`` for the
same durations (both modules read ``time.perf_counter``, patched here to a
scripted clock); ``trace`` takes JAX's parameters with ``device`` last,
writes a ``torch.profiler`` trace file when asked for the CPU, and raises
without a card.
"""

import inspect
import json
import time

import numpy as np
import pytest
import torch

from tiny_audio_tpu.utils import profiling as jax_profiling
from tiny_audio_tpu_torch.utils import profiling

DURATIONS = {
    "one_stage_once": [("mel", 0.25)],
    "two_stages": [("mel", 0.5), ("decode", 1.5), ("mel", 0.125), ("decode", 3.0),
                   ("decode", 0.75)],
    "odd_count_median": [("prefill", 0.001), ("prefill", 0.004), ("prefill", 0.002)],
    "even_count_median": [("e2e", 2.0), ("e2e", 1.0), ("e2e", 4.0), ("e2e", 3.0)],
}


def _run(module, monkeypatch, stages):
    """``stages`` [(name, seconds)] timed by ``module.StageTimer`` on a
    clock that advances by exactly ``seconds`` inside each stage."""
    now = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    timer = module.StageTimer()
    for name, seconds in stages:
        with timer.stage(name):
            now[0] += seconds
        now[0] += 7.0  # time between stages is not counted
    return timer


@pytest.mark.parametrize("case", list(DURATIONS))
def test_stage_timer_summary_is_the_jax_packages(monkeypatch, case):
    ours = _run(profiling, monkeypatch, DURATIONS[case]).summary()
    theirs = _run(jax_profiling, monkeypatch, DURATIONS[case]).summary()
    assert ours == theirs
    assert list(ours) == list(dict.fromkeys(name for name, _ in DURATIONS[case]))
    for stats in ours.values():
        assert set(stats) == {"count", "total_s", "mean_s", "p50_s", "max_s"}


@pytest.mark.parametrize("case", list(DURATIONS))
def test_stage_timer_dump_is_the_jax_packages(monkeypatch, tmp_path, case):
    _run(profiling, monkeypatch, DURATIONS[case]).dump(tmp_path / "ours.json")
    _run(jax_profiling, monkeypatch, DURATIONS[case]).dump(tmp_path / "theirs.json")
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()


def test_a_stage_that_raises_is_still_timed(monkeypatch):
    for module in (profiling, jax_profiling):
        now = [0.0]
        monkeypatch.setattr(time, "perf_counter", lambda: now[0])
        timer = module.StageTimer()
        with pytest.raises(ValueError):
            with timer.stage("bad"):
                now[0] += 2.0
                raise ValueError("stage failed")
        assert timer.summary()["bad"]["total_s"] == 2.0


def test_trace_signature_is_the_jax_packages_with_device_last():
    ours = list(inspect.signature(profiling.trace).parameters.values())
    theirs = list(inspect.signature(jax_profiling.trace).parameters.values())
    assert [(p.name, p.default) for p in ours[:-1]] == [(p.name, p.default) for p in theirs]
    assert (ours[-1].name, ours[-1].default) == ("device", "cuda")
    assert not hasattr(profiling, "block_until_ready_via_host")


def test_trace_on_the_cpu_writes_a_trace_file(tmp_path):
    log_dir = tmp_path / "traces"
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32))
    with profiling.trace(log_dir, device="cpu"):
        (a @ a).sum()
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    assert not any(e.get("cat") == "kernel" for e in events)


def test_trace_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    log_dir = tmp_path / "traces"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(log_dir):
            pass
    assert not log_dir.exists()
