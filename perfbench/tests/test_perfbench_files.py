"""Cells, configurations and metrics are found by name from files of their own."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import cell
from perfbench.tests.conftest import PERFBENCH, REPO

BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == workload)
    spec = cell.load_workload(workload)
    assert spec["config"] == entry["config"] and spec["chips"] == entry["chips"]
    assert workload == f"{entry['config']}.{entry['traffic']}"
    config = next(c for c in BENCHMARK["configs"] if c["name"] == entry["config"])
    assert (REPO / config["file"]).resolve() == PERFBENCH / "configs" / f"{entry['config']}.json"
    assert cell.load_config(spec["config"])["reduced"] == config["reduced"]
    lap = cell.load_lap(spec["lap"])
    reported = {m["name"] for m in BENCHMARK["end_to_end"]
                if workload in m.get("workloads", [workload])}
    assert reported == set(lap.END_TO_END)
    for m in BENCHMARK["end_to_end"]:
        if m["name"] in lap.END_TO_END:
            assert m["unit"] == lap.END_TO_END[m["name"]]


def test_every_per_layer_metric_has_its_reader():
    readers = cell.load_metrics()
    assert {m["name"] for m in BENCHMARK["per_layer"]} == set(readers)
    kinds = {w["name"]: cell.load_lap(cell.load_workload(w["name"])["lap"]).END_TO_END
             for w in BENCHMARK["workloads"]}
    for m in BENCHMARK["per_layer"]:
        reader = readers[m["name"]]
        assert (m["layer"], m["unit"], m["better"], m["moves"]) == (
            reader.LAYER, reader.UNIT, reader.BETTER, reader.MOVES)
        for w in m["workloads"]:
            assert m["moves"] in kinds[w]


def test_a_cell_config_and_metric_added_as_files_are_found(copy):
    """The tiny configuration and cells come as new files in the copy; a new
    metric is one more file.  No file that was there is edited."""
    before = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    (copy / "metrics" / "extra_ms.offline.py").write_text(
        'LAYER, UNIT, BETTER, MOVES = "decode loop", "ms", "lower", "rtfx"\n'
        "def read(ctx):\n    return 1.5\n")
    assert cell.load_workload("tiny.serve")["config"] == "tiny"
    assert cell.load_config("tiny")["decoder"]["hidden_size"] == 64
    assert cell.load_metrics()["extra_ms.offline"].read(None) == 1.5
    after = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_import_check_compares_whole_top_level_names():
    found = cell.forbidden_modules(["tiny_audio_tpu", "tiny_audio_tpu.models.asr",
                                    "tiny_audio_tpu_torch", "tiny_audio_tpu_torch.kernels",
                                    "jax", "jaxlib.xla_client", "flax.linen", "jaxtyping",
                                    "flaxen", "numpy"])
    assert found == ["flax.linen", "jax", "jaxlib.xla_client", "tiny_audio_tpu",
                     "tiny_audio_tpu.models.asr"]


def test_a_run_exits_without_a_result_where_only_the_benchmark_is(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/, the
    program is missing: non-zero exit, no result line."""
    import shutil

    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                           BENCHMARK["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                           "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
