"""Fixtures of the benchmark's tests: a copy of ``perfbench/`` with the tiny
CPU configuration and cells added as files, the only change made to it."""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
REPO = PERFBENCH.parent
TINY = Path(__file__).resolve().parent / "tiny"


@pytest.fixture
def copy(tmp_path, monkeypatch):
    """``tmp_path/perfbench``: the benchmark's files plus ``tests/tiny``'s
    configuration and workloads; ``cell.ROOT`` points at it."""
    from perfbench import cell

    root = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for kind in ("configs", "workloads"):
        for path in (TINY / kind).iterdir():
            shutil.copy(path, root / kind / path.name)
    monkeypatch.setattr(cell, "ROOT", root)
    return root
