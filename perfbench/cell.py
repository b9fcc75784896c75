"""Finding a cell's files by name, and the checks every run makes.

``workloads/<cell>.json`` names its configuration (``configs/<name>.json``)
and its kind of lap (``laps/<lap>.py``); every ``metrics/<metric>.py`` is a
per-layer reader.  Nothing here lists cells, configurations or metrics: a
later change adds one by adding its file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

#: where the files are found (the tests point it at a copy)
ROOT = Path(__file__).resolve().parent
#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tiny_audio_tpu")


def load_workload(name: str) -> dict:
    path = ROOT / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload {name!r} ({path} is missing)")
    spec = json.loads(path.read_text())
    spec["name"] = name
    return spec


def load_config(name: str) -> dict:
    path = ROOT / "configs" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no configuration {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def load_lap(name: str):
    """The module of a kind of lap, ``perfbench.laps.<name>``."""
    return importlib.import_module(f"perfbench.laps.{name}")


def load_metrics() -> dict:
    """Every per-layer reader under ``metrics/``, by metric name (the file's
    name without ``.py``)."""
    readers = {}
    for path in sorted((ROOT / "metrics").glob("*.py")):
        name = path.name[:-3]
        if name.startswith("_"):
            continue
        mod_name = "perfbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        readers[name] = module
    return readers


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``tiny_audio_tpu_torch`` is not ``tiny_audio_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
