"""Hydra-style YAML config composition, dependency-free.

The reference composes ``configs/config.yaml`` <- data/training groups <-
``+experiments=`` overlays <- dotted CLI overrides via Hydra/OmegaConf
(the reference's ``configs/config.yaml:44-52``, SURVEY.md §5).  This module
reimplements exactly that composition contract on plain PyYAML:

- ``defaults:`` list in ``config.yaml`` pulls group files
  (``- data: multiasr`` -> ``configs/data/multiasr.yaml`` merged under the
  ``data`` key; ``- training: production`` likewise);
- ``+experiments=<name>`` CLI token deep-merges
  ``configs/experiments/<name>.yaml`` over the composed tree;
- ``a.b.c=value`` CLI tokens override single keys (values YAML-parsed).

Port of :mod:`tiny_audio_tpu.train.config_loader` (the port's own copy).
PyYAML is imported when a file is read, not with the module: a machine
without it imports the training package and fails only here.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Optional, Sequence


def deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive dict merge; overlay wins, nested dicts merge."""
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _yaml():
    try:
        import yaml
    except ImportError as e:  # pragma: no cover - depends on the machine
        raise ImportError("composing configs/ needs PyYAML (pip install pyyaml)") from e
    return yaml


def _load_yaml(path: Path) -> dict:
    data = _yaml().safe_load(path.read_text())
    return data or {}


def set_dotted(cfg: dict, dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"cannot override through non-dict at {k!r}")
    node[keys[-1]] = value


def load_config(
    config_dir: str | Path,
    overrides: Optional[Sequence[str]] = None,
    base_name: str = "config.yaml",
) -> dict:
    """Compose the full config tree from ``config_dir`` + CLI overrides."""
    config_dir = Path(config_dir)
    base = _load_yaml(config_dir / base_name)

    cfg: dict = {}
    for entry in base.pop("defaults", []):
        if entry == "_self_":
            cfg = deep_merge(cfg, base)
            base = {}
            continue
        if not isinstance(entry, dict):
            raise ValueError(f"unsupported defaults entry: {entry!r}")
        (group, name), = entry.items()
        if name is None:
            continue
        group_file = config_dir / group / f"{name}.yaml"
        cfg = deep_merge(cfg, {group: _load_yaml(group_file)})
    cfg = deep_merge(cfg, base)  # config.yaml body wins over group defaults

    # Hydra precedence, independent of CLI argument order: experiment
    # overlays and group swaps apply FIRST, dotted key overrides LAST —
    # `training.max_steps=100 +experiments=transcription` must keep the
    # user's 100, not the experiment file's value (token-order application
    # silently clobbered overrides placed before the overlay).
    parsed = []
    for token in overrides or []:
        if "=" not in token:
            raise ValueError(f"override must be key=value, got {token!r}")
        key, _, raw = token.partition("=")
        value = _yaml().safe_load(raw) if raw != "" else None
        parsed.append((key, value))

    for key, value in parsed:  # pass 1: overlays + group swaps
        if key.startswith("+experiments"):
            exp_file = config_dir / "experiments" / f"{value}.yaml"
            cfg = deep_merge(cfg, _load_yaml(exp_file))
        elif (
            not key.startswith("+")
            and "." not in key
            and isinstance(value, str)
            and (config_dir / key / f"{value}.yaml").is_file()
        ):
            # Hydra-style config-group swap (`data=loquacious`,
            # `training=production`): replace the whole group with that file
            cfg[key] = _load_yaml(config_dir / key / f"{value}.yaml")

    for key, value in parsed:  # pass 2: dotted/scalar overrides win
        if key.startswith("+experiments"):
            continue
        if key.startswith("+"):
            set_dotted(cfg, key[1:], value)
        elif (
            "." not in key
            and isinstance(value, str)
            and (config_dir / key / f"{value}.yaml").is_file()
        ):
            continue  # handled in pass 1
        else:
            set_dotted(cfg, key, value)
    return cfg
