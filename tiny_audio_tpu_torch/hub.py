"""A code-carrying checkpoint: the port's runtime staged beside the weights.

Port of :func:`tiny_audio_tpu.hub.stage_artifact` (the reference's
self-contained artifact: a checkpoint carries the source it runs on).
:func:`stage_artifact` copies the port's runtime modules, the files they
read (the kernels' CUDA sources in ``csrc/``, the VAD and ECAPA weights in
``data/``), the model card and ``.gitattributes`` into the checkpoint
directory, so that directory alone on ``PYTHONPATH`` imports
``tiny_audio_tpu_torch`` and transcribes; on the card the staged copy
builds its kernels from its own ``csrc/``.  Uploading (``push_to_hub``)
needs the network and is not part of the port.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Optional

PACKAGE = "tiny_audio_tpu_torch"

# Serving entry points a consumer calls directly; every module they import
# (transitively) ships too.  The kernel loader, the device rule, the
# parameter bridge and the checkpoint reader are listed as well, wherever
# an import inside a function might hide them from the scan.
ARTIFACT_ENTRYPOINTS = [
    "__init__.py",
    "config.py",
    "generation.py",
    "pipeline.py",
    "processing.py",
    "tokenization.py",
    "alignment.py",
    "diarization.py",
    "vad.py",
    "handler.py",
    "serving.py",
    "batching.py",
    "models/asr.py",
    "kernels.py",
    "device.py",
    "bridge.py",
    "utils/msgpack_io.py",
]

_IMPORT_DOTTED = re.compile(rf"^\s*(?:from|import)\s+{PACKAGE}\.([A-Za-z0-9_.]+)", re.M)
# `from tiny_audio_tpu_torch[.sub] import a, b`: each name may itself be a
# submodule (`from tiny_audio_tpu_torch.utils import msgpack_io`); the
# single-line and the parenthesized forms are matched apart, and `as`
# aliases and comments are stripped by the consumer
_IMPORT_FROM = re.compile(
    rf"^\s*from\s+{PACKAGE}((?:\.[A-Za-z0-9_.]+)?)\s+import\s+"
    r"([A-Za-z0-9_, \t]+(?:\s+as\s+[A-Za-z0-9_]+)?"
    r"(?:\s*,\s*[A-Za-z0-9_]+(?:\s+as\s+[A-Za-z0-9_]+)?)*)",
    re.M,
)
_IMPORT_FROM_PAREN = re.compile(
    rf"^\s*from\s+{PACKAGE}((?:\.[A-Za-z0-9_.]+)?)\s+import\s+\(([^)]*)\)", re.M | re.S)
# data a module reads beside itself: `... / "data" / "name.msgpack"`
_DATA_FILE = re.compile(r'"data"\s*/\s*"([A-Za-z0-9_.\-]+)"')


def _pkg_root() -> Path:
    return Path(__file__).resolve().parent


def _files_for_module(pkg_root: Path, mod: str) -> list[str]:
    rel = mod.replace(".", "/")
    if (pkg_root / (rel + ".py")).is_file():
        return [rel + ".py"]
    if (pkg_root / rel).is_dir() and (pkg_root / rel / "__init__.py").is_file():
        return [rel + "/__init__.py"]
    return []


def artifact_modules() -> list[str]:
    """The package's modules the entry points reach through their imports
    (paths relative to the package)."""
    pkg_root = _pkg_root()
    seen: set[str] = set()
    queue = list(ARTIFACT_ENTRYPOINTS)
    while queue:
        rel = queue.pop()
        if rel in seen or not (pkg_root / rel).is_file():
            continue
        seen.add(rel)
        src = (pkg_root / rel).read_text()
        mods: list[str] = []
        for m in _IMPORT_DOTTED.finditer(src):
            parts = m.group(1).split(".")
            mods += [".".join(parts[:depth]) for depth in range(1, len(parts) + 1)]
        for pat in (_IMPORT_FROM, _IMPORT_FROM_PAREN):
            for m in pat.finditer(src):
                base = m.group(1).lstrip(".")
                for name in m.group(2).split(","):
                    name = name.split("#")[0].split(" as ")[0].strip()
                    if name:  # a symbol or a submodule: non-files drop out
                        mods.append(f"{base}.{name}" if base else name)
        for mod in mods:
            for f in _files_for_module(pkg_root, mod):
                if f not in seen:
                    queue.append(f)
        # every package on the way needs its __init__.py
        parent = Path(rel).parent
        while str(parent) != ".":
            init = str(parent / "__init__.py")
            if init not in seen and (pkg_root / init).is_file():
                queue.append(init)
            parent = parent.parent
    return sorted(seen)


def artifact_files() -> list[str]:
    """Every file the artifact carries: :func:`artifact_modules`, the
    ``data/`` files they read, and ``csrc/`` whole when the kernel loader
    is among them."""
    pkg_root = _pkg_root()
    modules = artifact_modules()
    files = set(modules)
    for rel in modules:
        for name in _DATA_FILE.findall((pkg_root / rel).read_text()):
            if (pkg_root / "data" / name).is_file():
                files.add(f"data/{name}")
    if "kernels.py" in modules:
        files.update(f"csrc/{p.name}" for p in (pkg_root / "csrc").iterdir()
                     if p.suffix in (".cu", ".cuh"))
    return sorted(files)


GITATTRIBUTES = """*.msgpack filter=lfs diff=lfs merge=lfs -text
*.safetensors filter=lfs diff=lfs merge=lfs -text
*.bin filter=lfs diff=lfs merge=lfs -text
"""


def stage_artifact(checkpoint_dir, model_card: Optional[str] = None) -> Path:
    """Copy the runtime (:func:`artifact_files`) into
    ``checkpoint_dir/tiny_audio_tpu_torch/``, with ``.gitattributes`` and a
    ``README.md`` model card, so the checkpoint is self-contained."""
    ckpt = Path(checkpoint_dir)
    if not (ckpt / "config.json").exists():
        raise FileNotFoundError(f"{ckpt} is not a checkpoint (no config.json)")
    pkg_root = _pkg_root()
    code_dir = ckpt / PACKAGE
    for rel in artifact_files():
        dst = code_dir / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(pkg_root / rel, dst)
    (ckpt / ".gitattributes").write_text(GITATTRIBUTES)

    card_dst = ckpt / "README.md"
    if model_card and Path(model_card).exists():
        shutil.copy2(model_card, card_dst)
    elif not card_dst.exists():
        repo_card = pkg_root.parent / "MODEL_CARD.md"
        if repo_card.exists():
            shutil.copy2(repo_card, card_dst)
        else:
            card_dst.write_text("# tiny-audio-tpu checkpoint\n\nSelf-contained ASR checkpoint "
                                "with the PyTorch + CUDA runtime (tiny_audio_tpu_torch).\n")
    return ckpt
