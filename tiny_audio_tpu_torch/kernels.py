"""Build and load the Hopper kernels in ``csrc/``.

The CUDA C++ sources are compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds).  The build happens at first use, into
``build/kernels/<hash>/`` beside the package, keyed on a hash of the sources
and flags: a changed source builds anew, an unchanged one loads the library
already built.  Nothing here runs when the module is imported, so the CPU
tests import every module of the port on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libta_kernels.so"

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# name -> argtypes of the C entry points in csrc/attention.cu
_SIGNATURES = {
    "ta_encoder_attention": (_PTR, _PTR, _PTR, _PTR, _PTR,
                             _INT, _INT, _INT, _INT, ctypes.c_float, _PTR),
    "ta_prefill_attention": (_PTR, _PTR, _PTR, _PTR, _PTR,
                             _INT, _INT, _INT, _INT, _INT, ctypes.c_float, _PTR),
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the library if needed.  Returns (path, build seconds, compiler
    log); the seconds are 0 when an existing build was reused."""
    out_dir = BUILD_ROOT / _build_key()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, seconds, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, device, *args) -> None:
    """Call C entry point ``name`` on PyTorch's current stream of ``device``;
    raise if the launch was refused.  Pointer arguments are
    ``Tensor.data_ptr()`` ints (0 for null); the stream is appended here."""
    import torch

    fn = getattr(library(), name)
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
