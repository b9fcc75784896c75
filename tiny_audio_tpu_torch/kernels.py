"""Build and load the Hopper kernels in ``csrc/``.

Each CUDA C++ source is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds).  The build happens at first use, into
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libta_kernels.so"

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_DECODE_ARGS = (_PTR,) * 11 + (_INT,) * 8 + (ctypes.c_float, _INT, _PTR)
_MATMUL_ARGS = (_PTR,) * 6 + (_INT,) * 5 + (_PTR,)
_PREFILL_BWD_ARGS = (_INT,) * 5 + (ctypes.c_float, _PTR)
_ENCODER_ATTENTION_ARGS = (_PTR,) * 5 + (_INT,) * 4 + (ctypes.c_float, _PTR)
_PREFILL_ARGS = (_PTR,) * 5 + (_INT,) * 5 + (ctypes.c_float, _PTR)
# name -> argtypes of the C entry points in csrc/*.cu; attention_f32.cu's
# fp32 instances take their bf16 entry point's arguments
_SIGNATURES = {
    "ta_encoder_ffn": (_PTR,) * 8 + (_INT,) * 3 + (_PTR,),
    "ta_encoder_ffn_smem_bytes": (),
    "ta_log_mel": (_PTR,) * 5 + (_INT,) * 5 + (_PTR,),
    **{name + suffix: argtypes
       for suffix in ("", "_f32")
       for name, argtypes in (
           ("ta_encoder_attention", _ENCODER_ATTENTION_ARGS),
           ("ta_prefill_attention", _PREFILL_ARGS),
           ("ta_prefill_attention_fwd_stats", (_PTR,) * 7 + _PREFILL_BWD_ARGS),
           ("ta_prefill_attention_bwd_dkv", (_PTR,) * 10 + _PREFILL_BWD_ARGS),
           ("ta_prefill_attention_bwd_dq", (_PTR,) * 9 + _PREFILL_BWD_ARGS))},
    "ta_decode_attention": _DECODE_ARGS,
    "ta_decode_attention_update": _DECODE_ARGS,
    "ta_w8a8_matmul": _MATMUL_ARGS,
    "ta_wq_matmul": _MATMUL_ARGS,
    "ta_encoder_attention_variant": (_PTR,) * 5 + (_INT,) * 6 + (ctypes.c_float, _PTR),
    "ta_wq_matmul_pipe": (_PTR,) * 4 + (_INT,) * 4 + (_PTR,),
    "ta_a8_matmul": (_PTR,) * 7 + (_INT,) * 5 + (_PTR,),
    "ta_a8t_matmul": (_PTR,) * 7 + (_INT,) * 5 + (_PTR,),
    "ta_attention_sm90_smem_bytes": (_INT, _INT),
    "ta_encoder_attention_variant_smem_bytes": (_INT, _INT),
    "ta_attention_bwd_sm90_smem_bytes": (_INT, _INT),
    "ta_attention_bwd_sm90_dkv_entry_registers": (),
    "ta_encoder_attention_variant_entry_registers": (),
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def cuda_tool(name: str) -> str:
    """Path of the CUDA toolkit's program ``name`` (``nvcc``, ``cuobjdump``):
    on PATH, else under ``$CUDA_HOME/bin``."""
    found = shutil.which(name)
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / name
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put it on PATH)")


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the library if needed.  Returns (path, build seconds, compiler
    log); the seconds are 0 when an existing build was reused."""
    out_dir = BUILD_ROOT / _build_key()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    nvcc = cuda_tool("nvcc")
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    jobs = []  # (command, process): one nvcc per source, all running at once
    for src in (p for p in _sources() if p.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    tmp = work / LIB_NAME
    link = [nvcc, "-shared", "-o", str(tmp), *(str(work / f"{Path(c[-1]).stem}.o")
                                              for c, _ in jobs)]
    log = ""
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            for _, other in jobs:
                other.wait()
            shutil.rmtree(work)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    proc = subprocess.run(link, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        shutil.rmtree(work)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    shutil.rmtree(work)
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


def dtype_entry(name: str, dtype) -> str:
    """The entry point of attention kernel ``name`` for tensors of ``dtype``:
    ``name`` itself for bf16, its fp32 instance ``name + "_f32"`` for fp32."""
    import torch

    return name + "_f32" if dtype == torch.float32 else name


def launch(name: str, device, *args) -> None:
    """Call C entry point ``name`` on PyTorch's current stream of ``device``;
    raise if the launch was refused.  Pointer arguments are
    ``Tensor.data_ptr()`` ints (0 for null); the stream is appended here."""
    import torch

    fn = getattr(library(), name)
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


#: the counters of the kernels that coordinate their blocks inside a launch
#: (the decode kernels' and the int8 products' split merges, #8's tile queue
#: and readiness counters): int32 buffers per device, zeroed once (outside
#: any graph capture) and left zero by every launch.  A buffer is never
#: freed, because a CUDA graph captured with it keeps its address: a grid
#: that needs more counters gets a larger buffer beside the old ones.  All
#: of these kernels share a device's buffers, so they must never run
#: concurrently: launches on one stream never overlap, and every path of
#: the port launches on one stream.  A kernel running beside another on a
#: second stream would find the other's counters non-zero (#8 would skip
#: tiles and leave output unwritten, a merge would read unfinished parts).
_counters: dict = {}
#: counters of a device's first buffer: grids of up to B x Hkv x chunks = 64K
COUNTERS_MIN = 1 << 16


def counter_buffer(device, n: int):
    """The counters of ``device`` (a ``torch.device``) that a launch uses, at
    least ``n`` of them: an int32 tensor, zero."""
    import torch

    buffers = _counters.setdefault(device, [])
    if not buffers or buffers[-1].numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a kernel needs {n} merge counters on {device} and cannot allocate them "
                "during a CUDA graph capture: run the same call once before capturing")
        buffers.append(torch.zeros(max(n, COUNTERS_MIN), dtype=torch.int32, device=device))
    return buffers[-1]


def counter_buffers(device) -> list:
    """Every counter buffer ``device`` has had, the newest last: all zero
    between launches."""
    return list(_counters.get(device, []))
