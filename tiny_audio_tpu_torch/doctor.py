"""Environment diagnostics for the port: ``ta-torch doctor``.

The port's counterpart of :mod:`tiny_audio_tpu.doctor`, probing CUDA
instead of the TPU backend.  The device probe runs in a subprocess under a
timeout, so a wedged driver becomes a diagnosis instead of a hung process.

Checks: library versions; the card (name, compute capability, count,
power limit, a timed bf16 matmul; the port's kernels need sm_90); the
CUDA compiler (``nvcc --version``); whether the kernel library for the
current sources is built under ``build/kernels/<hash>/`` and loads; the
native C++ audio runtime.  Exit code 0 = healthy, 1 = degraded (a card
that is not sm_90, or kernels that neither load nor can be built),
2 = no usable CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from typing import Optional

#: the compute capability the port's kernels are built for (sm_90a)
REQUIRED_CAPABILITY = (9, 0)

#: subprocess snippet: touch the card, time one matmul, report JSON
_PROBE = r"""
import json, time
import torch
if not torch.cuda.is_available():
    print(json.dumps({"cuda_available": False}))
    raise SystemExit(0)
props = torch.cuda.get_device_properties(0)
x = torch.ones((1024, 1024), dtype=torch.bfloat16, device="cuda")
(x @ x).sum().item()  # first use: context and library load
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(8):
    y = x @ x
torch.cuda.synchronize()
print(json.dumps({
    "cuda_available": True,
    "device_name": props.name,
    "capability": [props.major, props.minor],
    "device_count": torch.cuda.device_count(),
    "memory_gib": props.total_memory / 2**30,
    "matmul_ms": (time.perf_counter() - t0) / 8 * 1000,
}))
"""


def _probe_device(timeout_s: float) -> dict:
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                             timeout=timeout_s, text=True)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": (
            f"the CUDA probe exceeded its timeout ({timeout_s:.0f} s): driver wedged?")}
    if out.returncode != 0:
        return {"ok": False, "error": (out.stderr or "probe failed").strip()[-400:]}
    try:
        report = json.loads(out.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"ok": False, "error": "the probe printed no JSON"}
    if not report.get("cuda_available"):
        return {"ok": False, "error": "no CUDA device (torch.cuda.is_available() is False)",
                **report}
    return {"ok": True, **report}


def _power_limit(timeout_s: float = 30.0) -> Optional[str]:
    """``name, power.limit`` as ``nvidia-smi`` prints them (None without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=timeout_s)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else None


def _check_versions() -> dict:
    import numpy
    import torch

    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "numpy": numpy.__version__}


def _check_nvcc() -> dict:
    from tiny_audio_tpu_torch import kernels

    try:
        nvcc = kernels.cuda_tool("nvcc")
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return {"found": False, "error": str(e)}
    release = re.search(r"release ([0-9.]+)", out.stdout)
    return {"found": out.returncode == 0, "path": nvcc,
            "release": release.group(1) if release else None}


def _check_kernels() -> dict:
    from tiny_audio_tpu_torch import kernels

    lib = kernels.BUILD_ROOT / kernels._build_key() / kernels.LIB_NAME
    info = {"dir": str(lib.parent), "built": lib.exists(), "loads": False}
    if lib.exists():
        try:
            ctypes.CDLL(str(lib))
            info["loads"] = True
        except OSError as e:
            info["error"] = str(e)
    return info


def _check_native() -> dict:
    from tiny_audio_tpu_torch import native

    try:
        return {"available": native.available()}
    except Exception as e:  # a diagnosis, never a crash
        return {"available": False, "error": str(e)}


def run_doctor(probe_timeout_s: Optional[float] = None) -> dict:
    """Run every check; the structured report (also what the tests read)."""
    timeout = probe_timeout_s if probe_timeout_s is not None else float(
        os.environ.get("TA_DOCTOR_PROBE_S", "300"))
    report = {
        "versions": _check_versions(),
        "device": _probe_device(timeout),
        "nvcc": _check_nvcc(),
        "kernels": _check_kernels(),
        "native_audio": _check_native(),
    }
    dev = report["device"]
    if dev.get("ok"):
        dev["power"] = _power_limit()
        dev["sm90"] = tuple(dev["capability"]) == REQUIRED_CAPABILITY
    kern = report["kernels"]
    buildable = kern["loads"] or report["nvcc"]["found"]
    if not dev.get("ok"):
        report["status"] = "unreachable"
    elif not dev["sm90"] or not buildable:
        report["status"] = "degraded"
    else:
        report["status"] = "healthy"
    return report


def main(probe_timeout_s: Optional[float] = None, as_json: bool = False) -> int:
    """Print the report (JSON with ``as_json``); exit code as in the module
    docstring."""
    report = run_doctor(probe_timeout_s)
    if as_json:
        print(json.dumps(report))
    else:
        print("versions : " + ", ".join(f"{k} {v}" for k, v in report["versions"].items()))
        dev = report["device"]
        if dev.get("ok"):
            cap = ".".join(map(str, dev["capability"]))
            print(f"device   : {dev['device_name']} x{dev['device_count']}, sm {cap}"
                  f"{'' if dev['sm90'] else ' (NOT sm_90: the kernels need Hopper)'}, "
                  f"{dev['power'] or 'power limit unknown'}, matmul {dev['matmul_ms']:.3f} ms")
        else:
            print(f"device   : UNREACHABLE - {dev.get('error')}")
        nv = report["nvcc"]
        print("nvcc     : " + (f"{nv['path']} (release {nv['release']})" if nv["found"]
                                else f"not found ({nv.get('error')})"))
        k = report["kernels"]
        print(f"kernels  : {k['dir']} " + ("built, loads" if k["loads"] else
                                           "built, DOES NOT LOAD" if k["built"] else
                                           "not built (the first use builds them)"))
        n = report["native_audio"]
        print("native   : " + ("C++ audio runtime loaded" if n.get("available")
                               else "numpy (build with `ta-torch dev build-native`)"))
        print(f"status   : {report['status']}")
    return {"healthy": 0, "degraded": 1, "unreachable": 2}[report["status"]]
