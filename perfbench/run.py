"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from this module's first statement to the window's
start): the kernel library built or loaded (``build/kernels/`` in the
checkout), the cell's weights made from the seed on the card, the program's
objects built and the cell's own shapes warmed up.  The window runs whole
units (laps or optimizer steps) until ``--seconds`` have passed; its
end-to-end rate is all their work over all its time.  With ``--trace 1`` the
window runs as in a plain run (and at least ``trace_units`` units), then
``trace_units`` more units run under the profiler, and the per-layer
metrics replace the end-to-end ones.  After the window the program's state
is freed and the plain reference decides ``correct``.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the result's last
key.  Without enough cards, or with JAX or the JAX package loaded, the run
exits non-zero and prints no result.  ``--device cpu`` is for the tests: it
runs the same code on the CPU and reports no device metric.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from perfbench import cell, trace  # noqa: E402
from perfbench.readers import Context  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def caches_in_checkout() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    build = CHECKOUT / "build" / "perfbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    caches_in_checkout()
    spec = cell.load_workload(args.workload)
    cfg = cell.load_config(spec["config"])
    lap_module = cell.load_lap(spec["lap"])
    import torch

    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
            log(f"{args.workload} needs {spec['chips']} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        from tiny_audio_tpu_torch import kernels

        lib, build_s, _ = kernels.build()
        kernels.library()
        log(f"kernels {'built in %.1f s' % build_s if build_s else 'loaded'} {lib.parent.name}")
        log(f"card {card_line()}")
    device = torch.device(args.device)
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)

    lap = lap_module.Lap(spec, cfg, args.seed, device)
    lap.setup()
    sync()
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    wrappers = getattr(lap_module, "WRAPPERS", {})
    recorder = trace.Recorder(device, wrappers) if args.trace and on_card else None
    traced = int(spec["trace_units"])
    setup_s = time.perf_counter() - T0
    win = window(lap, args.seconds, recorder, traced if recorder else 0, sync)
    units, window_s = win["units"], win["window_s"]
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    attempted, failed = lap.counts(units)

    if args.trace:
        metrics, device_info, breakdown = per_layer(lap, lap_module.KIND, recorder, traced,
                                                    window_peak, win["unit_s"])
        if recorder:
            events = {key: sum(len(u.of(key)) for u in recorder.units)
                      for key in recorder.launched}
            log(f"launches of the traced units: wrappers {recorder.launched}, trace {events}")
            log(f"host seconds a unit: untraced {win['unit_s']!r}, traced {win['traced_s']!r}")
    else:
        metrics = {name: {"value": value, "unit": lap_module.END_TO_END[name]}
                   for name, value in {**lap.metrics(units, window_s), "setup_s": setup_s}.items()}
        device_info, breakdown = {}, None

    lap.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = lap.check()
    correct = failed == 0 and all(c["limit"] is not None and c["value"] <= c["limit"]
                                  for c in checks.values())
    log(f"units={units} window_s={window_s!r} setup_s={setup_s!r} "
        f"check_s={time.perf_counter() - t_check!r} unit_ends_s={win['ends']!r}")

    found = cell.forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 1

    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if on_card:
        result["metrics"] = metrics
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": 1, "memory_peak_bytes": max(setup_peak, window_peak),
                            **device_info}
    else:  # never under a device metric's name
        result["metrics"] = {}
        result["device"] = {"platform": "cpu", "count": 1}
        result["cpu_readings"] = metrics
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} value={c['value']!r} limit={c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them: the
    peaks of ``flops.py`` assume the full 700 W."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, stdin=subprocess.DEVNULL)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read (rc {out.returncode})"


def window(lap, seconds: float, recorder=None, traced: int = 0, sync=lambda: None) -> dict:
    """Whole units until ``seconds`` have passed and ``traced`` units have
    run: ``units``, the seconds from the start at each unit's end (``ends``),
    ``window_s``.  Then, with a recorder, ``traced`` more units run under the
    profiler, which slows the host: ``unit_s`` is the window's host seconds a
    unit, the unit as it runs untraced; ``traced_s`` the traced units'."""
    t_start = time.perf_counter()
    units, ends = 0, []
    while True:
        lap.unit()
        units += 1
        ends.append(time.perf_counter() - t_start)
        if time.perf_counter() - t_start >= seconds and units >= traced:
            break
    sync()
    window_s = time.perf_counter() - t_start
    out = {"window_s": window_s, "unit_s": window_s / units, "traced_s": 0.0}
    if recorder:
        recorder.start()
        t_traced = time.perf_counter()
        for _ in range(traced):
            recorder.marker()
            lap.unit()
            units += 1
            ends.append(time.perf_counter() - t_start)
        recorder.stop()
        out["traced_s"] = (ends[-1] - (t_traced - t_start)) / traced
    return {**out, "units": units, "ends": ends}


def per_layer(lap, kind: str, recorder, n_units: int, window_peak: int,
              unit_s: float) -> tuple:
    """The per-layer metrics of the traced units, ``device``'s busy and window
    seconds, and the breakdown; ``unit_s``: an untraced unit's host seconds."""
    events = recorder.events() if recorder else []
    units = trace.split_units(events)[:n_units]
    if recorder:
        recorder.units = units
    busy = trace.union_s([e for u in units for e in u.events])
    win = trace.window_s(units)
    shapes = lap.context(len(units)) if units else {"expected": [], "model_flops": []}
    ctx = Context(kind=kind, units=units, expected=shapes["expected"],
                  model_flops=shapes["model_flops"],
                  window_s=win, busy_s=busy, peak_bytes=window_peak,
                  decode_steps=shapes.get("decode_steps", 0), unit_s=unit_s)
    metrics = {}
    for name, reader in cell.load_metrics().items():
        value = reader.read(ctx) if units else None
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    if not units:
        return metrics, {}, None
    breakdown = {"device_ops": trace.top(trace.device_ops(units)),
                 "idle_gaps": trace.top(trace.idle_gaps(units, lap.phases))}
    log(f"traced units={len(units)} events={len(events)} busy_s={busy!r} window_s={win!r}")
    return metrics, {"busy_s": busy, "window_s": win}, breakdown


if __name__ == "__main__":
    sys.exit(main())
