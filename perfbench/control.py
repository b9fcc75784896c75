"""The readings that a cell's limits are set from, on the card at the cell's size.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

For each seed: the program's numbers (one lap at the cell's load for
serving; the three checked steps for training), each against the plain
reference, as a run compares them.  For each control seed besides: the
control, the reference computed in fp8 put in the program's place (for
serving also the program's own int8 path, ``enable_w8a8_decode``), and for
training the fault of half of each micro-batch left out (planted in the
reference).  A state left unchanged reads 1 by the training measure and
needs no run.  One JSON line a seed, then the summary: the lower reading
(largest of the program's) and the upper (smallest of the controls').
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from perfbench import cell, reference


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve_seed(spec, cfg, seed, device, control: bool) -> dict:
    from perfbench.laps import serve_offline as s

    lap = s.Lap(spec, cfg, seed, device)
    lap.setup()
    lap.unit()
    if control:
        lap.model.enable_w8a8_decode()
        lap.unit()
    lap.release()
    free()
    w8a8 = lap.outputs[1:]
    lap.outputs = lap.outputs[:1]
    picks = lap.sample()
    rows = [(lap.pool.rows(lap.outputs[k][0])[r], lap.outputs[k][1][r]) for k, r in picks]
    args = (cfg, seed, device, lap.pool, lap.mel_length)
    out = s.served_gaps(*args, rows)
    if control:
        free()
        fp8 = s.served_gaps(*args, rows, reference.Precision("fp8"))
        out.update({f"control_fp8.{k}": v for k, v in fp8.items()})
        free()
        low = [(lap.pool.rows(w8a8[0][0])[r], w8a8[0][1][r]) for _, r in picks]
        out.update({f"control_w8a8.{k}": v for k, v in s.served_gaps(*args, low).items()})
    return out


def train_seed(spec, cfg, seed, device, control: bool) -> dict:
    from perfbench.laps import train_stage as t

    lap = t.Lap(spec, cfg, seed, device)
    lap.setup()
    lap.release()
    free()
    program = {"losses": lap.losses, "grad1": {n: g / (1 - lap.beta1) for n, g in lap.mu1.items()},
               "change": {n: lap.p3[n] - lap.p0[n] for n in lap.p0}}
    ref = t.reference_steps(cfg, spec, seed, device, lap.rows)
    free()
    out = dict(t.compare(program, ref))
    if control:
        low = t.reference_steps(cfg, spec, seed, device, lap.rows, reference.Precision("fp8"))
        free()
        out.update({f"control_fp8.{k}": v for k, v in t.compare(low, ref).items()})
        half = t.reference_steps(cfg, spec, seed, device, lap.rows,
                                 keep_rows=list(range(lap.rows.micro_batch // 2)))
        free()
        out.update({f"fault_half_batch.{k}": v for k, v in t.compare(half, ref).items()})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None, help="also write the lines to this file")
    args = p.parse_args(argv)
    spec = cell.load_workload(args.workload)
    cfg = cell.load_config(spec["config"])
    device = torch.device("cuda")
    from tiny_audio_tpu_torch import kernels

    kernels.build()
    kernels.library()
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    run = serve_seed if spec["lap"] == "serve_offline" else train_seed
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        out = {"seed": seed, **run(spec, cfg, seed, device, seed in controls),
               "seconds": time.perf_counter() - t0}
        lines.append(out)
        print(json.dumps(out), flush=True)
    names = {k for line in lines for k in line} - {"seed", "seconds"}
    summary = {}
    for name in sorted(names):
        values = [line[name] for line in lines if name in line]
        summary[name] = {"max": max(values), "min": min(values), "n": len(values)}
    summary["device"] = torch.cuda.get_device_name(device)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines + [{"summary": summary}]) + "\n")
    found = cell.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
