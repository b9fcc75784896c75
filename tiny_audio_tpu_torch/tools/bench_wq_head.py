"""The LM head's int8 products at the decode shape.

    python -m tiny_audio_tpu_torch.tools.bench_wq_head
    python -m tiny_audio_tpu_torch.tools.bench_wq_head --device cpu \\
        --batch 8 --k 256 --n 4096 --nc 2048 --a8-nt 1024 --reps 1

The port's counterpart of ``scripts/bench_wq_head.py``: x ``[48, 1024]``
bf16 (unit normal times 2) against the flagship's LM head ``[1024, 151936]``
(normal times 0.02, quantized per output channel with ``quantize_weight``).
It times, with CUDA events over ``--reps`` calls after warmup, the bf16
``F.linear`` of the unquantized head, kernel #6 (``wq_matmul``), kernel #5
(``w8a8_matmul``) and the three bench variants at each point of the
script's sweep: #9b ``wq_matmul_pipe`` (the chunk width nc; the script's
tile width nt has no counterpart in the port's kernel), #9c ``a8_matmul``
and #9d ``a8t_matmul`` (nt), each with the int8 bytes' rate; then each one's
``rel_err`` (Frobenius, against the bf16 product) and greedy-argmax
agreement, its difference from its plain version (#9c, #9d bitwise), and the
fastest.  It runs on the card unless ``--device cpu`` is passed (then every
int8 product is its plain version); a kernel that fails to build or launch
fails the run.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from tiny_audio_tpu_torch.device import require_device
from tiny_audio_tpu_torch.ops.wq_head import w8a8_matmul, w8a8_matmul_plain
from tiny_audio_tpu_torch.ops.wq_head_variants import (
    A8_SWEEP,
    PIPE_SWEEP,
    a8_matmul,
    a8t_matmul,
    wq_matmul_pipe,
)
from tiny_audio_tpu_torch.ops.wq_matmul import (
    WQ_ATOL,
    WQ_RTOL,
    quantize_weight,
    wq_matmul,
    wq_matmul_plain,
)
from tiny_audio_tpu_torch.tools import time_ms

# scripts/bench_wq_head.py's shape and reps
B, K, N = 48, 1024, 151936
REPS = 50


def make_inputs(b: int, k: int, n: int, device, seed: int = 0) -> dict:
    """x [b, k] bf16, the bf16 head w [k, n], its int8 quantization in both
    layouts and the per-channel scales, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((b, k), generator=gen, device=device) * 2.0).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=device) * 0.02).to(torch.bfloat16)
    w_i8, scale = quantize_weight(w)
    return {"x": x, "w": w, "w_i8": w_i8, "wt_i8": w_i8.T.contiguous(), "scale": scale}


def run(b: int = B, k: int = K, n: int = N, device="cuda", reps: int = REPS,
        pipe_sweep=PIPE_SWEEP, a8_sweep=A8_SWEEP, seed: int = 0, out=print) -> dict:
    """Time and check every product; prints the script's lines and returns
    their numbers by name."""
    device = require_device(device)
    d = make_inputs(b, k, n, device, seed)
    x, w_i8, wt_i8, scale = d["x"], d["w_i8"], d["wt_i8"], d["scale"]
    w_linear = d["w"].T.contiguous()  # nn.Linear's [N, K]
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out(f"LM-head shape B={b} K={k} N={n}, {reps}-rep loop, device={where}")
    ref = F.linear(x, w_linear).float()
    # #9b's function is #6's; #9c's and #9d's are #5's (W8A8, per-row x)
    plains = {"wq": wq_matmul_plain(x, w_i8, scale), "w8a8": w8a8_matmul_plain(x, wt_i8, scale)}
    products = [("bf16 dot", lambda: F.linear(x, w_linear), None, None),
                ("wq shipped (#6)", lambda: wq_matmul(x, w_i8, scale), "wq", "tol"),
                ("w8a8 shipped (#5)", lambda: w8a8_matmul(x, wt_i8, scale), "w8a8", "bitwise")]
    products += [(f"pipe nc={nc}", lambda nc=nc: wq_matmul_pipe(x, w_i8, scale, nc), "wq", "tol")
                 for nc in pipe_sweep]
    products += [(f"a8 nt={nt}", lambda nt=nt: a8_matmul(x, w_i8, scale, nt), "w8a8", "bitwise")
                 for nt in a8_sweep]
    products += [(f"a8t nt={nt}", lambda nt=nt: a8t_matmul(x, wt_i8, scale, nt), "w8a8", "bitwise")
                 for nt in a8_sweep]

    results = {}
    for name, call, plain_name, rule in products:
        got = call()
        ms = time_ms(call, reps, device)
        gbs = k * n / (ms * 1e-3) / 1e9
        r = {"ms": ms, "int8_gb_per_s": gbs, "finite": bool(torch.isfinite(got).all())}
        g32 = got.float()
        r["rel_err"] = float(torch.linalg.norm(g32 - ref) / (torch.linalg.norm(ref) or 1.0))
        r["argmax_agree"] = float((g32.argmax(1) == ref.argmax(1)).float().mean())
        if plain_name is not None:
            want = plains[plain_name]
            diff = (g32 - want.float()).abs()
            r["max_abs_err_vs_plain"] = float(diff.max())
            r["within"] = (torch.equal(got.view(torch.int16), want.view(torch.int16))
                           if rule == "bitwise" else
                           bool((diff <= WQ_ATOL + WQ_RTOL * want.float().abs()).all()))
            r["rule"] = rule
        results[name] = r
        out(f"{name:26s} {ms:7.3f} ms   ({gbs:6.1f} GB/s int8-bytes)")
    for name, r in results.items():
        vs_plain = ("" if "rule" not in r else
                    f"  vs_plain={'bitwise' if r['rule'] == 'bitwise' and r['within'] else r['max_abs_err_vs_plain']}")
        out(f"{name:26s} rel_err={r['rel_err']:.4f}  argmax-agree={r['argmax_agree']:.3f}{vs_plain}")
    best = min(results, key=lambda name: results[name]["ms"])
    out(f"fastest: {best} at {results[best]['ms']:.3f} ms "
        f"(bf16 baseline {results['bf16 dot']['ms']:.3f} ms)")
    return {"products": results, "fastest": best, "inputs": d}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--k", type=int, default=K)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--nc", type=int, nargs="*", help="#9b chunk widths")
    p.add_argument("--a8-nt", type=int, nargs="*", help="#9c and #9d channels per block")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    return run(a.batch, a.k, a.n, a.device, a.reps, tuple(a.nc or PIPE_SWEEP),
               tuple(a.a8_nt or A8_SWEEP), a.seed)


if __name__ == "__main__":
    main()
