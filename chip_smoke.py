#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the Hopper kernels from ``tiny_audio_tpu_torch/csrc`` (one ``nvcc`` per
source, started together) and shows that #1 and #2 are the Hopper design of
``csrc/attention_sm90.cu``, #2b and #2c that of
``csrc/attention_bwd_sm90.cu``, #8 that of ``csrc/encoder_ffn.cu`` and
each of #9a's 13 modes that of ``csrc/encoder_attention_variants.cu``: for
each instance of their kernels,
registers, shared memory and spills from the ``ptxas -v`` log (no spill),
and its HGMMA (wgmma), UTMALDG (TMA) and USETMAXREG instructions counted
with ``cuobjdump -sass`` (neither of the first two may be 0).  It holds each kernel against its plain PyTorch version on random
inputs (the decode kernels at every GQA group and head_dim they take, the
int8 products at the flagship's layer and head shapes; #2 also at the JAX
bench's batch of 48, timed beside SDPA), then drives the port at the
flagship width (random weights from seed 0, int8 KV cache):

- ``ASRModel.generate`` on 4 x 30 s of audio, 128 tokens, on the fused
  decode path (kernel #4 per layer and step, the default on the card) and on
  the module path (``fused_decode=False``: kernel #3 plus the cache write),
  with the device milliseconds of encoder + projector and of the prefill
  in one call (CUDA events);
- ``ASRPipeline`` on three requests;
- ``ASRPipeline.transcribe_streaming`` on one 30 s clip, 32 tokens;
- ``generate`` again under each int8 decode mode (``enable_wq_decode``:
  kernel #6; ``enable_w8a8_head`` and ``enable_w8a8_decode``: kernel #5);
- the HTTP server: ``save_pretrained`` of the flagship model,
  ``EndpointHandler(path, w8a8_decode=True)`` over it, ``make_server`` with a
  ``DynamicBatcher``, three concurrent ``POST /transcribe`` and the
  ``/healthz`` and ``/metrics`` routes;
- training at the flagship width (``Trainer`` over a synthetic corpus of
  10-30 s clips, batch 6): stage 1 (projector only) for 10 steps on one
  batch, with gradient accumulation 2, with gradient checkpointing, and
  stage 2 (LoRA, projector frozen); exact launch counts per micro-step
  (kernel #1 32, #2 28 or 56 checkpointed, its backward kernels 28 each,
  the decode and int8 kernels 0), finite losses and gradient norms, frozen
  towers bitwise unchanged, trainable parameters changed, the repeated
  batch's loss falling, and ``model/`` loaded back with ``from_pretrained``
  and generating on the card;
- the two kernels that only their own entry points reach (no path of the
  port or of the JAX package calls them; every path above launches them 0
  times): the fused log-mel front end (#7, ``log_mel_spectrogram_fused``) on
  the serving batch's audio, the training batch's clips zero-padded to 30 s
  and the edge shapes of tests/test_mel_pallas.py, each held with its plain
  version against an fp64 oracle; and the fused encoder FFN (#8,
  ``fused_ffn`` / ``encoder_ffn``) on encoder layer 0's MLP input from the
  serving ``generate`` and at scripts/bench_encoder_ffn.py's shape, with
  what that script prints (fused and unfused cuBLAS times and TFLOP/s, both
  errors against fp64 on 4,096 rows), the gradient through ``EncoderFFN``,
  a second launch and two CUDA-graph replays bitwise equal to the first,
  and its times at both M back to back and from a graph beside the
  previous design's (``PREVIOUS_FFN_MS``).

The decode kernels #3 and #4 (``csrc/decode_attention.cu``, a split over the
cache rows merged inside the launch): the registers, shared memory and
spills of each of their 40 instances (none over an int8 or bf16 cache at
head_dim <= 128 may spill); each kernel against its plain version and the
split's oracle at B = 1, 4 and 48 at the edges of the split, NaN planted past
kv_len, the appended rows bitwise, repeated runs bitwise; a CUDA graph with a
device kv_len advanced between replays bitwise equal to eager calls; the
merge counters zero after each phase; and their times from a CUDA graph
over cold layer views (B = 4, 48, 1) beside their bound, the previous
design's times and SDPA on a bf16 cache.  ``torch._weight_int8pack_mm``, one call
computing #6's function, is timed beside #6 at its head shape.

The int8 products #5 and #6 (``csrc/int8_matmul.cu``, a split over K merged
inside the launch): the registers, shared memory and spills of the 18
instances of ``split_matmul_kernel`` (none may spill); each product against
its plain version at the flagship's layer and head shapes, B = 4, 16 and 48
(#5 bitwise, #6 within ``WQ_ATOL``/``WQ_RTOL``); the instance each path
shape takes at B = 4 and 48 (the split design, or the run fails), three runs
bitwise, a CUDA graph replay bitwise equal to eager calls, zero merge
counters; their times from a CUDA graph cycling through 28 copies of each
weight (every read cold in L2) beside bf16 ``F.linear`` and the previous
design's times (``PREVIOUS_INT8_GRAPH_MS``); and, under ``enable_wq_decode``
and ``enable_w8a8_decode``, the int8 products of one decode step (7 x 28
layers and the head, the model's own ``wq``) from one CUDA graph, beside the
same products as bf16 ``F.linear``.

Before the paths, the prefill kernel's forward (serving and with saved
statistics) and its two backward kernels are held against their plain
versions at every (GQA group, head_dim) pair the decoders take, and the
repo's tiny towers (``tiny_test_config``, head_dim 16) run on the card in
fp32 and bf16 against the same weights on the CPU (``generate`` on both
decode paths and both cache kinds, fp32 token-exact), then the documented
``python -m tiny_audio_tpu_torch.train +experiments=smoke`` for 4 steps in
process, each fp32 / head_dim-16 attention instance timed on its inputs.
After the paths, the four bench variants (#9a-#9d), which no path calls,
run through their entry points, ``tools/bench_encoder_attention.py`` and
``tools/bench_wq_head.py``, at the TPU scripts' full shapes: every mode and
sweep point against its plain version (#9c and #9d bitwise, ``packed2``
bitwise ``shift_post``), #9a also against an fp64 oracle, each #9a mode's
time beside its previous design's (``PREVIOUS_VARIANT_MS``) and #1's.

Every kernel's launch count is set to 0 just before each path and read just
after; the inputs the path gave each kernel in its first call are kept,
and each kernel is held against its plain version once more on exactly
those tensors, where its time, its plain version's, its bound and (where
one PyTorch call computes the same function) the library call's are taken.
Each phase prints one line; the line before the card's name and power limit
is a JSON object with every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero, and so does a
machine without a CUDA device: nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH = 4
CLIP_S = 30.0
MAX_NEW = 128
REQUEST_SECONDS = (5, 12, 30)
STREAM_TOKENS = 32
DECODE_KV_LENS = (1, 255, 256, 468, 595)
# The decode kernels' timed points (B, kv_len) at S = 608: the path's batch
# (its first and last step), the JAX bench's batch and a stream.  Each graph
# cycles through at least DECODE_LAYERS cache views, and through as many as
# make the prefixes read twice the L2.
DECODE_GRAPH_POINTS = ((4, 468), (4, 595), (48, 468), (48, 595), (1, 468))
DECODE_GRAPH_S = 608
DECODE_LAYERS = 28
L2_BYTES = 50e6
# The previous design of #3 and #4 (one block per KV head and batch row, a
# one-row prefetch a thread), timed by decode_graph_times on that tree:
# (cache, B, kv_len) -> (#3 ms, #4 ms); NVIDIA H100 80GB HBM3, 700.00 W.
PREVIOUS_DECODE_GRAPH_MS = {
    ("int8", 4, 468): (0.013656952551433019, 0.01372228633789789),
    ("int8", 4, 595): (0.016341714631943477, 0.016884952783584595),
    ("int8", 48, 468): (0.04284609499431792, 0.04284323680968512),
    ("int8", 48, 595): (0.05152933370499384, 0.05138990424928211),
    ("int8", 1, 468): (0.013757175869411893, 0.013878850375904757),
    ("bf16", 4, 468): (0.017679047016870408, 0.017631618749527705),
    ("bf16", 4, 595): (0.02149771366800581, 0.021488191116423833),
    ("bf16", 48, 468): (0.044431047780173163, 0.04468361820493426),
    ("bf16", 48, 595): (0.054499240148635136, 0.05471866471426828),
    ("bf16", 1, 468): (0.017548376659177384, 0.017560150638316414),
}
TRAIN_BATCH = 6  # configs/training/production.yaml's per_device_batch_size
TRAIN_CLIP_S = (10.0, 30.0)
TRAIN_STEPS = 10  # stage 1 on one repeated batch
TRAIN_LR = 1e-3

# H100 SXM peaks at its 700 W limit (NVIDIA's data sheet; dense rates)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
FP32_FLOPS = 67e12

# the library kernels of jax 0.9.0 that the backward kernels replace
BWD_REPLACES = {
    "prefill_attention_bwd_dkv":
        "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
    "prefill_attention_bwd_dq":
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
}
# (GQA group, head_dim) pairs the decode and prefill kernels take
DECODE_SHAPES = [(g, d) for g in (1, 2, 3, 4, 8) for d in (16, 32, 64, 128, 256)]
# the decode step's int8 products at the flagship width: (K, N) of the layer
# projections and of the LM head, and the batches they are checked at
INT8_SHAPES = {"q_proj": (1024, 2048), "k_proj|v_proj": (1024, 1024), "o_proj": (2048, 1024),
               "gate_proj|up_proj": (1024, 3072), "down_proj": (3072, 1024),
               "head": (1024, 151936)}
INT8_BATCHES = (4, 16, 48)
# the batches of the cold-L2 timings (the path's and the JAX bench's), and
# the distinct weight copies a timed graph cycles through (a decode step
# streams its 28 layers' weights, so no product finds its weight in L2)
INT8_GRAPH_BATCHES = (4, 48)
INT8_VIEWS = 28
# The previous design of #5 and #6 (the first design's CUDA-core tiles, no split over
# K), timed by int8_graph_times and int8_step_times on that tree:
# (kernel, shape or "step", B) -> ms; NVIDIA H100 80GB HBM3, 700.00 W.  The
# same run's token agreement with bf16 under each int8 mode (fused path):
# #5 is bitwise its plain version in both designs, so the W8A8 modes' must
# not move.
PREVIOUS_TOKEN_AGREEMENT = {"enable_wq_decode": 0.859375, "enable_w8a8_head": 0.814453125,
                            "enable_w8a8_decode": 0.888671875}
PREVIOUS_INT8_GRAPH_MS = {
    ('wq_matmul', 'q_proj', 4): 0.024147998718988328,
    ('w8a8_matmul', 'q_proj', 4): 0.011286666705494835,
    ('wq_matmul', 'q_proj', 48): 0.053851808820452006,
    ('w8a8_matmul', 'q_proj', 48): 0.04995238213312058,
    ('wq_matmul', 'k_proj|v_proj', 4): 0.018239238432475498,
    ('w8a8_matmul', 'k_proj|v_proj', 4): 0.009347047834169297,
    ('wq_matmul', 'k_proj|v_proj', 48): 0.048164379029046925,
    ('w8a8_matmul', 'k_proj|v_proj', 48): 0.048051431065513975,
    ('wq_matmul', 'o_proj', 4): 0.04158095234916324,
    ('w8a8_matmul', 'o_proj', 4): 0.018957714239756267,
    ('wq_matmul', 'o_proj', 48): 0.10259847413925897,
    ('w8a8_matmul', 'o_proj', 48): 0.09818019185747419,
    ('wq_matmul', 'gate_proj|up_proj', 4): 0.02333638072013855,
    ('w8a8_matmul', 'gate_proj|up_proj', 4): 0.011419809290340968,
    ('wq_matmul', 'gate_proj|up_proj', 48): 0.05315428688412621,
    ('w8a8_matmul', 'gate_proj|up_proj', 48): 0.051603998456682475,
    ('wq_matmul', 'down_proj', 4): 0.06078533331553141,
    ('w8a8_matmul', 'down_proj', 4): 0.02692685808454241,
    ('wq_matmul', 'down_proj', 48): 0.15052552450270879,
    ('w8a8_matmul', 'down_proj', 48): 0.14229276066734678,
    ('wq_matmul', 'head', 4): 0.2366767610822405,
    ('w8a8_matmul', 'head', 4): 0.08018209253038679,
    ('wq_matmul', 'head', 48): 1.5133750552222842,
    ('w8a8_matmul', 'head', 48): 0.3399885722569057,
    ('wq_matmul', 'step', 4): 6.232949574788411,
    ('wq_matmul', 'step', 48): 15.895509084065756,
    ('w8a8_matmul', 'step', 4): 2.8480052947998047,
    ('w8a8_matmul', 'step', 48): 14.086427052815756,
}
INT8_MODES = {"enable_wq_decode": "wq_matmul", "enable_w8a8_head": "w8a8_matmul",
              "enable_w8a8_decode": "w8a8_matmul"}

# bf16 tolerance of a kernel against its plain version on the same bf16
# inputs, |got - want| <= KERNEL_ATOL + KERNEL_RTOL * |want|: both round the
# probabilities to bf16 before the P.V product (the kernel unnormalized, the
# plain version normalized) and round the output to bf16.  bf16 spacing is
# at most 2**-7 of a value, so KERNEL_RTOL allows two ulps of the output, and
# KERNEL_ATOL covers outputs near zero, where the P rounding dominates.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 2.0**-6
# An fp32 kernel (fp32 FMAs) against its fp32 plain version, forward or
# gradient: sums in other orders, a few fp32 ulps a term; FP32_TOL of the
# largest |want| (at least 1) bounds a row's sum (the cuda tests' limit).
FP32_TOL = 1e-4
# The small-model check runs the same bf16 weights on the card (kernels,
# cuBLAS) and on the CPU (plain versions); matmul order and the kernels'
# rounding points differ, so outputs agree to a few bf16 ulps of their scale.
SMALL_MODEL_RTOL = 5e-2
# A backward kernel's gradient against the fp32 plain backward (autograd
# through the plain version on the fp32 copies of the same bf16 inputs): its
# error may be at most BWD_ERR_RATIO times the bf16 plain backward's own
# error, plus BWD_FLOOR of the gradient's largest magnitude (one bf16 ulp
# near the top of a binade; both outputs are rounded to bf16).
BWD_ERR_RATIO = 2.0
BWD_FLOOR = 2.0**-8
# Kernel #7 (fp32) and its plain version (cuBLAS fp32 products) are each held
# against an fp64 oracle of the same formula: near the max - 8 floor a bin is
# a difference of large terms, where two right fp32 answers can differ by
# more than the JAX tests' 5e-4 after the log.  The kernel's error may be at
# most MEL_ERR_RATIO times the plain version's, plus MEL_FLOOR (a fifth of
# that 5e-4, in the normalized units of the output).
MEL_ERR_RATIO = 2.0
MEL_FLOOR = 1e-4
# Kernel #8's second input: the shape of scripts/bench_encoder_ffn.py
# (32 x 1536 frames of the flagship encoder), errors against fp64 on 4,096 rows
FFN_BENCH_SHAPE = (32 * 1536, 1280, 5120)
FFN_ORACLE_ROWS = 4096
# Kernel #8 and its plain version compute one formula (fp32 h through the
# GELU, g rounded to bf16 once) and differ only where a g sits on a bf16
# rounding boundary: ~98% of the outputs are bitwise equal at F = 5,120.
# Rounding h to bf16 before the GELU (naive_ffn's formula) still fits the
# tolerance above but matches about a third, so the share is held too.
FFN_MIN_EQUAL_SHARE = 0.95
# Kernel #8's timed row counts: encoder layer 0's MLP input of the serving
# batch (4 x 1,500 frames) and FFN_BENCH_SHAPE's; back to back (CUDA events
# over FFN_REPS calls) and from a CUDA graph of FFN_REPS calls, on random
# bf16 operands made from SEED + M (D = 1,280, F = 5,120): ffn_times.
FFN_TIMED_M = (BATCH * 1500, FFN_BENCH_SHAPE[0])
FFN_REPS = 10
# The previous design of #8 (32-row blocks of 16 warps, mma.sync, both
# weights streamed from L2 into fragments), timed by this script's ffn_times
# run on the package of the tree before the redesign (one run on the card,
# beside #9a's previous times below): M -> ms; NVIDIA H100 80GB HBM3, 700.00 W.
PREVIOUS_FFN_MS = {6000: {"ms": 2.271993637084961, "graph_ms": 2.263920021057129},
                   49152: {"ms": 13.578060913085938, "graph_ms": 13.50537567138672}}
# The tiny towers (tiny_test_config, head_dim 16): the clips, tokens and
# training steps of their phase.  fp32 runs the same formulas on the card's
# CUDA cores and on the CPU, so their audio embeddings agree to fp32 sums
# in other orders (FP32_EMBED_RTOL of the largest).
TINY_CLIP_S = (1.0, 0.55, 0.3)
TINY_TOKENS = 16
TINY_TRAIN_STEPS = 4
FP32_EMBED_RTOL = 1e-4
# Kernels #9a-#9d, the bench variants that only their tools reach; reps of
# their timed loops (the scripts' own are 30 and 50).  Every #9a mode's bf16
# output against the fp64 oracle on the real rows: at most 2.5e-3 measured on
# the card over the 13 modes (bf16 P and output roundings), twice that here.
BENCH_VARIANTS = ("encoder_attention_variant", "wq_matmul_pipe", "a8_matmul", "a8t_matmul")
# #9b-#9d at their numerics points before the redesign of #5 and #6, from
# this script on that tree (ms; NVIDIA H100 80GB HBM3, 700.00 W); then #9a's
# previous design (mma.sync, 16 warps a 256-row block, V copied transposed)
# by mode and hg, and #1 and SDPA at its shape, from the tool's timings on
# that tree in the same run as PREVIOUS_FFN_MS (ms; NVIDIA H100 80GB HBM3,
# 700.00 W)
PREVIOUS_VARIANT_MS = {"wq_matmul_pipe": 2.2355056762695313, "a8_matmul": 3.1405344009399414,
                       "a8t_matmul": 1.719843292236328,
                       "loop-fp32(hg=10)": 7.6249137878417965, "loop-bf16(hg=10)": 8.999305725097656,
                       "loop-rcp(hg=10)": 5.438627243041992, "loop-nomax(hg=10)": 6.589358520507813,
                       "loop-shift(hg=10)": 6.450341033935547,
                       "loop-tilemax(hg=10)": 7.425672149658203,
                       "loop-tilemax_rcp(hg=10)": 5.39941291809082,
                       "loop-qnorm(hg=10)": 6.376964950561524,
                       "loop-qnorm_post(hg=10)": 2.811782455444336,
                       "loop-fp32_post(hg=10)": 4.003662490844727,
                       "loop-shift_post(hg=10)": 2.6980031967163085,
                       "loop-tilemax_post(hg=10)": 4.010643386840821,
                       "loop-packed2(hg=10)": 2.6028432846069336,
                       "loop-fp32(hg=4)": 7.7754066467285154, "loop-fp32(hg=20)": 9.939046478271484,
                       "encoder_attention (#1)": 1.1767824172973633,
                       "sdpa (key mask)": 1.3554479598999023}
VARIANT_REPS = 20
VARIANT_ORACLE_ATOL = 5e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_done() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls, after warmup."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, stream=None) -> float:
    """Mean device milliseconds of ``fn`` replayed from a CUDA graph of
    ``iters`` calls (captured on ``stream``, or a stream of its own): the
    launches leave the host out, so a kernel shorter than its Python call is
    timed itself, not the host's call rate."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within the tolerance of
    got's dtype: FP32_TOL for fp32, KERNEL_ATOL/RTOL for bf16)."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        within = bool(diff.max() <= FP32_TOL * max(want.float().abs().max().item(), 1.0))
    else:
        within = bool((diff <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all())
    return diff.max().item(), within


def tolerance_text(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return f"fp32_tol={FP32_TOL}*max(|want|,1)"
    return f"atol={KERNEL_ATOL} rtol={KERNEL_RTOL}"


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def record_first_call(module, name: str, store: dict):
    """Keep a copy of the arguments of the first call to ``module.name``."""
    original = getattr(module, name)

    def recorder(*args, **kwargs):
        if name not in store:
            copy = lambda a: a.clone() if isinstance(a, torch.Tensor) else a  # noqa: E731
            store[name] = (tuple(map(copy, args)), {k: copy(v) for k, v in kwargs.items()})
        return original(*args, **kwargs)

    setattr(module, name, recorder)
    try:
        yield
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def record_first_backward(store: dict):
    """Keep a copy of what the first ``PrefillAttention`` backward hands its
    two kernels: (q, k, v, padding_mask, dout, m, l, delta)."""
    from tiny_audio_tpu_torch.ops import prefill_attention as prefill_module

    function = prefill_module.PrefillAttention
    original = function.backward

    def backward(ctx, dout):
        if "backward" not in store:
            q, k, v, mask, out, m, l = ctx.saved_tensors
            dout = dout.to(q.dtype).contiguous()
            delta = prefill_module.attention_delta(out, dout)
            store["backward"] = tuple(None if x is None else x.clone()
                                      for x in (q, k, v, mask, dout, m, l, delta))
        return original(ctx, dout)

    function.backward = staticmethod(backward)
    try:
        yield
    finally:
        function.backward = staticmethod(original)


def compare_on_path_inputs(name: str, kernel, plain, call: tuple) -> dict:
    """Kernel vs plain version on the tensors the serving path gave the kernel.
    Padding query rows are don't-care, as in the random-input comparisons.
    The kernel's ms is replayed from a CUDA graph (a ~0.02 ms prefill is
    shorter than its Python call); back-to-back launches are printed too."""
    args, kwargs = call
    mask = args[3] if len(args) > 3 else kwargs.get("kv_mask", kwargs.get("padding_mask"))
    valid = (torch.ones(args[0].shape[:2], dtype=torch.bool, device=args[0].device)
             if mask is None else mask.bool())
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    err, within = kernel_error(got[valid], want[valid])
    finite = bool(torch.isfinite(got[valid]).all())
    back_to_back_ms = cuda_ms(lambda: kernel(*args, **kwargs), 20)
    ms = graph_ms(lambda: kernel(*args, **kwargs), 20)
    plain_ms = cuda_ms(lambda: plain(*args, **kwargs), 5)
    print(f"{name} on the serving path's layer-0 inputs shape={list(args[0].shape)} "
          f"real_keys={'all' if mask is None else int(mask.sum())} max_abs_err={err!r} "
          f"{tolerance_text(got.dtype)} kernel_graph_ms={ms!r} "
          f"kernel_back_to_back_ms={back_to_back_ms!r} plain_ms={plain_ms!r}")
    if not finite:
        fail(f"{name} kernel produced non-finite values on the serving path's inputs")
    if not within:
        fail(f"{name} kernel disagrees with its plain version on the serving path's inputs: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def attention_extras(name: str, call: tuple, kernel_ms: float) -> dict:
    """Bound and library time of kernel #1 or #2 on the path's inputs, and a
    line with the kernel's achieved TFLOP/s and share of its bound.  The
    library call is scaled_dot_product_attention on the same tensors, laid
    out [B, H, T, D] outside the timed call, replayed from a CUDA graph as the
    kernel is; the port never calls it."""
    import torch.nn.functional as F

    args, kwargs = call
    q, k, v = args[:3]
    if name == "encoder_attention":
        h = args[4] if len(args) > 4 else kwargs["num_heads"]
        mask = args[3] if len(args) > 3 else kwargs.get("padding_mask")
        b, t, hd = q.shape
        d = hd // h
        heads = lambda x: x.reshape(b, t, h, d).transpose(1, 2).contiguous()  # noqa: E731
        key_mask = None if mask is None else mask.bool()[:, None, None, :]
        qq, kk, vv = heads(q), heads(k), heads(v)
        call_lib = lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=key_mask)  # noqa: E731
        flops = 4.0 * b * h * t * t * d
    else:
        b, t, hq, d = q.shape
        qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        call_lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, kk, vv, is_causal=True, enable_gqa=True)
        flops = 4.0 * b * hq * d * t * (t + 1) / 2  # causal: keys 1..t for query row t
    moved = 2 * nbytes(q) + nbytes(k, v)  # q and the output, k and v
    extras = {**bound(moved, flops, BF16_TENSOR_FLOPS), "library_ms": graph_ms(call_lib, 20)}
    print(f"{name} rate on the serving path's layer-0 inputs (CUDA graph) kernel_ms={kernel_ms!r} "
          f"tflops={flops / kernel_ms / 1e9!r} bound_ms={extras['bound_ms']!r} "
          f"bound_share={extras['bound_ms'] / kernel_ms!r} sdpa_ms={extras['library_ms']!r} "
          f"sdpa_tflops={flops / extras['library_ms'] / 1e9!r} "
          f"sdpa_back_to_back_ms={cuda_ms(call_lib, 20)!r}")
    return extras


def compare_encoder_kernel(gen: torch.Generator) -> dict:
    from tiny_audio_tpu_torch.ops.encoder_attention import (
        encoder_attention,
        encoder_attention_plain,
    )

    b, t, h, d = 2, 1500, 20, 64
    q, k, v = (
        torch.randn((b, t, h * d), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(3)
    )
    q = q * 2  # sharper softmax rows than unit scores
    mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    mask[1, 900:] = 0  # ragged per-row lengths: 1500 and 900 real frames
    got = encoder_attention(q, k, v, mask, h)
    want = encoder_attention_plain(q, k, v, mask, h)
    valid = mask.bool()
    err, within = kernel_error(got[valid], want[valid])
    if not torch.isfinite(got).all():
        fail("encoder attention kernel produced non-finite values")
    ms = cuda_ms(lambda: encoder_attention(q, k, v, mask, h), 20)
    plain_ms = cuda_ms(lambda: encoder_attention_plain(q, k, v, mask, h), 5)
    print(f"encoder_attention B={b} T={t} H={h} D={d} bf16 max_abs_err={err!r} "
          f"atol={KERNEL_ATOL} rtol={KERNEL_RTOL} kernel_ms={ms!r} plain_ms={plain_ms!r}")
    if not within:
        fail(f"encoder attention kernel disagrees with its plain version: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def compare_prefill_kernel(gen: torch.Generator) -> dict:
    from tiny_audio_tpu_torch.ops.prefill_attention import (
        prefill_attention,
        prefill_attention_plain,
    )

    b, t, hq, hkv, d = 2, 468, 16, 8, 128
    q = torch.randn((b, t, hq, d), generator=gen, device="cuda").to(torch.bfloat16) * 2
    k, v = (
        torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(2)
    )
    mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    mask[1, 400:] = 0  # one row right-padded
    got = prefill_attention(q, k, v, mask)
    want = prefill_attention_plain(q, k, v, mask)
    valid = mask.bool()  # padding query rows are don't-care
    err, within = kernel_error(got[valid], want[valid])
    if not torch.isfinite(got[valid]).all():
        fail("prefill attention kernel produced non-finite values")
    ms = cuda_ms(lambda: prefill_attention(q, k, v, mask), 20)
    plain_ms = cuda_ms(lambda: prefill_attention_plain(q, k, v, mask), 5)
    print(f"prefill_attention B={b} T={t} Hq={hq} Hkv={hkv} D={d} causal bf16 "
          f"max_abs_err={err!r} atol={KERNEL_ATOL} rtol={KERNEL_RTOL} "
          f"kernel_ms={ms!r} plain_ms={plain_ms!r}")
    if not within:
        fail(f"prefill attention kernel disagrees with its plain version: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


# the Hopper design's kernel templates and their instances: the forward
# (csrc/attention_sm90.cu; head_dim, causal, statistics) behind #1 and #2,
# the backward (csrc/attention_bwd_sm90.cu; head_dim) behind #2b and #2c
SM90_KERNEL = "attention_fwd_sm90"
SM90_BWD_KERNELS = ("attention_bwd_dkv_sm90", "attention_bwd_dq_sm90")
# #8 (csrc/encoder_ffn.cu, one instance) and #9a (csrc/encoder_attention_
# variants.cu: variant_sm90<shift, exp bf16, norm, guard, heads a stage>, one
# instance a mode, in ta_encoder_attention_variant's numbering)
FFN_KERNEL = "encoder_ffn_sm90"
VARIANT_KERNEL = "variant_sm90"
VARIANT_INSTANCE_MODES = {
    (0, 0, 0, 0, 1): "fp32", (0, 1, 0, 0, 1): "bf16", (0, 0, 1, 0, 1): "rcp",
    (1, 0, 0, 0, 1): "nomax", (2, 0, 0, 1, 1): "shift", (3, 0, 0, 1, 1): "tilemax",
    (3, 0, 1, 1, 1): "tilemax_rcp", (4, 0, 0, 1, 1): "qnorm", (4, 0, 2, 1, 1): "qnorm_post",
    (0, 0, 2, 1, 1): "fp32_post", (2, 0, 2, 1, 1): "shift_post", (3, 0, 2, 1, 1): "tilemax_post",
    (2, 0, 2, 1, 2): "packed2"}
SM90_INSTANCES = {(SM90_KERNEL, 64, 0, 0), (SM90_KERNEL, 64, 1, 0), (SM90_KERNEL, 64, 1, 1),
                  (SM90_KERNEL, 128, 1, 0), (SM90_KERNEL, 128, 1, 1),
                  *((name, d) for name in SM90_BWD_KERNELS for d in (64, 128)),
                  (FFN_KERNEL,), *((VARIANT_KERNEL, *key) for key in VARIANT_INSTANCE_MODES)}
# the flagship prefill at the JAX bench's batch (bench.py: 48 x 30 s)
BENCH_BATCH = 48


def sm90_instance(mangled: str):
    """The instance of the Hopper design a kernel symbol names:
    (attention_fwd_sm90, head_dim, causal, stats), (attention_bwd_*_sm90,
    head_dim), (encoder_ffn_sm90,) or (variant_sm90, shift, exp bf16, norm,
    guard, heads a stage); None for any other kernel."""
    found = re.search(SM90_KERNEL + r"ILi(\d+)E.*?Lb([01])ELb([01])E", mangled)
    if found:
        return (SM90_KERNEL, *(int(x) for x in found.groups()))
    found = re.search(r"(" + "|".join(SM90_BWD_KERNELS) + r")ILi(\d+)E", mangled)
    if found:
        return (found.group(1), int(found.group(2)))
    if FFN_KERNEL in mangled:
        return (FFN_KERNEL,)
    found = re.search(VARIANT_KERNEL + r"ILi(\d)ELb([01])ELi(\d)ELb([01])ELi(\d)E", mangled)
    return None if found is None else (VARIANT_KERNEL, *(int(x) for x in found.groups()))


def instance_text(inst: tuple) -> str:
    if inst[0] == SM90_KERNEL:
        return f"{SM90_KERNEL}<D={inst[1]}, causal={bool(inst[2])}, stats={bool(inst[3])}>"
    if inst[0] == FFN_KERNEL:
        return f"{FFN_KERNEL} (#8)"
    if inst[0] == VARIANT_KERNEL:
        return f"{VARIANT_KERNEL}<{VARIANT_INSTANCE_MODES[inst[1:]]}> (#9a)"
    return f"{inst[0]}<D={inst[1]}>"


def ptxas_facts(log: str, instance) -> dict:
    """Registers, static shared memory and spilled bytes from the build's
    ``ptxas -v`` log for each kernel that ``instance(mangled name)`` names
    (it returns None for the others)."""
    ptxas: dict = {}
    current = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = instance(entry.group(1))
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            ptxas.setdefault(current, {})["spill_bytes"] = [int(x) for x in spill.groups()]
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            ptxas.setdefault(current, {}).update(
                registers=int(used.group(1)), static_smem_bytes=int(smem.group(1)) if smem else 0)
            current = None
    return ptxas


# #3 and #4: decode_kernel<model dtype, cache dtype, head_dim, update> of
# csrc/decode_attention.cu, one instance per combination the kernels take
DECODE_INSTANCES = {(q, c, d, u) for q in ("bf16", "fp32") for c in ("int8", q)
                    for d in (16, 32, 64, 128, 256) for u in (0, 1)}


def decode_instance(mangled: str):
    """(model dtype, cache dtype, head_dim, update) of a decode_kernel
    symbol, None for any other kernel (the second of two bf16 arguments is
    mangled as a substitution, S<n>_)."""
    found = re.search(r"decode_kernelI(13__nv_bfloat16|f)(a|f|13__nv_bfloat16|S\d*_)"
                      r"Li(\d+)ELb([01])E", mangled)
    if found is None:
        return None
    q = "fp32" if found.group(1) == "f" else "bf16"
    cache = {"a": "int8", "f": "fp32"}.get(found.group(2), "bf16")
    return (q, cache, int(found.group(3)), int(found.group(4)))


def decode_design_facts(log: str) -> None:
    """Registers, static shared memory and spills of every instance of #3
    and #4 (``ptxas -v``).  Fails before any launch if an instance is
    missing, or if one over an int8 or bf16 cache at head_dim <= 128 spills."""
    ptxas = ptxas_facts(log, decode_instance)
    if set(ptxas) != DECODE_INSTANCES:
        fail(f"decode kernel instances: ptxas {sorted(ptxas)}, expected {sorted(DECODE_INSTANCES)}")
    spilling = []
    for inst in sorted(DECODE_INSTANCES):
        q, cache, d, update = inst
        print(f"decode design decode_kernel<Q={q}, cache={cache}, D={d}, update={update}> "
              f"ptxas={json.dumps(ptxas[inst])}")
        if cache in ("int8", "bf16") and d <= 128 and ptxas[inst].get("spill_bytes") != [0, 0]:
            spilling.append(inst)
    if spilling:
        fail(f"decode_kernel instances spill: {spilling}")


# #5 and #6: split_matmul_kernel<W8A8, NT, WN, SHALLOW> of csrc/int8_matmul.cu,
# one instance per batch size class (NT 8-row MMA columns), block arrangement
# and (#5 at 32+ rows) ring depth
INT8_INSTANCES = {(w8a8, nt, wn, shallow) for w8a8 in (0, 1) for nt in (1, 2, 4, 6, 8)
                  for wn in ((1,) if w8a8 else (1, 4))
                  for shallow in ((0, 1) if w8a8 and nt >= 4 else (0,))}


def int8_instance_of(mangled: str):
    """(W8A8, NT, WN, SHALLOW) of a split_matmul_kernel symbol, None for any
    other."""
    found = re.search(r"split_matmul_kernelILb([01])ELi(\d+)ELi(\d+)ELb([01])E", mangled)
    return None if found is None else tuple(int(x) for x in found.groups())


def int8_design_facts(log: str) -> None:
    """Registers, static shared memory and spills of every instance of the
    split design of #5 and #6 (``ptxas -v``).  Fails before any launch if an
    instance is missing or spills."""
    ptxas = ptxas_facts(log, int8_instance_of)
    if set(ptxas) != INT8_INSTANCES:
        fail(f"int8 kernel instances: ptxas {sorted(ptxas)}, expected {sorted(INT8_INSTANCES)}")
    for inst in sorted(INT8_INSTANCES):
        w8a8, nt, wn, shallow = inst
        print(f"int8 design split_matmul_kernel<W8A8={bool(w8a8)}, NT={nt}, WN={wn}, "
              f"SHALLOW={bool(shallow)}> ptxas={json.dumps(ptxas[inst])}")
    spilling = [inst for inst in sorted(INT8_INSTANCES) if ptxas[inst].get("spill_bytes") != [0, 0]]
    if spilling:
        fail(f"split_matmul_kernel instances spill: {spilling}")


def hopper_design_facts(log: str) -> None:
    """What shows that #1, #2, #2b, #2c, #8 and #9a are the Hopper design:
    for each instance of attention_fwd_sm90, attention_bwd_dkv_sm90,
    attention_bwd_dq_sm90, encoder_ffn_sm90 and variant_sm90 (one a #9a
    mode), its registers, static shared memory and spills
    from the build's ``ptxas -v`` log, its dynamic shared memory, and its
    HGMMA (wgmma), UTMALDG (TMA load) and USETMAXREG instructions counted in
    the library's SASS with cuobjdump.  Fails before any launch if an
    instance is missing, spills, or has no HGMMA or no UTMALDG, if ptxas
    serialized a wgmma or ignored a setmaxnreg, or if dkv's or a #9a
    instance's entry registers are not the count its setmaxnreg balances."""
    from tiny_audio_tpu_torch import kernels

    for line in log.splitlines():
        if "wgmma" in line and "serialized" in line:
            fail(f"ptxas serialized a wgmma: {line.strip()}")
        if "C7508" in line or ("setmaxnreg" in line and "ignored" in line):
            fail(f"ptxas ignored a setmaxnreg: {line.strip()}")
    ptxas = ptxas_facts(log, sm90_instance)
    sass = subprocess.run([kernels.cuda_tool("cuobjdump"), "-sass", str(kernels.build()[0])],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    ops = ("HGMMA", "UTMALDG", "USETMAXREG")
    counts: dict = {}
    current = None
    for line in sass.splitlines():
        header = re.search(r"Function : (\S+)", line)
        if header:
            current = sm90_instance(header.group(1))
            if current is not None:
                counts[current] = dict.fromkeys(ops, 0)
            continue
        if current is not None:
            for op in ops:
                counts[current][op] += re.search(r"\b" + op + r"\b", line) is not None
    if set(ptxas) != SM90_INSTANCES or set(counts) != SM90_INSTANCES:
        fail(f"Hopper design instances: ptxas {sorted(ptxas)}, SASS {sorted(counts)}, "
             f"expected {sorted(SM90_INSTANCES)}")
    lib = kernels.library()
    # dkv's registers at entry, which its setmaxnreg balances: with fewer, a
    # consumer's setmaxnreg.inc could wait forever (the launch refuses such a
    # build; the run stops here, before any launch)
    dkv_entry_registers = lib.ta_attention_bwd_sm90_dkv_entry_registers()
    # likewise #9a's instances, whose setmaxnreg split assumes this count
    variant_entry_registers = lib.ta_encoder_attention_variant_entry_registers()
    for inst in sorted(SM90_INSTANCES):
        if inst[0] == SM90_KERNEL:
            smem = lib.ta_attention_sm90_smem_bytes(inst[1], inst[2])
        elif inst[0] == FFN_KERNEL:
            smem = lib.ta_encoder_ffn_smem_bytes()
        elif inst[0] == VARIANT_KERNEL:  # at the bench's T = 1,536
            from tiny_audio_tpu_torch.ops.encoder_attention_variants import MODES

            smem = lib.ta_encoder_attention_variant_smem_bytes(
                MODES.index(VARIANT_INSTANCE_MODES[inst[1:]]), 1536)
        else:
            smem = lib.ta_attention_bwd_sm90_smem_bytes(inst[1], inst[0] == SM90_BWD_KERNELS[0])
        print(f"hopper design {instance_text(inst)} ptxas={json.dumps(ptxas[inst])} "
              f"dynamic_smem_bytes={smem} "
              + " ".join(f"sass_{op}={counts[inst][op]}" for op in ops))
        if not counts[inst]["HGMMA"] or not counts[inst]["UTMALDG"]:
            fail(f"{instance_text(inst)} has no HGMMA or no UTMALDG in its SASS: {counts[inst]}")
        if ptxas[inst].get("spill_bytes", [0, 0]) != [0, 0]:
            fail(f"{instance_text(inst)} spills: {ptxas[inst]}")
        entry = {SM90_BWD_KERNELS[0]: dkv_entry_registers,
                 VARIANT_KERNEL: variant_entry_registers}.get(inst[0])
        if entry is not None and (
                ptxas[inst]["registers"] != entry or not counts[inst]["USETMAXREG"]):
            fail(f"{instance_text(inst)} enters with {ptxas[inst]['registers']} registers and "
                 f"{counts[inst]['USETMAXREG']} USETMAXREG; its setmaxnreg balances {entry}")


def prefill_at_bench_batch(gen: torch.Generator) -> None:
    """Kernel #2 at the JAX bench's batch (B = 48, the flagship's 468-token
    prompt, one row right-padded) against its plain version, with its time,
    achieved TFLOP/s, share of its bound and SDPA's time on the same tensors."""
    import torch.nn.functional as F

    from tiny_audio_tpu_torch.ops.prefill_attention import (
        prefill_attention,
        prefill_attention_plain,
    )

    b, t, hq, hkv, d = BENCH_BATCH, 468, 16, 8, 128
    q = torch.randn((b, t, hq, d), generator=gen, device="cuda").to(torch.bfloat16) * 2
    k, v = (torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
    mask[-1, 400:] = 0
    got = prefill_attention(q, k, v, mask)
    err, within = kernel_error(got[mask.bool()], prefill_attention_plain(q, k, v, mask)[mask.bool()])
    if not within or not bool(torch.isfinite(got[mask.bool()]).all()):
        fail(f"prefill attention kernel disagrees with its plain version at B={b}: {err}")
    ms = cuda_ms(lambda: prefill_attention(q, k, v, mask), 20)
    qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                             enable_gqa=True), 20)
    flops = 4.0 * b * hq * d * t * (t + 1) / 2
    lim = bound(2 * nbytes(q) + nbytes(k, v), flops, BF16_TENSOR_FLOPS)
    print(f"prefill_attention at the bench batch B={b} T={t} Hq={hq} Hkv={hkv} D={d} causal "
          f"max_abs_err={err!r} kernel_ms={ms!r} tflops={flops / ms / 1e9!r} "
          f"bound_ms={lim['bound_ms']!r} bound_share={lim['bound_ms'] / ms!r} "
          f"sdpa_ms={sdpa_ms!r} sdpa_tflops={flops / sdpa_ms / 1e9!r}")


@contextlib.contextmanager
def time_stages(model, store: dict):
    """CUDA events on the card's stream around the first encoder + projector
    call and the first prefill (the decoder's first call over more than one
    position) inside the block; their device milliseconds go into ``store``."""
    events: dict = {}

    def mark(name: str) -> None:
        if name not in events:
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

    def prefill(name: str):
        return lambda module, args, *out: mark(name) if args[0].shape[1] > 1 else None

    hooks = [model.encoder.register_forward_pre_hook(lambda module, args: mark("encoder")),
             model.projector.register_forward_hook(lambda module, args, out: mark("projector")),
             model.decoder.register_forward_pre_hook(prefill("prefill")),
             model.decoder.register_forward_hook(prefill("prefilled"))]
    try:
        yield
    finally:
        for hook in hooks:
            hook.remove()
    torch.cuda.synchronize()
    store["encoder_projector_ms"] = events["encoder"].elapsed_time(events["projector"])
    store["prefill_ms"] = events["prefill"].elapsed_time(events["prefilled"])


def bound(nbytes: float, flops: float, peak_flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def same_bytes(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Bitwise equality (NaN planted in both compares equal)."""
    return torch.equal(x.view(torch.uint8), y.view(torch.uint8))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def decode_bound(q, cache_k, kv_len: int, k_scale, update: bool) -> dict:
    """Bytes the decode step must move: q, fresh K/V and the output once, the
    valid prefix of K, V (and their scales) once, and for the append the new
    row; the operations are fp32 (scores and P.V, 2 x 2 x Hq x kv_len x D per
    batch row), on the CUDA cores."""
    b, hq, d = q.shape
    hkv = cache_k.shape[2]
    row = hkv * d * cache_k.element_size() + (hkv * 4 if k_scale is not None else 0)
    moved = 2 * nbytes(q) + 2 * b * hkv * d * q.element_size() + 2 * b * kv_len * row
    if update:
        moved += 2 * b * row
    return bound(moved, 4.0 * b * hq * (kv_len + 1) * d, FP32_FLOPS)


def sdpa_decode_ms(q, cache_k, cache_v, fresh_k, fresh_v, kv_len: int) -> tuple[float, torch.Tensor]:
    """The one PyTorch call computing kernel #3's function on a bf16 cache:
    scaled_dot_product_attention over the prefix plus the fresh row, the
    concatenation made outside the timed call.  Never called by the port."""
    import torch.nn.functional as F

    k = torch.cat([cache_k[:, :kv_len], fresh_k[:, None]], dim=1).transpose(1, 2).contiguous()
    v = torch.cat([cache_v[:, :kv_len], fresh_v[:, None]], dim=1).transpose(1, 2).contiguous()
    qq = q[:, :, None]
    call = lambda: F.scaled_dot_product_attention(qq, k, v, enable_gqa=True)  # noqa: E731
    return cuda_ms(call, 20), call()[:, :, 0]


def rotation_graph_ms(call, views: int, reps: int = 2) -> float:
    """Mean device milliseconds of ``call(i)`` over a CUDA graph that cycles
    ``reps`` times through views ``i = 0 .. views - 1`` (each call's inputs
    are then cold in L2 when the views outgrow it), replayed 3 times."""
    for i in range(views):  # warm up, outside the capture
        call(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for i in range(views):
                call(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps * views)


def decode_graph_times(gen: torch.Generator) -> dict:
    """Kernels #3 and #4 from a CUDA graph at a cold L2, at every point of
    DECODE_GRAPH_POINTS, over an int8 and a bf16 cache: ``kv_len`` is a
    device tensor, and each graph cycles through the layer views of one
    ``[L, B, S, Hkv, D]`` cache as the fused step reads them (L = 28, or
    more where 28 prefixes fit twice in L2).  Beside each time: its bound,
    the previous design's graph time, and on the bf16 cache SDPA over the same
    rotation (the prefix and the fresh row laid out [B, Hkv, T, D] outside
    the timed call).  Returns {(cache, B, kv_len): stats of both kernels}."""
    import torch.nn.functional as F

    from tiny_audio_tpu_torch.ops.decode_attention import decode_attention, decode_attention_update

    s, hq, hkv, d = DECODE_GRAPH_S, 16, 8, 128
    results = {}
    for quantized in (True, False):
        cache = "int8" if quantized else "bf16"
        for b in dict.fromkeys(b for b, _ in DECODE_GRAPH_POINTS):
            kv_lens = [n for bb, n in DECODE_GRAPH_POINTS if bb == b]
            row = hkv * d * (1 if quantized else 2) + (hkv * 4 if quantized else 0)
            views = max(DECODE_LAYERS, -(-int(2 * L2_BYTES) // (2 * b * min(kv_lens) * row)))
            shape = (views, b, s, hkv, d)
            if quantized:
                ck, cv = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                        dtype=torch.int8) for _ in range(2))
                ks, vs = (torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 + 1e-3
                          for _ in range(2))
            else:
                ck, cv = (torch.empty(shape, dtype=torch.bfloat16, device="cuda")
                          .normal_(generator=gen) for _ in range(2))
                ks = vs = None
            q = (torch.randn((b, hq, d), generator=gen, device="cuda") * 2).to(torch.bfloat16)
            fk, fv = (torch.randn((b, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            layer = lambda x, i: None if x is None else x[i]  # noqa: E731
            for kv_len in kv_lens:
                kv_t = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
                args = lambda i: (q, ck[i], cv[i], fk, fv, kv_t, layer(ks, i), layer(vs, i))  # noqa: E731
                ms3 = rotation_graph_ms(lambda i: decode_attention(*args(i)), views)
                ms4 = rotation_graph_ms(lambda i: decode_attention_update(*args(i)), views)
                bound3 = decode_bound(q, ck[0], kv_len, layer(ks, 0), False)["bound_ms"]
                bound4 = decode_bound(q, ck[0], kv_len, layer(ks, 0), True)["bound_ms"]
                library_ms = lib_err = None
                if not quantized:
                    cat = lambda x, f, i: torch.cat(  # noqa: E731
                        [x[i, :, :kv_len], f[:, None]], dim=1).transpose(1, 2).contiguous()
                    kk = [cat(ck, fk, i) for i in range(views)]
                    vv = [cat(cv, fv, i) for i in range(views)]
                    qq = q[:, :, None]
                    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                        qq, kk[i], vv[i], enable_gqa=True)
                    library_ms = rotation_graph_ms(sdpa, views)
                    lib_err = (decode_attention(*args(1)).float()
                               - sdpa(1)[:, :, 0].float()).abs().max().item()
                    del kk, vv
                previous = PREVIOUS_DECODE_GRAPH_MS.get((cache, b, kv_len), (None, None))
                print(f"decode graph cache={cache} B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
                      f"kv_len={kv_len} views={views} decode_attention_ms={ms3!r} "
                      f"decode_attention_update_ms={ms4!r} bound_ms={bound3!r} "
                      f"update_bound_ms={bound4!r} previous_design_ms={previous[0]!r} "
                      f"previous_design_update_ms={previous[1]!r} library_ms={library_ms!r}"
                      + (f" (SDPA over the same rotation) kernel_vs_sdpa_max_abs_err={lib_err!r}"
                         if not quantized else
                         " (no PyTorch call attends over an int8 cache with per-entry scales)"))
                results[(cache, b, kv_len)] = {
                    "decode_attention": {"ms": ms3, "bound_ms": bound3, "library_ms": library_ms},
                    "decode_attention_update": {"ms": ms4, "bound_ms": bound4,
                                                "library_ms": library_ms}}
            del ck, cv, ks, vs
            torch.cuda.empty_cache()
    check_decode_counters()
    return results


def int8pack_head_times(gen: torch.Generator) -> dict:
    """``torch._weight_int8pack_mm``, the one PyTorch call computing kernel
    #6's function (weight-only int8, per-output-channel scales; the call
    takes its weight [N, K] and its scales in x's dtype, both made outside
    the timed call), at #6's head shape (K 1,024 -> N 151,936), B = 4 and
    48, from a CUDA graph beside #6 from a graph, with its largest
    difference from #6.  A yardstick only: the port never calls it.
    Returns {B: its ms} (empty where torch has no CUDA kernel for it)."""
    import torch.nn.functional as F

    from tiny_audio_tpu_torch.ops.wq_matmul import NT, quantize_weight, wq_matmul

    k, n = INT8_SHAPES["head"]
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.03).to(torch.bfloat16)
    wi, si = quantize_weight(w)
    w_nk, s_lib = wi.T.contiguous(), si.to(torch.bfloat16)
    pad = -n % NT  # the head as the wq collections pad it
    wi_pad, si_pad = F.pad(wi, (0, pad)), F.pad(si, (0, pad))
    library: dict = {}
    for b in (BATCH, BENCH_BATCH):
        x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
        kernel_ms = graph_ms(lambda: wq_matmul(x, wi_pad, si_pad), 20)
        try:
            got = torch._weight_int8pack_mm(x, w_nk, s_lib)
        except (RuntimeError, NotImplementedError) as e:
            print(f"int8pack head K={k} N={n} B={b} wq_graph_ms={kernel_ms!r} library_ms=None "
                  f"(torch {torch.__version__} has no CUDA kernel for _weight_int8pack_mm: "
                  f"{str(e).splitlines()[0]})")
            continue
        err = (got.float() - wq_matmul(x, wi_pad, si_pad)[:, :n].float()).abs().max().item()
        lib_ms = graph_ms(lambda: torch._weight_int8pack_mm(x, w_nk, s_lib), 20)
        library[b] = lib_ms
        print(f"int8pack head K={k} N={n} B={b} wq_graph_ms={kernel_ms!r} library_ms={lib_ms!r} "
              f"(torch._weight_int8pack_mm, CUDA graph) max_abs_err_vs_wq={err!r}")
        if not bool(torch.isfinite(got).all()):
            fail(f"torch._weight_int8pack_mm gave non-finite values at B={b}")
    return library


def compare_decode_kernels(gen: torch.Generator) -> dict:
    """Kernels #3 and #4 against their plain versions and the split's oracle
    (``decode_attention_split_plain``) at the path's shape, int8 and bf16
    caches, B = 1, 4 and 48, at DECODE_KV_LENS and at the edges of the split
    each batch takes (kv_len 0, 1, R - 1, R, R + 1, S - 1), NaN planted in
    every cache row at and past kv_len; the rows #4 writes bitwise the plain
    version's, and two more runs of each kernel bitwise the first.

    The kernels compute in fp32 from the bf16 inputs, so the plain version
    they are held to is ``decode_attention_plain`` on fp32 copies of those
    inputs (no rounding but the output's).  The bf16 plain version rounds
    P x v_scale to bf16 before the product; where large terms cancel that
    alone moves an output past KERNEL_ATOL (an int8 cache at B = 48: kernel
    and fp32 oracle 0.00778, bf16 plain -0.00577), so it is required only at
    the points it was before (B = 4, DECODE_KV_LENS) and printed elsewhere."""
    from tiny_audio_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
        decode_attention_split_plain,
        decode_attention_update,
        decode_attention_update_plain,
        split_plan,
    )

    s, hq, hkv, d = 608, 16, 8, 128
    errs = {"decode_attention": 0.0, "decode_attention_update": 0.0}
    for b in (1, BATCH, BENCH_BATCH):
        rows = split_plan(b, s, hkv, hq // hkv, d, torch.int8).rows
        kv_lens = sorted(n for n in {*DECODE_KV_LENS, 0, 1, rows - 1, rows, rows + 1, s - 1}
                         if n < s)
        for quantized in (True, False):
            for kv_len in kv_lens:
                randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
                q = (randn(b, hq, d) * 2).to(torch.bfloat16)
                fk, fv = (randn(b, hkv, d).to(torch.bfloat16) for _ in range(2))
                if quantized:
                    ck, cv = (torch.randint(-127, 128, (b, s, hkv, d), generator=gen,
                                            device="cuda").to(torch.int8) for _ in range(2))
                    ks, vs = (randn(b, s, hkv).abs() * 0.02 + 1e-3 for _ in range(2))
                    ks[:, kv_len:] = float("nan")  # the int8 rows past kv_len: NaN scales
                    vs[:, kv_len:] = float("nan")
                else:
                    ck, cv = (randn(b, s, hkv, d).to(torch.bfloat16) for _ in range(2))
                    ck[:, kv_len:] = float("nan")
                    cv[:, kv_len:] = float("nan")
                    ks = vs = None
                got = decode_attention(q, ck, cv, fk, fv, kv_len, ks, vs)
                want = decode_attention_plain(q, ck, cv, fk, fv, kv_len, ks, vs)
                exact = decode_attention_plain(q.float(), *(x if x.dtype == torch.int8
                                                            else x.float() for x in (ck, cv)),
                                               fk.float(), fv.float(), kv_len, ks, vs)
                err3, ok3 = kernel_error(got, exact)
                err3_bf16, ok3_bf16 = kernel_error(got, want)
                err_split, ok_split = kernel_error(
                    got, decode_attention_split_plain(q, ck, cv, fk, fv, kv_len, ks, vs))
                repeat = all(same_bytes(got, decode_attention(q, ck, cv, fk, fv, kv_len, ks, vs))
                             for _ in range(2))
                finite = bool(torch.isfinite(got).all())
                # #4: the same attention, and the written row equal to the plain one's
                bufs = [x.clone() if x is not None else None for x in (ck, cv, ks, vs)]
                ref = [x.clone() if x is not None else None for x in (ck, cv, ks, vs)]
                upd = lambda: decode_attention_update(  # noqa: E731
                    q, bufs[0], bufs[1], fk, fv, kv_len, bufs[2], bufs[3])
                got4 = upd()
                want4 = decode_attention_update_plain(q, ref[0], ref[1], fk, fv, kv_len,
                                                      ref[2], ref[3])
                err4, ok4 = kernel_error(got4, exact)  # the attention reads rows < kv_len
                err4_bf16, ok4_bf16 = kernel_error(got4, want4)
                rows_equal = all(same_bytes(x, y) for x, y in zip(bufs, ref) if x is not None)
                repeat = repeat and all(same_bytes(got4, upd()) for _ in range(2))
                rows_equal = rows_equal and all(same_bytes(x, y) for x, y in zip(bufs, ref)
                                                if x is not None)
                finite = finite and bool(torch.isfinite(got4).all())
                line = (f"decode kernels B={b} S={s} Hq={hq} Hkv={hkv} D={d} rows_per_split={rows} "
                        f"cache={'int8' if quantized else 'bf16'} kv_len={kv_len} nan_tail=true "
                        f"decode_attention_max_abs_err={err3!r} "
                        f"decode_attention_update_max_abs_err={err4!r} "
                        f"split_oracle_max_abs_err={err_split!r} "
                        f"bf16_plain_max_abs_err={max(err3_bf16, err4_bf16)!r} "
                        f"bf16_plain_within={str(ok3_bf16 and ok4_bf16).lower()} "
                        f"written_rows_equal={str(rows_equal).lower()} "
                        f"three_runs_bitwise_equal={str(repeat).lower()} "
                        f"atol={KERNEL_ATOL} rtol={KERNEL_RTOL}")
                if kv_len == 468 and b == BATCH:  # the first decode step's prefix
                    # back to back: the wrapper's call rate, not the kernel's time
                    ms3 = cuda_ms(lambda: decode_attention(q, ck, cv, fk, fv, kv_len, ks, vs), 50)
                    line += f" decode_attention_back_to_back_ms={ms3!r}"
                print(line)
                if not finite:
                    fail(f"decode kernels gave non-finite values (B={b}, kv_len={kv_len}, "
                         f"quantized={quantized})")
                legacy = b == BATCH and kv_len in DECODE_KV_LENS
                if not (ok3 and ok4 and ok_split and (ok3_bf16 and ok4_bf16 or not legacy)):
                    worst = ((got.float() - exact.float()).abs()
                             - KERNEL_RTOL * exact.float().abs()).flatten().argmax().item()
                    fail(f"decode kernels disagree with their plain versions (B={b}, "
                         f"kv_len={kv_len}, quantized={quantized}): {err3} {err4} {err_split} "
                         f"{err3_bf16} {err4_bf16}; worst element {worst}: kernel "
                         f"{got.flatten()[worst].item()!r} fp32 plain "
                         f"{exact.flatten()[worst].item()!r} bf16 plain "
                         f"{want.flatten()[worst].item()!r}")
                if not rows_equal:
                    fail(f"decode_attention_update wrote other bytes than its plain version "
                         f"(B={b}, kv_len={kv_len}, quantized={quantized})")
                if not repeat:
                    fail(f"decode kernels gave other bits on a repeated run (B={b}, "
                         f"kv_len={kv_len}, quantized={quantized})")
                errs["decode_attention"] = max(errs["decode_attention"], err3)
                errs["decode_attention_update"] = max(errs["decode_attention_update"], err4)
    decode_graph_replay(gen)
    return errs


def decode_graph_replay(gen: torch.Generator) -> None:
    """#4 then #3 captured once in a CUDA graph, with a device kv_len that the
    graph advances after them (468 -> 469 -> 470, #4 appending each time), at
    B = 1, 4 and 48 over both caches: every replay's outputs and the caches
    at the end bitwise those of the same calls made eagerly; then the merge
    counters all zero."""
    from tiny_audio_tpu_torch.ops.decode_attention import decode_attention, decode_attention_update

    s, hq, hkv, d, start = 608, 16, 8, 128, 468
    for b in (1, BATCH, BENCH_BATCH):
        for quantized in (True, False):
            randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
            q = (randn(b, hq, d) * 2).to(torch.bfloat16)
            fk, fv = (randn(b, hkv, d).to(torch.bfloat16) for _ in range(2))
            if quantized:
                cache = [torch.randint(-127, 128, (b, s, hkv, d), generator=gen, device="cuda")
                         .to(torch.int8) for _ in range(2)]
                cache += [randn(b, s, hkv).abs() * 0.02 + 1e-3 for _ in range(2)]
            else:
                cache = [randn(b, s, hkv, d).to(torch.bfloat16) for _ in range(2)] + [None, None]
            graph_bufs, eager_bufs, warm = ([x if x is None else x.clone() for x in cache]
                                            for _ in range(3))
            kv_t = torch.tensor(start, dtype=torch.int32, device="cuda")
            decode_attention_update(q, *warm[:2], fk, fv, kv_t, *warm[2:])  # outside the capture
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out4 = decode_attention_update(q, *graph_bufs[:2], fk, fv, kv_t, *graph_bufs[2:])
                out3 = decode_attention(q, *graph_bufs[:2], fk, fv, kv_t, *graph_bufs[2:])
                kv_t.add_(1)
            equal = True
            for step in range(3):
                graph.replay()
                want4 = decode_attention_update(q, *eager_bufs[:2], fk, fv, start + step,
                                                *eager_bufs[2:])
                want3 = decode_attention(q, *eager_bufs[:2], fk, fv, start + step,
                                         *eager_bufs[2:])
                equal = equal and same_bytes(out4, want4) and same_bytes(out3, want3)
            equal = equal and int(kv_t) == start + 3 and all(
                same_bytes(x, y) for x, y in zip(graph_bufs, eager_bufs) if x is not None)
            print(f"decode graph replay B={b} cache={'int8' if quantized else 'bf16'} "
                  f"kv_len={start}->{start + 2} (advanced on the device) "
                  f"replays_bitwise_equal_to_eager={str(equal).lower()}")
            if not equal:
                fail(f"decode kernels replayed from a CUDA graph differ from eager calls "
                     f"(B={b}, quantized={quantized})")
    check_decode_counters()


def check_decode_counters() -> None:
    """The counters of the decode kernels, the int8 products and #8 (one
    set of buffers, ``kernels.counter_buffers``) are all zero between
    launches."""
    from tiny_audio_tpu_torch.kernels import counter_buffers

    torch.cuda.synchronize()
    counters = torch.cat(counter_buffers(torch.device("cuda", torch.cuda.current_device())))
    print(f"merge counters (decode attention, int8 products)={counters.numel()} "
          f"all_zero={str(not counters.any()).lower()}")
    if counters.any():
        fail(f"merge counters left non-zero: {counters.nonzero().flatten().tolist()[:8]}")


def compare_decode_on_path_inputs(name: str, kernel, plain, call: tuple) -> dict:
    """Kernel vs plain version on the tensors the path gave the kernel in its
    first layer and first step; the append mutates the cache views, so each
    call gets its own copy of them."""
    args, kwargs = call
    q, ck, cv, fk, fv, kv_len = args[:6]
    ks, vs = kwargs.get("k_scale"), kwargs.get("v_scale")
    n = int(kv_len)
    update = name == "decode_attention_update"
    copies = lambda: [x.clone() if x is not None else None for x in (ck, cv, ks, vs)]  # noqa: E731
    mine, ref = copies(), copies()
    got = kernel(q, mine[0], mine[1], fk, fv, kv_len, k_scale=mine[2], v_scale=mine[3])
    want = plain(q, ref[0], ref[1], fk, fv, n, k_scale=ref[2], v_scale=ref[3])
    err, within = kernel_error(got, want)
    rows_equal = all(same_bytes(x, y) for x, y in zip(mine, ref) if x is not None)
    ms = cuda_ms(lambda: kernel(q, mine[0], mine[1], fk, fv, kv_len,
                                k_scale=mine[2], v_scale=mine[3]), 50)
    plain_ms = cuda_ms(lambda: plain(q, ref[0], ref[1], fk, fv, n,
                                     k_scale=ref[2], v_scale=ref[3]), 10)
    library_ms = None
    if ks is None:
        library_ms, _ = sdpa_decode_ms(q, ck, cv, fk, fv, n)
    stats = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             **decode_bound(q, ck, n, ks, update), "library_ms": library_ms}
    print(f"{name} on the path's layer-0 inputs q={list(q.shape)} {q.dtype} cache={list(ck.shape)} "
          f"{ck.dtype} kv_len={n} max_abs_err={err!r} {tolerance_text(got.dtype)} "
          f"written_rows_equal={str(rows_equal).lower()} "
          f"kernel_back_to_back_ms={ms!r} plain_ms={plain_ms!r} bound_ms={stats['bound_ms']!r} "
          f"library_ms={library_ms!r}"
          + (" (no PyTorch call attends over an int8 cache with per-entry scales)"
             if ks is not None else ""))
    if not bool(torch.isfinite(got).all()):
        fail(f"{name} kernel produced non-finite values on the path's inputs")
    if not within:
        fail(f"{name} kernel disagrees with its plain version on the path's inputs: {err}")
    if not rows_equal:
        fail(f"{name} wrote other cache bytes than its plain version on the path's inputs")
    return stats


def compare_decode_every_shape(gen: torch.Generator) -> dict:
    """Kernels #3 and #4 at every (GQA group, head_dim) pair they take, small
    B and S, int8 and bf16 caches, NaN planted at and past kv_len; the rows
    #4 writes must be bitwise those of the plain version."""
    from tiny_audio_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
        decode_attention_update,
        decode_attention_update_plain,
    )

    b, s, hkv, kv_len = 2, 96, 2, 77
    errs = {"decode_attention": 0.0, "decode_attention_update": 0.0}
    for group, d in DECODE_SHAPES:
        line = []
        for quantized in (True, False):
            randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
            q = (randn(b, group * hkv, d) * 2).to(torch.bfloat16)
            fk, fv = (randn(b, hkv, d).to(torch.bfloat16) for _ in range(2))
            if quantized:
                ck, cv = (torch.randint(-127, 128, (b, s, hkv, d), generator=gen, device="cuda")
                          .to(torch.int8) for _ in range(2))
                ks, vs = (randn(b, s, hkv).abs() * 0.02 + 1e-3 for _ in range(2))
                ks[:, kv_len:] = float("nan")
                vs[:, kv_len:] = float("nan")
            else:
                ck, cv = (randn(b, s, hkv, d).to(torch.bfloat16) for _ in range(2))
                ck[:, kv_len:] = float("nan")
                cv[:, kv_len:] = float("nan")
                ks = vs = None
            got = decode_attention(q, ck, cv, fk, fv, kv_len, ks, vs)
            err3, ok3 = kernel_error(got, decode_attention_plain(q, ck, cv, fk, fv, kv_len, ks, vs))
            mine = [x.clone() if x is not None else None for x in (ck, cv, ks, vs)]
            ref = [x.clone() if x is not None else None for x in (ck, cv, ks, vs)]
            got4 = decode_attention_update(q, mine[0], mine[1], fk, fv, kv_len, mine[2], mine[3])
            err4, ok4 = kernel_error(got4, decode_attention_update_plain(
                q, ref[0], ref[1], fk, fv, kv_len, ref[2], ref[3]))
            rows_equal = all(same_bytes(x, y) for x, y in zip(mine, ref) if x is not None)
            finite = bool(torch.isfinite(got).all()) and bool(torch.isfinite(got4).all())
            cache = "int8" if quantized else "bf16"
            if not (finite and ok3 and ok4 and rows_equal):
                fail(f"decode kernels wrong at group={group} head_dim={d} cache={cache}: "
                     f"errors {err3} {err4}, finite={finite}, written_rows_equal={rows_equal}")
            errs["decode_attention"] = max(errs["decode_attention"], err3)
            errs["decode_attention_update"] = max(errs["decode_attention_update"], err4)
            line.append(f"{cache}_max_abs_err={max(err3, err4)!r}")
        print(f"decode kernels group={group} head_dim={d} B={b} S={s} Hkv={hkv} kv_len={kv_len} "
              f"nan_tail=true written_rows_equal=true {' '.join(line)}")
    return errs


def int8_bound(name: str, x, w_i8, scale) -> dict:
    """Bytes and operations of one int8 product: x, the int8 weight and its
    scales read once, the bf16 output written once; 2 B K N operations at
    the int8 (#5) or bf16 (#6) tensor rate."""
    b, k = x.shape
    n = scale.shape[0]
    peak = INT8_TENSOR_OPS if name == "w8a8_matmul" else BF16_TENSOR_FLOPS
    return bound(nbytes(x, w_i8, scale) + b * n * 2, 2.0 * b * k * n, peak)


def compare_int8_matmuls(gen: torch.Generator) -> dict:
    """Kernels #5 (bitwise) and #6 (within WQ_ATOL + WQ_RTOL) against their
    plain versions at the flagship's layer and head shapes, B = 4, 16 and 48,
    on a random bf16 weight quantized as the decode modes do; beside them
    the time of F.linear on that bf16 weight, what the modes stand in for
    (a yardstick, never called by the port).  Each is timed from the host's
    back-to-back calls and from a CUDA graph of the same calls (device time
    only: a layer product is shorter than its Python call)."""
    import torch.nn.functional as F

    from tiny_audio_tpu_torch.ops.wq_head import (
        quantize_head_w8a8,
        quantize_weight_w8a8,
        w8a8_matmul,
        w8a8_matmul_plain,
    )
    from tiny_audio_tpu_torch.ops.wq_matmul import (
        NT,
        WQ_ATOL,
        WQ_RTOL,
        quantize_weight,
        wq_matmul,
        wq_matmul_plain,
    )

    errs = {"w8a8_matmul": 0.0, "wq_matmul": 0.0}
    for name, (k, n) in INT8_SHAPES.items():
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.03).to(torch.bfloat16)
        wi, si = quantize_weight(w)
        if name == "head":  # padded as the collections pad it
            wt, st = quantize_head_w8a8(w)
            pad = -n % NT
            wi, si = F.pad(wi, (0, pad)), F.pad(si, (0, pad))
        else:
            wt, st = quantize_weight_w8a8(w)
        w_linear = w.T.contiguous()  # nn.Linear's [N, K]
        for b in INT8_BATCHES:
            x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
            got5, want5 = w8a8_matmul(x, wt, st), w8a8_matmul_plain(x, wt, st)
            bitwise = same_bytes(got5, want5)
            err5 = (got5.float() - want5.float()).abs().max().item()
            got6, want6 = wq_matmul(x, wi, si), wq_matmul_plain(x, wi, si)
            diff = (got6.float() - want6.float()).abs()
            err6 = diff.max().item()
            ok6 = bool((diff <= WQ_ATOL + WQ_RTOL * want6.float().abs()).all())
            finite = bool(torch.isfinite(got5).all()) and bool(torch.isfinite(got6).all())
            ms5 = cuda_ms(lambda: w8a8_matmul(x, wt, st), 20)
            ms6 = cuda_ms(lambda: wq_matmul(x, wi, si), 20)
            plain5 = cuda_ms(lambda: w8a8_matmul_plain(x, wt, st), 5)
            plain6 = cuda_ms(lambda: wq_matmul_plain(x, wi, si), 5)
            linear_ms = cuda_ms(lambda: F.linear(x, w_linear), 20)
            graph5 = graph_ms(lambda: w8a8_matmul(x, wt, st), 20)
            graph6 = graph_ms(lambda: wq_matmul(x, wi, si), 20)
            graph_linear = graph_ms(lambda: F.linear(x, w_linear), 20)
            b5, b6 = int8_bound("w8a8_matmul", x, wt, st), int8_bound("wq_matmul", x, wi, si)
            print(f"int8 matmul {name} K={k} N={n} B={b} w8a8_bitwise={str(bitwise).lower()} "
                  f"w8a8_ms={ms5!r} w8a8_graph_ms={graph5!r} w8a8_plain_ms={plain5!r} "
                  f"w8a8_bound_ms={b5['bound_ms']!r} wq_max_abs_err={err6!r} wq_atol={WQ_ATOL} "
                  f"wq_rtol={WQ_RTOL} wq_ms={ms6!r} wq_graph_ms={graph6!r} "
                  f"wq_plain_ms={plain6!r} wq_bound_ms={b6['bound_ms']!r} "
                  f"bf16_linear_ms={linear_ms!r} bf16_linear_graph_ms={graph_linear!r}")
            if not finite:
                fail(f"int8 matmul kernels gave non-finite values at {name} B={b}")
            if not bitwise:
                fail(f"w8a8 matmul kernel is not bitwise its plain version at {name} B={b}: {err5}")
            if not ok6:
                fail(f"wq matmul kernel disagrees with its plain version at {name} B={b}: {err6}")
            errs["w8a8_matmul"] = max(errs["w8a8_matmul"], err5)
            errs["wq_matmul"] = max(errs["wq_matmul"], err6)
    return errs


def int8_weights(w: torch.Tensor, head: bool) -> dict:
    """One bf16 weight ``[K, N]`` as the decode modes store it: #6's ``[K, N]``
    int8 and scales (the head padded to NT), #5's ``[N, K]`` (the head padded
    to NT_HEAD), and nn.Linear's bf16 ``[N, K]`` for the F.linear yardstick."""
    import torch.nn.functional as F

    from tiny_audio_tpu_torch.ops.wq_head import quantize_head_w8a8, quantize_weight_w8a8
    from tiny_audio_tpu_torch.ops.wq_matmul import NT, quantize_weight

    wi, si = quantize_weight(w)
    if head:
        pad = -w.shape[1] % NT
        wi, si = F.pad(wi, (0, pad)), F.pad(si, (0, pad))
    wt, st = quantize_head_w8a8(w) if head else quantize_weight_w8a8(w)
    return {"wq_matmul": (wi, si), "w8a8_matmul": (wt, st), "linear": w.T.contiguous()}


def int8_graph_times(gen: torch.Generator) -> dict:
    """#5, #6 and bf16 F.linear at every INT8_SHAPES shape and INT8_GRAPH_BATCHES
    batch, each from a CUDA graph that cycles through INT8_VIEWS distinct copies
    of the weight (every read cold in L2, as in a decode step, which streams
    28 layers' weights and the head), beside the bound and the previous
    design's time from the same graph.  Returns {(name, B): {kernel: ms}}."""
    from tiny_audio_tpu_torch.ops.wq_head import w8a8_matmul
    from tiny_audio_tpu_torch.ops.wq_matmul import wq_matmul

    import torch.nn.functional as F

    results = {}
    for name, (k, n) in INT8_SHAPES.items():
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.03).to(torch.bfloat16)
        one = int8_weights(w, name == "head")
        del w
        copies = lambda t: t.expand(INT8_VIEWS, *t.shape).clone()  # noqa: E731
        for kernel in ("wq_matmul", "w8a8_matmul", "linear"):
            weights = copies(one[kernel][0] if kernel != "linear" else one[kernel])
            for b in INT8_GRAPH_BATCHES:
                x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
                if kernel == "linear":
                    call = lambda i: F.linear(x, weights[i])  # noqa: E731
                    stats = bound(nbytes(x, weights[0]) + b * n * 2, 2.0 * b * k * n,
                                  BF16_TENSOR_FLOPS)
                else:
                    fn, scale = (wq_matmul if kernel == "wq_matmul" else w8a8_matmul), one[kernel][1]
                    call = lambda i: fn(x, weights[i], scale)  # noqa: E731
                    stats = int8_bound(kernel, x, weights[0], scale)
                ms = rotation_graph_ms(call, INT8_VIEWS)
                results.setdefault((name, b), {})[kernel] = {"ms": ms, **stats}
            del weights
            torch.cuda.empty_cache()
        for b in INT8_GRAPH_BATCHES:
            r = results[(name, b)]
            print(f"int8 graph {name} K={k} N={n} B={b} views={INT8_VIEWS} "
                  + " ".join(f"{kern}_ms={r[kern]['ms']!r} {kern}_bound_ms={r[kern]['bound_ms']!r} "
                             f"{kern}_previous_design_ms="
                             f"{PREVIOUS_INT8_GRAPH_MS.get((kern, name, b))!r}"
                             for kern in ("wq_matmul", "w8a8_matmul"))
                  + f" bf16_linear_ms={r['linear']['ms']!r} "
                  f"bf16_linear_bound_ms={r['linear']['bound_ms']!r} (F.linear, a yardstick)")
    return results


def int8_instance(b: int, k: int, n: int, kind: str) -> str:
    """The kernel instance #5 (``kind`` "w8a8") or #6 ("wq") takes at this
    shape, as text: the split design's template arguments (NT from the rows,
    SHALLOW as ``launch_nt`` in csrc/int8_matmul.cu picks it) and plan, or
    the first design where the plan refuses the shape."""
    from tiny_audio_tpu_torch.ops.wq_matmul import SPLIT_MAX_ROWS, int8_split_plan

    rows = min(b, SPLIT_MAX_ROWS)
    plan = int8_split_plan(rows, k, n, kind)
    if plan is None:
        return "first design (CUDA-core tiles, no split)"
    nt = next(c for c in (1, 2, 4, 6, 8) if rows <= 8 * c)
    shallow = kind == "w8a8" and nt >= 4 and plan.units > 256
    return (f"split_matmul_kernel<W8A8={kind == 'w8a8'}, NT={nt}, WN={plan.warps_n}, "
            f"SHALLOW={shallow}> tile_n={plan.tile_n} split_k={plan.split_k} "
            f"splits={plan.splits} tiles={plan.tiles} units={plan.units}")


def int8_repeat_and_graph(gen: torch.Generator) -> None:
    """#5 and #6 at every INT8_SHAPES shape and INT8_GRAPH_BATCHES batch: the
    instance each takes (every path shape must take the split design), three
    runs bitwise equal, a CUDA graph of both products replayed bitwise equal
    to the eager calls, and the merge counters zero after."""
    from tiny_audio_tpu_torch.ops.wq_head import w8a8_matmul
    from tiny_audio_tpu_torch.ops.wq_matmul import wq_matmul

    for name, (k, n) in INT8_SHAPES.items():
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.03).to(torch.bfloat16)
        one = int8_weights(w, name == "head")
        (wi, si), (wt, st) = one["wq_matmul"], one["w8a8_matmul"]
        for b in INT8_GRAPH_BATCHES:
            x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
            calls = (lambda: wq_matmul(x, wi, si), lambda: w8a8_matmul(x, wt, st))
            eager = [call() for call in calls]
            repeat = all(same_bytes(call(), want) for call, want in zip(calls, eager)
                         for _ in range(2))
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = [call() for call in calls]
            graph.replay()
            torch.cuda.synchronize()
            replay = all(same_bytes(got, want) for got, want in zip(replayed, eager))
            instances = {"wq_matmul": int8_instance(b, k, wi.shape[1], "wq"),
                         "w8a8_matmul": int8_instance(b, k, wt.shape[0], "w8a8")}
            print(f"int8 instance {name} K={k} B={b} " + " ".join(
                f"{kern}=[{text}]" for kern, text in instances.items())
                  + f" three_runs_bitwise={str(repeat).lower()} "
                  f"graph_replay_bitwise={str(replay).lower()}")
            if any(text.startswith("first design") for text in instances.values()):
                fail(f"the int8 products at the path shape {name} B={b} took the first design")
            if not (repeat and replay):
                fail(f"int8 products not repeatable at {name} B={b}: runs {repeat}, graph {replay}")
            del graph
    check_decode_counters()


def int8_step_times(model, kernel: str) -> dict:
    """The int8 products of one decode step under the model's current int8
    mode: the 7 projections of every layer in the path's order, then the
    head, on the model's own ``wq`` collection, from one CUDA graph (two
    steps captured, replayed three times; a step streams every layer's
    weights and the head, so every read is cold in L2), at each
    INT8_GRAPH_BATCHES batch; beside them the same products as bf16
    F.linear on the model's own weights (a yardstick the port never calls)
    and both bounds.  Returns {B: {"ms", "linear_ms", "bound_ms", ...}}."""
    import torch.nn.functional as F

    from tiny_audio_tpu_torch.models.decoder import PROJECTIONS, int8_matmul

    dec = model.decoder
    head_w = dec.embed_tokens.weight if dec.cfg.tie_word_embeddings else dec.lm_head.weight
    results = {}
    for b in INT8_GRAPH_BATCHES:
        gen = torch.Generator(device=model.device).manual_seed(SEED + b)
        layer0 = dec.layers[0]
        xs = {name: torch.randn((b, getattr(layer0, name).in_features), generator=gen,
                                device=model.device).to(torch.bfloat16) for name in PROJECTIONS}
        xh = torch.randn((b, head_w.shape[1]), generator=gen,
                         device=model.device).to(torch.bfloat16)
        calls = [(xs[name], layer, name) for layer in dec.layers for name in PROJECTIONS]

        def step_int8():
            for x, layer, name in calls:
                if int8_matmul(x, layer.wq, name) is None:
                    fail(f"{name} has no int8 weights under {kernel}")
            int8_matmul(xh, dec.wq, "head")

        def step_linear():
            for x, layer, name in calls:
                F.linear(x, getattr(layer, name).weight)
            F.linear(xh, head_w)

        ms = rotation_graph_ms(lambda i: step_int8(), 1, reps=2)
        linear_ms = rotation_graph_ms(lambda i: step_linear(), 1, reps=2)
        wq = dec.wq
        int8_bytes = sum(t.numel() * t.element_size() for t in wq["layers"].values()) + \
            sum(t.numel() * t.element_size() for key, t in wq.items() if key.startswith("head"))
        bf16_bytes = sum(getattr(layer, name).weight.numel() * 2 for layer in dec.layers
                         for name in PROJECTIONS) + head_w.numel() * 2
        ops = 2.0 * b * (sum(getattr(layer0, name).weight.numel() for name in PROJECTIONS)
                         * len(dec.layers) + head_w.numel())
        peak = INT8_TENSOR_OPS if kernel == "w8a8_matmul" else BF16_TENSOR_FLOPS
        r = {"ms": ms, "linear_ms": linear_ms, **bound(int8_bytes, ops, peak),
             "linear_bound_ms": bound(bf16_bytes, ops, BF16_TENSOR_FLOPS)["bound_ms"],
             "previous_design_ms": PREVIOUS_INT8_GRAPH_MS.get((kernel, "step", b))}
        print(f"int8 step {kernel} B={b} products={len(calls) + 1} int8_step_ms={ms!r} "
              f"bound_ms={r['bound_ms']!r} previous_design_ms={r['previous_design_ms']!r} "
              f"bf16_linear_step_ms={linear_ms!r} bf16_linear_bound_ms={r['linear_bound_ms']!r} "
              f"int8_weight_bytes={int8_bytes} (CUDA graph of two steps, cold L2)")
        results[b] = r
    return results


def compare_int8_on_path_inputs(name: str, kernel, plain, call: tuple, bf16_weight) -> dict:
    """#5 or #6 against its plain version on the tensors the generate path
    gave it first (the prefill's one-row head), with its bound and the time
    of F.linear on the bf16 head weight of the same product."""
    import torch.nn.functional as F

    from tiny_audio_tpu_torch.ops.wq_matmul import WQ_ATOL, WQ_RTOL

    args, _ = call
    x, w_i8, scale = args
    got, want = kernel(*args), plain(*args)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if name == "w8a8_matmul":
        within = same_bytes(got, want)
    else:
        within = bool((diff <= WQ_ATOL + WQ_RTOL * want.float().abs()).all())
    ms = cuda_ms(lambda: kernel(*args), 20)
    plain_ms = cuda_ms(lambda: plain(*args), 5)
    library_ms = cuda_ms(lambda: F.linear(x, bf16_weight), 20)
    stats = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             **int8_bound(name, x, w_i8, scale), "library_ms": None}
    print(f"{name} on the path's first inputs x={list(x.shape)} weight={list(w_i8.shape)} "
          f"max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r} "
          f"bound_ms={stats['bound_ms']!r} bf16_linear_ms={library_ms!r} (F.linear on the "
          f"unquantized head, a yardstick: no PyTorch call computes the int8 function)")
    if not bool(torch.isfinite(got).all()) or not within:
        fail(f"{name} kernel disagrees with its plain version on the path's inputs: {err}")
    return stats


def serve_requests(model, rng, reset_counts, read_counts) -> str:
    """Save ``model`` in the JAX package's checkpoint layout, serve it with
    ``EndpointHandler(path, w8a8_decode=True)`` behind ``make_server`` and a
    ``DynamicBatcher``, send three concurrent ``POST /transcribe`` (pcm-f32)
    and read ``/healthz`` and ``/metrics``.  Returns the phase's numbers."""
    from tiny_audio_tpu_torch.batching import DynamicBatcher
    from tiny_audio_tpu_torch.handler import EndpointHandler
    from tiny_audio_tpu_torch.serving import make_server

    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        model.save_pretrained(ckpt)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt).iterdir())
        t0 = time.perf_counter()
        handler = EndpointHandler(ckpt, w8a8_decode=True)
        phase_done()
        load_s = time.perf_counter() - t0
    served = handler.pipe.model
    if served.device.type != "cuda" or served.wq is None or "head_t_i8" not in served.wq:
        fail("the handler did not build a W8A8 model on the card")
    for (name, a), (_, b) in zip(model.named_parameters(), served.named_parameters()):
        if not torch.equal(a, b):
            fail(f"the checkpoint read back another {name}")
    batcher = DynamicBatcher(handler.pipe, max_batch=4, max_wait_ms=200)
    server = make_server(handler, host="127.0.0.1", port=0, batcher=batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    answers: list = [None] * len(REQUEST_SECONDS)

    def post(i: int, seconds: float) -> None:
        clip = (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)
        req = urllib.request.Request(f"{url}/transcribe", data=clip.tobytes(),
                                     headers={"Content-Type": "application/pcm-f32"})
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                answers[i] = (r.status, json.loads(r.read()), time.perf_counter() - t)
        except Exception as e:  # reported below, after the threads join
            answers[i] = (None, repr(e), time.perf_counter() - t)

    reset_counts()
    t0 = time.perf_counter()
    posts = [threading.Thread(target=post, args=(i, sec)) for i, sec in enumerate(REQUEST_SECONDS)]
    for t in posts:
        t.start()
    for t in posts:
        t.join()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
        metrics = r.read().decode()
    batcher.close()
    server.shutdown()
    thread.join(timeout=60)
    for seconds, (status, body, _) in zip(REQUEST_SECONDS, answers):
        if status != 200 or not isinstance(body, dict) or not isinstance(body.get("text"), str):
            fail(f"POST /transcribe of {seconds} s answered {status}: {body!r}")
    done = 'ta_requests_total{route="/transcribe",code="200"} ' + str(len(REQUEST_SECONDS))
    if health.get("status") != "ok" or done not in metrics.splitlines():
        fail(f"/healthz or /metrics wrong: {health!r}, no line {done!r}")
    if counts["w8a8_matmul"] == 0 or counts["decode_attention_update"] == 0:
        fail(f"the served requests missed a kernel of the W8A8 path: {counts}")
    del handler, served
    torch.cuda.empty_cache()
    return (f"status={[a[0] for a in answers]} latency_s={[a[2] for a in answers]} "
            f"wall_s={wall_s!r} text_chars={[len(a[1]['text']) for a in answers]} "
            f"checkpoint_bytes={ckpt_bytes} save_s={save_s!r} load_s={load_s!r} "
            f"healthz={json.dumps(health)} launches={json.dumps(counts)}")


def backward_error(got: torch.Tensor, want32: torch.Tensor, ref16: torch.Tensor) -> tuple[float, float, bool]:
    """(error against fp32, the plain backward's error in got's dtype, within
    the criterion and finite).  bf16: BWD_ERR_RATIO times the bf16 plain
    backward's error plus BWD_FLOOR of the largest |want|; fp32: FP32_TOL."""
    want32 = want32.float()
    err = (got.float() - want32).abs().max().item()
    ref_err = (ref16.float() - want32).abs().max().item()
    if got.dtype == torch.float32:
        limit = FP32_TOL * max(want32.abs().max().item(), 1.0)
    else:
        limit = BWD_ERR_RATIO * ref_err + BWD_FLOOR * want32.abs().max().item()
    return err, ref_err, bool(torch.isfinite(got).all()) and err <= limit


def check_prefill_backward(q, k, v, mask, dout, label: str) -> dict:
    """Forward with statistics, then both backward kernels, against the
    plain backward in fp32 and in bf16; fails the run on a disagreement."""
    from tiny_audio_tpu_torch.ops.prefill_attention import (
        attention_delta,
        prefill_attention_backward_plain,
        prefill_attention_bwd_dkv,
        prefill_attention_bwd_dq,
        prefill_attention_forward,
        prefill_attention_plain,
    )

    out, m, l = prefill_attention_forward(q, k, v, mask)
    fwd_err, fwd_ok = kernel_error(out, prefill_attention_plain(q, k, v, mask))
    delta = attention_delta(out, dout)
    dk, dv = prefill_attention_bwd_dkv(q, k, v, mask, dout, m, l, delta)
    dq = prefill_attention_bwd_dq(q, k, v, mask, dout, m, l, delta)
    want = prefill_attention_backward_plain(*(x.float() for x in (q, k, v)), mask, dout.float())
    ref = prefill_attention_backward_plain(q, k, v, mask, dout)
    errs = {}
    for name, got, w, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want, ref):
        err, ref_err, ok = backward_error(got, w, r)
        errs[name] = (err, ref_err)
        if not ok:
            fail(f"prefill backward {name} at {label}: error {err} against the fp32 plain "
                 f"backward, the bf16 plain backward's {ref_err}")
    if not fwd_ok or not bool(torch.isfinite(out).all()):
        fail(f"prefill forward with statistics disagrees with its plain version at {label}: {fwd_err}")
    return {"forward": fwd_err, "dkv": max(errs["dk"][0], errs["dv"][0]), "dq": errs["dq"][0],
            "errs": errs}


def compare_prefill_every_shape(gen: torch.Generator) -> dict:
    """Kernel #2's forward (serving launch and with statistics) and its two
    backward kernels at every (GQA group, head_dim) pair, B=2, ragged T=131,
    padding inside one row and at the end of the other."""
    from tiny_audio_tpu_torch.ops.prefill_attention import prefill_attention, prefill_attention_plain

    b, t, hkv = 2, 131, 2
    worst = {"prefill_attention": 0.0, "prefill_attention_bwd_dkv": 0.0,
             "prefill_attention_bwd_dq": 0.0}
    for group, d in DECODE_SHAPES:
        randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
        q = (randn(b, t, group * hkv, d) * 2).to(torch.bfloat16)
        k, v = (randn(b, t, hkv, d).to(torch.bfloat16) for _ in range(2))
        dout = randn(b, t, group * hkv, d).to(torch.bfloat16)
        mask = torch.ones((b, t), dtype=torch.int32, device="cuda")
        mask[0, 5:9] = 0
        mask[1, 90:] = 0
        serve_err, serve_ok = kernel_error(prefill_attention(q, k, v, mask),
                                           prefill_attention_plain(q, k, v, mask))
        if not serve_ok:
            fail(f"prefill forward disagrees at group={group} head_dim={d}: {serve_err}")
        r = check_prefill_backward(q, k, v, mask, dout, f"group={group} head_dim={d}")
        worst["prefill_attention"] = max(worst["prefill_attention"], serve_err, r["forward"])
        worst["prefill_attention_bwd_dkv"] = max(worst["prefill_attention_bwd_dkv"], r["dkv"])
        worst["prefill_attention_bwd_dq"] = max(worst["prefill_attention_bwd_dq"], r["dq"])
        print(f"prefill kernels group={group} head_dim={d} B={b} T={t} Hkv={hkv} bf16 "
              f"forward_max_abs_err={max(serve_err, r['forward'])!r} "
              + " ".join(f"{n}_err={e!r} {n}_bf16_plain_err={pe!r}"
                         for n, (e, pe) in r["errs"].items())
              + f" ratio_limit={BWD_ERR_RATIO} floor={BWD_FLOOR}")
    return worst


def sdpa_backward_graph_ms(q, k, v, dout) -> dict:
    """Device ms of scaled_dot_product_attention's backward (a yardstick the
    port never calls: one autograd call computing dq, dk and dv, causal, GQA,
    without the padding mask, which SDPA's causal path does not take) for
    each non-math backend that takes these inputs, pinned with
    ``sdpa_kernel``: back to back, and captured in a CUDA graph.  The forward
    runs on the capture stream, so the autograd backward it records does
    too."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qq, kk, vv = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dd = dout.transpose(1, 2).contiguous()
    params = torch.backends.cuda.SDPAParams(qq, kk, vv, None, 0.0, True, True)
    usable = {SDPBackend.FLASH_ATTENTION: torch.backends.cuda.can_use_flash_attention,
              SDPBackend.CUDNN_ATTENTION: torch.backends.cuda.can_use_cudnn_attention,
              SDPBackend.EFFICIENT_ATTENTION: torch.backends.cuda.can_use_efficient_attention}
    times = {}
    for backend, can_use in usable.items():
        if not can_use(params, False):
            continue
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with sdpa_kernel(backend), torch.cuda.stream(stream):
            out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, enable_gqa=True)
        torch.cuda.current_stream().wait_stream(stream)

        def backward(out=out):
            return torch.autograd.grad(out, (qq, kk, vv), dd, retain_graph=True)

        times[backend.name] = {"ms": cuda_ms(backward, 20),
                               "graph_ms": graph_ms(backward, 20, stream=stream)}
    if not times:
        fail("no fused SDPA backend takes the training path's attention: no yardstick")
    return times


def compare_backward_on_path_inputs(call: tuple) -> dict:
    """The backward kernels on the tensors the training path gave them first
    (the backward's first call: the last layer), against the plain backward,
    with times: the forward with statistics (on the same layer's inputs),
    each backward kernel, ``attention_delta`` and the port's whole backward
    (``attention_delta`` + dkv + dq) back to back and from a CUDA graph, the plain backward (bf16
    autograd), the bound, and SDPA's backward per pinned backend
    (:func:`sdpa_backward_graph_ms`); the library time is the fastest
    backend's from a CUDA graph, as the kernels' times."""
    from tiny_audio_tpu_torch.ops.prefill_attention import (
        attention_delta,
        prefill_attention_backward_plain,
        prefill_attention_bwd_dkv,
        prefill_attention_bwd_dq,
        prefill_attention_forward,
    )

    q, k, v, mask, dout, m, l, delta = call
    out = prefill_attention_forward(q, k, v, mask)[0]
    r = check_prefill_backward(q, k, v, mask, dout, "the training path's inputs")
    fwd_ms = cuda_ms(lambda: prefill_attention_forward(q, k, v, mask), 20)
    fwd_graph_ms = graph_ms(lambda: prefill_attention_forward(q, k, v, mask), 20)

    def dkv():
        return prefill_attention_bwd_dkv(q, k, v, mask, dout, m, l, delta)

    def dq():
        return prefill_attention_bwd_dq(q, k, v, mask, dout, m, l, delta)

    def whole():
        d = attention_delta(out, dout)
        return (prefill_attention_bwd_dkv(q, k, v, mask, dout, m, l, d),
                prefill_attention_bwd_dq(q, k, v, mask, dout, m, l, d))

    times = {name: {"ms": cuda_ms(fn, 20), "graph_ms": graph_ms(fn, 20)}
             for name, fn in (("dkv", dkv), ("dq", dq), ("delta", lambda: attention_delta(out, dout)),
                              ("backward", whole))}
    plain_ms = cuda_ms(lambda: prefill_attention_backward_plain(q, k, v, mask, dout), 5)
    sdpa = sdpa_backward_graph_ms(q, k, v, dout)
    fastest = min(sdpa, key=lambda name: sdpa[name]["graph_ms"])
    b, t, hq, d = q.shape
    fwd_flops = 4.0 * b * hq * d * t * (t + 1) / 2  # causal: keys 1..t for query row t
    inputs = nbytes(q, k, v, mask, dout, m, l, delta)
    # dkv recomputes S and dP and forms dV, dK (2x the forward's products);
    # dq recomputes S and dP and forms dQ (1.5x); a fused backward 2.5x
    b_dkv = bound(inputs + nbytes(k, v), 2.0 * fwd_flops, BF16_TENSOR_FLOPS)
    b_dq = bound(inputs + nbytes(q), 1.5 * fwd_flops, BF16_TENSOR_FLOPS)
    b_bwd = bound(inputs + nbytes(q, k, v), 2.5 * fwd_flops, BF16_TENSOR_FLOPS)
    flops = {"dkv": 2.0 * fwd_flops, "dq": 1.5 * fwd_flops, "delta": 0.0,
             "backward": 3.5 * fwd_flops}
    print(f"prefill backward on the training path's inputs q={list(q.shape)} k={list(k.shape)} "
          f"real_keys={int(mask.sum()) if mask is not None else 'all'} "
          + " ".join(f"{n}_err={e!r} {n}_bf16_plain_err={pe!r}" for n, (e, pe) in r["errs"].items())
          + f" fwd_stats_ms={fwd_ms!r} fwd_stats_graph_ms={fwd_graph_ms!r} "
          + " ".join(f"{n}_ms={x['ms']!r} {n}_graph_ms={x['graph_ms']!r} "
                     f"{n}_graph_tflops={flops[n] / x['graph_ms'] / 1e9!r}"
                     for n, x in times.items())
          + f" plain_backward_ms={plain_ms!r} bound_dkv_ms={b_dkv['bound_ms']!r} "
          f"bound_dq_ms={b_dq['bound_ms']!r} bound_backward_2.5x_ms={b_bwd['bound_ms']!r} "
          + " ".join(f"sdpa_{n}_backward_ms={x['ms']!r} sdpa_{n}_backward_graph_ms={x['graph_ms']!r}"
                     for n, x in sdpa.items())
          + f" library=sdpa_{fastest}_backward_graph")
    library_ms = sdpa[fastest]["graph_ms"]
    return {
        "prefill_attention_bwd_dkv": {"max_abs_err": r["dkv"], "ms": times["dkv"]["graph_ms"],
                                      "plain_ms": plain_ms, **b_dkv, "library_ms": library_ms},
        "prefill_attention_bwd_dq": {"max_abs_err": r["dq"], "ms": times["dq"]["graph_ms"],
                                     "plain_ms": plain_ms, **b_dq, "library_ms": library_ms},
        "fwd_stats_ms": fwd_ms,
    }


def train_phases(reset_counts, read_counts) -> dict:
    """Training at the flagship width on the card (see the module docstring).
    Returns the backward kernels' path numbers and the stage-1 run's counts."""
    from tiny_audio_tpu_torch import ASRConfig
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.train.data import synthetic_dataset
    from tiny_audio_tpu_torch.train.optim import OptimizerConfig
    from tiny_audio_tpu_torch.train.trainer import Trainer, TrainingConfig

    rows = synthetic_dataset(TRAIN_BATCH, seed=SEED, min_s=TRAIN_CLIP_S[0],
                             max_s=TRAIN_CLIP_S[1])
    path_inputs: dict = {}
    results = {}
    tmp = tempfile.mkdtemp()

    class StepClock:
        """Host time at each logged optimizer step (logging reads the loss,
        which waits for the device)."""

        def __init__(self):
            self.times = []

        def on_log(self, trainer, record):
            self.times.append(time.perf_counter())

    def run(label, model, steps, accum=1, record=False):
        collator = DataCollator(model.tokenizer, model.projector,
                                num_mel_bins=model.config.encoder.num_mel_bins,
                                system_prompt=model.config.system_prompt,
                                encoder_conv_layers=model.config.encoder_conv_layers,
                                device=model.device)
        out_dir = Path(tmp) / label
        config = TrainingConfig(
            output_dir=str(out_dir), max_steps=steps, per_device_batch_size=TRAIN_BATCH,
            gradient_accumulation_steps=accum, logging_steps=1, save_steps=0, eval_steps=0,
            dataloader_workers=0, seed=SEED,
            optimizer=OptimizerConfig(learning_rate=TRAIN_LR, lr_scheduler_type="constant"))
        # snapshots on the host, so the device's peak memory is the run's own
        snapshot = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
        frozen = {n: t for n, t in snapshot.items() if not model.get_parameter(n).requires_grad}
        trainable = {n: t for n, t in snapshot.items() if n not in frozen}
        clock = StepClock()
        trainer = Trainer(model, config, rows, collator, callbacks=[clock])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        if record:
            with record_first_backward(path_inputs):
                trainer.train()
        else:
            trainer.train()
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        micro = steps * accum
        forwards = 2 if model.config.gradient_checkpointing else 1
        n_enc, n_dec = model.config.encoder.num_layers, model.config.decoder.num_layers
        want = {name: 0 for name in counts}
        want.update({"encoder_attention": n_enc * micro,
                     "prefill_attention": n_dec * micro * forwards,
                     "prefill_attention_bwd_dkv": n_dec * micro,
                     "prefill_attention_bwd_dq": n_dec * micro})
        if counts != want:
            fail(f"training run {label} launches {counts}, expected {want}")
        records = [json.loads(line)
                   for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["ce_loss"] for r in records]
        norms = [r["grad_norm"] for r in records]
        if len(losses) != steps or not all(np.isfinite(losses + norms)):
            fail(f"training run {label}: losses {losses}, grad norms {norms}")
        params = dict(model.named_parameters())
        for name, before in frozen.items():
            if not same_bytes(before, params[name].detach().cpu()):
                fail(f"training run {label} changed the frozen parameter {name}")
        changed = [n for n, before in trainable.items()
                   if not torch.equal(params[n].detach().cpu(), before)]
        if not changed:
            fail(f"training run {label} changed no trainable parameter")
        del frozen, trainable
        step_times = [float(x) for x in np.diff([t0] + clock.times)]
        step_ms = float(np.mean(step_times[1:]) * 1e3) if len(step_times) > 1 else None
        print(f"train run={label} stage={'2 (LoRA)' if model.config.use_lora else '1'} "
              f"batch={TRAIN_BATCH} clip_s={list(TRAIN_CLIP_S)} steps={steps} accum={accum} "
              f"checkpointing={str(model.config.gradient_checkpointing).lower()} "
              f"first_step_ms={step_times[0] * 1e3!r} step_ms_after_first={step_ms!r} "
              f"peak_mem_gib={peak_gib!r} first_loss={losses[0]!r} last_loss={losses[-1]!r} "
              f"grad_norms={[round(x, 4) for x in norms]} trainable_changed={len(changed)} "
              f"frozen_unchanged=true launches={json.dumps(counts)} "
              f"micro_steps={micro}")
        results[label] = {"losses": losses, "counts": counts, "out_dir": out_dir}
        phase_done()
        return losses

    t0 = time.perf_counter()
    model = ASRModel(ASRConfig(), seed=SEED)  # stage 1: freeze_language_model, the default
    phase_done()
    print(f"train init_s={time.perf_counter() - t0!r} trainable_params="
          f"{sum(p.numel() for p in model.parameters() if p.requires_grad)}")
    losses = run("stage1", model, TRAIN_STEPS, record=True)
    if not losses[-1] < losses[0]:
        fail(f"stage 1 on one repeated batch did not lower the loss: {losses}")
    run("stage1_accum2", model, 2, accum=2)
    del model
    torch.cuda.empty_cache()
    model = ASRModel(ASRConfig(gradient_checkpointing=True), seed=SEED)
    run("stage1_checkpointed", model, 3)
    del model
    torch.cuda.empty_cache()
    model = ASRModel(ASRConfig(use_lora=True, lora_rank=8, lora_alpha=32,
                               freeze_projector=True), seed=SEED)
    run("stage2_lora", model, 3)

    # model/ of the LoRA run back from disk, on the card, and generating
    t0 = time.perf_counter()
    loaded = ASRModel.from_pretrained(results["stage2_lora"]["out_dir"] / "model")
    phase_done()
    load_s = time.perf_counter() - t0
    if loaded.device.type != "cuda" or not loaded.config.use_lora:
        fail("model/ did not load as a LoRA model on the card")
    for (name, a), (_, b) in zip(model.named_parameters(), loaded.named_parameters()):
        if not torch.equal(a, b):
            fail(f"model/ read back another {name}")
    from tiny_audio_tpu_torch.processing import ASRProcessor

    feats = ASRProcessor(loaded.projector, num_mel_bins=loaded.config.encoder.num_mel_bins,
                         device=loaded.device).extract_features(
        [rows[0]["audio"]["array"], rows[1]["audio"]["array"]])
    tokens = loaded.generate(feats["input_features"], feats["audio_attention_mask"],
                             min_new_tokens=8, max_new_tokens=8)
    vocab = loaded.config.decoder.vocab_size
    if tokens.shape != (2, 8) or tokens.min() < 0 or tokens.max() >= vocab:
        fail(f"generate on the loaded LoRA model gave {tokens!r}")
    files = sorted(p.name for p in (results["stage2_lora"]["out_dir"] / "model").iterdir())
    print(f"train model_dir_loaded=true files={files} load_s={load_s!r} "
          f"generate_tokens_shape={list(tokens.shape)}")
    del model, loaded
    torch.cuda.empty_cache()
    phase_done()

    path = compare_backward_on_path_inputs(path_inputs["backward"])
    shutil.rmtree(tmp)
    return {"path": path, "counts": results["stage1"]["counts"]}


def mel_oracle_fp64(audio: torch.Tensor, mels: int) -> torch.Tensor:
    """The log-mel formula in float64 on the card: frame t is the 400 padded
    samples at t * hop, hann-windowed DFT, power, filterbank, log10, clamp."""
    from tiny_audio_tpu_torch.ops.mel import (
        HOP_LENGTH,
        N_FFT,
        _dft_basis,
        mel_filter_bank,
        normalize_log_spec,
        pad_audio,
    )

    n_frames = audio.shape[1] // HOP_LENGTH
    frames = pad_audio(audio).double().unfold(1, N_FFT, HOP_LENGTH)[:, :n_frames]
    cos_b, sin_b = (torch.from_numpy(b).to(audio.device) for b in _dft_basis())
    power = (frames @ cos_b.T) ** 2 + (frames @ sin_b.T) ** 2
    fb = torch.from_numpy(mel_filter_bank(N_FFT // 2 + 1, mels)).to(audio.device)
    mel = (power @ fb).transpose(1, 2)
    return normalize_log_spec(torch.log10(torch.clamp(mel, min=1e-10)))


def mel_bound(audio: torch.Tensor, mels: int) -> dict:
    """Kernel #7's bound from the work its function needs, not the work the
    kernel does: the audio read and the features written once, and per frame
    the window, a real FFT of 400 samples (2.5 N log2 N, half a complex
    FFT's 5 N log2 N), the power (two products and a sum per bin), the
    filterbank's nonzero weights (each bin feeds at most two triangles) and
    one log per mel, in fp32."""
    from tiny_audio_tpu_torch.ops.mel import HOP_LENGTH, N_FFT, mel_filter_bank

    b, n = audio.shape
    t = n // HOP_LENGTH
    n_freq = N_FFT // 2 + 1
    nonzero = int(np.count_nonzero(mel_filter_bank(n_freq, mels)))
    per_frame = N_FFT + 2.5 * N_FFT * np.log2(N_FFT) + 3 * n_freq + 2 * nonzero + mels
    return bound(nbytes(audio) + b * mels * t * 4, b * t * per_frame, FP32_FLOPS)


def front_end_phase(serving_audio: list, reset_counts, read_counts) -> dict:
    """Kernel #7 through its entry point, ``log_mel_spectrogram_fused``, on the
    serving batch's audio, the training batch's clips zero-padded to 30 s and
    the edge shapes of tests/test_mel_pallas.py; each output against the plain
    mel and both against an fp64 oracle; then timed at the serving batch
    beside the plain mel and torch.stft + power + filterbank."""
    from tiny_audio_tpu_torch.ops.mel import log_mel_spectrogram, pad_audio
    from tiny_audio_tpu_torch.ops.mel_fused import (
        kernel_constants,
        launch_log_mel,
        log_mel_spectrogram_fused,
    )
    from tiny_audio_tpu_torch.train.data import synthetic_dataset

    n30 = int(CLIP_S * 16000)
    clips = [r["audio"]["array"] for r in synthetic_dataset(
        TRAIN_BATCH, seed=SEED, min_s=TRAIN_CLIP_S[0], max_s=TRAIN_CLIP_S[1])]
    train = np.zeros((len(clips), n30), np.float32)
    for i, clip in enumerate(clips):
        train[i, : len(clip)] = clip[:n30]
    rng = np.random.default_rng(SEED + 7)
    noise = lambda b, n: (rng.standard_normal((b, n)) * 0.1).astype(np.float32)  # noqa: E731
    cases = [("serving_4x30s", np.stack(serving_audio), 128),
             ("training_6x10-30s_zero_padded", train, 128),
             ("1s_80mels", noise(2, 16000), 80), ("3s_128mels", noise(2, 48000), 128),
             ("one_tpu_tile", noise(2, 256 * 160), 128), ("30s_128mels", noise(2, n30), 128),
             ("silence_80mels", np.zeros((1, 32000), np.float32), 80),
             ("160_samples_constant_pad", noise(2, 160), 80)]
    inputs = [(label, torch.from_numpy(a).cuda(), mels) for label, a, mels in cases]
    torch.cuda.synchronize()
    reset_counts()
    outs = [log_mel_spectrogram_fused(x, num_mel_bins=mels) for _, x, mels in inputs]
    torch.cuda.synchronize()
    counts = read_counts()
    want = {name: 0 for name in counts}
    want["log_mel_spectrogram_fused"] = len(inputs)
    if counts != want:
        fail(f"the front-end phase launches {counts}, expected {want}")
    worst = 0.0
    for (label, x, mels), got in zip(inputs, outs):
        plain = log_mel_spectrogram(x, mels)
        oracle = mel_oracle_fp64(x, mels)
        err = (got - plain).abs().max().item()
        err_k = (got.double() - oracle).abs().max().item()
        err_p = (plain.double() - oracle).abs().max().item()
        at_floor = oracle <= oracle.amin(dim=(1, 2), keepdim=True) + 1e-6
        floor_err = (got - plain).abs()[at_floor].max().item() if at_floor.any() else None
        within = err_k <= MEL_ERR_RATIO * err_p + MEL_FLOOR
        print(f"log_mel_spectrogram_fused {label} shape={list(x.shape)} mels={mels} "
              f"max_abs_err_vs_plain={err!r} kernel_vs_fp64={err_k!r} plain_vs_fp64={err_p!r} "
              f"limit=({MEL_ERR_RATIO} x plain + {MEL_FLOOR}) bins_at_floor={int(at_floor.sum())} "
              f"max_abs_err_at_floor={floor_err!r}")
        if got.shape != plain.shape or not bool(torch.isfinite(got).all()):
            fail(f"the front-end kernel gave shape {tuple(got.shape)} or non-finite values at {label}")
        if not within:
            fail(f"the front-end kernel is further from fp64 than its plain version allows at "
                 f"{label}: {err_k} against {err_p}")
        worst = max(worst, err)

    # times at the serving batch: the kernel alone, the entry point, the plain
    # mel and the library chain (torch.stft, power, filterbank, log, clamp)
    _, x, mels = inputs[0]
    b, n = x.shape
    t = n // 160
    padded = pad_audio(x)[:, : (t + 3) * 160].contiguous()
    ms = cuda_ms(lambda: launch_log_mel(padded, t, mels), 20)
    entry_ms = cuda_ms(lambda: log_mel_spectrogram_fused(x, mels), 20)
    plain_ms = cuda_ms(lambda: log_mel_spectrogram(x, mels), 20)
    window = torch.hann_window(400, periodic=True, device=x.device)
    fb = torch.from_numpy(kernel_constants(mels)[1]).cuda()

    def library():
        spec = torch.stft(x, 400, 160, window=window, center=True, pad_mode="reflect",
                          return_complex=True)[..., :-1]
        mel = torch.matmul(fb.T, spec.abs() ** 2)
        log_spec = torch.log10(torch.clamp(mel, min=1e-10))
        return (torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0) + 4.0) / 4.0

    library_ms = cuda_ms(library, 20)
    stft_ms = cuda_ms(lambda: torch.stft(x, 400, 160, window=window, center=True,
                                         pad_mode="reflect", return_complex=True), 20)
    library_err = (library() - outs[0]).abs().max().item()
    stats = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             **mel_bound(x, mels), "library_ms": library_ms}
    print(f"log_mel_spectrogram_fused timing shape={list(x.shape)} mels={mels} kernel_ms={ms!r} "
          f"entry_point_ms={entry_ms!r} plain_ms={plain_ms!r} stft_chain_ms={library_ms!r} "
          f"stft_alone_ms={stft_ms!r} stft_chain_vs_kernel_max_abs_err={library_err!r} "
          f"bound_ms={stats['bound_ms']!r} bound_by={stats['bound_by']} "
          f"launches={json.dumps(counts)}")
    return {"stats": stats, "launches": counts["log_mel_spectrogram_fused"]}


@contextlib.contextmanager
def record_encoder_mlp(model, store: dict):
    """Keep the first input of encoder layer 0's MLP (fc1's input, the
    final LayerNorm's output), its weights, and the MLP's own output (fc2's)."""
    layer = model.encoder.layers[0]

    def fc1_hook(module, args):
        if "x" not in store:
            store["x"] = args[0].detach().clone()

    def fc2_hook(module, args, output):
        if "mlp_out" not in store:
            store["mlp_out"] = output.detach().clone()

    hooks = [layer.fc1.register_forward_pre_hook(fc1_hook),
             layer.fc2.register_forward_hook(fc2_hook)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        store.update({name: p.detach().clone() for name, p in (
            ("w1", layer.fc1.weight), ("b1", layer.fc1.bias),
            ("w2", layer.fc2.weight), ("b2", layer.fc2.bias))})


def ffn_phase(layer0: dict, reset_counts, read_counts) -> dict:
    """Kernel #8 through its entry points on encoder layer 0's MLP input of
    the serving batch (``fused_ffn``, [4, 1500, 1280]) and at the shape of
    scripts/bench_encoder_ffn.py (``encoder_ffn``, and its gradient through
    ``EncoderFFN``), against the plain version; then what that script
    prints: fused and unfused ms and TFLOP/s, both errors against fp64."""
    import torch.nn.functional as F

    from tiny_audio_tpu_torch.ops.encoder_ffn import (
        encoder_ffn,
        encoder_ffn_plain,
        fused_ffn,
        naive_ffn,
    )

    x0 = layer0["x"]
    w = [layer0[k] for k in ("w1", "b1", "w2", "b2")]
    m, d, f = FFN_BENCH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    xb = randn(m, d).to(torch.bfloat16)
    wb = [(randn(f, d) / d ** 0.5).to(torch.bfloat16), (0.1 * randn(f)).to(torch.bfloat16),
          (randn(d, f) / f ** 0.5).to(torch.bfloat16), (0.1 * randn(d)).to(torch.bfloat16)]
    dout = randn(m, d).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (xb, *wb)]
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        out0 = fused_ffn(x0, *w, torch.bfloat16)
        outb = encoder_ffn(xb, *wb)
    out_g = encoder_ffn(*leaves)
    out_g.backward(dout)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {name: 0 for name in counts}
    want["encoder_ffn"] = 3
    if counts != want:
        fail(f"the FFN phase launches {counts}, expected {want}")

    worst = 0.0
    x0_2d = x0.reshape(-1, d)
    for label, got, args in (("encoder_layer0_mlp", out0.reshape(-1, d), (x0_2d, *w)),
                             ("bench_encoder_ffn_shape", outb, (xb, *wb))):
        plain = encoder_ffn_plain(*args)
        err, within = kernel_error(got, plain)
        equal = (got == plain).float().mean().item()
        finite = bool(torch.isfinite(got).all())
        print(f"encoder_ffn {label} M={args[0].shape[0]} D={d} F={f} bf16 max_abs_err={err!r} "
              f"atol={KERNEL_ATOL} rtol={KERNEL_RTOL} bitwise_equal_share={equal!r}")
        if not (finite and within):
            fail(f"the FFN kernel disagrees with its plain version at {label}: {err}, finite={finite}")
        if equal < FFN_MIN_EQUAL_SHARE:
            fail(f"the FFN kernel is bitwise its plain version on {equal} of the outputs at {label}, "
                 f"below {FFN_MIN_EQUAL_SHARE}: not the fp32-h formula")
        worst = max(worst, err)
    vs_block = (out0 - layer0["mlp_out"]).abs().max().item()
    print(f"encoder_ffn layer-0 kernel vs the encoder block's own unfused MLP (bf16 h) "
          f"max_abs_err={vs_block!r}")
    # a second launch, and a CUDA graph replayed twice, give the first
    # launch's bytes at both M (the tile queue's counters are left zero by
    # each launch; M = 49,152 has the most row blocks and the longest tail)
    for label, first, args in (("encoder_layer0_mlp", out0.reshape(-1, d), (x0_2d, *w)),
                               ("bench_encoder_ffn_shape", outb, (xb, *wb))):
        second = encoder_ffn(*args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = encoder_ffn(*args)
        replays = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(same_bytes(replayed, first))
        if not (same_bytes(second, first) and all(replays)):
            fail(f"the FFN kernel's repeated launch or graph replay differs from its first "
                 f"launch at {label}: second launch equal={same_bytes(second, first)}, "
                 f"replays equal={replays}")
        print(f"encoder_ffn {label} M={args[0].shape[0]} second launch and two CUDA-graph "
              f"replays bitwise equal to the first launch=true")
        del graph, second, replayed
        torch.cuda.empty_cache()

    # the gradient: EncoderFFN's backward recomputes naive_ffn in bf16
    ref = [t.detach().clone().requires_grad_(True) for t in (xb, *wb)]
    naive_ffn(*ref, dtype=torch.bfloat16).backward(dout)
    names = ("x", "w1", "b1", "w2", "b2")
    for name, leaf, r in zip(names, leaves, ref):
        if not torch.equal(leaf.grad, r.grad):
            fail(f"EncoderFFN's gradient of {name} differs from autograd through naive_ffn")
    ref32 = [t.detach().float().requires_grad_(True) for t in (xb, *wb)]
    encoder_ffn_plain(*ref32).backward(dout.float())
    grad_errs = {n: ((leaf.grad.float() - r.grad).abs().max() / r.grad.abs().max()).item()
                 for n, leaf, r in zip(names, leaves, ref32)}
    print(f"encoder_ffn gradient through EncoderFFN M={m}: equal to autograd through naive_ffn "
          f"(bf16)=true; relative max error against fp32 autograd of the plain version "
          f"{json.dumps(grad_errs)}")
    del leaves, ref, ref32, out_g

    # scripts/bench_encoder_ffn.py's numbers at its shape
    flops_b = 4.0 * m * d * f

    def unfused(x, w1, b1, w2, b2):
        return F.linear(F.gelu(F.linear(x, w1, b1), approximate="tanh"), w2, b2)

    fused_ms_b = cuda_ms(lambda: encoder_ffn(xb, *wb), 10)
    unfused_ms_b = cuda_ms(lambda: unfused(xb, *wb), 10)
    rows = slice(0, FFN_ORACLE_ROWS)
    xd, w1d, b1d, w2d, b2d = (t.double() for t in (xb[rows], *wb))
    hd = xd @ w1d.T + b1d
    gd = 0.5 * hd * (1.0 + torch.tanh(0.7978845608028654 * (hd + 0.044715 * hd ** 3)))
    oracle = gd @ w2d.T + b2d
    scale = oracle.abs().max()
    rel = {name: ((out[rows].double() - oracle).abs().max() / scale).item()
           for name, out in (("fused", outb), ("unfused", unfused(xb, *wb)))}
    print(f"encoder_ffn bench shape M={m} D={d} F={f} bf16 fused_ms={fused_ms_b!r} "
          f"fused_tflops={flops_b / fused_ms_b / 1e9!r} unfused_cublas_ms={unfused_ms_b!r} "
          f"unfused_tflops={flops_b / unfused_ms_b / 1e9!r} "
          f"max_rel_err_vs_fp64_{FFN_ORACLE_ROWS}_rows={json.dumps(rel)}")
    del xb, wb, outb, dout, xd, hd, gd, oracle
    torch.cuda.empty_cache()

    # times on the path's own tensors (M = 6,000)
    ms = cuda_ms(lambda: encoder_ffn(x0_2d, *w), 20)
    kernel_graph_ms = graph_ms(lambda: encoder_ffn(x0_2d, *w), 20)
    plain_ms = cuda_ms(lambda: encoder_ffn_plain(x0_2d, *w), 5)
    library_ms = cuda_ms(lambda: unfused(x0_2d, *w), 20)
    library_graph_ms = graph_ms(lambda: unfused(x0_2d, *w), 20)
    m0 = x0_2d.shape[0]
    stats = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             **bound(2 * nbytes(x0_2d) + nbytes(*w), 4.0 * m0 * d * f, BF16_TENSOR_FLOPS),
             "library_ms": library_ms}
    print(f"encoder_ffn timing on the layer-0 input M={m0} kernel_ms={ms!r} "
          f"kernel_graph_ms={kernel_graph_ms!r} "
          f"kernel_tflops={4.0 * m0 * d * f / ms / 1e9!r} plain_ms={plain_ms!r} "
          f"cublas_chain_ms={library_ms!r} cublas_chain_graph_ms={library_graph_ms!r} "
          f"bound_ms={stats['bound_ms']!r} "
          f"bound_by={stats['bound_by']} launches={json.dumps(counts)}")
    # the new design beside the previous one, each at both M (ffn_times)
    for m_t, t in ffn_times(encoder_ffn).items():
        prev = PREVIOUS_FFN_MS.get(m_t, {})
        ops_t = 4.0 * m_t * d * f
        print(f"encoder_ffn design times M={m_t} D={d} F={f} (random operands) "
              f"kernel_ms={t['ms']!r} kernel_graph_ms={t['graph_ms']!r} "
              f"previous_design_ms={prev.get('ms')!r} "
              f"previous_design_graph_ms={prev.get('graph_ms')!r} "
              f"tflops={ops_t / t['ms'] / 1e9!r} graph_tflops={ops_t / t['graph_ms'] / 1e9!r} "
              f"bound_ms={ops_t / BF16_TENSOR_FLOPS * 1e3!r}")
    return {"stats": stats, "launches": counts["encoder_ffn"]}


def ffn_operands(m: int) -> list:
    """x [m, 1,280] and the flagship encoder MLP's weights, random bf16 from
    SEED + m, at the scale of scripts/bench_encoder_ffn.py's."""
    d, f = FFN_BENCH_SHAPE[1:]
    gen = torch.Generator(device="cuda").manual_seed(SEED + m)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    return [randn(m, d).to(torch.bfloat16), (randn(f, d) / d ** 0.5).to(torch.bfloat16),
            (0.1 * randn(f)).to(torch.bfloat16), (randn(d, f) / f ** 0.5).to(torch.bfloat16),
            (0.1 * randn(d)).to(torch.bfloat16)]


def ffn_times(encoder_ffn) -> dict:
    """Kernel #8 at each M of FFN_TIMED_M: {M: {"ms", "graph_ms"}}, back to
    back and from a CUDA graph."""
    times = {}
    for m in FFN_TIMED_M:
        ops = ffn_operands(m)
        call = lambda: encoder_ffn(*ops)  # noqa: E731
        times[m] = {"ms": cuda_ms(call, FFN_REPS), "graph_ms": graph_ms(call, FFN_REPS)}
        del ops, call
        torch.cuda.empty_cache()
    return times


def small_model_reference() -> None:
    """The serving path on a small bf16 model, card vs CPU on equal weights."""
    from tiny_audio_tpu_torch import ASRConfig, DecoderConfig, EncoderConfig
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.processing import ASRProcessor

    cfg = ASRConfig(
        encoder=EncoderConfig(num_mel_bins=128, d_model=256, num_layers=2, num_heads=4,
                              ffn_dim=512, max_source_positions=1500),
        decoder=DecoderConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                              num_kv_heads=2, head_dim=128, intermediate_size=512),
        kv_cache_dtype="int8",
    )
    cuda_model = ASRModel(cfg, seed=SEED, device="cuda")
    cpu_model = ASRModel(cfg, seed=SEED, device="cpu")
    cpu_model.load_state_dict(cuda_model.state_dict())
    audio = [np.random.default_rng(SEED).standard_normal(n).astype(np.float32) * 0.1
             for n in (16000 * 7, 16000 * 3)]
    embeds = {}
    tokens = {}
    for name, model in (("cuda", cuda_model), ("cpu", cpu_model)):
        feats = ASRProcessor(model.projector, device=model.device).extract_features(audio)
        with torch.inference_mode():
            embeds[name] = model._encode_audio(
                feats["input_features"], feats["audio_attention_mask"]
            ).float().cpu()
        tokens[name] = model.generate(feats["input_features"], feats["audio_attention_mask"],
                                      max_new_tokens=16)
    rel = ((embeds["cuda"] - embeds["cpu"]).abs().max() / embeds["cpu"].abs().max()).item()
    agree = float((tokens["cuda"] == tokens["cpu"]).mean())
    print(f"small_model audio_embeds rel_err={rel!r} rtol={SMALL_MODEL_RTOL} "
          f"token_agreement_vs_cpu={agree!r}")
    if not rel <= SMALL_MODEL_RTOL:
        fail(f"small model's audio embeddings on the card disagree with the CPU: {rel}")


def tiny_towers_phase(reset_counts, read_counts) -> dict:
    """The repo's tiny towers (``tiny_test_config``: head_dim 16 in both
    towers) on the card, in fp32 and bf16, against the same weights on the
    CPU: ``generate`` (16 tokens, EOS masked) on the fused and the module
    decode path with a cache of the model's dtype and an int8 one, then the
    documented training command, ``+experiments=smoke`` (fp32 tiny towers),
    for 4 steps.  fp32 must give the CPU's tokens exactly; bf16 audio
    embeddings must agree within SMALL_MODEL_RTOL.  The inputs each attention
    kernel got first (per dtype and cache kind; the backward's in training)
    are kept, and each of those instances is held against its plain version
    on them and timed beside it."""
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.ops import attention as attention_dispatch
    from tiny_audio_tpu_torch.ops import fused_decode as fused_module
    from tiny_audio_tpu_torch.processing import ASRProcessor
    from tiny_audio_tpu_torch.train.__main__ import main as train_main

    rng = np.random.default_rng(SEED + 11)
    audio = [(rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32) for s in TINY_CLIP_S]
    first_calls = {}  # (model dtype, cache) -> the first inputs of each kernel
    for model_dtype in ("float32", "bfloat16"):
        for kv in ("bfloat16", "int8"):  # "bfloat16": a cache of the model's dtype
            cfg = tiny_test_config(model_dtype=model_dtype, kv_cache_dtype=kv)
            models = {"cuda": ASRModel(cfg, seed=SEED, device="cuda"),
                      "cpu": ASRModel(cfg, seed=SEED, device="cpu")}
            models["cpu"].load_state_dict(models["cuda"].state_dict())
            store = first_calls.setdefault((model_dtype, kv), {})
            embeds, tokens, counts = {}, {}, {}
            for where, model in models.items():
                feats = ASRProcessor(model.projector, num_mel_bins=cfg.encoder.num_mel_bins,
                                     device=model.device).extract_features(audio)
                args = (feats["input_features"], feats["audio_attention_mask"])
                with torch.inference_mode():
                    embeds[where] = model._encode_audio(*args).float().cpu()
                paths = (("fused", True), ("module", False)) if where == "cuda" else (("cpu", None),)
                for label, fused in paths:
                    reset_counts()
                    with record_first_call(attention_dispatch, "encoder_attention", store), \
                            record_first_call(attention_dispatch, "prefill_attention", store), \
                            record_first_call(attention_dispatch, "decode_attention", store), \
                            record_first_call(fused_module, "decode_attention_update", store):
                        tokens[label] = model.generate(*args, min_new_tokens=TINY_TOKENS,
                                                       max_new_tokens=TINY_TOKENS,
                                                       fused_decode=fused)
                    torch.cuda.synchronize()
                    counts[label] = read_counts()
            rel = ((embeds["cuda"] - embeds["cpu"]).abs().max()
                   / embeds["cpu"].abs().max()).item()
            agree = {label: float((tokens[label] == tokens["cpu"]).mean())
                     for label in ("fused", "module")}
            print(f"tiny_towers dtype={model_dtype} kv={kv} head_dim=16 tokens={TINY_TOKENS} "
                  f"clip_s={list(TINY_CLIP_S)} audio_embeds_rel_err={rel!r} "
                  f"token_agreement_vs_cpu={json.dumps(agree)} "
                  f"fused_launches={json.dumps(counts['fused'])} "
                  f"module_launches={json.dumps(counts['module'])}")
            if tokens["fused"].shape != (len(TINY_CLIP_S), TINY_TOKENS):
                fail(f"tiny towers {model_dtype}/{kv}: tokens of shape {tokens['fused'].shape}")
            if model_dtype == "float32" and min(agree.values()) < 1.0:
                fail(f"tiny towers fp32 kv={kv}: tokens differ from the CPU's: {agree}")
            if not rel <= (FP32_EMBED_RTOL if model_dtype == "float32" else SMALL_MODEL_RTOL):
                fail(f"tiny towers {model_dtype} kv={kv}: audio embeddings off the CPU's by {rel}")
            fused_c, module_c = counts["fused"], counts["module"]
            if min(fused_c["encoder_attention"], fused_c["prefill_attention"],
                   fused_c["decode_attention_update"], module_c["decode_attention"]) == 0:
                fail(f"tiny towers {model_dtype} kv={kv} missed a kernel: fused {fused_c}, "
                     f"module {module_c}")
            if any(fused_c[n] or module_c[n] for n in BENCH_VARIANTS):
                fail(f"tiny towers {model_dtype} kv={kv} launched a bench variant")
            del models
    torch.cuda.empty_cache()

    # the documented training command, in process, 4 steps on the card
    out_dir = tempfile.mkdtemp()
    backward: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    with record_first_backward(backward):
        train_main(["+experiments=smoke", f"training.max_steps={TINY_TRAIN_STEPS}",
                    f"training.eval_steps={TINY_TRAIN_STEPS}", f"run.output_dir={out_dir}"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = read_counts()
    records = [json.loads(line)
               for line in (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]
    losses = [r[key] for r in records for key in r if "loss" in key]
    shutil.rmtree(out_dir)
    print(f"tiny_towers train +experiments=smoke steps={TINY_TRAIN_STEPS} device=cuda fp32 "
          f"wall_s={train_s!r} records={len(records)} losses={json.dumps(losses)} "
          f"launches={json.dumps(train_counts)}")
    if not losses or not all(np.isfinite(losses)):
        fail(f"the smoke training run logged non-finite or no losses: {records}")
    if min(train_counts["prefill_attention_bwd_dkv"], train_counts["prefill_attention_bwd_dq"],
           train_counts["prefill_attention"], train_counts["encoder_attention"]) == 0:
        fail(f"the smoke training run missed a kernel: {train_counts}")
    if any(train_counts[n] for n in BENCH_VARIANTS):
        fail("the smoke training run launched a bench variant")
    check_tiny_instances(first_calls, backward["backward"])


def check_tiny_instances(first_calls: dict, backward: tuple) -> None:
    """The fp32 and bf16 head_dim-16 instances of #1-#4, #2b and #2c held
    against their plain versions on the inputs the tiny towers gave them
    (fp32 within FP32_TOL, bf16 within KERNEL_ATOL/RTOL; the rows #4 writes
    bitwise) and timed beside them; fails the run on a disagreement."""
    from tiny_audio_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
        decode_attention_update,
        decode_attention_update_plain,
    )
    from tiny_audio_tpu_torch.ops.encoder_attention import (
        encoder_attention,
        encoder_attention_plain,
    )
    from tiny_audio_tpu_torch.ops.prefill_attention import (
        prefill_attention,
        prefill_attention_backward_plain,
        prefill_attention_bwd_dkv,
        prefill_attention_bwd_dq,
        prefill_attention_plain,
    )

    # the decode path's cache views are inference tensors: the plain append
    # writes its copy of them in place, as generate does
    with torch.inference_mode():
        for (model_dtype, kv), calls in first_calls.items():
            label = f"tiny_towers {model_dtype} kv={kv}"
            if kv == "int8":  # the towers' forward does not depend on the cache
                compare_on_path_inputs(f"{label} encoder_attention", encoder_attention,
                                       encoder_attention_plain, calls["encoder_attention"])
                compare_on_path_inputs(f"{label} prefill_attention", prefill_attention,
                                       prefill_attention_plain, calls["prefill_attention"])
            compare_decode_on_path_inputs(f"{label} decode_attention", decode_attention,
                                          decode_attention_plain, calls["decode_attention"])
            compare_decode_on_path_inputs(f"{label} decode_attention_update",
                                          decode_attention_update, decode_attention_update_plain,
                                          calls["decode_attention_update"])
    q, k, v, mask, dout, m, l, delta = backward
    r = check_prefill_backward(q, k, v, mask, dout, "the smoke training run's inputs")
    times = {n: cuda_ms(lambda fn=fn: fn(q, k, v, mask, dout, m, l, delta), 50)
             for n, fn in (("dkv", prefill_attention_bwd_dkv), ("dq", prefill_attention_bwd_dq))}
    plain_ms = cuda_ms(lambda: prefill_attention_backward_plain(q, k, v, mask, dout), 20)
    print(f"tiny_towers prefill backward on the smoke training run's inputs dtype={q.dtype} "
          f"q={list(q.shape)} k={list(k.shape)} forward_max_abs_err={r['forward']!r} "
          + " ".join(f"{n}_err={e!r}" for n, (e, _) in r["errs"].items())
          + f" {tolerance_text(q.dtype)} dkv_ms={times['dkv']!r} dq_ms={times['dq']!r} "
          f"plain_backward_ms={plain_ms!r}")


def encoder_variants_phase(reset_counts, read_counts) -> dict:
    """Kernel #9a through its entry point, the port's
    tools/bench_encoder_attention.py at scripts/bench_encoder_attention.py's
    shape: every mode at hg = 10 and fp32 at hg 4 and 20, each against its
    plain version (values, and the share of outputs that differ from it and
    from the other modes' plain versions) and an fp64 oracle on a 4-batch
    slice, packed2 bitwise shift_post; the modes whose shifts cancel there
    told apart on stress inputs; then the plain version's time at the full
    shape (in 4-batch chunks) and the bound."""
    from tiny_audio_tpu_torch.ops.encoder_attention_variants import (
        encoder_attention_variant_plain,
    )
    from tiny_audio_tpu_torch.tools import bench_encoder_attention as tool

    reset_counts()
    r = tool.run(reps=VARIANT_REPS, out=lambda line: print(f"bench_encoder_attention {line}"))
    torch.cuda.synchronize()
    counts = read_counts()
    others = {n: c for n, c in counts.items()
              if n not in ("encoder_attention_variant", "encoder_attention") and c}
    if counts["encoder_attention_variant"] == 0 or others:
        fail(f"the #9a phase launches {counts}")
    for name, v in r["variants"].items():
        if not (v["finite"] and v["within"]):
            fail(f"#9a {name} disagrees with its plain version: max error "
                 f"{v['max_abs_err_vs_plain']}, {v['differ_share_vs_plain']:.2%} of the outputs "
                 f"differ, nearest other mode {v['nearest_other']}")
        if not v["max_abs_err_fp64"] <= VARIANT_ORACLE_ATOL:
            fail(f"#9a {name} is {v['max_abs_err_fp64']} off the fp64 oracle")
    # the shifts that cancel on the bench's inputs, told apart (a comparison:
    # its launches are not the phase's)
    stress = tool.modes_apart(out=lambda line: print(f"bench_encoder_attention {line}"))
    for mode, a in stress.items():
        if not a["apart"]:
            fail(f"#9a {mode} is not told apart on the stress inputs: {a}")
    hg = tool.HG
    packed = r["variants"][f"loop-packed2(hg={hg})"]["output"]
    post = r["variants"][f"loop-shift_post(hg={hg})"]["output"]
    if not same_bytes(packed, post):
        fail("#9a packed2 is not bitwise shift_post")
    q, k, v, mask = r["inputs"]
    h = tool.H

    def plain_full():
        for i in range(0, q.shape[0], tool.ORACLE_BATCH):
            s = slice(i, i + tool.ORACLE_BATCH)
            encoder_attention_variant_plain(q[s], k[s], v[s], mask[s], h, "fp32")

    plain_ms = cuda_ms(plain_full, 1)
    b, t, hd = q.shape
    fp32 = r["variants"][f"loop-fp32(hg={hg})"]
    stats = {"max_abs_err": max(x["max_abs_err_vs_plain"] for x in r["variants"].values()),
             "ms": fp32["ms"], "plain_ms": plain_ms,
             **bound(4 * nbytes(q) + nbytes(mask), 4.0 * b * h * t * t * (hd // h),
                     BF16_TENSOR_FLOPS),
             "library_ms": r["yardsticks"]["sdpa (key mask)"]["ms"]}
    from tiny_audio_tpu_torch.ops.encoder_attention_variants import variant_units

    unit_flops = 2.0 * b * h * t * t * (hd // h)  # one product over all keys
    kernel1 = r["yardsticks"]["encoder_attention (#1)"]["ms"]
    for name, x in r["variants"].items():
        flops = variant_units(x["mode"]) * unit_flops
        print(f"encoder_attention_variant design times {name} units={variant_units(x['mode'])} "
              f"ms={x['ms']!r} previous_design_ms={PREVIOUS_VARIANT_MS.get(name)!r} "
              f"tflops={flops / x['ms'] / 1e9!r} bound_ms={flops / BF16_TENSOR_FLOPS * 1e3!r} "
              f"kernel1_ms={kernel1!r} "
              f"kernel1_previous_ms={PREVIOUS_VARIANT_MS.get('encoder_attention (#1)')!r}")
    print(f"encoder_attention_variant packed2_equals_shift_post_bitwise=true "
          f"fp32_hg{hg}_ms={stats['ms']!r} plain_ms={plain_ms!r} bound_ms={stats['bound_ms']!r} "
          f"bound_by={stats['bound_by']} sdpa_ms={stats['library_ms']!r} "
          f"kernel1_ms={r['yardsticks']['encoder_attention (#1)']['ms']!r} "
          f"modes={json.dumps({n: x['ms'] for n, x in r['variants'].items()})} "
          f"launches={json.dumps(counts)}")
    del r, q, k, v, mask, packed, post
    torch.cuda.empty_cache()
    return {"stats": stats, "launches": counts["encoder_attention_variant"]}


def wq_head_variants_phase(reset_counts, read_counts) -> dict:
    """Kernels #9b-#9d through their entry point, the port's
    tools/bench_wq_head.py at scripts/bench_wq_head.py's shape, every sweep
    point: #9c and #9d bitwise their plain versions, #9b within #6's
    tolerance; then each one's plain time and bound at the script's
    numerics points, nc = 8192 (#9b) and nt = 2048 (#9c, #9d)."""
    from tiny_audio_tpu_torch.ops.wq_head import w8a8_matmul_plain
    from tiny_audio_tpu_torch.ops.wq_matmul import wq_matmul_plain
    from tiny_audio_tpu_torch.tools import bench_wq_head as tool

    reset_counts()
    r = tool.run(reps=VARIANT_REPS, out=lambda line: print(f"bench_wq_head {line}"))
    torch.cuda.synchronize()
    counts = read_counts()
    mine = ("wq_matmul_pipe", "a8_matmul", "a8t_matmul")
    allowed = mine + ("wq_matmul", "w8a8_matmul")  # the script's shipped yardsticks
    if min(counts[n] for n in mine) == 0 or any(c for n, c in counts.items() if n not in allowed):
        fail(f"the #9b-#9d phase launches {counts}")
    for name, p in r["products"].items():
        if "rule" in p and not (p["finite"] and p["within"]):
            fail(f"{name} disagrees with its plain version ({p['rule']}): {p['max_abs_err_vs_plain']}")
    d = r["inputs"]
    x, w_i8, wt_i8, scale = d["x"], d["w_i8"], d["wt_i8"], d["scale"]
    x_i8 = torch.empty_like(x, dtype=torch.int8)
    sx = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    out = torch.empty((x.shape[0], scale.shape[0]), dtype=torch.bfloat16, device=x.device)
    ops = 2.0 * x.shape[0] * x.shape[1] * scale.shape[0]
    entries = {}
    for kernel, label, plain, args, moved, peak in (
            ("wq_matmul_pipe", "pipe nc=8192", wq_matmul_plain, (x, w_i8, scale),
             nbytes(x, w_i8, scale, out), BF16_TENSOR_FLOPS),
            ("a8_matmul", "a8 nt=2048", w8a8_matmul_plain, (x, w_i8.T, scale),
             nbytes(x_i8, sx, w_i8, scale, out), INT8_TENSOR_OPS),
            ("a8t_matmul", "a8t nt=2048", w8a8_matmul_plain, (x, wt_i8, scale),
             nbytes(x_i8, sx, wt_i8, scale, out), INT8_TENSOR_OPS)):
        group = [p for n, p in r["products"].items() if n.split()[0] == label.split()[0]]
        entries[kernel] = {
            "max_abs_err": max(p["max_abs_err_vs_plain"] for p in group),
            "ms": r["products"][label]["ms"], "plain_ms": cuda_ms(lambda: plain(*args), 5),
            **bound(moved, ops, peak), "library_ms": None}
    print("wq_head variants at the script's numerics points "
          + " ".join(f"{n}_ms={e['ms']!r} {n}_previous_ms={PREVIOUS_VARIANT_MS[n]!r} "
                     f"{n}_plain_ms={e['plain_ms']!r} "
                     f"{n}_bound_ms={e['bound_ms']!r}" for n, e in entries.items())
          + f" bf16_linear_ms={r['products']['bf16 dot']['ms']!r} "
          f"wq_matmul_ms={r['products']['wq shipped (#6)']['ms']!r} "
          f"w8a8_matmul_ms={r['products']['w8a8 shipped (#5)']['ms']!r} "
          f"launches={json.dumps(counts)} (no PyTorch call computes these int8 functions)")
    del r, d, x, w_i8, wt_i8, out
    torch.cuda.empty_cache()
    return {"stats": entries, "launches": {n: counts[n] for n in mine}}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device; this smoke run measures the GPU and never runs on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    power_line = gpu_name_and_power()
    print(f"gpu {power_line} torch={torch.__version__} cuda={torch.version.cuda}")

    # ---- 2. build ----
    from tiny_audio_tpu_torch import kernels

    t0 = time.perf_counter()
    _, nvcc_s, log = kernels.build()
    kernels.library()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"build nvcc_s={nvcc_s!r} total_s={time.perf_counter() - t0!r} "
          f"ptxas={json.dumps(ptxas)}")
    hopper_design_facts(log)
    decode_design_facts(log)
    int8_design_facts(log)
    phase_done()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # ---- 3, 4. kernels vs their plain versions ----
    enc = compare_encoder_kernel(gen)
    phase_done()
    pre = compare_prefill_kernel(gen)
    phase_done()
    prefill_at_bench_batch(gen)
    phase_done()
    pre_shapes = compare_prefill_every_shape(gen)
    phase_done()
    dec = compare_decode_kernels(gen)
    phase_done()
    dec_shapes = compare_decode_every_shape(gen)
    phase_done()
    dec_graph = decode_graph_times(gen)
    phase_done()
    int8pack = int8pack_head_times(gen)
    phase_done()
    int8_errs = compare_int8_matmuls(gen)
    phase_done()
    int8_graph = int8_graph_times(gen)
    phase_done()
    int8_repeat_and_graph(gen)
    phase_done()
    small_model_reference()
    phase_done()

    from tiny_audio_tpu_torch import ASRConfig
    from tiny_audio_tpu_torch.models import asr as asr_module
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.ops import attention as attention_dispatch
    from tiny_audio_tpu_torch.ops import fused_decode as fused_module
    from tiny_audio_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
        decode_attention_update,
        decode_attention_update_plain,
    )
    from tiny_audio_tpu_torch.ops.encoder_attention import (
        encoder_attention,
        encoder_attention_plain,
    )
    from tiny_audio_tpu_torch.ops.encoder_attention_variants import encoder_attention_variant
    from tiny_audio_tpu_torch.ops.encoder_ffn import encoder_ffn
    from tiny_audio_tpu_torch.ops.mel_fused import log_mel_spectrogram_fused
    from tiny_audio_tpu_torch.ops.prefill_attention import (
        prefill_attention,
        prefill_attention_bwd_dkv,
        prefill_attention_bwd_dq,
        prefill_attention_plain,
    )
    from tiny_audio_tpu_torch.models import decoder as decoder_module
    from tiny_audio_tpu_torch.ops.wq_head import w8a8_matmul, w8a8_matmul_plain
    from tiny_audio_tpu_torch.ops.wq_head_variants import a8_matmul, a8t_matmul, wq_matmul_pipe
    from tiny_audio_tpu_torch.ops.wq_matmul import wq_matmul, wq_matmul_plain
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    wrappers = {"encoder_attention": encoder_attention, "prefill_attention": prefill_attention,
                "decode_attention": decode_attention,
                "decode_attention_update": decode_attention_update,
                "w8a8_matmul": w8a8_matmul, "wq_matmul": wq_matmul,
                "prefill_attention_bwd_dkv": prefill_attention_bwd_dkv,
                "prefill_attention_bwd_dq": prefill_attention_bwd_dq,
                "log_mel_spectrogram_fused": log_mel_spectrogram_fused,
                "encoder_ffn": encoder_ffn,
                "encoder_attention_variant": encoder_attention_variant,
                "wq_matmul_pipe": wq_matmul_pipe, "a8_matmul": a8_matmul,
                "a8t_matmul": a8t_matmul}
    # the serving paths launch neither int8 product (outside their modes), nor
    # a backward kernel, nor the fused front end (#7), the encoder FFN (#8) or
    # the bench variants (#9a-#9d), which only their own entry points reach
    no_int8 = {"w8a8_matmul": 0, "wq_matmul": 0, "prefill_attention_bwd_dkv": 0,
               "prefill_attention_bwd_dq": 0, "log_mel_spectrogram_fused": 0, "encoder_ffn": 0,
               **{name: 0 for name in BENCH_VARIANTS}}

    def reset_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    # ---- 4b. the tiny towers on the card: fp32, head_dim 16, training ----
    tiny_towers_phase(reset_counts, read_counts)
    phase_done()

    # ---- 5. generate at the flagship width, on both decode paths ----
    t0 = time.perf_counter()
    cfg = ASRConfig(kv_cache_dtype="int8")
    model = ASRModel(cfg, seed=SEED)  # the default device: the card
    phase_done()
    init_s = time.perf_counter() - t0
    if model.device.type != "cuda":
        fail(f"ASRModel built on {model.device}, not on the card")
    pipe = ASRPipeline(model)
    n = int(CLIP_S * 16000)
    rng = np.random.default_rng(SEED)
    pcm = (np.clip(rng.standard_normal((BATCH, n)) * 0.1, -1, 1) * 32767).astype(np.int16)
    audio = [row.astype(np.float32) / 32768.0 for row in pcm]
    n_enc, n_dec = cfg.encoder.num_layers, cfg.decoder.num_layers
    steps = MAX_NEW - 1

    def run_generate(max_new: int, **kwargs):
        # min_new_tokens = the budget masks EOS: every row decodes all tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = pipe.processor.extract_features(audio)
        tokens = model.generate(feats["input_features"], feats["audio_attention_mask"],
                                mel_length=int(feats["mel_lengths"].max()),
                                min_new_tokens=max_new, max_new_tokens=max_new, **kwargs)
        torch.cuda.synchronize()
        return tokens, time.perf_counter() - t0, feats

    path_inputs: dict = {}
    stage_ms: dict = {}  # device ms of encoder + projector and of the prefill
    layer0_mlp: dict = {}  # encoder layer 0's MLP input and weights, for kernel #8
    results = {}
    for label, kwargs, kernel_name in (("fused", {}, "decode_attention_update"),
                                       ("module", {"fused_decode": False}, "decode_attention")):
        # the counted call also keeps the first layer's inputs of each kernel
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with record_first_call(attention_dispatch, "encoder_attention", path_inputs), \
                record_first_call(attention_dispatch, "prefill_attention", path_inputs), \
                record_first_call(attention_dispatch, "decode_attention", path_inputs), \
                record_first_call(fused_module, "decode_attention_update", path_inputs), \
                record_encoder_mlp(model, layer0_mlp):
            tokens, first_s, feats = run_generate(MAX_NEW, **kwargs)
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        want = {"encoder_attention": n_enc, "prefill_attention": n_dec,
                "decode_attention": 0, "decode_attention_update": 0, **no_int8}
        want[kernel_name] = n_dec * steps
        if counts != want:
            fail(f"{label} decode path launches {counts}, expected {want}")
        reset_counts()
        with time_stages(model, stage_ms) if label == "fused" else contextlib.nullcontext():
            tokens2, batch_s, _ = run_generate(MAX_NEW, **kwargs)
        if read_counts() != want:
            fail(f"{label} decode path's second call launches {read_counts()}, expected {want}")
        if tokens.shape != (BATCH, MAX_NEW):
            fail(f"tokens have shape {tokens.shape}, expected {(BATCH, MAX_NEW)}")
        if tokens.min() < 0 or tokens.max() >= cfg.decoder.vocab_size:
            fail("tokens outside the vocabulary")
        if not np.array_equal(tokens, tokens2):
            fail(f"two {label} generate calls on the same batch gave different tokens")
        results[label] = {"tokens": tokens, "first_s": first_s, "batch_s": batch_s,
                          "counts": counts, "peak_gib": peak_gib}
        phase_done()
    # the part of a call that is not the decode loop: 1 token, no decode step
    _, fixed_s, _ = run_generate(1)
    if not np.array_equal(results["fused"]["tokens"], results["module"]["tokens"]):
        diff = int((results["fused"]["tokens"] != results["module"]["tokens"]).sum())
        fail(f"the fused and the module decode paths gave different tokens ({diff} differ)")
    with torch.inference_mode():
        hidden = model.encoder(feats["input_features"], feats["audio_attention_mask"])
    if not torch.isfinite(hidden).all():
        fail("encoder output is not finite")
    for label, r in results.items():
        step_ms = (r["batch_s"] - fixed_s) / steps * 1e3
        r["step_ms"] = step_ms
        print(f"generate path={label} batch={BATCH} clip_s={CLIP_S} new_tokens={MAX_NEW} kv=int8 "
              f"bf16 init_s={init_s!r} first_call_s={r['first_s']!r} batch_wall_s={r['batch_s']!r} "
              f"one_token_call_s={fixed_s!r} decode_step_ms={step_ms!r} "
              f"peak_mem_gib={r['peak_gib']!r} launches={json.dumps(r['counts'])} "
              f"deterministic=true encoder_finite=true")
    print("generate fused_vs_module_tokens_identical=true")
    print(f"generate stages batch={BATCH} clip_s={CLIP_S} (the fused path's second call, "
          f"CUDA events) encoder_projector_ms={stage_ms['encoder_projector_ms']!r} "
          f"prefill_ms={stage_ms['prefill_ms']!r}")
    phase_done()

    # ---- 5b. kernels vs plain versions on the path's own inputs ----
    if set(path_inputs) != set(wrappers) - set(no_int8):
        fail(f"the paths did not reach every kernel's wrapper: {sorted(path_inputs)}")
    enc_path = compare_on_path_inputs("encoder_attention", encoder_attention,
                                      encoder_attention_plain, path_inputs["encoder_attention"])
    enc_path.update(attention_extras("encoder_attention", path_inputs["encoder_attention"],
                                     enc_path["ms"]))
    pre_path = compare_on_path_inputs("prefill_attention", prefill_attention,
                                      prefill_attention_plain, path_inputs["prefill_attention"])
    pre_path.update(attention_extras("prefill_attention", path_inputs["prefill_attention"],
                                     pre_path["ms"]))
    dec_path = compare_decode_on_path_inputs("decode_attention", decode_attention,
                                             decode_attention_plain,
                                             path_inputs["decode_attention"])
    upd_path = compare_decode_on_path_inputs("decode_attention_update", decode_attention_update,
                                             decode_attention_update_plain,
                                             path_inputs["decode_attention_update"])
    del path_inputs
    phase_done()

    # ---- 6. the pipeline answers three requests ----
    texts = []
    reset_counts()
    t0 = time.perf_counter()
    for seconds in REQUEST_SECONDS:
        clip = rng.standard_normal(int(seconds * 16000)).astype(np.float32) * 0.1
        result = pipe(clip, min_new_tokens=16)  # EOS masked: the decode loop runs
        if not isinstance(result, dict) or not isinstance(result.get("text"), str):
            fail(f"pipeline gave {result!r} for a {seconds} s request")
        texts.append(len(result["text"]))
    phase_done()
    counts = read_counts()
    if min(counts["encoder_attention"], counts["prefill_attention"],
           counts["decode_attention_update"]) == 0 or counts["decode_attention"] or \
            any(counts[name] for name in no_int8):
        fail(f"the pipeline missed a kernel of its path: {counts}")
    print(f"pipeline requests={len(REQUEST_SECONDS)} seconds={list(REQUEST_SECONDS)} "
          f"wall_s={time.perf_counter() - t0!r} text_chars={texts} launches={json.dumps(counts)}")

    # ---- 7. streaming: one 30 s clip, token by token ----
    first_token_at: list = []
    original_stream = asr_module.stream_generate

    def timed_stream(*args, **kwargs):
        for tok in original_stream(*args, **kwargs):
            if not first_token_at:
                first_token_at.append(time.perf_counter())
            yield tok

    model.gen_config = dataclasses.replace(model.gen_config, min_new_tokens=STREAM_TOKENS,
                                           max_new_tokens=STREAM_TOKENS)
    clip = rng.standard_normal(int(CLIP_S * 16000)).astype(np.float32) * 0.1
    asr_module.stream_generate = timed_stream
    reset_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fragments = list(pipe.transcribe_streaming(clip))
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    finally:
        asr_module.stream_generate = original_stream
    counts = read_counts()
    want = {"encoder_attention": n_enc, "prefill_attention": n_dec,
            "decode_attention": n_dec * (STREAM_TOKENS - 1), "decode_attention_update": 0,
            **no_int8}
    if counts != want:
        fail(f"streaming launches {counts}, expected {want}")
    if not first_token_at or not all(isinstance(f, str) for f in fragments):
        fail(f"streaming gave no tokens or non-text fragments: {fragments!r}")
    print(f"streaming clip_s={CLIP_S} tokens={STREAM_TOKENS} "
          f"time_to_first_token_s={first_token_at[0] - t0!r} total_s={stream_s!r} "
          f"fragments={len(fragments)} text_chars={sum(map(len, fragments))} "
          f"launches={json.dumps(counts)}")
    phase_done()

    # ---- 8. generate under each int8 decode mode ----
    bf16_tokens = results["fused"]["tokens"]
    int8_inputs: dict = {}
    per_step_matmuls = 7 * n_dec + 1  # every layer projection and the head
    mode_launches = {}
    int8_steps: dict = {}
    for mode, kernel_name in INT8_MODES.items():
        model.wq = None
        t0 = time.perf_counter()
        getattr(model, mode)()
        phase_done()
        quantize_s = time.perf_counter() - t0
        n_int8 = steps * (per_step_matmuls if mode != "enable_w8a8_head" else 1) + 1  # + prefill head
        runs = [("fused", {})] + ([("module", {"fused_decode": False})]
                                  if mode == "enable_w8a8_decode" else [])
        mode_tokens = {}
        for label, kwargs in runs:
            want = {"encoder_attention": n_enc, "prefill_attention": n_dec,
                    "decode_attention": n_dec * steps if label == "module" else 0,
                    "decode_attention_update": n_dec * steps if label == "fused" else 0,
                    **no_int8, kernel_name: n_int8}
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with record_first_call(decoder_module, kernel_name, int8_inputs):
                tokens, first_s, _ = run_generate(MAX_NEW, **kwargs)
            counts = read_counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            if counts != want:
                fail(f"{mode} {label} path launches {counts}, expected {want}")
            reset_counts()
            tokens2, batch_s, _ = run_generate(MAX_NEW, **kwargs)
            if read_counts() != want:
                fail(f"{mode} {label} second call launches {read_counts()}, expected {want}")
            if tokens.shape != (BATCH, MAX_NEW) or not np.array_equal(tokens, tokens2):
                fail(f"two {mode} {label} generate calls gave different tokens")
            _, fixed_s, _ = run_generate(1, **kwargs)
            step_ms = (batch_s - fixed_s) / steps * 1e3
            mode_tokens[label] = tokens
            mode_launches[kernel_name] = counts[kernel_name]
            print(f"generate mode={mode} path={label} batch={BATCH} clip_s={CLIP_S} "
                  f"new_tokens={MAX_NEW} kv=int8 quantize_s={quantize_s!r} "
                  f"first_call_s={first_s!r} batch_wall_s={batch_s!r} one_token_call_s={fixed_s!r} "
                  f"decode_step_ms={step_ms!r} bf16_fused_decode_step_ms="
                  f"{results['fused']['step_ms']!r} peak_mem_gib={peak_gib!r} "
                  f"launches={json.dumps(counts)} deterministic=true "
                  f"token_agreement_with_bf16={float((tokens == bf16_tokens).mean())!r} "
                  f"previous_design_token_agreement={PREVIOUS_TOKEN_AGREEMENT[mode]!r}")
        if "module" in mode_tokens and not np.array_equal(mode_tokens["fused"],
                                                          mode_tokens["module"]):
            fail(f"{mode}: the fused and the module decode paths gave different tokens")
        if "module" in mode_tokens:
            print(f"generate mode={mode} fused_vs_module_tokens_identical=true")
        if mode != "enable_w8a8_head":
            int8_steps[kernel_name] = int8_step_times(model, kernel_name)
        phase_done()
    check_decode_counters()
    model.wq = None
    head_bf16 = model.decoder.embed_tokens.weight  # the tied head, [vocab, hidden]
    int8_path = {
        "w8a8_matmul": compare_int8_on_path_inputs(
            "w8a8_matmul", w8a8_matmul, w8a8_matmul_plain,
            int8_inputs["w8a8_matmul"], head_bf16),
        "wq_matmul": compare_int8_on_path_inputs(
            "wq_matmul", wq_matmul, wq_matmul_plain, int8_inputs["wq_matmul"], head_bf16),
    }
    del int8_inputs
    torch.cuda.empty_cache()
    phase_done()

    # ---- 9. the HTTP server over a saved checkpoint, W8A8 decode ----
    served = serve_requests(model, rng, reset_counts, read_counts)
    print(f"server requests={len(REQUEST_SECONDS)} seconds={list(REQUEST_SECONDS)} "
          f"{served}")
    phase_done()
    del model, pipe
    torch.cuda.empty_cache()

    # ---- 10. training at the flagship width ----
    trained = train_phases(reset_counts, read_counts)
    phase_done()

    # ---- 11. kernel #7, the fused front end, through its entry point ----
    front = front_end_phase(audio, reset_counts, read_counts)
    phase_done()

    # ---- 12. kernel #8, the fused encoder FFN, through its entry points ----
    ffn = ffn_phase(layer0_mlp, reset_counts, read_counts)
    del layer0_mlp
    phase_done()

    # ---- 13. kernels #9a-#9d through the two bench entry points ----
    variants_9a = encoder_variants_phase(reset_counts, read_counts)
    phase_done()
    variants_9bcd = wq_head_variants_phase(reset_counts, read_counts)
    phase_done()

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                                   "msgpack", "tiny_audio_tpu",
                                                                   "scripts"))
    if loaded:
        fail(f"the port imported the JAX side: {loaded[:5]}")

    # Times are at the paths' inputs (#3 and #4: from a CUDA graph over 28
    # cold layer views at the path's shape, B = 4, kv_len 468, int8); the
    # error is the larger of the random-input and the path-input comparisons.
    source = "tiny_audio_tpu_torch/csrc/attention_sm90.cu"
    # the training path's head_dim (128) runs the Hopper backward (64 and 128)
    bwd_source = "tiny_audio_tpu_torch/csrc/attention_bwd_sm90.cu"
    decode_source = "tiny_audio_tpu_torch/csrc/decode_attention.cu"
    int8_source = "tiny_audio_tpu_torch/csrc/int8_matmul.cu"
    launches = {**results["fused"]["counts"],
                "decode_attention": results["module"]["counts"]["decode_attention"]}
    # #5 and #6 at the head, B = 4, from a CUDA graph at a cold L2
    int8_head = {kern: {key: int8_graph[("head", BATCH)][kern][key]
                        for key in ("ms", "bound_ms", "bound_by")}
                 for kern in ("w8a8_matmul", "wq_matmul")}
    print(json.dumps({"kernels": [
        {"name": "encoder_attention", "route": "cuda", "source": source,
         "replaces": "tiny_audio_tpu/ops/encoder_attention.py:159",
         "launches": launches["encoder_attention"], **enc_path,
         "max_abs_err": max(enc["max_abs_err"], enc_path["max_abs_err"])},
        {"name": "prefill_attention", "route": "cuda", "source": source,
         "replaces": "tiny_audio_tpu/ops/attention.py:65",
         "launches": launches["prefill_attention"], **pre_path,
         "max_abs_err": max(pre["max_abs_err"], pre_shapes["prefill_attention"],
                            pre_path["max_abs_err"])},
        {"name": "decode_attention", "route": "cuda", "source": decode_source,
         "replaces": "tiny_audio_tpu/ops/decode_attention.py:152",
         "launches": launches["decode_attention"], **dec_path,
         "ms": dec_graph[("int8", BATCH, 468)]["decode_attention"]["ms"],
         "max_abs_err": max(dec["decode_attention"], dec_shapes["decode_attention"],
                            dec_path["max_abs_err"])},
        {"name": "decode_attention_update", "route": "cuda", "source": decode_source,
         "replaces": "tiny_audio_tpu/ops/decode_attention.py:428",
         "launches": launches["decode_attention_update"], **upd_path,
         "ms": dec_graph[("int8", BATCH, 468)]["decode_attention_update"]["ms"],
         "max_abs_err": max(dec["decode_attention_update"], dec_shapes["decode_attention_update"],
                            upd_path["max_abs_err"])},
        {"name": "w8a8_matmul", "route": "cuda", "source": int8_source,
         "replaces": "tiny_audio_tpu/ops/wq_head.py:128",
         "launches": mode_launches["w8a8_matmul"], **int8_path["w8a8_matmul"],
         **int8_head["w8a8_matmul"],
         "max_abs_err": max(int8_errs["w8a8_matmul"], int8_path["w8a8_matmul"]["max_abs_err"])},
        {"name": "wq_matmul", "route": "cuda", "source": int8_source,
         "replaces": "tiny_audio_tpu/ops/wq_matmul.py:73",
         "launches": mode_launches["wq_matmul"], **int8_path["wq_matmul"], **int8_head["wq_matmul"],
         "library_ms": int8pack.get(BATCH),
         "max_abs_err": max(int8_errs["wq_matmul"], int8_path["wq_matmul"]["max_abs_err"])},
        *({"name": name, "route": "cuda", "source": bwd_source, "replaces": replaces,
           "launches": trained["counts"][name], **trained["path"][name],
           "max_abs_err": max(pre_shapes[name], trained["path"][name]["max_abs_err"])}
          for name, replaces in BWD_REPLACES.items()),
        {"name": "log_mel_spectrogram_fused", "route": "cuda",
         "source": "tiny_audio_tpu_torch/csrc/mel.cu",
         "replaces": "tiny_audio_tpu/ops/mel_pallas.py:93",
         "launches": front["launches"], **front["stats"]},
        {"name": "encoder_ffn", "route": "cuda", "source": "tiny_audio_tpu_torch/csrc/encoder_ffn.cu",
         "replaces": "tiny_audio_tpu/ops/encoder_ffn.py:115",
         "launches": ffn["launches"], **ffn["stats"]},
        {"name": "encoder_attention_variant", "route": "cuda",
         "source": "tiny_audio_tpu_torch/csrc/encoder_attention_variants.cu",
         "replaces": "scripts/bench_encoder_attention.py:209",
         "launches": variants_9a["launches"], **variants_9a["stats"]},
        *({"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": variants_9bcd["launches"][name], **variants_9bcd["stats"][name]}
          for name, source, replaces in (
              ("wq_matmul_pipe", "tiny_audio_tpu_torch/csrc/int8_matmul_variants.cu",
               "scripts/bench_wq_head.py:95"),
              ("a8_matmul", "tiny_audio_tpu_torch/csrc/int8_matmul_variants.cu",
               "scripts/bench_wq_head.py:142"),
              ("a8t_matmul", int8_source, "scripts/bench_wq_head.py:184"))),
    ]}))
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
