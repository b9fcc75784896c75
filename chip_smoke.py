#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the Hopper kernels from ``tiny_audio_tpu_torch/csrc`` (one ``nvcc`` per
source, started together) and shows that #1 and #2 are the Hopper design of
``csrc/attention_sm90.cu``, #2b and #2c that of
``csrc/attention_bwd_sm90.cu``, #8 that of ``csrc/encoder_ffn.cu``,
each of #9a's 13 modes that of ``csrc/encoder_attention_variants.cu`` and
#9b that of ``csrc/int8_matmul_variants.cu``: for each instance of their
kernels,
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
- the MOSA, MoE and QFormer presets at the flagship width, each built as
  ``python -m tiny_audio_tpu_torch.train +experiments=<kind>`` builds it
  (int8 KV): ``generate`` on the serving batch twice (32 tokens, EOS
  masked, the fused path: #1 32, #2 28, #4 28 per step, the same tokens
  both times, 375 / 375 / 300 audio tokens), the projector alone in bf16
  against its weights in fp32 on the CPU on the same encoder output
  (within ``PROJECTOR_RTOL`` of the output's scale) and timed, then three
  stage-1 Trainer steps (MoE's router loss logged and > 0, the others' 0,
  the projector moved, the towers bitwise unchanged); stage 3
  (``freeze_language_model=False``) for three steps (the decoder moved, the
  encoder not); and the convergence gate of tests/test_convergence_gate.py
  from its start (the JAX gate's seed-0 projector and decoder and the
  CTC-pretrained encoder) with its thresholds, then 50 steps of the CTC
  pretrain (#1's forward, its gradient by plain recompute);
- the decoding modes at the flagship on the serving batch (32 tokens, EOS
  masked, exact launches): beams (K = 4) on both decode steps with the same
  tokens, ``top_k=1`` sampling drawing only largest logits (greedy's tokens
  up to a tied top), a seeded generator repeating its tokens, top-p /
  temperature sampling, ``no_repeat_ngram_size=3`` leaving no repeated
  3-gram, and each row's best beam (``length_penalty=0``) reaching one
  beam's (greedy's) summed log-probability; the same modes on the tiny fp32
  towers giving the CPU's tokens;
- the neural VAD on an 80 s clip against its numpy mirror, wav2vec2-CTC at
  full width (seeded weights) and the CTC trellis and the synthetic ECAPA
  tier against the CPU, each timed; then ``ASRPipeline`` with
  ``return_timestamps`` and ``return_speakers`` on a 30 s two-voice
  synthetic conversation, the aligner attached by ``_attach_aux_towers``
  from a directory holding the seeded ``wav2vec2_aligner.msgpack`` (no
  error key, the neural VAD, model-aligned words, speaker segments);
- the realtime WebSocket server (the port's own transport) over that
  pipeline with the neural stream VAD: ``tools/bench_realtime``'s sessions,
  4 concurrent real-time-paced sessions of 4 s of synthesized speech, on
  the lock and through ``DynamicBatcher`` (first partial and endpoint
  latency, launches of #1, #2 and #4 a final; a final for every turn, no
  second final, no partial after its final), one 8 kHz session with
  timestamps, speakers and confidence, and one session on the tiny fp32
  towers giving the CPU's messages; then the eval harness: ``run_eval``
  over the tiny fp32 towers with the ``local``, ``local-streaming`` and
  ``realtime`` backends (WER equal to the CPU's), ``synthetic-diarization``
  and ``synthetic-alignment``, and ``tools/bench_quality``'s DER and
  alignment error;
- the two kernels that only their own entry points reach (no path of the
  port or of the JAX package calls them; every path above launches them 0
  times): the fused log-mel front end (#7, ``log_mel_spectrogram_fused``,
  an FFT in shared memory) on the serving batch's audio, the training
  batch's clips zero-padded to 30 s, the edge shapes of
  tests/test_mel_pallas.py, a T that is no multiple of its 32-frame tile and
  8 mels, each held with its plain version against an fp64 oracle, then
  timed alone at both batches back to back and from a CUDA graph beside its
  previous design's times (``PREVIOUS_MEL_MS``), its entry point, the plain
  mel, the ``torch.stft`` chain, its bound and its ptxas facts (no spill);
  and the fused encoder FFN (#8,
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
design's times and SDPA on a bf16 cache.  Then both with a ``[B]`` kv_len
(the continuous engine's per-row lengths) at B = 16, lengths spread over
[0, 608): against the per-row plain version, #4's rows bitwise, equal
lengths bitwise the scalar launch, a graph advancing the vector, and their
times beside the scalar launch's.  ``torch._weight_int8pack_mm``, one call
computing #6's function, is timed beside #6 at its head shape.

The continuous engine (``ContinuousEngine``, after the realtime phase): at
the flagship, 16 slots and chunks of 8 steps, 32 clips of 2-30 s submitted
open loop (every future resolves; #1 32 and #2 28 launches a prefill
group, #4 28 x 8 a chunk, no plain decode attention; each transcript
against solo ``generate``, parting only where the solo run's top-2 logit
margin is under ``ENGINE_MARGIN_BOUND``; latency and clips/s beside the
``DynamicBatcher`` on the same arrivals, printed), a short run under each
of ``enable_wq_decode`` and ``enable_w8a8_decode`` with exact #6 / #5
launches; the tiny fp32 towers' engine on the card giving the CPU's tokens,
and ``serve(engine="continuous")`` over their checkpoint answering HTTP
requests with the CPU's transcripts.  The offline tools (after the eval
phase): ``train_vad``'s and ``train_speaker_embedder``'s trainers at their
full widths and batches for ``TOOLS_STEPS`` steps on the card and on the
CPU from one init (losses within ``TOOLS_LOSS_RTOL``), their files read
back on both, and ``handler_local`` with ``--timestamps --speakers``.
Then the conversion and CLI phase (after the engine phase): the flagship
written in HF layout by the port's own safetensors writer (the decoder
under Qwen3 names, the encoder under GLM's ``audio_tower.`` prefix, the
projector and the reference ``config.json`` through
``export_reference_artifact``), ``convert_reference_checkpoint`` back onto
the card (every parameter bitwise), ``save_pretrained``, ``ta-torch
transcribe`` in process on three files (the bulk path: texts equal to
``transcribe_batch``, #1 32, #2 28, #4 28 a step, no plain attention) and
on one with ``--srt --timestamps``, ``whisper_mode`` features against the
CPU's and a ``generate`` on them (#1 at T = 1,500), ``doctor --json`` and
the native runtime against numpy; each time beside the card's name and
power limit.  ``debug``'s gradient flow (#2b and #2c 28 each, none into
the encoder) runs after the server phase, on the seeded weights, and the
projector phase runs ``debug``'s router health on the MoE and MOSA
presets.

The int8 products #5 and #6 (``csrc/int8_matmul.cu``, a split over K merged
inside the launch): the registers, shared memory and spills of the 34
instances of ``split_matmul_kernel`` (#5, #6, #9c and #9d's; none may
spill); each product against
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
time beside its previous design's (``PREVIOUS_VARIANT_MS``) and #1's; #9c
and #9d (the split design's third and fourth kinds) also bitwise at B = 1,
4, 17, 48, 64, at ragged N and replayed from a CUDA graph, #9b (the TMA-fed
pipe) within #6's tolerance there and bitwise repeatable, and each of the
three timed alone back to back and from a graph, at B = 48 and 1, beside
its previous design (``PREVIOUS_VARIANT_MS``), its bound and, at B = 48,
#5, #6, #9c, bf16 ``F.linear`` and (#9b) ``torch._weight_int8pack_mm``.

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

import collections
import contextlib
import dataclasses
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
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
# Kernel #7 (an fp32 FFT) and its plain version (cuBLAS fp32 products) are each held
# against an fp64 oracle of the same formula: near the max - 8 floor a bin is
# a difference of large terms, where two right fp32 answers can differ by
# more than the JAX tests' 5e-4 after the log.  The kernel's error may be at
# most MEL_ERR_RATIO times the plain version's, plus MEL_FLOOR (a fifth of
# that 5e-4, in the normalized units of the output).
MEL_ERR_RATIO = 2.0
MEL_FLOOR = 1e-4
# kernel #7 alone: reps of its timed loops, and its previous design (the
# dense DFT product on the CUDA cores, one block per 32 frames) at the
# serving and the training batch, this script's mel_times on the parent
# tree's package (ms; NVIDIA H100 80GB HBM3, 700.00 W)
MEL_REPS = 20
PREVIOUS_MEL_MS = {"serving": {"ms": 0.22946560382843018, "graph_ms": 0.22814559936523438},
                   "training": {"ms": 0.3746880054473877, "graph_ms": 0.37284159660339355}}
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
# The previous designs of #9b (one block per nc-wide chunk) and #9d (#5's
# first CUDA-core tiles, one block per nt channels), each alone from a CUDA
# graph at the bench shape (nc 8,192, nt 2,048), timed by this script's
# alone_times on the package of the tree before their redesign (one run on
# the card); #9c at its numerics point before the redesign of #5 and #6,
# from this script on that tree; then #9a's previous design (mma.sync, 16
# warps a 256-row block, V copied transposed) by mode and hg, and #1 and SDPA
# at its shape, from the tool's timings on that tree in the same run as
# PREVIOUS_FFN_MS (ms; NVIDIA H100 80GB HBM3, 700.00 W)
PREVIOUS_VARIANT_MS = {"wq_matmul_pipe": 2.2131631851196287, "a8_matmul": 3.1405344009399414,
                       "a8t_matmul": 1.5968688011169434,
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
# #9c beyond the sweep: row counts at the bench shape, and N that leave the
# last 128-channel tile part-filled (the head's, and a narrow one whose K is
# split)
A8_CHECK_BATCHES = (1, 4, 17, 48, 64)
A8_RAGGED_N = (151936 - 112, 1040)


# The three projector presets (configs/experiments/{mosa,moe,qformer}.yaml
# over configs/config.yaml, int8 KV) at the flagship width: new tokens of
# their generate (EOS masked), training steps, and the audio tokens a 30 s
# clip must give (1,500 encoder frames: two stride-2 convolutions, 4-frame
# stacks, 100 windows of 15 frames with 3 queries each)
PROJECTOR_KINDS = ("mosa", "moe", "qformer")
PROJECTOR_NEW = 32
PROJECTOR_TRAIN_STEPS = 3
PROJECTOR_AUDIO_TOKENS = {"mosa": 375, "moe": 375, "qformer": 300}
# The projector alone in bf16 on the card against the same fp32 weights in
# fp32 on the CPU, fed the same encoder output: bf16 rounds every product's
# inputs (2**-9 relative) and each layer's output (2**-8), so the outputs
# agree to a few bf16 ulps of their scale: PROJECTOR_RTOL of the largest
# |fp32 output| (the CPU tests hold O(1) bf16 outputs to 5e-2).
PROJECTOR_RTOL = 5e-2
STAGE3_STEPS = 3
# The convergence ladder on the card: tests/test_convergence_gate.py's rows,
# start, steps, learning rates and thresholds (tiny fp32 towers: the JAX
# gate's seed-0 projector and decoder, the checked-in CTC-pretrained
# encoder), then a short CTC pretrain of a fresh encoder
LADDER_TRAIN_ROWS, LADDER_EVAL_ROWS = 256, 24
LADDER_WARMUP = (300, 3e-3)
LADDER_DEAD = (40, 0.0)
LADDER_S1 = (300, 1e-3)
LADDER_CTC_STEPS = 50

# The decoding modes (sampling, beams, n-gram bans) at the flagship: the
# serving batch, MODES_NEW tokens with EOS masked, BEAMS beams.  A row's best
# beam (length_penalty 0: the summed log-probability) must reach one beam's
# (greedy's) sum less BEAM_SCORE_SLACK, the JAX package's own test property.
MODES_NEW = 32
BEAMS = 4
BEAM_SCORE_SLACK = 1e-2
# The auxiliary towers: the neural VAD on a clip past its largest bucket
# (4,096 frames), wav2vec2-CTC at full width on VAD_CLIP_S / ALIGN_CLIP_S,
# ECAPA on ECAPA_WINDOWS windows; card vs the numpy mirror or the CPU.
VAD_CLIP_S = 80.0
ALIGN_CLIP_S = (5.0, 30.0)
ECAPA_WINDOWS = 256
VAD_PROB_ATOL = 1e-4
AUX_LOGP_ATOL = 1e-3
ECAPA_ATOL = 1e-3
TRELLIS_ATOL = 1e-3
# The pipeline with timestamps and speakers: a two-voice synthetic clip
CONVERSATION_S = 30.0
# the realtime phase: tools/bench_realtime's sessions, real-time paced
REALTIME_SESSIONS = 4
REALTIME_SPEECH_S = 4.0
# the flagship's token budget a decode in the realtime phase: at ~31 ms a
# decode step (PERF.md, PR 15) the default 128 tokens would make each partial
# and final a ~4 s decode
REALTIME_NEW = 24
REALTIME_OPTIONS = "timestamps=true&speakers=true&confidence=true"
REALTIME_EXTRA_RATE = 8000
# the eval phase: rows of each synthetic source through run_eval
EVAL_ROWS = 4
EVAL_DIARIZATION_ROWS = 2
# the continuous engine (PR 17): #3/#4 with per-row lengths at the engine's
# batch; the engine at the flagship (16 slots, chunks of 8 steps), 32 clips
# of 2-30 s submitted open loop 0.1 s apart, 16-token budgets (each prefill
# group's reference runs its own decode), then 4 clips under each int8 mode.
# A request's tokens may part from generate on its prefill group only at a
# step whose top-2 logit margin (bf16 logits; batch-16 and batch-n products
# round differently) is under ENGINE_MARGIN_BOUND.
ROW_BATCH = 16
ENGINE_SLOTS = 16
ENGINE_CHUNK = 8
ENGINE_CLIPS = 32
ENGINE_CLIP_S = (2.0, 30.0)
ENGINE_GAP_S = 0.1
ENGINE_NEW = 16
ENGINE_MARGIN_BOUND = 0.25
ENGINE_MODE_CLIPS = 4
# the offline tools: steps and synthesized utterances (of 1,500 / 3,500 and
# 600 / 768 in the JAX scripts), card losses against the CPU's on the same
# batches from one init (fp32 both; cuDNN's and the CPU's sums differ, and
# Adam amplifies a gradient near 0)
TOOLS_STEPS = 10
TOOLS_UTTS = 20
TOOLS_LOSS_RTOL = 5e-3
# the conversion and CLI phase (flagship, int8 KV): the files' clip lengths,
# the tokens each transcript decodes (EOS masked through the exported
# config's min_new_tokens), the whisper-mode clips and the card-vs-CPU
# bound on their fp32 log-mel (|mel| <= ~1.5 after Whisper's scaling)
CONVERT_CLIP_S = (5.0, 12.0, 30.0)
CONVERT_NEW = 32
WHISPER_CLIP_S = (1.0, 2.5, 4.0)
WHISPER_MEL_ATOL = 1e-3
WHISPER_NEW = 4


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
# #8 (csrc/encoder_ffn.cu, one instance), #9a (csrc/encoder_attention_
# variants.cu: variant_sm90<shift, exp bf16, norm, guard, heads a stage>, one
# instance a mode, in ta_encoder_attention_variant's numbering) and #9b
# (csrc/int8_matmul_variants.cu: wq_pipe_sm90<NB>, x padded to NB rows)
FFN_KERNEL = "encoder_ffn_sm90"
VARIANT_KERNEL = "variant_sm90"
PIPE_KERNEL = "wq_pipe_sm90"
PIPE_NB = (16, 32, 48)
VARIANT_INSTANCE_MODES = {
    (0, 0, 0, 0, 1): "fp32", (0, 1, 0, 0, 1): "bf16", (0, 0, 1, 0, 1): "rcp",
    (1, 0, 0, 0, 1): "nomax", (2, 0, 0, 1, 1): "shift", (3, 0, 0, 1, 1): "tilemax",
    (3, 0, 1, 1, 1): "tilemax_rcp", (4, 0, 0, 1, 1): "qnorm", (4, 0, 2, 1, 1): "qnorm_post",
    (0, 0, 2, 1, 1): "fp32_post", (2, 0, 2, 1, 1): "shift_post", (3, 0, 2, 1, 1): "tilemax_post",
    (2, 0, 2, 1, 2): "packed2"}
SM90_INSTANCES = {(SM90_KERNEL, 64, 0, 0), (SM90_KERNEL, 64, 1, 0), (SM90_KERNEL, 64, 1, 1),
                  (SM90_KERNEL, 128, 1, 0), (SM90_KERNEL, 128, 1, 1),
                  *((name, d) for name in SM90_BWD_KERNELS for d in (64, 128)),
                  (FFN_KERNEL,), *((VARIANT_KERNEL, *key) for key in VARIANT_INSTANCE_MODES),
                  *((PIPE_KERNEL, nb) for nb in PIPE_NB)}
# the flagship prefill at the JAX bench's batch (bench.py: 48 x 30 s)
BENCH_BATCH = 48


def sm90_instance(mangled: str):
    """The instance of the Hopper design a kernel symbol names:
    (attention_fwd_sm90, head_dim, causal, stats), (attention_bwd_*_sm90,
    head_dim), (encoder_ffn_sm90,), (variant_sm90, shift, exp bf16, norm,
    guard, heads a stage) or (wq_pipe_sm90, NB); None for any other kernel."""
    found = re.search(SM90_KERNEL + r"ILi(\d+)E.*?Lb([01])ELb([01])E", mangled)
    if found:
        return (SM90_KERNEL, *(int(x) for x in found.groups()))
    found = re.search(r"(" + "|".join(SM90_BWD_KERNELS) + r")ILi(\d+)E", mangled)
    if found:
        return (found.group(1), int(found.group(2)))
    if FFN_KERNEL in mangled:
        return (FFN_KERNEL,)
    found = re.search(PIPE_KERNEL + r"ILi(\d+)E", mangled)
    if found:
        return (PIPE_KERNEL, int(found.group(1)))
    found = re.search(VARIANT_KERNEL + r"ILi(\d)ELb([01])ELi(\d)ELb([01])ELi(\d)E", mangled)
    return None if found is None else (VARIANT_KERNEL, *(int(x) for x in found.groups()))


def instance_text(inst: tuple) -> str:
    if inst[0] == SM90_KERNEL:
        return f"{SM90_KERNEL}<D={inst[1]}, causal={bool(inst[2])}, stats={bool(inst[3])}>"
    if inst[0] == FFN_KERNEL:
        return f"{FFN_KERNEL} (#8)"
    if inst[0] == VARIANT_KERNEL:
        return f"{VARIANT_KERNEL}<{VARIANT_INSTANCE_MODES[inst[1:]]}> (#9a)"
    if inst[0] == PIPE_KERNEL:
        return f"{PIPE_KERNEL}<NB={inst[1]}> (#9b)"
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


# #5, #6, #9c and #9d: split_matmul_kernel<KIND, NT, WN, SHALLOW> of
# csrc/int8_matmul.cu (KIND 0 = #6, 1 = #5, 2 = #9c, 3 = #9d), one instance
# per batch size class (NT 8-row MMA columns), block arrangement and (the s8
# kinds at 32+ rows) ring depth
INT8_KINDS = {0: "wq (#6)", 1: "w8a8 (#5)", 2: "a8 (#9c)", 3: "a8t (#9d)"}
INT8_INSTANCES = {(kind, nt, wn, shallow) for kind in INT8_KINDS for nt in (1, 2, 4, 6, 8)
                  for wn in {0: (1, 4), 1: (1,), 2: (4,), 3: (1,)}[kind]
                  for shallow in ((0, 1) if kind and nt >= 4 else (0,))}


def int8_instance_of(mangled: str):
    """(KIND, NT, WN, SHALLOW) of a split_matmul_kernel symbol, None for any
    other."""
    found = re.search(r"split_matmul_kernelILi(\d)ELi(\d+)ELi(\d+)ELb([01])E", mangled)
    return None if found is None else tuple(int(x) for x in found.groups())


def int8_design_facts(log: str) -> dict:
    """Registers, static shared memory and spills of every instance of the
    split design of #5, #6, #9c and #9d (``ptxas -v``).  Fails before any launch
    if an instance is missing or spills; returns the facts by instance."""
    ptxas = ptxas_facts(log, int8_instance_of)
    if set(ptxas) != INT8_INSTANCES:
        fail(f"int8 kernel instances: ptxas {sorted(ptxas)}, expected {sorted(INT8_INSTANCES)}")
    for inst in sorted(INT8_INSTANCES):
        kind, nt, wn, shallow = inst
        print(f"int8 design split_matmul_kernel<KIND={INT8_KINDS[kind]}, NT={nt}, WN={wn}, "
              f"SHALLOW={bool(shallow)}> ptxas={json.dumps(ptxas[inst])}")
    spilling = [inst for inst in sorted(INT8_INSTANCES) if ptxas[inst].get("spill_bytes") != [0, 0]]
    if spilling:
        fail(f"split_matmul_kernel instances spill: {spilling}")
    return ptxas


MEL_KERNEL = "log_mel_kernel"


def mel_design_facts(log: str) -> dict:
    """Registers, static shared memory and spills of #7's kernel (``ptxas
    -v``), beside its dynamic shared memory (the audio run and the exchange).
    Fails before any launch if it is missing or spills."""
    ptxas = ptxas_facts(log, lambda mangled: MEL_KERNEL if MEL_KERNEL in mangled else None)
    facts = ptxas.get(MEL_KERNEL)
    if facts is None:
        fail(f"{MEL_KERNEL} is not in the build's ptxas log")
    facts["dynamic_smem_bytes"] = 4 * (31 * 160 + 400) + 8 * 32 * 200
    print(f"mel design {MEL_KERNEL} (#7) ptxas={json.dumps(facts)}")
    if facts.get("spill_bytes") != [0, 0]:
        fail(f"{MEL_KERNEL} spills: {facts}")
    return facts


def hopper_design_facts(log: str) -> dict:
    """What shows that #1, #2, #2b, #2c, #8, #9a and #9b are the Hopper
    design: for each instance of attention_fwd_sm90, attention_bwd_dkv_sm90,
    attention_bwd_dq_sm90, encoder_ffn_sm90, variant_sm90 (one a #9a mode)
    and wq_pipe_sm90 (one a padded batch), its registers, static shared memory and spills
    from the build's ``ptxas -v`` log, its dynamic shared memory, and its
    HGMMA (wgmma), UTMALDG (TMA load) and USETMAXREG instructions counted in
    the library's SASS with cuobjdump.  Fails before any launch if an
    instance is missing, spills, or has no HGMMA or no UTMALDG, if ptxas
    serialized a wgmma or ignored a setmaxnreg, or if dkv's or a #9a
    instance's entry registers are not the count its setmaxnreg balances.
    Returns the facts by instance."""
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
    facts = {}
    for inst in sorted(SM90_INSTANCES):
        if inst[0] == SM90_KERNEL:
            smem = lib.ta_attention_sm90_smem_bytes(inst[1], inst[2])
        elif inst[0] == FFN_KERNEL:
            smem = lib.ta_encoder_ffn_smem_bytes()
        elif inst[0] == PIPE_KERNEL:  # at the bench's K = 1,024, B = NB
            from tiny_audio_tpu_torch.ops.wq_head_variants import pipe_plan

            smem = pipe_plan(inst[1], 1024, 151936).smem
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
        facts[inst] = {**ptxas[inst], "dynamic_smem_bytes": smem,
                       **{f"sass_{op}": counts[inst][op] for op in ops}}
    return facts


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
    """The kernel instance #5 (``kind`` "w8a8"), #6 ("wq") or #9c ("a8") takes at this
    shape, as text: the split design's template arguments (NT from the rows,
    SHALLOW as ``launch_nt`` in csrc/int8_matmul.cu picks it) and plan, or
    the first design where the plan refuses the shape."""
    from tiny_audio_tpu_torch.ops.wq_matmul import SPLIT_MAX_ROWS, int8_split_plan

    rows = min(b, SPLIT_MAX_ROWS)
    plan = int8_split_plan(rows, k, n, kind)
    if plan is None:
        return "first design (CUDA-core tiles, no split)"
    nt = next(c for c in (1, 2, 4, 6, 8) if rows <= 8 * c)
    shallow = kind != "wq" and nt >= 4 and plan.units > 256
    kind_id = {"wq": 0, "w8a8": 1, "a8": 2}[kind]
    return (f"split_matmul_kernel<KIND={INT8_KINDS[kind_id]}, NT={nt}, WN={plan.warps_n}, "
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


class StepClock:
    """Host time at each logged optimizer step (logging reads the loss,
    which waits for the device)."""

    def __init__(self):
        self.times = []

    def on_log(self, trainer, record):
        self.times.append(time.perf_counter())


def trainer_run(label: str, model, rows, steps: int, out_root: Path, reset_counts, read_counts,
                accum: int = 1, backward_store=None) -> dict:
    """``steps`` optimizer steps of the Trainer at TRAIN_BATCH on ``rows``
    (logging every step, no checkpoints), with every kernel's launches
    counted from 0: the encoder's and the prefill's per micro-step (twice
    the prefill's under gradient checkpointing), each backward kernel's per
    micro-step and no other.  Fails on non-finite losses or gradient norms,
    a frozen parameter that changed or no trainable one that did; prints the
    run's line and returns its losses, aux losses, counts, changed
    parameters and output directory."""
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.train.optim import OptimizerConfig
    from tiny_audio_tpu_torch.train.trainer import Trainer, TrainingConfig

    collator = DataCollator(model.tokenizer, model.projector,
                            num_mel_bins=model.config.encoder.num_mel_bins,
                            system_prompt=model.config.system_prompt,
                            encoder_conv_layers=model.config.encoder_conv_layers,
                            device=model.device)
    out_dir = out_root / label
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
    if backward_store is not None:
        with record_first_backward(backward_store):
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
    aux = [r["aux_loss"] for r in records]
    norms = [r["grad_norm"] for r in records]
    if len(losses) != steps or not all(np.isfinite(losses + aux + norms)):
        fail(f"training run {label}: losses {losses}, aux {aux}, grad norms {norms}")
    params = dict(model.named_parameters())
    for name, before in frozen.items():
        if not same_bytes(before, params[name].detach().cpu()):
            fail(f"training run {label} changed the frozen parameter {name}")
    changed = [n for n, before in trainable.items()
               if not torch.equal(params[n].detach().cpu(), before)]
    if not changed:
        fail(f"training run {label} changed no trainable parameter")
    del frozen, trainable, snapshot
    step_times = [float(x) for x in np.diff([t0] + clock.times)]
    step_ms = float(np.mean(step_times[1:]) * 1e3) if len(step_times) > 1 else None
    cfg = model.config
    stage = "2 (LoRA)" if cfg.use_lora else ("1" if cfg.freeze_language_model else "3")
    print(f"train run={label} stage={stage} projector={cfg.projector_type} "
          f"batch={TRAIN_BATCH} clip_s={list(TRAIN_CLIP_S)} steps={steps} accum={accum} "
          f"checkpointing={str(cfg.gradient_checkpointing).lower()} "
          f"first_step_ms={step_times[0] * 1e3!r} step_ms_after_first={step_ms!r} "
          f"peak_mem_gib={peak_gib!r} first_loss={losses[0]!r} last_loss={losses[-1]!r} "
          f"aux_losses={aux!r} grad_norms={[round(x, 4) for x in norms]} "
          f"trainable_changed={len(changed)} frozen_unchanged=true "
          f"launches={json.dumps(counts)} micro_steps={micro}")
    phase_done()
    return {"losses": losses, "aux": aux, "counts": counts, "out_dir": out_dir,
            "changed": changed, "step_ms": step_ms, "peak_gib": peak_gib}


def train_phases(reset_counts, read_counts) -> dict:
    """Training at the flagship width on the card (see the module docstring).
    Returns the backward kernels' path numbers and the stage-1 run's counts."""
    from tiny_audio_tpu_torch import ASRConfig
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.train.data import synthetic_dataset

    rows = synthetic_dataset(TRAIN_BATCH, seed=SEED, min_s=TRAIN_CLIP_S[0],
                             max_s=TRAIN_CLIP_S[1])
    path_inputs: dict = {}
    results = {}
    tmp = tempfile.mkdtemp()

    def run(label, model, steps, accum=1, record=False):
        results[label] = trainer_run(label, model, rows, steps, Path(tmp), reset_counts,
                                     read_counts, accum=accum,
                                     backward_store=path_inputs if record else None)
        return results[label]["losses"]

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

    feats = ASRProcessor(loaded.tokenizer, loaded.projector,
                         num_mel_bins=loaded.config.encoder.num_mel_bins,
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


def projector_phases(audio: list, reset_counts, read_counts) -> dict:
    """The MOSA, MoE and QFormer presets at the flagship width on the card,
    each built as ``python -m tiny_audio_tpu_torch.train +experiments=<kind>``
    builds it (int8 KV cache): ``generate`` on the serving batch twice
    (PROJECTOR_NEW tokens, EOS masked, the default fused path: kernel #1 per
    encoder layer, #2 per decoder layer, #4 per layer and step, no other),
    the same tokens both times and the preset's audio-token count; the
    projector alone in bf16 against its weights in fp32 on the CPU on the
    same encoder output (within PROJECTOR_RTOL) and timed; then
    PROJECTOR_TRAIN_STEPS stage-1 Trainer steps (the projector moves, the
    towers stay bitwise, MoE's router loss is logged and > 0, the others'
    0).  Returns each kind's numbers."""
    from tiny_audio_tpu_torch.debug import check_router_health
    from tiny_audio_tpu_torch.models.projectors import create_projector
    from tiny_audio_tpu_torch.processing import ASRProcessor
    from tiny_audio_tpu_torch.train.__main__ import CONFIG_DIR, build_model
    from tiny_audio_tpu_torch.train.config_loader import load_config
    from tiny_audio_tpu_torch.train.data import synthetic_dataset

    rows = synthetic_dataset(TRAIN_BATCH, seed=SEED, min_s=TRAIN_CLIP_S[0],
                             max_s=TRAIN_CLIP_S[1])
    tmp = Path(tempfile.mkdtemp())
    out = {}
    for kind in PROJECTOR_KINDS:
        t0 = time.perf_counter()
        composed = load_config(CONFIG_DIR, [f"+experiments={kind}", "model.kv_cache_dtype=int8"])
        model = build_model(composed, device="cuda")
        phase_done()
        init_s = time.perf_counter() - t0
        cfg = model.config
        if cfg.projector_type != kind or cfg.kv_cache_dtype != "int8" or model.device.type != "cuda":
            fail(f"+experiments={kind} built {cfg.projector_type} / {cfg.kv_cache_dtype} "
                 f"on {model.device}")
        n_params = sum(p.numel() for p in model.projector.parameters())
        feats = ASRProcessor(model.tokenizer, model.projector,
                             num_mel_bins=cfg.encoder.num_mel_bins,
                             device=model.device).extract_features(audio)
        mel_len = int(feats["mel_lengths"].max())
        n_audio = model._num_audio_tokens(mel_len)
        if n_audio != PROJECTOR_AUDIO_TOKENS[kind]:
            fail(f"{kind}: {n_audio} audio tokens for 30 s, expected "
                 f"{PROJECTOR_AUDIO_TOKENS[kind]}")
        n_enc, n_dec = cfg.encoder.num_layers, cfg.decoder.num_layers
        want = {name: 0 for name in read_counts()}
        want.update({"encoder_attention": n_enc, "prefill_attention": n_dec,
                     "decode_attention_update": n_dec * (PROJECTOR_NEW - 1)})
        calls = []
        for _ in range(2):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = model.generate(feats["input_features"], feats["audio_attention_mask"],
                                    mel_length=mel_len, min_new_tokens=PROJECTOR_NEW,
                                    max_new_tokens=PROJECTOR_NEW)
            torch.cuda.synchronize()
            calls.append((tokens, time.perf_counter() - t0, read_counts()))
        for tokens, _, counts in calls:
            if counts != want:
                fail(f"{kind} generate launches {counts}, expected {want}")
            if tokens.shape != (BATCH, PROJECTOR_NEW) or tokens.min() < 0 \
                    or tokens.max() >= cfg.decoder.vocab_size:
                fail(f"{kind} generate gave tokens of shape {tokens.shape}")
        if not np.array_equal(calls[0][0], calls[1][0]):
            fail(f"two {kind} generate calls gave different tokens")

        # the projector alone: bf16 on the card vs fp32 on the CPU
        with torch.inference_mode():
            hidden = model.encoder(feats["input_features"], feats["audio_attention_mask"])
            got, aux = model.projector(hidden)
            proj_ms = cuda_ms(lambda: model.projector(hidden), 5)
        reference = create_projector(cfg, dtype=torch.float32, device="cpu")
        reference.load_state_dict(model.projector.state_dict())
        with torch.inference_mode():
            want_out, _ = reference(hidden.float().cpu())
        err = float((got.float().cpu() - want_out).abs().max())
        scale = float(want_out.abs().max())
        if got.shape != (BATCH, n_audio, cfg.llm_dim) or not torch.isfinite(got).all() \
                or float(aux) != 0.0:
            fail(f"{kind} projector gave {tuple(got.shape)} (finite "
                 f"{bool(torch.isfinite(got).all())}, aux {float(aux)})")
        if not err <= PROJECTOR_RTOL * scale:
            fail(f"{kind} projector on the card is {err} off the fp32 CPU's (scale {scale})")
        del hidden, got, reference, want_out
        if kind in ("moe", "mosa"):  # ta debug check-moe / check-mosa on the preset
            reset_counts()
            t0 = time.perf_counter()
            health = check_router_health(model)
            torch.cuda.synchronize()
            router_s = time.perf_counter() - t0
            counts = read_counts()
            usage = health["per_expert_usage"]
            if counts != {**{name: 0 for name in counts}, "encoder_attention": n_enc} or \
                    not abs(sum(usage) - 1.0) < 1e-3 or \
                    not 0.0 <= health["normalized_entropy"] <= 1.0:
                fail(f"debug router on {kind}: {health}, launches {counts}")
            print(f"debug_router kind={kind} wall_s={router_s!r} "
                  f"normalized_entropy={health['normalized_entropy']!r} per_expert_usage={usage} "
                  f"collapsed={health['collapsed']} launches={json.dumps(counts)}")
        print(f"projector kind={kind} params={n_params} batch={BATCH} clip_s={CLIP_S} kv=int8 "
              f"init_s={init_s!r} audio_tokens={n_audio} new_tokens={PROJECTOR_NEW} "
              f"first_call_s={calls[0][1]!r} second_call_s={calls[1][1]!r} "
              f"launches={json.dumps(calls[0][2])} deterministic=true "
              f"projector_bf16_ms={proj_ms!r} max_abs_err_vs_cpu_fp32={err!r} "
              f"tolerance={PROJECTOR_RTOL}*{scale!r}")
        phase_done()

        run = trainer_run(f"{kind}_stage1", model, rows, PROJECTOR_TRAIN_STEPS, tmp,
                          reset_counts, read_counts)
        if any(not n.startswith("projector.") for n in run["changed"]):
            fail(f"{kind} stage 1 moved a tower: {run['changed'][:3]}")
        aux_ok = all(a > 0 for a in run["aux"]) if kind == "moe" else \
            all(a == 0 for a in run["aux"])
        if not aux_ok:
            fail(f"{kind} stage 1 logged aux losses {run['aux']}")
        out[kind] = {"generate_s": calls[1][1], "projector_ms": proj_ms, "err": err,
                     "step_ms": run["step_ms"], "peak_gib": run["peak_gib"]}
        del model
        torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    return out


def stage3_phase(reset_counts, read_counts) -> dict:
    """Stage 3 at the flagship width: the MLP model with
    ``freeze_language_model=False`` (the decoder trains with the projector,
    the encoder stays frozen), STAGE3_STEPS Trainer steps at TRAIN_BATCH."""
    from tiny_audio_tpu_torch import ASRConfig
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.train.data import synthetic_dataset

    rows = synthetic_dataset(TRAIN_BATCH, seed=SEED, min_s=TRAIN_CLIP_S[0],
                             max_s=TRAIN_CLIP_S[1])
    tmp = Path(tempfile.mkdtemp())
    model = ASRModel(ASRConfig(freeze_language_model=False), seed=SEED)
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    run = trainer_run("stage3", model, rows, STAGE3_STEPS, tmp, reset_counts, read_counts)
    moved = [n for n in run["changed"] if n.startswith("decoder.")]
    if not moved or any(n.startswith("encoder.") for n in run["changed"]):
        fail(f"stage 3 moved decoder {len(moved)} / encoder params: {run['changed'][:3]}")
    n_decoder = sum(1 for n, _ in model.named_parameters() if n.startswith("decoder."))
    print(f"train stage3 trainable_params={trainable} decoder_tensors_moved={len(moved)}/"
          f"{n_decoder} encoder_unchanged=true step_ms_after_first={run['step_ms']!r} "
          f"peak_mem_gib={run['peak_gib']!r}")
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    return {"step_ms": run["step_ms"], "peak_gib": run["peak_gib"], "moved": len(moved)}


def convergence_phase(reset_counts, read_counts) -> dict:
    """The convergence gate of tests/test_convergence_gate.py on the card,
    from its start (the JAX gate's seed-0 projector and decoder and the
    CTC-pretrained encoder, ``convergence.load_gate_start``), thresholds
    unchanged: held-out WER at init > 0.6, the warmup's last
    logged loss under half its first, a zero-learning-rate stage 1 that does
    not beat the warmup's eval loss, WER after stage 1 <= 0.85 x init and
    the stage-1 eval loss under the warmup's; then LADDER_CTC_STEPS steps of
    the CTC pretrain on a fresh encoder (kernel #1 forward, its gradient by
    plain recompute).  Counts: the ladder's training and evaluation reach
    #1, #2, #2b, #2c and #4; the CTC pretrain only #1."""
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.train import convergence as conv
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.utils.speech_synth import labeled_speech_dataset

    t0 = time.perf_counter()
    train_rows = labeled_speech_dataset(LADDER_TRAIN_ROWS, conv.DEFAULT_VOCAB, seed=SEED)
    eval_rows = labeled_speech_dataset(LADDER_EVAL_ROWS, conv.DEFAULT_VOCAB, seed=SEED + 10_000)
    data_s = time.perf_counter() - t0
    tmp = Path(tempfile.mkdtemp())
    seconds, wers = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result

    model = ASRModel(tiny_test_config(model_dtype="float32"), seed=SEED)
    conv.load_gate_start(model)
    collator = DataCollator(model.tokenizer, model.projector,
                            num_mel_bins=model.config.encoder.num_mel_bins,
                            system_prompt=model.config.system_prompt,
                            encoder_conv_layers=model.config.encoder_conv_layers,
                            device=model.device)

    def stage(name, steps_lr):
        steps, lr = steps_lr
        return timed(name, lambda: conv.train_stage(
            model, collator, train_rows, eval_rows[:16], str(tmp / name), steps, lr,
            seed=SEED, verbose=False))

    reset_counts()
    wers["init"] = timed("wer_init", lambda: conv._wer_eval(model, eval_rows))
    model.config.freeze_language_model = False
    model.config.freeze_projector = True
    warm = stage("warmup", LADDER_WARMUP)
    wers["warmup"] = timed("wer_warmup", lambda: conv._wer_eval(model, eval_rows))
    model.config.freeze_language_model = True
    model.config.freeze_projector = False
    snapshot = {n: p.detach().clone() for n, p in model.named_parameters()}
    dead = stage("stage1_dead", LADDER_DEAD)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(snapshot[name])
    s1 = stage("stage1", LADDER_S1)
    wers["s1"] = timed("wer_s1", lambda: conv._wer_eval(model, eval_rows))
    counts = read_counts()
    curves = {"warmup": warm["curve"], "stage1": s1["curve"]}
    print(f"convergence ladder rows={LADDER_TRAIN_ROWS}/{LADDER_EVAL_ROWS} data_s={data_s!r} "
          f"wer={json.dumps(wers)} eval_loss_warmup={warm['eval_loss']!r} "
          f"eval_loss_dead={dead['eval_loss']!r} eval_loss_s1={s1['eval_loss']!r} "
          f"seconds={json.dumps(seconds)} curves={json.dumps(curves)} "
          f"launches={json.dumps(counts)}")
    used = ("encoder_attention", "prefill_attention", "prefill_attention_bwd_dkv",
            "prefill_attention_bwd_dq", "decode_attention_update")
    if min(counts[name] for name in used) == 0 or \
            any(counts[name] for name in counts if name not in used):
        fail(f"the convergence ladder's launches {counts}")
    if not wers["init"] > 0.6:
        fail(f"held-out WER at init {wers['init']}: the task is degenerate")
    if not warm["curve"][-1][1] < 0.5 * warm["curve"][0][1]:
        fail(f"the decoder warmup's loss did not halve: {warm['curve']}")
    if dead["eval_loss"] < warm["eval_loss"]:
        fail(f"a zero-learning-rate stage 1 beat the warmup: {dead['eval_loss']} < "
             f"{warm['eval_loss']}")
    if not wers["s1"] <= 0.85 * wers["init"]:
        fail(f"held-out WER did not fall: init {wers['init']} -> stage 1 {wers['s1']}")
    if not s1["eval_loss"] < warm["eval_loss"]:
        fail(f"stage 1's eval loss {s1['eval_loss']} not under the warmup's {warm['eval_loss']}")
    del model, snapshot
    shutil.rmtree(tmp)

    # a short CTC pretrain of a fresh encoder
    fresh = ASRModel(tiny_test_config(model_dtype="float32"), seed=SEED)
    reset_counts()
    ctc = timed("ctc", lambda: conv.pretrain_encoder_ctc(
        fresh, train_rows, eval_rows, conv.DEFAULT_VOCAB, steps=LADDER_CTC_STEPS, batch=16,
        seed=SEED, verbose=False))
    counts = read_counts()
    want = {name: 0 for name in counts}
    want["encoder_attention"] = fresh.config.encoder.num_layers * (LADDER_CTC_STEPS + 1)
    if counts != want:
        fail(f"the CTC pretrain launched {counts}, expected {want}")
    losses = [loss for _, loss in ctc["curve"]]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"the CTC pretrain's loss curve {ctc['curve']}")
    print(f"convergence ctc steps={LADDER_CTC_STEPS} batch=16 wall_s={seconds['ctc']!r} "
          f"ms_per_step={seconds['ctc'] / LADDER_CTC_STEPS * 1e3!r} curve={json.dumps(ctc['curve'])} "
          f"token_error_rate={ctc['token_error_rate']!r} launches={json.dumps(counts)}")
    del fresh
    torch.cuda.empty_cache()
    return {"wer": wers, "seconds": seconds}


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

    b, n = audio.shape[0], audio.shape[-1]
    t = n // HOP_LENGTH
    n_freq = N_FFT // 2 + 1
    nonzero = int(np.count_nonzero(mel_filter_bank(n_freq, mels)))
    per_frame = N_FFT + 2.5 * N_FFT * np.log2(N_FFT) + 3 * n_freq + 2 * nonzero + mels
    return bound(nbytes(audio) + b * mels * t * 4, b * t * per_frame, FP32_FLOPS)


def serving_audio(rng: np.random.Generator) -> list:
    """The serving batch: BATCH x 30 s of int16 PCM noise, as float32 rows
    (``main`` hands ``generate`` the first draw of default_rng(SEED))."""
    n = int(CLIP_S * 16000)
    pcm = (np.clip(rng.standard_normal((BATCH, n)) * 0.1, -1, 1) * 32767).astype(np.int16)
    return [row.astype(np.float32) / 32768.0 for row in pcm]


def training_audio() -> np.ndarray:
    """The training batch's TRAIN_BATCH synthetic 10-30 s clips from SEED,
    zero-padded to 30 s: [TRAIN_BATCH, 480,000] float32."""
    from tiny_audio_tpu_torch.train.data import synthetic_dataset

    n30 = int(CLIP_S * 16000)
    clips = [r["audio"]["array"] for r in synthetic_dataset(
        TRAIN_BATCH, seed=SEED, min_s=TRAIN_CLIP_S[0], max_s=TRAIN_CLIP_S[1])]
    train = np.zeros((len(clips), n30), np.float32)
    for i, clip in enumerate(clips):
        train[i, : len(clip)] = clip[:n30]
    return train


def mel_times(launch_log_mel, pad_audio) -> dict:
    """Kernel #7 alone (``launch_log_mel`` on padded audio, 128 mels) at the
    serving batch and the training batch: {batch: {"ms", "graph_ms"}}, back
    to back and from a CUDA graph of MEL_REPS launches."""
    times = {}
    for label, audio in (("serving", np.stack(serving_audio(np.random.default_rng(SEED)))),
                         ("training", training_audio())):
        x = torch.from_numpy(audio).cuda()
        t = x.shape[1] // 160
        padded = pad_audio(x)[:, : (t + 3) * 160].contiguous()
        call = lambda: launch_log_mel(padded, t, 128)  # noqa: E731
        times[label] = {"ms": cuda_ms(call, MEL_REPS), "graph_ms": graph_ms(call, MEL_REPS)}
    return times


def front_end_phase(serving: list, mel_ptxas: dict, reset_counts, read_counts) -> dict:
    """Kernel #7 through its entry point, ``log_mel_spectrogram_fused``, on the
    serving batch's audio, the training batch's clips zero-padded to 30 s,
    the edge shapes of tests/test_mel_pallas.py, a T that is no multiple of
    the kernel's 32-frame tile and 8 mels; each output against the plain mel
    and both against an fp64 oracle; then the kernel alone timed at the
    serving and the training batch, back to back and from a CUDA graph,
    beside its previous design's times (PREVIOUS_MEL_MS), the entry point,
    the plain mel, torch.stft + power + filterbank, the bound and its ptxas
    facts."""
    from tiny_audio_tpu_torch.ops.mel import log_mel_spectrogram, mel_filter_bank, pad_audio
    from tiny_audio_tpu_torch.ops.mel_fused import launch_log_mel, log_mel_spectrogram_fused

    n30 = int(CLIP_S * 16000)
    rng = np.random.default_rng(SEED + 7)
    noise = lambda b, n: (rng.standard_normal((b, n)) * 0.1).astype(np.float32)  # noqa: E731
    cases = [("serving_4x30s", np.stack(serving), 128),
             ("training_6x10-30s_zero_padded", training_audio(), 128),
             ("1s_80mels", noise(2, 16000), 80), ("3s_128mels", noise(2, 48000), 128),
             ("one_tpu_tile", noise(2, 256 * 160), 128), ("30s_128mels", noise(2, n30), 128),
             ("silence_80mels", np.zeros((1, 32000), np.float32), 80),
             ("160_samples_constant_pad", noise(2, 160), 80),
             ("T_101_frames_ragged_tile", noise(3, 101 * 160), 128),
             ("3s_8mels", noise(2, 48000), 8)]
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

    # the kernel alone at both batches; the entry point, the plain mel and the
    # library chain (torch.stft, power, filterbank, log, clamp) at the serving one
    times = mel_times(launch_log_mel, pad_audio)
    _, x, mels = inputs[0]
    entry_ms = cuda_ms(lambda: log_mel_spectrogram_fused(x, mels), MEL_REPS)
    entry_graph_ms = graph_ms(lambda: log_mel_spectrogram_fused(x, mels), MEL_REPS)
    plain_ms = cuda_ms(lambda: log_mel_spectrogram(x, mels), MEL_REPS)
    window = torch.hann_window(400, periodic=True, device=x.device)
    fb = torch.from_numpy(mel_filter_bank(201, mels).astype(np.float32)).cuda()

    def library():
        spec = torch.stft(x, 400, 160, window=window, center=True, pad_mode="reflect",
                          return_complex=True)[..., :-1]
        mel = torch.matmul(fb.T, spec.abs() ** 2)
        log_spec = torch.log10(torch.clamp(mel, min=1e-10))
        return (torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0) + 4.0) / 4.0

    library_ms = cuda_ms(library, MEL_REPS)
    stft_ms = cuda_ms(lambda: torch.stft(x, 400, 160, window=window, center=True,
                                         pad_mode="reflect", return_complex=True), MEL_REPS)
    library_err = (library() - outs[0]).abs().max().item()
    # from CUDA graphs too: each chain is several launches, host-bound back to back
    library_graph_ms = graph_ms(library, MEL_REPS)
    plain_graph_ms = graph_ms(lambda: log_mel_spectrogram(x, mels), MEL_REPS)
    train_x = inputs[1][1]
    stats = {"max_abs_err": worst, "ms": times["serving"]["graph_ms"],
             "plain_ms": plain_graph_ms, **mel_bound(x, mels), "library_ms": library_graph_ms,
             "back_to_back_ms": times["serving"]["ms"], "entry_point_ms": entry_ms,
             "entry_point_graph_ms": entry_graph_ms}
    for label, bx in (("serving", x), ("training", train_x)):
        now, before = times[label], PREVIOUS_MEL_MS[label]
        print(f"log_mel_spectrogram_fused timing batch={label} shape={list(bx.shape)} mels=128 "
              f"kernel_graph_ms={now['graph_ms']!r} kernel_ms={now['ms']!r} "
              f"previous_design_graph_ms={before['graph_ms']!r} "
              f"previous_design_ms={before['ms']!r} "
              f"bound_ms={mel_bound(bx, 128)['bound_ms']!r} "
              f"share_of_bound={mel_bound(bx, 128)['bound_ms'] / now['graph_ms']!r}")
    print(f"log_mel_spectrogram_fused timing shape={list(x.shape)} mels={mels} "
          f"kernel_graph_ms={stats['ms']!r} kernel_ms={stats['back_to_back_ms']!r} "
          f"entry_point_ms={entry_ms!r} entry_point_graph_ms={entry_graph_ms!r} "
          f"plain_ms={plain_ms!r} plain_graph_ms={plain_graph_ms!r} stft_chain_ms={library_ms!r} "
          f"stft_chain_graph_ms={library_graph_ms!r} "
          f"stft_alone_ms={stft_ms!r} stft_chain_vs_kernel_max_abs_err={library_err!r} "
          f"bound_ms={stats['bound_ms']!r} bound_by={stats['bound_by']} "
          f"ptxas={json.dumps(mel_ptxas)} launches={json.dumps(counts)}")
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
        feats = ASRProcessor(model.tokenizer, model.projector,
                             device=model.device).extract_features(audio)
        with torch.inference_mode():
            embeds[name] = model._encode_audio(
                feats["input_features"], feats["audio_attention_mask"]
            )[0].float().cpu()
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
                feats = ASRProcessor(model.tokenizer, model.projector,
                                     num_mel_bins=cfg.encoder.num_mel_bins,
                                     device=model.device).extract_features(audio)
                args = (feats["input_features"], feats["audio_attention_mask"])
                with torch.inference_mode():
                    embeds[where] = model._encode_audio(*args)[0].float().cpu()
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


def given_x_checks(kind: str, x, w_i8, scale) -> dict:
    """#9c (``kind`` "a8", the weight [K, N]) or #9d ("a8t", [N, K]) bitwise
    its plain version beyond the tool's sweep: at the bench shape for every
    A8_CHECK_BATCHES row count (fresh x), at ragged N (the last tile
    part-filled, and a narrow product whose K is split), and replayed from a
    CUDA graph; one launch per call (64 rows or fewer).  Returns {label:
    launches and plan}."""
    from tiny_audio_tpu_torch.ops.wq_head import w8a8_matmul_plain
    from tiny_audio_tpu_torch.ops.wq_head_variants import a8_matmul, a8t_matmul
    from tiny_audio_tpu_torch.ops.wq_matmul import int8_split_plan

    fn, label = {"a8": (a8_matmul, "a8_matmul (#9c)"),
                 "a8t": (a8t_matmul, "a8t_matmul (#9d)")}[kind]
    layout = (lambda w: w) if kind == "a8" else (lambda w: w.T.contiguous())  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    k = x.shape[1]
    cases = [(f"B={b}", (torch.randn((b, k), generator=gen, device="cuda") * 2).to(torch.bfloat16),
              w_i8, scale) for b in A8_CHECK_BATCHES]
    for n in A8_RAGGED_N:
        w = w_i8[:, :n].contiguous()
        cases.append((f"B=17 N={n}", cases[2][1], w, scale[:n].contiguous()))
    done = {}
    for case, xb, w, sc in cases:
        before = fn.launches
        got = fn(xb, layout(w), sc)
        want = w8a8_matmul_plain(xb, w.T, sc)
        if not same_bytes(got, want):
            fail(f"{label} is not bitwise its plain version at {case}: "
                 f"{(got.float() - want.float()).abs().max().item()}")
        plan = int8_split_plan(min(xb.shape[0], 64), k, w.shape[1], kind)
        done[case] = {"launches": fn.launches - before, "splits": plan.splits,
                      "tiles": plan.tiles}
        if done[case]["launches"] != 1:
            fail(f"{label} launched {done[case]['launches']} times at {case}")
    xg, wl = x.clone(), layout(w_i8)
    static = fn(xg, wl, scale)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fn(xg, wl, scale)
    for xb in (cases[3][1], x):  # another x of 48 rows, then the tool's
        xg.copy_(xb)
        graph.replay()
        torch.cuda.synchronize()
        if not same_bytes(static, w8a8_matmul_plain(xb, w_i8.T, scale)):
            fail(f"{label} replayed from a CUDA graph is not bitwise its plain version")
    print(f"{label} bitwise_vs_plain=true cases={json.dumps(done)} graph_replays=2 "
          f"graph_bitwise=true")
    return done


def pipe_checks(x, w_i8, scale) -> float:
    """#9b within #6's tolerance of its plain version beyond the tool's
    sweep (B = 1, 4, 17 and 48 on fresh x at the bench shape, and B = 17 at
    ragged N), and bitwise repeatable: a second call, and a CUDA graph
    replayed on the tool's x and on another, each equal to an eager call's
    bits.  Returns the largest error against the plain version."""
    from tiny_audio_tpu_torch.ops.wq_head_variants import wq_matmul_pipe
    from tiny_audio_tpu_torch.ops.wq_matmul import WQ_ATOL, WQ_RTOL, wq_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    k = x.shape[1]
    xs = {b: (torch.randn((b, k), generator=gen, device="cuda") * 2).to(torch.bfloat16)
          for b in (1, 4, 17, 48)}
    cases = [(f"B={b}", xb, w_i8, scale) for b, xb in xs.items()]
    cases += [(f"B=17 N={n}", xs[17], w_i8[:, :n].contiguous(), scale[:n].contiguous())
              for n in A8_RAGGED_N]
    worst = 0.0
    for case, xb, w, sc in cases:
        got, want = wq_matmul_pipe(xb, w, sc), wq_matmul_plain(xb, w, sc)
        diff = (got.float() - want.float()).abs()
        worst = max(worst, diff.max().item())
        if not bool((diff <= WQ_ATOL + WQ_RTOL * want.float().abs()).all()) or \
                not bool(torch.isfinite(got).all()):
            fail(f"wq_matmul_pipe (#9b) disagrees with its plain version at {case}: "
                 f"{diff.max().item()}")
        if not same_bytes(got, wq_matmul_pipe(xb, w, sc, 16384)):
            fail(f"wq_matmul_pipe (#9b) is not bitwise repeatable at {case}")
    xg = x.clone()
    static = wq_matmul_pipe(xg, w_i8, scale)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = wq_matmul_pipe(xg, w_i8, scale)
    for xb in (x, xs[48]):
        xg.copy_(xb)
        graph.replay()
        torch.cuda.synchronize()
        if not same_bytes(static, wq_matmul_pipe(xb, w_i8, scale)):
            fail("wq_matmul_pipe (#9b) replayed from a CUDA graph differs from an eager call")
    print(f"wq_matmul_pipe (#9b) within_wq_tolerance=true max_abs_err_vs_plain={worst!r} "
          f"cases={json.dumps([c[0] for c in cases])} repeat_bitwise=true graph_replays=2 "
          f"graph_bitwise=true")
    return worst


def alone_times(calls: dict) -> dict:
    """Each of ``calls`` (name -> one launch of a kernel alone, its inputs
    and output made beforehand) from a CUDA graph of VARIANT_REPS launches
    and back to back (CUDA events over VARIANT_REPS launches): name ->
    {"graph_ms", "back_to_back_ms"}."""
    return {name: {"graph_ms": graph_ms(fn, VARIANT_REPS),
                   "back_to_back_ms": cuda_ms(fn, VARIANT_REPS)} for name, fn in calls.items()}


def wq_head_variants_phase(int8_ptxas: dict, sm90_facts: dict, library_ms, reset_counts,
                           read_counts) -> dict:
    """Kernels #9b-#9d through their entry point, the port's
    tools/bench_wq_head.py at scripts/bench_wq_head.py's shape, every sweep
    point: #9c and #9d bitwise their plain versions, #9b within #6's
    tolerance; #9c and #9d also at more row counts, ragged N and from a CUDA
    graph (``given_x_checks``), #9b at more row counts and ragged N, bitwise
    repeatable and from a graph (``pipe_checks``); then each one's plain
    time and bound at the script's numerics points, nc = 8192 (#9b) and nt =
    2048 (#9c, #9d), and each kernel timed alone (#9c and #9d on x quantized
    beforehand) from a CUDA graph and back to back beside its previous
    design, its bound and, from graphs at B = 48, #5, #6, #9c and bf16
    ``F.linear`` (#9b also ``torch._weight_int8pack_mm``, ``library_ms``),
    and again at B = 1 beside #5 and #6."""
    import torch.nn.functional as F

    from tiny_audio_tpu_torch.ops.wq_head import quantize_act, w8a8_matmul, w8a8_matmul_plain
    from tiny_audio_tpu_torch.ops.wq_head_variants import (
        launch_a8,
        launch_a8t,
        launch_pipe,
        pipe_plan,
    )
    from tiny_audio_tpu_torch.ops.wq_matmul import int8_split_plan, wq_matmul, wq_matmul_plain
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
    given_x_checks("a8", x, w_i8, scale)
    given_x_checks("a8t", x, w_i8, scale)
    pipe_err = pipe_checks(x, w_i8, scale)
    x_i8, sx = quantize_act(x)
    sx = sx.reshape(-1).contiguous()
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
            "entry_ms": r["products"][label]["ms"], "plain_ms": cuda_ms(lambda: plain(*args), 5),
            **bound(moved, ops, peak), "library_ms": None}
    entries["wq_matmul_pipe"].update(max_abs_err=max(entries["wq_matmul_pipe"]["max_abs_err"],
                                                     pipe_err), library_ms=library_ms)
    # each kernel alone, and the yardsticks at B = 48, from graphs
    reset_counts()
    alone = alone_times({
        "wq_matmul_pipe": lambda: launch_pipe(x, w_i8, scale, out),
        "a8_matmul": lambda: launch_a8(x_i8, sx, w_i8, scale, out),
        "a8t_matmul": lambda: launch_a8t(x_i8, sx, wt_i8, scale, out)})
    w_linear = d["w"].T.contiguous()
    yard = {"w8a8_matmul (#5)": graph_ms(lambda: w8a8_matmul(x, wt_i8, scale), VARIANT_REPS),
            "wq_matmul (#6)": graph_ms(lambda: wq_matmul(x, w_i8, scale), VARIANT_REPS),
            "a8_matmul alone (#9c)": alone["a8_matmul"]["graph_ms"],
            "bf16 F.linear": graph_ms(lambda: F.linear(x, w_linear), VARIANT_REPS),
            "torch._weight_int8pack_mm": library_ms}
    del w_linear
    b, k, n = x.shape[0], x.shape[1], scale.shape[0]
    # the same kernels at B = 1: the same weight bytes, 48 times fewer products
    x1, out1 = x[:1].contiguous(), out[:1]
    x1_i8, sx1 = quantize_act(x1)
    sx1 = sx1.reshape(-1).contiguous()
    one = alone_times({
        "wq_matmul_pipe": lambda: launch_pipe(x1, w_i8, scale, out1),
        "a8_matmul": lambda: launch_a8(x1_i8, sx1, w_i8, scale, out1),
        "a8t_matmul": lambda: launch_a8t(x1_i8, sx1, wt_i8, scale, out1),
        "wq_matmul (#6)": lambda: wq_matmul(x1, w_i8, scale),
        "w8a8_matmul (#5)": lambda: w8a8_matmul(x1, wt_i8, scale)})
    one_bound = bound(nbytes(x1_i8, sx1, w_i8, scale, out1), 2.0 * k * n, INT8_TENSOR_OPS)
    print(f"wq_head variants alone at B=1 K={k} N={n}: graph_ms="
          f"{json.dumps({name: t['graph_ms'] for name, t in one.items()})} back_to_back_ms="
          f"{json.dumps({name: t['back_to_back_ms'] for name, t in one.items()})} "
          f"bound_ms={one_bound['bound_ms']!r} bound_by={one_bound['bound_by']}")
    nt = next(c for c in (1, 2, 4, 6, 8) if b <= 8 * c)
    for name, label in (("wq_matmul_pipe", "pipe"), ("a8_matmul", "a8"), ("a8t_matmul", "a8t")):
        e = entries[name]
        e.update(ms=alone[name]["graph_ms"], back_to_back_ms=alone[name]["back_to_back_ms"])
        sweep = {p_name: p["ms"] for p_name, p in r["products"].items()
                 if p_name.split()[0] == label}
        sweep_graph = {p_name: p["graph_ms"] for p_name, p in r["products"].items()
                       if p_name.split()[0] == label}
        if name == "wq_matmul_pipe":
            plan = pipe_plan(b, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
            design = (f"plan={json.dumps(plan._asdict())} instance=wq_pipe_sm90<NB={plan.nb}> "
                      f"facts={json.dumps(sm90_facts[(PIPE_KERNEL, plan.nb)])}")
        else:
            plan = int8_split_plan(b, k, n, label)
            inst = ({"a8": 2, "a8t": 3}[label], nt, plan.warps_n,
                    int(nt >= 4 and plan.units > 256))
            design = (f"plan={json.dumps(plan._asdict())} instance=split_matmul_kernel<"
                      f"KIND={INT8_KINDS[inst[0]]}, NT={inst[1]}, WN={inst[2]}, "
                      f"SHALLOW={bool(inst[3])}> ptxas={json.dumps(int8_ptxas[inst])}")
        print(f"{name} at B={b} K={k} N={n}: kernel_graph_ms={e['ms']!r} "
              f"kernel_ms={e['back_to_back_ms']!r} sweep_entry_point_ms={json.dumps(sweep)} "
              f"sweep_entry_point_graph_ms={json.dumps(sweep_graph)} "
              f"previous_design_ms={PREVIOUS_VARIANT_MS[name]!r} bound_ms={e['bound_ms']!r} "
              f"bound_by={e['bound_by']} share_of_bound={e['bound_ms'] / e['ms']!r} "
              f"plain_ms={e['plain_ms']!r} library_ms={e['library_ms']!r} "
              f"yardsticks_graph_ms={json.dumps(yard)} {design}")
    print("wq_head variants at the script's numerics points "
          + " ".join(f"{n_}_entry_ms={e['entry_ms']!r} {n_}_plain_ms={e['plain_ms']!r} "
                     f"{n_}_bound_ms={e['bound_ms']!r}" for n_, e in entries.items())
          + f" bf16_linear_ms={r['products']['bf16 dot']['ms']!r} "
          f"wq_matmul_ms={r['products']['wq shipped (#6)']['ms']!r} "
          f"w8a8_matmul_ms={r['products']['w8a8 shipped (#5)']['ms']!r} "
          f"launches={json.dumps(counts)} (no PyTorch call computes #9c's or #9d's int8 x int8 "
          f"product with both scales)")
    del r, d, x, w_i8, wt_i8, out
    torch.cuda.empty_cache()
    return {"stats": entries, "launches": {n_: counts[n_] for n_ in mine}}



def decoding_modes_phase(model, pipe, audio: list, no_int8: dict, reset_counts,
                         read_counts) -> None:
    """Sampling, beams and n-gram bans through ``ASRModel.generate`` at the
    flagship width on the serving batch (int8 KV, MODES_NEW tokens, EOS
    masked), each call's launches exact: beams on both decode steps with the
    same tokens, ``top_k=1`` sampling equal to greedy, a seeded generator
    repeating its tokens, top-p / temperature sampling, n-gram bans leaving
    no repeated 3-gram; then the beams' score property against one beam
    (greedy) on the exact prompt through ``generate_beams``."""
    from tiny_audio_tpu_torch import generation
    from tiny_audio_tpu_torch.models.asr import splice_audio

    cfg = model.config
    n_enc, n_dec = cfg.encoder.num_layers, cfg.decoder.num_layers
    steps = MODES_NEW - 1
    feats = pipe.processor.extract_features(audio)
    args = (feats["input_features"], feats["audio_attention_mask"])
    mel = int(feats["mel_lengths"].max())
    def run(label: str, fused: bool = True, **kwargs):
        want = {"encoder_attention": n_enc, "prefill_attention": n_dec,
                "decode_attention": 0 if fused else n_dec * steps,
                "decode_attention_update": n_dec * steps if fused else 0, **no_int8}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = model.generate(*args, mel_length=mel, max_new_tokens=MODES_NEW,
                                min_new_tokens=MODES_NEW, fused_decode=fused, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if counts != want:
            fail(f"decoding mode {label} launches {counts}, expected {want}")
        if tokens.shape != (BATCH, MODES_NEW) or tokens.min() < 0 or \
                tokens.max() >= cfg.decoder.vocab_size:
            fail(f"decoding mode {label}: tokens {tokens.shape} outside the vocabulary")
        print(f"decoding_modes mode={label} batch={BATCH} clip_s={CLIP_S} new_tokens={MODES_NEW} "
              f"kv=int8 wall_s={wall!r} launches={json.dumps({k: v for k, v in counts.items() if v})}")
        return tokens

    greedy = run("greedy")
    beams = run(f"beams{BEAMS}", num_beams=BEAMS)
    beams_module = run(f"beams{BEAMS}_module", fused=False, num_beams=BEAMS)
    if not np.array_equal(beams, beams_module):
        fail("beams: the fused and the module decode steps gave different tokens")
    # top_k = 1 keeps every logit equal to the largest (JAX's semantics), and
    # bf16 logits over 151,936 ids tie at the top now and then: each draw
    # must be a largest logit, and a row must give greedy's tokens up to its
    # first tied step (all of them without one)
    select, tied = generation._select_token, []

    def checked_select(logits, gen, generator):
        tok = select(logits, gen, generator)
        top = logits.max(dim=-1).values
        if not torch.equal(logits.gather(1, tok.long()[:, None])[:, 0], top):
            fail("sampling with top_k=1 drew a token below the largest logit")
        tied.append(((logits == top[:, None]).sum(dim=-1) > 1).cpu().numpy())
        return tok

    generation._select_token = checked_select
    try:
        top1 = run("sample_top_k1", do_sample=True, top_k=1)
    finally:
        generation._select_token = select
    tied = np.stack(tied, axis=1)  # [B, steps]
    for row in range(BATCH):
        first_tie = int(np.argmax(tied[row])) if tied[row].any() else MODES_NEW
        if not np.array_equal(top1[row, :first_tie], greedy[row, :first_tie]):
            fail(f"sampling with top_k=1 left greedy's tokens before a tie (row {row})")
    print(f"decoding_modes sample_top_k1 draws_are_largest_logit=true "
          f"steps_with_tied_top={int(tied.sum())} of {tied.size} "
          f"rows_equal_greedy={int((top1 == greedy).all(axis=1).sum())} of {BATCH}")
    sampled = [run(f"sample_top_p_seed{i}", do_sample=True, top_p=0.9, temperature=0.7,
                   generator=torch.Generator(device="cuda").manual_seed(seed))
               for i, seed in enumerate((1, 1, 2))]
    if not np.array_equal(sampled[0], sampled[1]):
        fail("two sampling runs from one generator seed gave different tokens")
    if np.array_equal(sampled[0], sampled[2]):
        fail("sampling runs from two generator seeds gave the same tokens")
    ngram = run("no_repeat_ngram3", no_repeat_ngram_size=3)
    prompt = model.build_prompt_ids(model._num_audio_tokens(mel))
    for row in ngram:
        seq = [*prompt, *row.tolist()]
        seen = {tuple(seq[i:i + 3]) for i in range(len(prompt) - 2)}
        for i in range(len(prompt) - 2, len(seq) - 2):
            gram = tuple(seq[i:i + 3])
            if gram in seen:
                fail(f"no_repeat_ngram_size=3 left a repeated 3-gram {gram}")
            seen.add(gram)

    # the score property, on the exact prompt through generate_beams
    with torch.inference_mode():
        ids = torch.tensor([prompt] * BATCH, device=model.device)
        embeds = splice_audio(model.decoder.embed(ids), ids == model.tokenizer.audio_token_id,
                              model._encode_audio(*args)[0])
    gen = dataclasses.replace(model.gen_config, max_new_tokens=MODES_NEW,
                              min_new_tokens=MODES_NEW, length_penalty=0.0)
    one, one_score = generation.generate_beams(
        model.decoder, embeds, dataclasses.replace(gen, num_beams=1), input_ids=ids)
    exact_greedy, _ = generation.generate_tokens(model.decoder, embeds, ids, gen)
    if not torch.equal(one, exact_greedy):
        fail("one beam did not give greedy's tokens")
    best, best_score = generation.generate_beams(
        model.decoder, embeds, dataclasses.replace(gen, num_beams=BEAMS), input_ids=ids)
    margin = (best_score - one_score).cpu().numpy()
    print(f"decoding_modes beam_score num_beams={BEAMS} length_penalty=0 "
          f"best_sum_logp={best_score.cpu().numpy().tolist()} "
          f"greedy_sum_logp={one_score.cpu().numpy().tolist()} "
          f"slack={BEAM_SCORE_SLACK} one_beam_is_greedy=true")
    if not (margin >= -BEAM_SCORE_SLACK).all():
        fail(f"a row's best beam scored below greedy's: {margin.tolist()}")
    print(f"decoding_modes beams_fused_vs_module_identical=true "
          f"generator_repeats=true ngram3_unrepeated=true "
          f"token_agreement_beams_vs_greedy={float((beams == greedy).mean())!r}")


def tiny_decoding_modes_phase(reset_counts, read_counts) -> None:
    """The decoding modes on the tiny fp32 towers (``tiny_test_config``,
    head_dim 16): the card's tokens equal the CPU's for beams (both steps),
    sampling with ``top_k=1`` and n-gram bans, over both cache kinds."""
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.processing import ASRProcessor

    rng = np.random.default_rng(SEED + 12)
    audio = [(rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32) for s in TINY_CLIP_S]
    modes = {"beams2": {"num_beams": 2}, "beams3_module": {"num_beams": 3, "fused_decode": False},
             "beams4_penalties": {"num_beams": 4, "no_repeat_ngram_size": 2,
                                  "repetition_penalty": 1.3, "length_penalty": 1.3},
             "sample_top_k1": {"do_sample": True, "top_k": 1},
             "ngram2": {"no_repeat_ngram_size": 2},
             "ngram3_module": {"no_repeat_ngram_size": 3, "fused_decode": False}}
    for kv in ("bfloat16", "int8"):  # "bfloat16": a cache of the model's dtype
        cfg = tiny_test_config(model_dtype="float32", kv_cache_dtype=kv)
        models = {"cuda": ASRModel(cfg, seed=SEED, device="cuda"),
                  "cpu": ASRModel(cfg, seed=SEED, device="cpu")}
        models["cpu"].load_state_dict(models["cuda"].state_dict())
        tokens, counts = {}, {}
        for where, model in models.items():
            feats = ASRProcessor(model.tokenizer, model.projector,
                                 num_mel_bins=cfg.encoder.num_mel_bins,
                                 device=model.device).extract_features(audio)
            for mode, kwargs in modes.items():
                kwargs = dict(kwargs)
                if where == "cpu":
                    kwargs.pop("fused_decode", None)  # the CPU takes its only step
                reset_counts()
                tokens[where, mode] = model.generate(
                    feats["input_features"], feats["audio_attention_mask"],
                    max_new_tokens=TINY_TOKENS, min_new_tokens=TINY_TOKENS // 2, **kwargs)
                torch.cuda.synchronize()
                counts[where, mode] = {k: v for k, v in read_counts().items() if v}
        agree = {mode: bool(np.array_equal(tokens["cuda", mode], tokens["cpu", mode]))
                 for mode in modes}
        print(f"tiny_decoding_modes dtype=float32 kv={kv} head_dim=16 tokens={TINY_TOKENS} "
              f"tokens_equal_cpu={json.dumps(agree)} "
              f"launches={json.dumps({m: counts['cuda', m] for m in modes})}")
        if not all(agree.values()):
            fail(f"tiny towers kv={kv}: decoding modes' tokens differ from the CPU's: {agree}")
        for mode in modes:
            c = counts["cuda", mode]
            step = "decode_attention" if "module" in mode else "decode_attention_update"
            if min(c.get("encoder_attention", 0), c.get("prefill_attention", 0),
                   c.get(step, 0)) == 0 or counts["cpu", mode]:
                fail(f"tiny towers kv={kv} {mode} launches: card {c}, cpu {counts['cpu', mode]}")
        del models
    torch.cuda.empty_cache()


def seeded_tower_tree(module, seed: int) -> dict:
    """A tower's flax tree from numpy draws in its shapes: kernels
    N(0, 1/fan_in), norm scales near 1, everything else near 0."""
    from tiny_audio_tpu_torch.bridge import tower_flax_tree

    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = fill(value)
                continue
            draw = rng.standard_normal(tuple(value.shape)).astype(np.float32)
            if key == "kernel":
                draw /= np.sqrt(np.prod(value.shape[:-1]))
            elif key in ("scale", "var"):
                draw = 1.0 + 0.1 * np.abs(draw)
            else:
                draw *= 0.1
            out[key] = torch.from_numpy(draw)
        return out

    return fill(tower_flax_tree(module))


def host_ms(fn, reps: int = 3) -> float:
    """Mean wall milliseconds of ``fn`` (ending in a device synchronize),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def aux_towers_phase(aligner_dir: Path) -> None:
    """The neural VAD, wav2vec2-CTC (full width, seeded weights written to
    ``aligner_dir`` as the JAX package's ``wav2vec2_aligner.msgpack``), the CTC
    trellis and the synthetic ECAPA tier on the card against the numpy
    mirror or the CPU, each timed."""
    from tiny_audio_tpu_torch import alignment, diarization, vad
    from tiny_audio_tpu_torch.bridge import load_flax_tower
    from tiny_audio_tpu_torch.models.wav2vec2 import Wav2Vec2CTC, conv_frame_count
    from tiny_audio_tpu_torch.ops.ctc import ctc_trellis
    from tiny_audio_tpu_torch.utils import msgpack_io
    from tiny_audio_tpu_torch.utils.speech_synth import synth_conversation

    long_clip, _, _ = synth_conversation(VAD_CLIP_S, n_speakers=2, seed=SEED)
    # the VAD: the card against the numpy mirror, through the same tiling
    model = vad.NeuralVAD.get("cuda")
    if model is None or model.device.type != "cuda":
        fail("the neural VAD did not load on the card")
    params = vad._np_params(model.params)
    probs = model.frame_probs(long_clip)
    mirror = vad.frame_probs_with(long_clip, lambda f: vad.np_vadnet_forward(params, f[0]))
    vad_err = float(np.abs(probs - mirror).max())
    vad_ms = host_ms(lambda: model.frame_probs(long_clip))
    print(f"aux vad clip_s={VAD_CLIP_S} frames={probs.size} max_prob_err_vs_numpy={vad_err!r} "
          f"atol={VAD_PROB_ATOL} ms={vad_ms!r} speech_share={float((probs >= 0.5).mean())!r}")
    if probs.size <= 4096 or not vad_err <= VAD_PROB_ATOL:
        fail(f"the VAD on the card is off its numpy mirror by {vad_err}")

    # wav2vec2-CTC at full width, fp32, seeded weights
    tree = seeded_tower_tree(Wav2Vec2CTC(), SEED + 21)
    msgpack_io.save(aligner_dir / "wav2vec2_aligner.msgpack", tree)
    towers = {}
    for where in ("cuda", "cpu"):
        towers[where] = Wav2Vec2CTC(device=where).eval()
        load_flax_tower(towers[where], tree)
    n5 = int(ALIGN_CLIP_S[0] * 16000)
    clip5 = torch.from_numpy(long_clip[None, :n5])
    with torch.inference_mode():
        logp = {where: m(clip5.to(where)).float().cpu() for where, m in towers.items()}
        clip30 = torch.from_numpy(long_clip[None, : int(ALIGN_CLIP_S[1] * 16000)]).cuda()
        w2v_ms = cuda_ms(lambda: towers["cuda"](clip30), 3)
    logp_err = (logp["cuda"] - logp["cpu"]).abs().max().item()
    print(f"aux wav2vec2 width=768x12 params={sum(p.numel() for p in towers['cpu'].parameters())} "
          f"fp32 clip_s={ALIGN_CLIP_S[0]} frames={conv_frame_count(n5)} "
          f"max_logp_err_vs_cpu={logp_err!r} atol={AUX_LOGP_ATOL} "
          f"ms_{int(ALIGN_CLIP_S[1])}s={w2v_ms!r}")
    if logp["cuda"].shape[1] != conv_frame_count(n5) or not logp_err <= AUX_LOGP_ATOL:
        fail(f"wav2vec2 on the card is off the CPU by {logp_err}")

    # the trellis, on the card's emission, against its CPU run
    tokens = torch.tensor(alignment.ForcedAligner.tokenize_transcript(
        "the quick brown fox jumps over the lazy dog " * 3))
    emission = logp["cuda"][0]
    with torch.inference_mode():
        t_gpu, m_gpu = ctc_trellis(emission.cuda(), tokens)
        t_cpu, m_cpu = ctc_trellis(emission, tokens)
        trellis_ms = host_ms(lambda: ctc_trellis(emission.cuda(), tokens), 2)
    finite = t_cpu > -1e29
    trellis_err = (t_gpu.cpu()[finite] - t_cpu[finite]).abs().max().item()
    moved_equal = bool(torch.equal(m_gpu.cpu(), m_cpu))
    print(f"aux ctc_trellis frames={emission.shape[0]} tokens={tokens.numel()} "
          f"max_err_vs_cpu={trellis_err!r} atol={TRELLIS_ATOL} moved_equal={str(moved_equal).lower()} "
          f"ms={trellis_ms!r}")
    if not trellis_err <= TRELLIS_ATOL or not moved_equal:
        fail(f"the CTC trellis on the card is off the CPU: {trellis_err}, moved {moved_equal}")
    del towers, logp

    # ECAPA-TDNN, the synthetic tier
    embedders = {where: diarization.EcapaEmbedder.get(where) for where in ("cuda", "cpu")}
    if embedders["cuda"].tier != "synthetic" or embedders["cuda"].device.type != "cuda":
        fail("the synthetic ECAPA tier did not load on the card")
    segments = diarization.decisions_to_segments(diarization.frame_vad(long_clip))
    windows, _ = diarization.sliding_windows(long_clip, segments)
    windows = windows[:ECAPA_WINDOWS]
    emb = {where: e.embed_windows(windows) for where, e in embedders.items()}
    ecapa_err = float(np.abs(emb["cuda"] - emb["cpu"]).max())
    feats = torch.from_numpy(diarization._speaker_fbank(windows)).cuda()
    with torch.inference_mode():
        ecapa_ms = cuda_ms(lambda: embedders["cuda"].module(feats), 5)
    print(f"aux ecapa tier=synthetic channels={list(diarization.EcapaEmbedder.SYNTH_CHANNELS)} "
          f"windows={len(windows)} max_embed_err_vs_cpu={ecapa_err!r} atol={ECAPA_ATOL} "
          f"ms_per_window_batch={ecapa_ms!r}")
    if len(windows) != ECAPA_WINDOWS or not ecapa_err <= ECAPA_ATOL:
        fail(f"ECAPA on the card is off the CPU by {ecapa_err}")


def timestamps_speakers_phase(model, pipe, aligner_dir: Path, reset_counts,
                              read_counts) -> None:
    """``pipeline(clip, return_timestamps=True, return_speakers=True)`` at the
    flagship width on a two-voice synthetic conversation, the aligner
    attached from ``aligner_dir`` through ``_attach_aux_towers``.  The byte
    tokenizer decodes ids below 256 only, so the tied head's rows past the
    bytes are zeroed (random weights otherwise give no text to align).  No
    error key, the neural VAD (no ``vad_fallback``), model-aligned words
    (only words without a CTC letter are interpolated) and speaker segments
    are required."""
    from tiny_audio_tpu_torch.alignment import ForcedAligner
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.models.wav2vec2 import CTC_LABELS
    from tiny_audio_tpu_torch.utils.speech_synth import synth_conversation

    ASRModel._attach_aux_towers(aligner_dir, model.device)
    if not ForcedAligner.has_model():
        fail("_attach_aux_towers did not attach the aligner")
    with torch.no_grad():
        model.decoder.embed_tokens.weight[256:] = 0
    clip, truth, _ = synth_conversation(CONVERSATION_S, n_speakers=2, seed=SEED + 3)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = pipe(clip, return_timestamps=True, return_speakers=True, no_repeat_ngram_size=3,
                  max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    for key in ("timestamp_error", "diarization_error"):
        if key in result:
            fail(f"the pipeline reported {key}: {result[key]}")
    words, segments = result.get("words", []), result.get("speaker_segments", [])
    letters = set(CTC_LABELS[2:])
    aligned = [w for w in words if set(w["word"].upper()) & letters]
    if not aligned or any(w.get("fallback") for w in aligned):
        fail(f"words were not aligned by the model: {words[:8]}")
    if not segments or any(s.get("vad_fallback") or s.get("fallback") for s in segments):
        fail(f"no speaker segments, or the heuristic VAD / a random embedder ran: {segments[:4]}")
    if min(counts.get("encoder_attention", 0), counts.get("prefill_attention", 0),
           counts.get("decode_attention_update", 0)) == 0:
        fail(f"the pipeline missed a kernel of its path: {counts}")
    speakers = sorted({s["speaker"] for s in segments})
    print(f"pipeline_timestamps_speakers clip_s={CONVERSATION_S} voices=2 wall_s={wall!r} "
          f"text_chars={len(result['text'])} words={len(words)} model_aligned={len(aligned)} "
          f"interpolated={len(words) - len(aligned)} segments={len(segments)} "
          f"speakers={json.dumps(speakers)} true_turns={len(truth)} "
          f"words_with_speaker={sum(w.get('speaker') is not None for w in words)} "
          f"launches={json.dumps(counts)}")


def realtime_phase(model, pipe, no_int8: dict, reset_counts, read_counts) -> dict:
    """The realtime WebSocket server (the port's own transport) over the
    flagship int8-KV pipeline, with the neural stream VAD: ``tools/
    bench_realtime``'s session runner drives ``REALTIME_SESSIONS`` concurrent
    real-time-paced sessions of ``REALTIME_SPEECH_S`` s of synthesized
    speech, once on the lock (solo) and once through ``DynamicBatcher``,
    then one session at 8 kHz with timestamps, speakers and confidence.
    Every session needs a final for each turn, no second final and no
    partial after its turn's final; the options' finals need words (aligned
    by the attached aligner), a speaker and a confidence.  The server may
    swallow no failure (``RealtimeServer.errors``), every final it decoded
    must have text (the head is zeroed past the bytes), the clients must
    receive exactly those texts, and in solo mode each must equal
    ``pipe(turn audio)`` called directly.  Then the tiny fp32 towers serve
    one session on the card and one on the CPU: the same messages.  Returns
    the launches of #1, #2 and #4 per final, per mode."""
    from tiny_audio_tpu_torch.batching import DynamicBatcher
    from tiny_audio_tpu_torch.realtime import RealtimeServer
    from tiny_audio_tpu_torch.tools import bench_realtime as bench

    class RecordingServer(RealtimeServer):
        """Keeps each final's turn audio and decoded text."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.decoded: list[tuple[np.ndarray, str]] = []

        def _transcribe(self, audio, blocking):
            text = super()._transcribe(audio, blocking)
            if blocking:
                self.decoded.append((np.array(audio, np.float32), text))
            return text

        def _transcribe_scored(self, audio):
            text, conf = super()._transcribe_scored(audio)
            self.decoded.append((np.array(audio, np.float32), text))
            return text, conf

    kernels = ("encoder_attention", "prefill_attention", "decode_attention_update")
    saved = model.gen_config
    model.gen_config = dataclasses.replace(saved, max_new_tokens=REALTIME_NEW)
    per_final = {}
    try:
        for mode in ("solo", "batched", "options"):
            batcher = (DynamicBatcher(pipe, max_batch=16, max_wait_ms=30.0)
                       if mode == "batched" else None)
            server = RecordingServer(pipe, host="127.0.0.1", port=0, partial_every_s=0.5,
                                     batcher=batcher).start()
            if server.vad_fn is not None:
                fail("the realtime server fell back to the heuristic VAD")
            reset_counts()
            t0 = time.perf_counter()
            if mode == "options":
                results = [{}]
                bench.run_session(server.port, SEED + 20, REALTIME_SPEECH_S, results[0],
                                  options=REALTIME_OPTIONS, sample_rate=REALTIME_EXTRA_RATE,
                                  speech_fraction=0.9)
            else:
                results, _ = bench.run_sessions(server.port, REALTIME_SESSIONS,
                                                REALTIME_SPEECH_S, first_seed=SEED + 7)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            server.shutdown()
            if batcher is not None:
                batcher.close()
            faults = [bench.session_faults(r.get("events", [])) for r in results]
            if any(faults):
                fail(f"realtime {mode}: {faults}")
            summary = bench.summarize(results)
            finals = [m for r in results for _, m in r["events"]
                      if m["type"] == "Turn" and m["end_of_turn"]]
            if summary["endpoint_latency_s"] is None or \
                    summary["endpoint_latency_s"]["n"] != len(results):
                fail(f"realtime {mode}: a session had no final after its last speech")
            if server.errors():
                fail(f"realtime {mode}: the server swallowed {server.errors()}")
            texts = sorted(text for _, text in server.decoded)
            if not texts or not all(texts) or \
                    texts != sorted(f["transcript"] for f in finals if f["transcript"]):
                fail(f"realtime {mode}: decoded finals {texts}, received "
                     f"{[f['transcript'] for f in finals]}")
            direct_equal = None
            if mode == "solo":
                direct = [pipe({"array": audio, "sampling_rate": 16000})["text"]
                          for audio, _ in server.decoded]
                direct_equal = direct == [text for _, text in server.decoded]
                if not direct_equal:
                    fail(f"realtime solo: finals {[t for _, t in server.decoded]} but the "
                         f"pipeline alone gives {direct}")
            if mode == "options":
                for f in finals:
                    words = f.get("words") or []
                    if not words or any(w.get("fallback") for w in words) or \
                            "speaker" not in f or not 0.0 < f.get("confidence", 0.0) <= 1.0:
                        fail(f"realtime options: a final without model-aligned words, a "
                             f"speaker or a confidence: {f}")
            if min(counts[k] for k in kernels) == 0 or any(counts[k] for k in no_int8):
                fail(f"realtime {mode}: the turns' decodes launched {counts}")
            per_final[mode] = {k: counts[k] / len(finals) for k in kernels}
            extra = (f"options={REALTIME_OPTIONS} sample_rate={REALTIME_EXTRA_RATE} "
                     if mode == "options" else "")
            print(f"realtime mode={mode} sessions={len(results)} speech_s={REALTIME_SPEECH_S} "
                  f"new_tokens={REALTIME_NEW} kv=int8 vad=neural_stream {extra}"
                  f"first_partial_s={json.dumps(summary['first_partial_s'])} "
                  f"endpoint_latency_s={json.dumps(summary['endpoint_latency_s'])} "
                  f"finals_per_session={summary['finals_per_session']} "
                  f"partials_per_session={summary['partials_per_session']} wall_s={wall!r} "
                  f"decoded_finals={len(server.decoded)} final_chars="
                  f"{[len(text) for _, text in server.decoded]} swallowed_errors=0 "
                  f"{'' if direct_equal is None else f'equal_to_direct_pipe={direct_equal} '}"
                  f"launches={json.dumps({k: v for k, v in counts.items() if v})} "
                  f"launches_per_final={json.dumps(per_final[mode])}")
            if mode == "options":
                shown = [{"speaker": f["speaker"], "confidence": f["confidence"],
                          "words": len(f["words"])} for f in finals]
                print(f"realtime options finals={json.dumps(shown)}")
    finally:
        model.gen_config = saved
    tiny_realtime_session(reset_counts, read_counts)
    return per_final


def tiny_realtime_session(reset_counts, read_counts) -> None:
    """One session on the tiny fp32 towers on the card and on the CPU (the
    same weights, the neural stream VAD, finals only): the same messages."""
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.pipeline import ASRPipeline
    from tiny_audio_tpu_torch.realtime import RealtimeServer
    from tiny_audio_tpu_torch.tools.bench_realtime import build_session_audio
    from tiny_audio_tpu_torch.utils.websocket import connect

    cfg = tiny_test_config(model_dtype="float32")
    models = {"cuda": ASRModel(cfg, seed=SEED, device="cuda"),
              "cpu": ASRModel(cfg, seed=SEED, device="cpu")}
    models["cpu"].load_state_dict(models["cuda"].state_dict())
    audio = np.concatenate([build_session_audio(SEED + 30 + i, 2.0)[0] for i in range(2)])
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    turns, counts = {}, {}
    for where, model in models.items():
        server = RealtimeServer(ASRPipeline(model), host="127.0.0.1", port=0,
                                partial_every_s=None).start()
        reset_counts()
        msgs = []
        with connect(f"ws://127.0.0.1:{server.port}/ws?sample_rate=16000") as ws:
            for i in range(0, len(pcm), 3200):
                ws.send(pcm[i:i + 3200])
            ws.send(json.dumps({"type": "Terminate"}))
            while not msgs or msgs[-1]["type"] != "Termination":
                msgs.append(json.loads(ws.recv(timeout=300)))
        torch.cuda.synchronize()
        counts[where] = {k: v for k, v in read_counts().items() if v}
        server.shutdown()
        if server.errors():
            fail(f"tiny realtime session on {where}: the server swallowed {server.errors()}")
        turns[where] = [(m["turn_order"], m["end_of_turn"], m["transcript"])
                        for m in msgs if m["type"] == "Turn"]
    finals = [t for t in turns["cuda"] if t[1]]
    print(f"realtime tiny dtype=float32 head_dim=16 audio_s={len(audio) / 16000!r} "
          f"finals={len(finals)} messages_equal_cpu={turns['cuda'] == turns['cpu']} "
          f"launches={json.dumps(counts['cuda'])}")
    if not finals or turns["cuda"] != turns["cpu"]:
        fail(f"tiny realtime session: card {turns['cuda']} vs CPU {turns['cpu']}")
    if min(counts["cuda"].get(k, 0) for k in ("encoder_attention", "prefill_attention",
                                              "decode_attention_update")) == 0 or counts["cpu"]:
        fail(f"tiny realtime session launches: card {counts['cuda']}, cpu {counts['cpu']}")
    del models
    torch.cuda.empty_cache()


def eval_phase(reset_counts, read_counts) -> dict:
    """The eval harness on the card: ``run_eval`` over the tiny fp32 towers
    (saved in the JAX layout) on ``EVAL_ROWS`` synthetic ASR rows with the
    ``local``, ``local-streaming`` and ``realtime`` backends, each WER equal
    to the CPU's; ``synthetic-diarization`` and ``synthetic-alignment``
    through ``run_eval``; then ``tools/bench_quality``'s numbers (corpus and
    per-condition DER over 10 conversations, the aligner's median error)."""
    import io

    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.eval.cli import run_eval
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.tools import bench_quality

    out: dict = {}
    with tempfile.TemporaryDirectory() as root:
        ckpt = str(Path(root) / "tiny")
        ASRModel(tiny_test_config(model_dtype="float32"), seed=SEED, device="cuda").save_pretrained(ckpt)
        for backend in ("local", "local-streaming", "realtime"):
            runs = {}
            for device in ("cuda", "cpu"):
                reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    metrics = run_eval(ckpt, "synthetic", num_samples=EVAL_ROWS, backend=backend,
                                       output_dir=str(Path(root) / device), device=device)
                torch.cuda.synchronize()
                runs[device] = (metrics, time.perf_counter() - t0,
                                {k: v for k, v in read_counts().items() if v})
            (card, card_s, launches), (cpu, _, cpu_launches) = runs["cuda"], runs["cpu"]
            print(f"eval backend={backend} dataset=synthetic rows={EVAL_ROWS} "
                  f"corpus_wer={card['corpus_wer']!r} cpu_corpus_wer={cpu['corpus_wer']!r} "
                  f"avg_sample_wer={card['avg_sample_wer']!r} wall_s={card_s!r} "
                  f"{'turns_avg=' + repr(card['turns_avg']) + ' ' if 'turns_avg' in card else ''}"
                  f"launches={json.dumps(launches)}")
            if (card["corpus_wer"], card["avg_sample_wer"], card["num_samples"]) != \
                    (cpu["corpus_wer"], cpu["avg_sample_wer"], cpu["num_samples"]):
                fail(f"eval {backend}: the card's WER {card} differs from the CPU's {cpu}")
            if not launches.get("encoder_attention") or cpu_launches:
                fail(f"eval {backend} launches: card {launches}, cpu {cpu_launches}")
            out[backend] = card["corpus_wer"]
        for name, rows in (("synthetic-diarization", EVAL_DIARIZATION_ROWS),
                           ("synthetic-alignment", EVAL_ROWS)):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                metrics = run_eval(ckpt, name, num_samples=rows, output_dir=str(Path(root) / "o"),
                                   device="cuda")
            torch.cuda.synchronize()
            print(f"eval dataset={name} rows={rows} wall_s={time.perf_counter() - t0!r} "
                  f"metrics={json.dumps(metrics)}")
            if metrics.get("num_samples") != rows or metrics.get("errors"):
                fail(f"eval {name}: {metrics}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        quality = bench_quality.main(["--device", "cuda"])
    torch.cuda.synchronize()
    diar, align = quality["diarization"], quality["alignment"]
    print(f"bench_quality wall_s={time.perf_counter() - t0!r} corpus_der={diar['corpus_der']!r} "
          f"avg_der={diar['avg_der']!r} per_condition_der={json.dumps(diar['per_condition_der'])} "
          f"ecapa_tier={diar['ecapa_tier']} vad_trained={diar['vad_trained']} "
          f"alignment={json.dumps(align)}")
    if diar["num_samples"] != 10 or diar["errors"] or not diar["vad_trained"] or \
            diar["ecapa_tier"] != "synthetic":
        fail(f"bench_quality's diarization: {diar}")
    out["bench_quality"] = quality
    return out


def decode_rows_phase(gen: torch.Generator) -> dict:
    """Kernels #3 and #4 with a ``[B]`` kv_len (the continuous engine's
    slots, each at its own length) at the flagship's shapes, B = ROW_BATCH,
    S = 608, int8 and bf16 caches, lengths spread over [0, S) with 0, 1 and
    S - 1 among them: each kernel against the per-row plain version on fp32
    copies of its inputs (KERNEL_ATOL / KERNEL_RTOL, as the scalar phase),
    #4's cache bitwise the plain version's (each row's append at its own
    length, every other row untouched), equal lengths bitwise the scalar
    launch, a CUDA graph that advances the vector bitwise equal to eager
    calls, the merge counters zero; and both kernels' times from a CUDA
    graph over DECODE_LAYERS cold layer views beside the scalar launch at
    the lengths' mean and maximum, with the bound of the rows this run's
    lengths need.  Returns {cache: times}."""
    from tiny_audio_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
        decode_attention_update,
        decode_attention_update_plain,
    )

    s, hq, hkv, d, b = DECODE_GRAPH_S, 16, 8, 128, ROW_BATCH
    results = {}
    for quantized in (True, False):
        cache = "int8" if quantized else "bf16"
        shape = (DECODE_LAYERS, b, s, hkv, d)
        if quantized:
            ck, cv = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                    dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 + 1e-3
                      for _ in range(2))
        else:
            ck, cv = (torch.empty(shape, dtype=torch.bfloat16, device="cuda")
                      .normal_(generator=gen) for _ in range(2))
            ks = vs = None
        layer = lambda x, i: None if x is None else x[i]  # noqa: E731
        q = (torch.randn((b, hq, d), generator=gen, device="cuda") * 2).to(torch.bfloat16)
        fk, fv = (torch.randn((b, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.randint(0, s, (b,), generator=gen, device="cuda", dtype=torch.int32)
        lens[:3] = torch.tensor([0, 1, s - 1], dtype=torch.int32)
        args = [q, ck[0], cv[0], fk, fv, lens, layer(ks, 0), layer(vs, 0)]
        f32 = [x if x is None or x.dtype in (torch.int8, torch.int32, torch.float32)
               else x.float() for x in args]
        got3 = decode_attention(*args)
        exact = decode_attention_plain(*f32)
        err3, ok3 = kernel_error(got3, exact)
        bufs = [x if x is None else x.clone() for x in (ck[0], cv[0], layer(ks, 0), layer(vs, 0))]
        ref = [x if x is None else x.clone() for x in bufs]
        got4 = decode_attention_update(q, bufs[0], bufs[1], fk, fv, lens, bufs[2], bufs[3])
        decode_attention_update_plain(q, ref[0], ref[1], fk, fv, lens, ref[2], ref[3])
        err4, ok4 = kernel_error(got4, exact)  # the attention reads each row's prefix
        rows_equal = all(same_bytes(x, y) for x, y in zip(bufs, ref) if x is not None)
        # one length for every row: the same bits as the scalar launch
        equal = True
        for n in (0, 1, 55, 468, s - 1):
            full = torch.full((b,), n, dtype=torch.int32, device="cuda")
            equal = equal and same_bytes(decode_attention(*args[:5], full, *args[6:]),
                                         decode_attention(*args[:5], n, *args[6:]))
            a, c = ([x if x is None else x.clone() for x in bufs] for _ in range(2))
            equal = equal and same_bytes(
                decode_attention_update(q, a[0], a[1], fk, fv, full, a[2], a[3]),
                decode_attention_update(q, c[0], c[1], fk, fv, n, c[2], c[3])) and all(
                same_bytes(x, y) for x, y in zip(a, c) if x is not None)
        # a CUDA graph advancing the per-row lengths on the device
        start = lens.clamp(max=s - 4)
        graph_bufs, eager_bufs = ([x if x is None else x.clone() for x in bufs]
                                  for _ in range(2))
        lens_t = start.clone()
        decode_attention_update(q, *[x if x is None else x.clone() for x in bufs[:2]], fk, fv,
                                lens_t, *[x if x is None else x.clone() for x in bufs[2:]])
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out4 = decode_attention_update(q, *graph_bufs[:2], fk, fv, lens_t, *graph_bufs[2:])
            out3 = decode_attention(q, *graph_bufs[:2], fk, fv, lens_t, *graph_bufs[2:])
            lens_t.add_(1)
        replay = True
        for step in range(3):
            graph.replay()
            now = start + step
            want4 = decode_attention_update(q, *eager_bufs[:2], fk, fv, now, *eager_bufs[2:])
            want3 = decode_attention(q, *eager_bufs[:2], fk, fv, now, *eager_bufs[2:])
            replay = replay and same_bytes(out4, want4) and same_bytes(out3, want3)
        replay = replay and all(same_bytes(x, y) for x, y in zip(graph_bufs, eager_bufs)
                                if x is not None)
        # times over cold layer views: per row, and the scalar launch at the
        # lengths' mean and maximum
        mean_n = float(lens.float().mean())
        scalar = {"mean": round(mean_n), "max": int(lens.max())}
        times = {}
        for label, kv in (("rows", lens), *((k, torch.tensor(n, dtype=torch.int32,
                                                              device="cuda"))
                                            for k, n in scalar.items())):
            view = lambda i, kv=kv: (q, ck[i], cv[i], fk, fv, kv, layer(ks, i), layer(vs, i))  # noqa: E731
            times[label] = {
                "decode_attention": rotation_graph_ms(lambda i: decode_attention(*view(i)),
                                                      DECODE_LAYERS),
                "decode_attention_update": rotation_graph_ms(
                    lambda i: decode_attention_update(*view(i)), DECODE_LAYERS)}
        bound3 = decode_bound(q, ck[0], mean_n, layer(ks, 0), False)
        bound4 = decode_bound(q, ck[0], mean_n, layer(ks, 0), True)
        print(f"decode rows cache={cache} B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
              f"kv_len_mean={mean_n!r} kv_len_max={scalar['max']} "
              f"decode_attention_max_abs_err={err3!r} decode_attention_update_max_abs_err={err4!r} "
              f"written_rows_equal={str(rows_equal).lower()} "
              f"equal_lengths_bitwise_scalar={str(equal).lower()} "
              f"graph_replay_bitwise={str(replay).lower()} "
              f"per_row_ms={json.dumps(times['rows'])} scalar_mean_ms={json.dumps(times['mean'])} "
              f"scalar_max_ms={json.dumps(times['max'])} bound_ms={bound3['bound_ms']!r} "
              f"update_bound_ms={bound4['bound_ms']!r} views={DECODE_LAYERS} "
              f"atol={KERNEL_ATOL} rtol={KERNEL_RTOL}")
        if not (ok3 and ok4):
            fail(f"per-row decode kernels disagree with their plain versions ({cache}): "
                 f"{err3} {err4}")
        if not (rows_equal and equal and replay):
            fail(f"per-row decode kernels ({cache}): rows {rows_equal}, equal lengths "
                 f"{equal}, graph replay {replay}")
        results[cache] = {"times": times, "bound3": bound3, "bound4": bound4,
                          "err": max(err3, err4)}
        del ck, cv, ks, vs
        torch.cuda.empty_cache()
    check_decode_counters()
    return results


@contextlib.contextmanager
def plain_decode_calls():
    """Count the decode steps that ran a plain attention on the card: calls
    of the two plain versions and module steps whose attention launched no
    kernel.  Yields a dict whose ``n`` is that count."""
    from tiny_audio_tpu_torch.models import decoder as decoder_module
    from tiny_audio_tpu_torch.ops import decode_attention as da

    count = {"n": 0}
    saved = (da.decode_attention_plain, da.decode_attention_update_plain,
             decoder_module.decode_step_attention)

    def counted(fn):
        def call(*args, **kwargs):
            count["n"] += 1
            return fn(*args, **kwargs)
        return call

    def step_attention(*args, **kwargs):
        before = da.decode_attention.launches
        out = saved[2](*args, **kwargs)
        count["n"] += da.decode_attention.launches == before
        return out

    da.decode_attention_plain, da.decode_attention_update_plain = map(counted, saved[:2])
    decoder_module.decode_step_attention = step_attention
    try:
        yield count
    finally:
        (da.decode_attention_plain, da.decode_attention_update_plain,
         decoder_module.decode_step_attention) = saved


def recording_engine():
    """A ContinuousEngine that records its prefill groups (their futures),
    its chunks' wall ms and each request's tokens (by future)."""
    from tiny_audio_tpu_torch.continuous import ContinuousEngine

    class Recording(ContinuousEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.groups, self.chunk_ms, self.tokens = [], [], {}

        def _prefill_group(self, prompt, reqs):
            super()._prefill_group(prompt, reqs)
            self.groups.append([id(r["future"]) for r in reqs])

        def _decode_one_chunk(self):
            t0 = time.perf_counter()
            super()._decode_one_chunk()
            self.chunk_ms.append((time.perf_counter() - t0) * 1e3)

        def _finish(self, slot):
            self.tokens[id(slot["future"])] = list(slot["tokens"])
            super()._finish(slot)

    return Recording


def open_loop(clips: list, submit) -> dict:
    """Submit ``clips`` ENGINE_GAP_S apart whatever the answers (open loop);
    returns the texts, each request's latency, and clips per second from
    the first submit to the last answer."""
    futs, sent, done = [], [], [0.0] * len(clips)
    t0 = time.perf_counter()
    for i, clip in enumerate(clips):
        time.sleep(max(0.0, t0 + i * ENGINE_GAP_S - time.perf_counter()))
        sent.append(time.perf_counter())
        fut = submit(clip)
        fut.add_done_callback(lambda _, i=i: done.__setitem__(i, time.perf_counter()))
        futs.append(fut)
    texts = [f.result(timeout=600) for f in futs]
    latency = np.array([d - s for d, s in zip(done, sent)])
    return {"futures": futs, "texts": texts, "p50_s": float(np.percentile(latency, 50)),
            "p99_s": float(np.percentile(latency, 99)),
            "clips_per_s": len(clips) / (max(done) - t0)}


def engine_phase(model, pipe, no_int8: dict, reset_counts, read_counts) -> dict:
    """The continuous engine at the flagship width (bf16, int8 KV, random
    weights from seed 0): ENGINE_SLOTS slots, chunks of ENGINE_CHUNK steps,
    ENGINE_NEW-token budgets, warmed on the largest mel bucket, then
    ENGINE_CLIPS clips of ENGINE_CLIP_S seconds submitted open loop
    ENGINE_GAP_S apart (slots free and refill mid-flight).  Every future
    resolves; launches #1 32 and #2 28 a prefill group, #4 28 x
    ENGINE_CHUNK a chunk, no plain decode attention; each request's tokens
    against ``generate`` on its prefill group's clips (solo, ``pipe()``'s
    call, for a clip prefilled alone; a coalesced group shares its longest
    clip's prompt), where they part the reference run's top-2 logit margin
    at that step must be under ENGINE_MARGIN_BOUND; chunk and step ms, latency p50/p99 and clips/s
    printed beside the DynamicBatcher on the same arrivals (printed, not
    claimed).  Then a short run under ``enable_wq_decode`` and one under
    ``enable_w8a8_decode`` with their exact #6 / #5 launches."""
    from tiny_audio_tpu_torch import generation
    from tiny_audio_tpu_torch.batching import DynamicBatcher

    n_enc, n_dec = model.config.encoder.num_layers, model.config.decoder.num_layers
    saved_gen = model.gen_config
    # the greedy serving default (an earlier phase leaves EOS masked)
    model.gen_config = dataclasses.replace(saved_gen, max_new_tokens=ENGINE_NEW,
                                           min_new_tokens=0)
    rng = np.random.default_rng(SEED + 17)
    clips = [(rng.standard_normal(int(rng.uniform(*ENGINE_CLIP_S) * 16000)) * 0.1)
             .astype(np.float32) for _ in range(ENGINE_CLIPS)]
    Recording = recording_engine()
    eng = Recording(pipe, n_slots=ENGINE_SLOTS, chunk_steps=ENGINE_CHUNK, start=False)
    warm_s = eng.warmup(log=lambda *_: None, buckets=(pipe.processor.mel_buckets[-1],))
    eng.groups.clear()
    eng.chunk_ms.clear()
    eng.start()
    reset_counts()
    with plain_decode_calls() as plain:
        run = open_loop(clips, eng.submit)
    counts = read_counts()
    eng.close()
    want = {"encoder_attention": n_enc * len(eng.groups),
            "prefill_attention": n_dec * len(eng.groups), "decode_attention": 0,
            "decode_attention_update": n_dec * ENGINE_CHUNK * len(eng.chunk_ms), **no_int8}
    if counts != want or plain["n"]:
        fail(f"engine launches {counts}, expected {want}; plain decode attention calls "
             f"{plain['n']}")
    if not all(isinstance(t, str) for t in run["texts"]):
        fail("an engine request resolved without text")
    batcher = DynamicBatcher(pipe, max_batch=ENGINE_SLOTS, max_wait_ms=20)
    dyn = open_loop(clips, batcher.submit)
    batcher.close()

    # each request against generate on its own prefill group's clips: a
    # coalesced group shares its longest clip's prompt (the JAX engine's
    # semantics), so a clip prefilled alone is held to solo generate, pipe()'s
    # call, and the others to their group's batch; the reference run's
    # top-2 margin is kept for every row and step
    margins: list = []
    real_pick = generation._pick

    def pick(logits, *args, **kwargs):
        top = torch.topk(logits.float(), 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).cpu())
        return real_pick(logits, *args, **kwargs)

    eos = set(model.gen_config.eos_token_ids) | {model.gen_config.pad_token_id}
    clip_of = {id(f): i for i, f in enumerate(run["futures"])}
    equal, solo_equal, solo_n, parted = 0, 0, 0, []
    generation._pick = pick
    try:
        for group in eng.groups:
            members = [clip_of[f] for f in group]
            margins.clear()
            feats = pipe.processor.extract_features([clips[i] for i in members])
            ref = model.generate(feats["input_features"], feats["audio_attention_mask"],
                                 mel_length=int(feats["mel_lengths"].max()))
            for row, (i, f) in enumerate(zip(members, group)):
                want = []
                for t in ref[row].tolist():
                    if t in eos:
                        break
                    want.append(t)
                got = eng.tokens[f]
                solo_n += len(group) == 1
                if got == want:
                    equal += 1
                    solo_equal += len(group) == 1
                    continue
                step = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                            min(len(got), len(want)))
                parted.append({"clip": i, "group": len(group), "step": step,
                               "margin": float(margins[step][row]) if step < len(margins)
                               else None})
    finally:
        generation._pick = real_pick
    worst = max((p["margin"] for p in parted if p["margin"] is not None), default=0.0)
    chunk_ms = float(np.median(eng.chunk_ms))
    print(f"engine slots={ENGINE_SLOTS} chunk_steps={ENGINE_CHUNK} clips={ENGINE_CLIPS} "
          f"clip_s={list(ENGINE_CLIP_S)} gap_s={ENGINE_GAP_S} new_tokens={ENGINE_NEW} kv=int8 "
          f"warmup_s={warm_s!r} prefill_groups={len(eng.groups)} "
          f"group_sizes={sorted(collections.Counter(map(len, eng.groups)).items())} "
          f"chunks={len(eng.chunk_ms)} chunk_ms_p50={chunk_ms!r} "
          f"step_ms_p50={chunk_ms / ENGINE_CHUNK!r} latency_p50_s={run['p50_s']!r} "
          f"latency_p99_s={run['p99_s']!r} clips_per_s={run['clips_per_s']!r} "
          f"dynamic_latency_p50_s={dyn['p50_s']!r} dynamic_latency_p99_s={dyn['p99_s']!r} "
          f"dynamic_clips_per_s={dyn['clips_per_s']!r} launches={json.dumps(counts)} "
          f"plain_decode_attention_calls=0 equal_to_own_group={equal}/{ENGINE_CLIPS} "
          f"alone_equal_to_solo={solo_equal}/{solo_n} parted={json.dumps(parted)} "
          f"margin_bound={ENGINE_MARGIN_BOUND}")
    if worst > ENGINE_MARGIN_BOUND:
        fail(f"engine tokens part from their group's generate at a top-2 margin of {worst} "
             f"(bound {ENGINE_MARGIN_BOUND}): {parted}")

    # the int8 decode modes through the engine: the layers' and the head's
    # products a step, the head once a prefill group
    for mode, kernel_name in (("enable_wq_decode", "wq_matmul"),
                              ("enable_w8a8_decode", "w8a8_matmul")):
        model.wq = None
        getattr(model, mode)()
        eng = Recording(pipe, n_slots=4, chunk_steps=ENGINE_CHUNK, start=False)
        reset_counts()
        futs = [eng.submit(clip) for clip in clips[:ENGINE_MODE_CLIPS]]
        while not all(f.done() for f in futs):
            admitted = eng._admit()
            if admitted:
                eng._prefill_and_insert(admitted)
            if eng._active():
                eng._decode_one_chunk()
        counts = read_counts()
        chunks, groups = len(eng.chunk_ms), len(eng.groups)
        want = {"encoder_attention": n_enc * groups, "prefill_attention": n_dec * groups,
                "decode_attention": 0, "decode_attention_update": n_dec * ENGINE_CHUNK * chunks,
                **no_int8, kernel_name: chunks * ENGINE_CHUNK * (7 * n_dec + 1) + groups}
        texts = [f.result() for f in futs]
        print(f"engine mode={mode} clips={ENGINE_MODE_CLIPS} slots=4 chunks={chunks} "
              f"prefill_groups={groups} chunk_ms_p50={float(np.median(eng.chunk_ms))!r} "
              f"launches={json.dumps(counts)} texts_chars={[len(t) for t in texts]}")
        if counts != want:
            fail(f"engine under {mode} launches {counts}, expected {want}")
    model.wq = None
    model.gen_config = saved_gen
    return {"chunk_ms": chunk_ms, "launches_per_chunk": n_dec * ENGINE_CHUNK}


def tiny_engine_phase(reset_counts, read_counts) -> None:
    """The tiny fp32 towers' engine on the card (the fused step: #4's fp32
    instance) and on the CPU (the module step's plain version), the same
    weights and the same arrivals, driven by hand: the same tokens for
    every request; then ``serve(engine="continuous")`` over the tiny
    checkpoint on the card answering three HTTP requests with the CPU's
    solo transcripts."""
    from tiny_audio_tpu_torch import serving
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 12
    models = {"card": ASRModel(cfg, seed=SEED, device="cuda"),
              "cpu": ASRModel(cfg, seed=SEED, device="cpu")}
    models["cpu"].load_state_dict(models["card"].state_dict())
    rng = np.random.default_rng(SEED + 23)
    clips = [(rng.standard_normal(int(rng.uniform(0.5, 5.0) * 16000)) * 0.1)
             .astype(np.float32) for _ in range(6)]
    Recording = recording_engine()
    tokens, texts, counts = {}, {}, {}
    for where, model in models.items():
        eng = Recording(ASRPipeline(model), n_slots=2, chunk_steps=3, start=False)
        reset_counts()
        futs = [eng.submit(clip) for clip in clips]
        while not all(f.done() for f in futs):
            admitted = eng._admit()
            if admitted:
                eng._prefill_and_insert(admitted)
            if eng._active():
                eng._decode_one_chunk()
        counts[where] = {k: v for k, v in read_counts().items() if v}
        tokens[where] = [eng.tokens[id(f)] for f in futs]
        texts[where] = [f.result() for f in futs]
    print(f"engine tiny dtype=float32 head_dim=16 clips={len(clips)} slots=2 chunk_steps=3 "
          f"tokens_equal_cpu={tokens['card'] == tokens['cpu']} "
          f"launches={json.dumps(counts['card'])}")
    if tokens["card"] != tokens["cpu"] or counts["cpu"] or not counts["card"].get(
            "decode_attention_update"):
        fail(f"tiny engine: card {tokens['card']} vs CPU {tokens['cpu']}, launches {counts}")

    # serve(engine="continuous") over the tiny checkpoint, on the card
    servers = []
    real_make_server = serving.make_server

    def make_server(*args, **kwargs):
        servers.append(real_make_server(*args, **kwargs))
        return servers[-1]

    with tempfile.TemporaryDirectory() as ckpt:
        models["card"].save_pretrained(ckpt)
        serving.make_server = make_server
        try:
            thread = threading.Thread(target=serving.serve, args=(ckpt,), kwargs=dict(
                host="127.0.0.1", port=0, warmup=False, engine="continuous", max_batch=4,
                device="cuda"),
                daemon=True)
            with contextlib.redirect_stdout(io.StringIO()) as log:
                thread.start()
                deadline = time.time() + 300
                while not servers and time.time() < deadline:
                    time.sleep(0.1)
                if not servers:
                    fail("serve(engine='continuous') did not start its server")
                url = f"http://127.0.0.1:{servers[0].server_address[1]}/transcribe"
                answers = []
                for clip in clips[:3]:  # one at a time: each a prefill group of its own
                    req = urllib.request.Request(url, data=clip.tobytes(), headers={
                        "Content-Type": "application/pcm-f32"})
                    with urllib.request.urlopen(req, timeout=300) as r:
                        answers.append(json.loads(r.read())["text"])
                servers[0].shutdown()
                thread.join(timeout=60)
        finally:
            serving.make_server = real_make_server
    solo = [ASRPipeline(models["cpu"]).transcribe_batch([clip])[0] for clip in clips[:3]]
    print(f"engine serve engine=continuous requests=3 answers_equal_cpu_solo={answers == solo} "
          f"log={json.dumps(log.getvalue().splitlines()[-1:])}")
    if answers != solo or thread.is_alive():
        fail(f"serve(engine='continuous') answered {answers}, the CPU {solo}")
    del models
    torch.cuda.empty_cache()


def native_checks() -> dict:
    """Each function of the native C++ runtime against the numpy code it
    stands in for, on the host (max abs errors)."""
    from tiny_audio_tpu_torch import native
    from tiny_audio_tpu_torch.train.augmentation import _mix_at_snr

    if not native.available():
        fail("native: the C++ audio runtime did not build or load")
    rng = np.random.default_rng(SEED)
    errs = {}
    audio = rng.uniform(-0.5, 0.5, 16000).astype(np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())
    decoded, rate = native.wav_decode(buf.getvalue())
    with wave.open(io.BytesIO(buf.getvalue()), "rb") as w:
        want = np.frombuffer(w.readframes(w.getnframes()), np.int16) / np.float32(32768.0)
    errs["wav_decode"] = float(np.abs(decoded - want).max()) if rate == 16000 else float("inf")
    t = np.arange(16000) / 16000
    sine = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    down = native.resample(sine, 16000, 8000)
    expected = np.sin(2 * np.pi * 440 * np.arange(len(down)) / 8000)
    errs["resample_rms"] = float(np.sqrt(np.mean((down[100:-100] - expected[100:-100]) ** 2)))
    a, k = rng.standard_normal(4000).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    errs["fft_convolve"] = float(np.abs(native.fft_convolve(a, k) - np.convolve(
        a.astype(np.float64), k.astype(np.float64))[:len(a)]).max())
    noise = rng.standard_normal(500).astype(np.float32)
    errs["mix_at_snr"] = float(np.abs(native.mix_at_snr(a, noise, 12.0)
                                      - _mix_at_snr(a, noise, 12.0)).max())
    frames = a[:15 * 256].reshape(15, 256)
    energy, flat = native.vad_features(a[:15 * 256], 256)
    power = (np.abs(np.fft.rfft(frames * np.hanning(256), axis=1)) + 1e-10) ** 2
    errs["vad_energy_db"] = float(np.abs(energy - 10 * np.log10(
        np.mean(frames ** 2, axis=1) + 1e-10)).max())
    errs["vad_flatness"] = float(np.abs(flat - np.exp(np.mean(np.log(power), axis=1))
                                        / np.mean(power, axis=1)).max())
    bounds = {"wav_decode": 1e-6, "resample_rms": 0.02, "fft_convolve": 1e-3,
              "mix_at_snr": 1e-4, "vad_energy_db": 1e-3, "vad_flatness": 1e-3}
    for name, bound in bounds.items():
        if not errs[name] <= bound:
            fail(f"native {name} is {errs[name]} off numpy (bound {bound})")
    return errs


def debug_gradient_phase(model, reset_counts, read_counts, power_line: str) -> None:
    """``debug``'s gradient flow at the flagship on its seeded weights: ok,
    #2b and #2c 28 times each, #1 forward only, no gradient into the
    encoder or the frozen decoder.  It runs before the timestamps phase
    zeroes the tied head's rows past the bytes: a token whose embedding is
    exactly zero (the prompt's first, a special) keeps a zero residual
    stream through all 28 layers, each RMSNorm's backward at a zero input
    scales its gradient by 1/sqrt(eps) = 1,000, and after ~13 layers the
    gradient overflows fp32 (the plain backward as much as the kernels; a
    masked P of 0 times an infinite dO then spreads NaN over the tile)."""
    from tiny_audio_tpu_torch.debug import check_gradient_flow

    n_enc, n_dec = model.config.encoder.num_layers, model.config.decoder.num_layers
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = check_gradient_flow(model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {**{name: 0 for name in counts}, "encoder_attention": n_enc,
            "prefill_attention": n_dec, "prefill_attention_bwd_dkv": n_dec,
            "prefill_attention_bwd_dq": n_dec}
    norms = report["module_grad_norms"]
    if not report["ok"] or counts != want or norms["encoder"] != 0.0 or \
            norms["decoder"] != 0.0 or not norms["projector"] > 0:
        fail(f"debug gradient: {report}, launches {counts} (expected {want})")
    print(f"debug_gradient ok=true module_grad_norms={json.dumps(norms)} wall_s={wall!r} "
          f"launches={json.dumps(counts)} gpu={power_line!r}")


def convert_cli_phase(model, reset_counts, read_counts, power_line: str) -> dict:
    """The flagship (seed 0, int8 KV) written out in HF layout by the port's
    own writer (the decoder under Qwen3 names, the encoder under the GLM
    ``audio_tower.`` prefix with Whisper block names, each with a
    ``config.json``; the projector and the reference ``config.json``
    through ``export_reference_artifact``, which carries ``kv_cache_dtype``
    and the decode budget as a user's config would), converted back on the
    card (every parameter bitwise the original's), saved, and transcribed
    through ``cli.main`` in process: three files on the bulk path (texts
    equal to the original model's ``transcribe_batch``; #1 32, #2 28, #4 28
    a step, no plain attention), one with ``--srt --timestamps``.  Then
    ``whisper_mode`` features (3,000 frames, the card's fp32 log-mel within
    WHISPER_MEL_ATOL of the CPU's, each clip's real length in the mask) and
    a ``generate`` on them (#1 32 times at T = 1,500); ``doctor --json``
    (sm_90, nvcc, the kernels built) and the native runtime against numpy.
    Returns the phase's numbers."""
    from tiny_audio_tpu_torch import cli, convert, export
    from tiny_audio_tpu_torch.bridge import state_dict_to_jax
    from tiny_audio_tpu_torch.ops import attention as attention_dispatch
    from tiny_audio_tpu_torch.pipeline import ASRPipeline
    from tiny_audio_tpu_torch.processing import ASRProcessor
    from tiny_audio_tpu_torch.utils import safetensors_io
    from tiny_audio_tpu_torch.utils.audio_io import write_wav

    t_phase = time.perf_counter()
    cfg = model.config
    n_enc, n_dec = cfg.encoder.num_layers, cfg.decoder.num_layers
    root = Path(tempfile.mkdtemp())
    out = {}

    # ---- the flagship in HF layout, and back ----
    t0 = time.perf_counter()
    tree = state_dict_to_jax(model)
    audio_cfg, text_cfg = export.tower_config_dicts(cfg)
    for sub, sd, tower_cfg in (
            ("encoder", export.export_encoder_state(tree["encoder"], cfg.encoder, "audio_tower."),
             {"audio_config": audio_cfg}),
            ("decoder", export.export_decoder_state(tree["decoder"], cfg.decoder), text_cfg)):
        (root / sub).mkdir()
        safetensors_io.save_file(sd, root / sub / "model.safetensors")
        (root / sub / "config.json").write_text(json.dumps(tower_cfg))
        del sd
    del tree
    export.export_reference_artifact(model, root / "reference")
    ref_json = root / "reference" / "config.json"
    ref_json.write_text(json.dumps({**json.loads(ref_json.read_text()), "kv_cache_dtype": "int8",
                                    "max_new_tokens": CONVERT_NEW,
                                    "min_new_tokens": CONVERT_NEW}))
    out["export_s"] = time.perf_counter() - t0
    out["hf_bytes"] = sum(f.stat().st_size for f in root.rglob("*.safetensors"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    converted = convert.convert_reference_checkpoint(
        root / "reference", encoder_path=root / "encoder", decoder_path=root / "decoder")
    torch.cuda.synchronize()
    out["convert_s"] = time.perf_counter() - t0
    want_cfg = dataclasses.replace(cfg, max_new_tokens=CONVERT_NEW, min_new_tokens=CONVERT_NEW)
    if converted.device.type != "cuda" or converted.config.to_dict() != want_cfg.to_dict():
        fail(f"the converted model's config on {converted.device}: "
             f"{converted.config.to_dict()} vs {want_cfg.to_dict()}")
    n_params = 0
    for (name, a), (other, b) in zip(model.named_parameters(), converted.named_parameters()):
        if name != other or a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"converted parameter {other} ({b.dtype}) is not the original {name} "
                 f"({a.dtype}) bitwise")
        n_params += a.numel()
    t0 = time.perf_counter()
    converted.save_pretrained(root / "out")
    out["save_s"] = time.perf_counter() - t0
    del converted
    for sub in ("encoder", "decoder"):
        shutil.rmtree(root / sub)
    torch.cuda.empty_cache()
    print(f"convert_cli round_trip params={n_params} bitwise=true hf_bytes={out['hf_bytes']} "
          f"export_s={out['export_s']!r} convert_s={out['convert_s']!r} "
          f"save_s={out['save_s']!r} gpu={power_line!r}")

    # ---- ta transcribe on the converted checkpoint ----
    rng = np.random.default_rng(SEED + 18)
    paths = []
    for name, seconds in zip("abc", CONVERT_CLIP_S):
        paths.append(str(root / f"{name}.wav"))
        write_wav(paths[-1], rng.standard_normal(int(seconds * 16000)).astype(np.float32) * 0.1)
    want_texts = ASRPipeline(model).transcribe_batch(paths, max_new_tokens=CONVERT_NEW,
                                                     min_new_tokens=CONVERT_NEW)
    want = {**{name: 0 for name in read_counts()}, "encoder_attention": n_enc,
            "prefill_attention": n_dec, "decode_attention_update": n_dec * (CONVERT_NEW - 1)}
    for label, argv in (("bulk", [*paths, "--json"]), ("srt", [paths[0], "--srt", "--timestamps"])):
        buf = io.StringIO()
        reset_counts()
        with plain_decode_calls() as plain, contextlib.redirect_stdout(buf):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["transcribe", "-m", str(root / "out"), *argv])
            torch.cuda.synchronize()
        out[f"{label}_s"] = time.perf_counter() - t0
        counts = read_counts()
        if rc != 0 or counts != want or plain["n"]:
            fail(f"ta transcribe ({label}) rc {rc}, launches {counts} (expected {want}), "
                 f"{plain['n']} plain decode steps")
        out[f"{label}_launches"] = counts
        if label == "bulk":
            records = [json.loads(line) for line in buf.getvalue().splitlines()]
            if [r["file"] for r in records] != paths or \
                    [r["text"] for r in records] != want_texts:
                fail(f"ta transcribe printed {records}, transcribe_batch gave {want_texts}")
        else:
            srt = buf.getvalue()
            out["srt_cues"] = srt.count(" --> ")
            if srt.strip() and not srt.startswith("1\n"):
                fail(f"ta transcribe --srt printed {srt[:200]!r}")
    print(f"convert_cli transcribe files={len(paths)} seconds={list(CONVERT_CLIP_S)} "
          f"new_tokens={CONVERT_NEW} wall_s={out['bulk_s']!r} "
          f"launches={json.dumps(out['bulk_launches'])} texts_equal_transcribe_batch=true "
          f"srt_wall_s={out['srt_s']!r} srt_cues={out['srt_cues']} "
          f"srt_launches={json.dumps(out['srt_launches'])} plain_decode_steps=0 "
          f"gpu={power_line!r}")

    # ---- whisper_mode: 3,000 frames whatever the clip ----
    clips = [rng.standard_normal(int(s * 16000)).astype(np.float32) * 0.1 for s in WHISPER_CLIP_S]
    kwargs = dict(num_mel_bins=cfg.encoder.num_mel_bins, whisper_mode=True)
    feats = ASRProcessor(model.tokenizer, model.projector, **kwargs).extract_features(clips)
    ref = ASRProcessor(model.tokenizer, **kwargs, device="cpu").extract_features(clips)
    err = float((feats["input_features"].cpu() - ref["input_features"]).abs().max())
    frames = feats["audio_attention_mask"].sum(-1).tolist()
    real = [int(np.ceil(len(c) / 160)) for c in clips]
    if tuple(feats["input_features"].shape) != (len(clips), cfg.encoder.num_mel_bins, 3000) \
            or not err <= WHISPER_MEL_ATOL or frames != real or \
            not torch.equal(feats["audio_attention_mask"].cpu(), ref["audio_attention_mask"]):
        fail(f"whisper_mode features {tuple(feats['input_features'].shape)}, error {err}, "
             f"mask frames {frames} (real {real})")
    first: dict = {}
    reset_counts()
    with record_first_call(attention_dispatch, "encoder_attention", first):
        tokens = model.generate(feats["input_features"], feats["audio_attention_mask"],
                                min_new_tokens=WHISPER_NEW, max_new_tokens=WHISPER_NEW)
    counts = read_counts()
    enc_t = int(first["encoder_attention"][0][0].shape[1])
    if counts["encoder_attention"] != n_enc or enc_t != 1500 or \
            tokens.shape != (len(clips), WHISPER_NEW):
        fail(f"whisper_mode generate: #1 {counts['encoder_attention']} launches at T = {enc_t}, "
             f"tokens {tokens.shape}")
    print(f"convert_cli whisper_mode clips_s={list(WHISPER_CLIP_S)} frames=3000 "
          f"max_abs_err_vs_cpu={err!r} tolerance={WHISPER_MEL_ATOL} mask_frames={frames} "
          f"encoder_attention_T={enc_t} launches={json.dumps(counts)}")
    del first, feats

    # ---- doctor and the native runtime ----
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["doctor", "--json", "--timeout", "120"])
    doctor_s = time.perf_counter() - t0
    report = json.loads(buf.getvalue())
    dev = report["device"]
    if rc != 0 or report["status"] != "healthy" or not dev.get("sm90") or \
            not report["nvcc"]["found"] or not report["kernels"]["loads"] or \
            not report["native_audio"]["available"]:
        fail(f"doctor (rc {rc}): {report}")
    errs = native_checks()
    shutil.rmtree(root)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"convert_cli doctor status=healthy device={dev['device_name']!r} "
          f"capability={dev['capability']} power={dev['power']!r} "
          f"nvcc={report['nvcc']['release']!r} kernels={report['kernels']['dir']!r} "
          f"wall_s={doctor_s!r}; native available=true max_abs_err_vs_numpy={json.dumps(errs)}")
    print(f"convert_cli phase_s={out['phase_s']!r} gpu={power_line!r}")
    return out


def tools_phase() -> None:
    """The offline tools on the card: ``train_vad``'s trainer at its full
    width and batch, ``train_speaker_embedder``'s at its CHANNELS and batch,
    TOOLS_STEPS steps each on TOOLS_UTTS synthesized utterances (the
    reductions of their 1,500 / 3,500 steps and 600 / 768 utterances), from
    one init, on the card and on the CPU on the same batches: finite losses
    within TOOLS_LOSS_RTOL of the CPU's; each file written to a temporary
    path and loaded back (``NeuralVAD.from_file``, ``EcapaEmbedder``) with
    the card's outputs within VAD_PROB_ATOL / ECAPA_ATOL of the CPU's; then
    ``handler_local`` on a saved tiny checkpoint with ``--timestamps
    --speakers``."""
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.diarization import EcapaEmbedder, _speaker_fbank
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.tools import handler_local
    from tiny_audio_tpu_torch.tools import train_speaker_embedder as tse
    from tiny_audio_tpu_torch.tools import train_vad as tv
    from tiny_audio_tpu_torch.utils import msgpack_io
    from tiny_audio_tpu_torch.utils.speech_synth import synth_utterance
    from tiny_audio_tpu_torch.vad import NeuralVAD

    quiet = lambda *_: None  # noqa: E731
    speakers = TOOLS_UTTS // 2
    vad_data = tv.ExampleFactory(np.random.default_rng(SEED), TOOLS_UTTS, log=quiet)
    vad_batches = [vad_data.batch(tv.BATCH) for _ in range(TOOLS_STEPS)]
    spk_data = tse.SpeakerData(np.random.default_rng(SEED), speakers, 2, log=quiet)
    spk_batches = []
    for _ in range(TOOLS_STEPS):
        audio, labels = spk_data.batch(tse.BATCH)
        spk_batches.append((_speaker_fbank(audio), labels))
    clip = synth_utterance(6.0, seed=SEED + 3)[0]
    windows = np.stack([clip[i * 16000: i * 16000 + tse.WIN_SAMPLES] for i in range(4)])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where, device in (("card", "cuda"), ("cpu", "cpu")):
            net = tv.init_vadnet(SEED).to(device)
            vad = tv.VadTrainer(net, steps=TOOLS_STEPS)
            ecapa, head = tse.init_ecapa(SEED)
            spk = tse.EmbedderTrainer(ecapa.to(device), head[:, :speakers].contiguous().to(device),
                                      steps=TOOLS_STEPS)
            rec = {"vad": [], "vad_ms": [], "ecapa": [], "ecapa_ms": []}
            for batch, name in ((vad_batches, "vad"), (spk_batches, "ecapa")):
                trainer = vad if name == "vad" else spk
                for b in batch:
                    t0 = time.perf_counter()
                    loss = trainer.step(*b)
                    rec[f"{name}_ms"].append((time.perf_counter() - t0) * 1e3)
                    rec[name].append(loss if name == "vad" else loss[0])
            from tiny_audio_tpu_torch.bridge import tower_flax_tree

            vad_path, ecapa_path = Path(tmp) / f"vad_{where}.msgpack", Path(tmp) / f"e_{where}"
            msgpack_io.save(vad_path, tower_flax_tree(net))
            msgpack_io.save(ecapa_path, tse.fp16_tree(tower_flax_tree(ecapa)))
            rec["probs"] = NeuralVAD.from_file(vad_path, "cuda").frame_probs(clip)
            rec["probs_cpu"] = NeuralVAD.from_file(vad_path, "cpu").frame_probs(clip)
            rec["emb"] = EcapaEmbedder.from_synthetic(ecapa_path, "cuda").embed_windows(windows)
            rec["emb_cpu"] = EcapaEmbedder.from_synthetic(ecapa_path, "cpu").embed_windows(
                windows)
            out[where] = rec
        ckpt = Path(tmp) / "tiny"
        ASRModel(tiny_test_config(model_dtype="float32"), seed=SEED,
                 device="cuda").save_pretrained(ckpt)
        wav = Path(tmp) / "clip.wav"
        from tiny_audio_tpu_torch.utils.audio_io import write_wav

        write_wav(wav, clip[:4 * 16000], 16000)  # inside the tiny encoder's 5.12 s window
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = handler_local.main(["-m", str(ckpt), "--wav", str(wav), "--timestamps",
                                     "--speakers", "--device", "cuda"])
        handler_s = time.perf_counter() - t0
    card, cpu = out["card"], out["cpu"]
    for name in ("vad", "ecapa"):
        rel = float(np.max(np.abs(np.subtract(card[name], cpu[name]))
                           / np.maximum(np.abs(cpu[name]), 1e-6)))
        print(f"tools {name} steps={TOOLS_STEPS} utterances={TOOLS_UTTS} "
              f"batch={tv.BATCH if name == 'vad' else tse.BATCH} "
              f"loss_first={card[name][0]!r} loss_last={card[name][-1]!r} "
              f"max_rel_diff_cpu={rel!r} rtol={TOOLS_LOSS_RTOL} "
              f"step_ms_p50={float(np.median(card[name + '_ms'][2:]))!r} "
              f"cpu_step_ms_p50={float(np.median(cpu[name + '_ms'][2:]))!r}")
        if not (np.all(np.isfinite(card[name])) and rel <= TOOLS_LOSS_RTOL):
            fail(f"tool {name}: card losses {card[name]} vs CPU {cpu[name]}")
    vad_err = float(np.abs(card["probs"] - card["probs_cpu"]).max())
    emb_err = float(np.abs(card["emb"] - card["emb_cpu"]).max())
    lines = log.getvalue().splitlines()
    print(f"tools files vad_card_vs_cpu_max_abs_err={vad_err!r} atol={VAD_PROB_ATOL} "
          f"ecapa_card_vs_cpu_max_abs_err={emb_err!r} atol={ECAPA_ATOL} "
          f"handler_local rc={rc} wall_s={handler_s!r} keys={[ln.split(':')[0] for ln in lines]}")
    if vad_err > VAD_PROB_ATOL or emb_err > ECAPA_ATOL:
        fail(f"tool files read back on the card disagree with the CPU: {vad_err} {emb_err}")
    if rc != 0 or not any(ln.startswith("text: ") for ln in lines) or not any(
            ln.startswith("speaker_segments: ") for ln in lines):
        fail(f"handler_local failed: {lines}")


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
    sm90_facts = hopper_design_facts(log)
    decode_design_facts(log)
    int8_ptxas = int8_design_facts(log)
    mel_ptxas = mel_design_facts(log)
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
    dec_rows = decode_rows_phase(gen)
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
    tiny_decoding_modes_phase(reset_counts, read_counts)
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
    rng = np.random.default_rng(SEED)
    audio = serving_audio(rng)
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

    # ---- 7b. sampling, beams and n-gram bans at the flagship ----
    decoding_modes_phase(model, pipe, audio, no_int8, reset_counts, read_counts)
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

    # ---- 9a. debug's gradient flow, on the seeded weights ----
    debug_gradient_phase(model, reset_counts, read_counts, power_line)
    phase_done()

    # ---- 9b. the VAD, the aligner and diarization; the pipeline with them ----
    aligner_dir = Path(tempfile.mkdtemp())
    aux_towers_phase(aligner_dir)
    phase_done()
    timestamps_speakers_phase(model, pipe, aligner_dir, reset_counts, read_counts)
    shutil.rmtree(aligner_dir)
    phase_done()

    # ---- 9c. the realtime server and the eval harness ----
    t0 = time.perf_counter()
    realtime_phase(model, pipe, no_int8, reset_counts, read_counts)
    phase_done()
    realtime_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = engine_phase(model, pipe, no_int8, reset_counts, read_counts)
    phase_done()
    engine_s = time.perf_counter() - t0
    convert_cli_phase(model, reset_counts, read_counts, power_line)
    phase_done()
    del model, pipe
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eval_phase(reset_counts, read_counts)
    phase_done()
    print(f"realtime_and_eval realtime_phase_s={realtime_s!r} "
          f"eval_phase_s={time.perf_counter() - t0!r}")
    t0 = time.perf_counter()
    tiny_engine_phase(reset_counts, read_counts)
    phase_done()
    tiny_engine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tools_phase()
    phase_done()
    print(f"engine_and_tools engine_phase_s={engine_s!r} tiny_engine_phase_s={tiny_engine_s!r} "
          f"tools_phase_s={time.perf_counter() - t0!r}")

    # ---- 10. training at the flagship width ----
    trained = train_phases(reset_counts, read_counts)
    phase_done()

    # ---- 10b-d. the MOSA, MoE and QFormer presets; stage 3; convergence ----
    projector_phases(audio, reset_counts, read_counts)
    phase_done()
    stage3_phase(reset_counts, read_counts)
    phase_done()
    convergence_phase(reset_counts, read_counts)
    phase_done()

    # ---- 11. kernel #7, the fused front end, through its entry point ----
    front = front_end_phase(audio, mel_ptxas, reset_counts, read_counts)
    phase_done()

    # ---- 12. kernel #8, the fused encoder FFN, through its entry points ----
    ffn = ffn_phase(layer0_mlp, reset_counts, read_counts)
    del layer0_mlp
    phase_done()

    # ---- 13. kernels #9a-#9d through the two bench entry points ----
    variants_9a = encoder_variants_phase(reset_counts, read_counts)
    phase_done()
    variants_9bcd = wq_head_variants_phase(int8_ptxas, sm90_facts, int8pack.get(BENCH_BATCH),
                                           reset_counts, read_counts)
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
         "per_row_ms": dec_rows["int8"]["times"]["rows"]["decode_attention"],
         "max_abs_err": max(dec["decode_attention"], dec_shapes["decode_attention"],
                            dec_rows["int8"]["err"], dec_rows["bf16"]["err"],
                            dec_path["max_abs_err"])},
        {"name": "decode_attention_update", "route": "cuda", "source": decode_source,
         "replaces": "tiny_audio_tpu/ops/decode_attention.py:428",
         "launches": launches["decode_attention_update"], **upd_path,
         "ms": dec_graph[("int8", BATCH, 468)]["decode_attention_update"]["ms"],
         "per_row_ms": dec_rows["int8"]["times"]["rows"]["decode_attention_update"],
         "max_abs_err": max(dec["decode_attention_update"], dec_shapes["decode_attention_update"],
                            dec_rows["int8"]["err"], dec_rows["bf16"]["err"],
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
              ("a8_matmul", int8_source, "scripts/bench_wq_head.py:142"),
              ("a8t_matmul", int8_source, "scripts/bench_wq_head.py:184"))),
    ]}))
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
