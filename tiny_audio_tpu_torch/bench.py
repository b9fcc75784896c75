"""End-to-end ASR throughput on one card.

    python -m tiny_audio_tpu_torch.bench [--device cuda]

Port of the repo-root ``bench.py``.  It measures RTFx (seconds of audio
transcribed per wall second) for the flagship ``ASRConfig()`` (a
GLM-ASR-Nano-class encoder and a Qwen3-0.6B-class decoder, bf16, random
weights from seed 0: throughput does not depend on the weights' values)
over batches of 30 s utterances through the whole path: int16 PCM to the
card, the mel front end, encoder, projector, prompt splice, prefill and the
KV-cached greedy decode of up to ``max_new_tokens = 128`` tokens (the loop
stops when every row has emitted EOS, as in the JAX package).

The environment sets the workload as it does for the JAX bench:

  TA_BENCH_KV      KV cache dtype (default ``int8``; ``bfloat16`` reverts)
  TA_BENCH_BATCH   rows a batch (default 48)
  TA_WQ_DECODE=1   weight-only int8 decode (``enable_wq_decode``, kernel #6)
  TA_W8A8_DECODE=1 W8A8 decode (``enable_w8a8_decode``, kernel #5)

The model runs on ``--device``: the card unless ``cpu`` is asked for.
Without a card it raises and prints no result.  On the card the kernel
library is built or loaded before the first clock, and an earlier line says
which and how long it took; so ``compile_s`` never holds an ``nvcc`` build.

``init_s`` is the model's construction, closed by ``torch.cuda.synchronize``.
``first_transfer_s`` is the first host-to-card copy of the int16 batch.
``compile_s`` is the first, untimed call (the port compiles nothing: it
holds the first use of cuBLAS, of the caching allocator and of the kernels).
Then ``ITERS`` laps, and ``wall_s_per_batch`` is their median.  Each lap
copies the next batch from pinned memory on a side stream while the current
one runs: only that copy runs there, because the decode kernels and the
int8 products share one merge-counter buffer per device and must stay on
one stream (``kernels.counter_buffer``).  A lap is the front end (int16 /
32768 in fp32 on the card, log-mel, frame mask) and ``ASRModel.generate``
up to its tokens as numpy.  ``p50_utterance_latency_s`` is the median of
``REPS`` batch-1 calls on row 0's first 10 s after a warm one.
``streaming_ttfb_s`` is the median of ``REPS`` times from finished mel
features to the first token of ``generation.stream_generate`` on the
unpadded prompt, after a warm call.

Baseline: the reference (torch, one A40) publishes no RTF figure; its A40
batch-1 pipeline is estimated at ~20x realtime for 30 s clips (BASELINE.md,
"Derivation of the A40 RTFx estimate"), and the target is 5x that, so
``vs_baseline = rtfx / (5 * 20)``.

An earlier line prints the launches of each serving kernel's wrapper in
the laps, the latency calls and the streaming calls.  The last line is one
JSON object: ``{"metric", "value", "unit", "vs_baseline", "extra"}``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time

import numpy as np
import torch

from tiny_audio_tpu_torch.config import ASRConfig
from tiny_audio_tpu_torch.tools import bench_stages
from tiny_audio_tpu_torch.tools.bench_stages import _sync

A40_RTFX_ESTIMATE = 20.0
TARGET_MULTIPLE = 5.0
SAMPLE_RATE = 16000
CLIP_S = 30.0
LATENCY_S = 10.0
ITERS = 5
REPS = 5

#: the serving path's kernel wrappers, by the module that holds each
PATH_KERNELS = {
    "encoder_attention": "tiny_audio_tpu_torch.ops.encoder_attention",
    "prefill_attention": "tiny_audio_tpu_torch.ops.prefill_attention",
    "decode_attention": "tiny_audio_tpu_torch.ops.decode_attention",
    "decode_attention_update": "tiny_audio_tpu_torch.ops.decode_attention",
    "w8a8_matmul": "tiny_audio_tpu_torch.ops.wq_head",
    "wq_matmul": "tiny_audio_tpu_torch.ops.wq_matmul",
}


def launches(reset: bool = False) -> dict:
    """Each serving kernel wrapper's launch count (set to 0 with ``reset``)."""
    counts = {}
    for name, module in PATH_KERNELS.items():
        fn = getattr(importlib.import_module(module), name)
        counts[name] = fn.launches
        if reset:
            fn.launches = 0
    return counts


def load_kernels() -> str:
    """Build (first use) or load the kernel library; says which, its build
    key and the seconds it took."""
    from tiny_audio_tpu_torch import kernels

    t0 = time.perf_counter()
    path, build_s, _ = kernels.build()
    kernels.library()
    return (f"kernels {'built' if build_s else 'loaded'} {path.parent.name} "
            f"in {time.perf_counter() - t0:.3f} s")


def pcm_batch(batch: int, seconds: float = CLIP_S) -> np.ndarray:
    """``batch`` rows of ``seconds`` of clipped noise as int16 PCM, from
    ``default_rng(0)``: the JAX bench's draw."""
    n_samples = int(seconds * SAMPLE_RATE)
    rng = np.random.default_rng(0)
    return (np.clip(rng.standard_normal((batch, n_samples)) * 0.1, -1, 1) * 32767).astype(np.int16)


def frame_inputs(n_rows: int, n_samples: int, device) -> tuple[torch.Tensor, int]:
    """Every row's length (all ``n_samples``) on ``device`` and the frames."""
    from tiny_audio_tpu_torch.ops import mel

    lengths = torch.full((n_rows,), n_samples, dtype=torch.int32, device=device)
    return lengths, n_samples // mel.HOP_LENGTH


@torch.inference_mode()
def frontend(model, pcm: torch.Tensor, lengths: torch.Tensor, n_frames: int):
    """int16 PCM on the model's device to log-mel features [B, mels, T] and
    the frame mask [B, T]: fp32 division by 32768, then the serving front end."""
    return bench_stages.frontend(model, pcm.to(torch.float32) / 32768.0, lengths, n_frames)


def transcribe(model, pcm: torch.Tensor, lengths: torch.Tensor, n_frames: int,
               **kwargs) -> np.ndarray:
    """One lap: the front end, then ``generate`` up to its tokens as numpy
    (``kwargs`` go to ``generate``)."""
    feats, mask = frontend(model, pcm, lengths, n_frames)
    return model.generate(feats, mask, mel_length=n_frames, **kwargs)


def stream_prompt(model, n_frames: int) -> torch.Tensor:
    """The unpadded prompt ids [1, T] for ``n_frames`` mel frames."""
    ids = model.build_prompt_ids(model._num_audio_tokens(n_frames))
    return torch.tensor([ids], dtype=torch.long, device=model.device)


@torch.inference_mode()
def first_token(model, pcm: torch.Tensor, lengths: torch.Tensor,
                n_frames: int) -> tuple[float, int | None]:
    """Seconds from finished mel features to the first streamed token (the
    splice, the prefill and the token's read), and that token."""
    from tiny_audio_tpu_torch.generation import stream_generate

    feats, mask = frontend(model, pcm, lengths, n_frames)
    input_ids = stream_prompt(model, n_frames)
    _sync(model.device)  # the front end must finish before the clock starts
    t0 = time.perf_counter()
    embeds = model._splice_embeds(feats, mask, input_ids)
    for tok in stream_generate(model.decoder, embeds, input_ids, model.gen_config):
        return time.perf_counter() - t0, tok
    return time.perf_counter() - t0, None


class Upload:
    """Copies of one int16 batch onto ``device``.  On the card the host copy
    is pinned and each copy runs on a side stream; :meth:`take` makes the
    current stream wait for it and records the tensor's use there, so the
    caching allocator does not hand its memory out while the lap reads it."""

    def __init__(self, pcm: np.ndarray, device: torch.device):
        self.device = device
        self.host = torch.from_numpy(pcm)
        self.stream = None
        if device.type == "cuda":
            self.host = self.host.pin_memory()
            self.stream = torch.cuda.Stream(device)

    def put(self) -> tuple:
        if self.stream is None:
            return self.host.clone(), None
        with torch.cuda.stream(self.stream):
            x = self.host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return x, done

    def take(self, pending: tuple) -> torch.Tensor:
        x, done = pending
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            x.record_stream(current)
        return x

    def close(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


def measure(model, batch: int, clip_s: float = CLIP_S, latency_s: float = LATENCY_S,
            iters: int = ITERS, reps: int = REPS, init_s: float = 0.0, log=None) -> dict:
    """The bench on ``model`` at ``batch`` rows of ``clip_s`` seconds; the
    latency and streaming calls on row 0's first ``latency_s`` seconds.
    Returns the JAX bench's line as a dict (``init_s``: the model's
    construction, measured by the caller).  ``log`` gets the launches line."""
    device = model.device
    pcm = pcm_batch(batch, clip_s)
    lengths, n_frames = frame_inputs(batch, pcm.shape[1], device)
    upload = Upload(pcm, device)
    counts = {}

    launches(reset=True)
    t0 = time.perf_counter()
    first = upload.take(upload.put())
    _sync(device)
    transfer_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    transcribe(model, first, lengths, n_frames)
    compile_s = time.perf_counter() - t0

    laps = []
    pending = upload.put()
    for _ in range(iters):
        current = upload.take(pending)
        pending = upload.put()  # the next batch's copy overlaps this lap
        t0 = time.perf_counter()
        transcribe(model, current, lengths, n_frames)
        laps.append(time.perf_counter() - t0)
    upload.close()
    wall = float(np.median(laps))
    rtfx = batch * clip_s / wall
    counts["laps"] = launches(reset=True)

    n_lat = int(latency_s * SAMPLE_RATE)
    lat_pcm = torch.from_numpy(pcm[:1, :n_lat].copy()).to(device)
    lat_lengths, lat_frames = frame_inputs(1, n_lat, device)
    t0 = time.perf_counter()
    transcribe(model, lat_pcm, lat_lengths, lat_frames)
    lat_compile_s = time.perf_counter() - t0
    lats = []
    for _ in range(reps):
        t0 = time.perf_counter()
        transcribe(model, lat_pcm, lat_lengths, lat_frames)
        lats.append(time.perf_counter() - t0)
    counts["latency"] = launches(reset=True)

    t0 = time.perf_counter()
    first_token(model, lat_pcm, lat_lengths, lat_frames)
    stream_compile_s = time.perf_counter() - t0
    ttfbs = [first_token(model, lat_pcm, lat_lengths, lat_frames)[0] for _ in range(reps)]
    counts["stream"] = launches(reset=True)
    if log is not None:
        log(f"launches {json.dumps(counts)}")

    cfg = model.config
    return {
        "metric": f"rtfx_e2e_{clip_s:g}s_b{batch}_decode{cfg.max_new_tokens}",
        "value": round(rtfx, 2),
        "unit": "audio_s/s/chip",
        "vs_baseline": round(rtfx / (TARGET_MULTIPLE * A40_RTFX_ESTIMATE), 3),
        "extra": {
            "batch": batch,
            "wall_s_per_batch": round(wall, 3),
            "compile_s": round(compile_s, 1),
            "init_s": round(init_s, 1),
            "first_transfer_s": round(transfer_s, 1),
            "warmup_total_s": round(compile_s + lat_compile_s + stream_compile_s, 1),
            "p50_utterance_latency_s": round(float(np.median(lats)), 3),
            "streaming_ttfb_s": round(float(np.median(ttfbs)), 3),
            "kv_cache_dtype": cfg.kv_cache_dtype,
            "wq_decode": model.wq is not None,
            "backend": device.type,
        },
    }


def main(argv=None) -> None:
    from tiny_audio_tpu_torch.device import require_device
    from tiny_audio_tpu_torch.models.asr import ASRModel

    parser = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.bench")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        print(load_kernels(), flush=True)
    cfg = ASRConfig()
    cfg.kv_cache_dtype = os.environ.get("TA_BENCH_KV", "int8")
    t0 = time.perf_counter()
    model = ASRModel(cfg, seed=0, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    if os.environ.get("TA_WQ_DECODE") == "1":
        model.enable_wq_decode()
    if os.environ.get("TA_W8A8_DECODE") == "1":
        model.enable_w8a8_decode()
    batch = int(os.environ.get("TA_BENCH_BATCH", "48"))
    result = measure(model, batch, CLIP_S, LATENCY_S, ITERS, REPS, init_s=init_s,
                     log=lambda line: print(line, flush=True))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
