"""Loaded serving benchmark: throughput, latency tails, mixes, streaming.

    python -m tiny_audio_tpu_torch.tools.bench_serving [--device cuda]

Port of ``scripts/bench_serving.py``.  Starts the port's HTTP server
(:func:`~tiny_audio_tpu_torch.serving.make_server` over an
:class:`~tiny_audio_tpu_torch.handler.EndpointHandler`) on the flagship-size
model (random weights from seed 0, int8 KV cache, 128 new tokens:
throughput does not depend on the weights' values) and measures:

1. batched-vs-solo loaded throughput (the dynamic batcher's justification);
2. p50/p99 request latency under three load mixes (uniform short clips,
   mixed long/short, short + timestamp requests);
3. backpressure: a small-queue batcher under burst load must answer 503
   (``BacklogFull``), not park requests for minutes;
4. the continuous engine against the dynamic batcher on the same open-loop
   Poisson arrivals;
5. streaming long-form: sustained RTF + per-chunk TTFB while chaining
   30 s windows through ``transcribe_streaming``.

``TA_BENCH_SERVING=throughput|mixes|continuous|streaming`` runs one part
(``mixes`` also runs the backpressure part); the last line is the JSON
report.  The model runs on ``--device`` (the card unless ``cpu`` is asked
for).  Request counts are keyword parameters of the part functions, with
the script's counts as defaults.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np

CLIP_S = 10.0
LONG_CLIP_S = 45.0
N_REQ = 48
CONCURRENCY = 16
MAX_NEW_TOKENS = 128


def _clip(seconds: float, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return np.clip(
        rng.standard_normal(int(seconds * 16000)) * 0.1, -1, 1
    ).astype(np.float32).tobytes()


def _post(port: int, body: bytes, query: str) -> int:
    """POST one pcm-f32 body to ``/transcribe``; returns the status code."""
    url = f"http://127.0.0.1:{port}/transcribe"
    if query:
        url += "?" + query
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/pcm-f32"}
    )
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            json.loads(r.read())
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def fire(port: int, requests: list, concurrency: int):
    """requests: [(body_bytes, query_string)] -> (wall_s, latencies, codes)."""
    sem = threading.Semaphore(concurrency)
    lats, codes = [], []
    lock = threading.Lock()

    def one(body, query):
        with sem:
            t0 = time.perf_counter()
            code = _post(port, body, query)
            lat = time.perf_counter() - t0
            with lock:
                lats.append(lat)
                codes.append(code)

    threads = [threading.Thread(target=one, args=r) for r in requests]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, lats, codes


def _percentiles(lats):
    return {
        "p50_s": round(float(np.percentile(lats, 50)), 2),
        "p99_s": round(float(np.percentile(lats, 99)), 2),
    }


def _start_server(handler, pipe, batcher):
    from tiny_audio_tpu_torch.serving import make_server

    server = make_server(handler, host="127.0.0.1", port=0, batcher=batcher)
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    return server, server.server_address[1]


def _stop_server(server) -> None:
    server.shutdown()
    server.server_close()


def bench_throughput(handler, pipe, short: bytes, n_req: int = N_REQ,
                     concurrency: int = CONCURRENCY) -> dict:
    from tiny_audio_tpu_torch.batching import DynamicBatcher

    results = {}
    arr = np.frombuffer(short, np.float32)
    for mode in ("batched", "solo"):
        batcher = (
            DynamicBatcher(pipe, max_batch=16, max_wait_ms=25)
            if mode == "batched" else None
        )
        server, port = _start_server(handler, pipe, batcher)
        # warm every shape this mode will hit, from the main thread, before
        # timing (a cold shape builds kernels and allocates)
        if batcher is not None:
            for bucket in pipe.BATCH_BUCKETS:
                print(f"[warm] batch bucket {bucket}", flush=True)
                pipe.transcribe_batch([arr] * bucket)
        else:
            pipe(arr)
        fire(port, [(short, "")] * 4, 4)
        wall, lats, codes = fire(port, [(short, "")] * n_req, concurrency)
        _stop_server(server)
        if batcher is not None:
            batcher.close()
        results[mode] = {
            "req_per_s": round(n_req / wall, 2),
            "audio_s_per_s": round(n_req * (len(arr) / 16000) / wall, 1),
            "wall_s": round(wall, 2),
            **_percentiles(lats),
            "non200": sum(1 for c in codes if c != 200),
        }
        print(mode, results[mode], flush=True)
    results["speedup_batched_vs_solo"] = round(
        results["batched"]["req_per_s"] / results["solo"]["req_per_s"], 2
    )
    return results


def request_mixes(short: bytes, long_clip: bytes, n: int = 32) -> dict:
    """The three mixes of ``n`` requests, drawn from ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    return {
        "uniform_short": [(short, "")] * n,
        "mixed_long_short": [
            (long_clip, "") if rng.random() < 0.3 else (short, "")
            for _ in range(n)
        ],
        "short_plus_timestamps": [
            (short, "timestamps=1") if rng.random() < 0.2 else (short, "")
            for _ in range(n)
        ],
    }


def bench_mixes(handler, pipe, short: bytes, long_clip: bytes, n_per_mix: int = 32,
                concurrency: int = CONCURRENCY) -> dict:
    """p50/p99 under three request mixes on the batched server."""
    from tiny_audio_tpu_torch.batching import DynamicBatcher

    batcher = DynamicBatcher(pipe, max_batch=16, max_wait_ms=25)
    server, port = _start_server(handler, pipe, batcher)
    arr = np.frombuffer(short, np.float32)
    for bucket in pipe.BATCH_BUCKETS:
        pipe.transcribe_batch([arr] * bucket)
    pipe(np.frombuffer(long_clip, np.float32))  # longform path warm
    pipe(arr)

    out = {}
    for name, reqs in request_mixes(short, long_clip, n_per_mix).items():
        fire(port, reqs[:4], 4)  # warm this mix's paths
        wall, lats, codes = fire(port, reqs, concurrency)
        out[name] = {
            "wall_s": round(wall, 2),
            "req_per_s": round(len(reqs) / wall, 2),
            **_percentiles(lats),
            "non200": sum(1 for c in codes if c != 200),
        }
        print(name, out[name], flush=True)
    _stop_server(server)
    batcher.close()
    return out


def bench_backpressure(handler, pipe, short: bytes, burst: int = 40) -> dict:
    """Burst >> queue bound: requests beyond max_queue get fast 503s."""
    from tiny_audio_tpu_torch.batching import DynamicBatcher

    batcher = DynamicBatcher(pipe, max_batch=4, max_wait_ms=10, max_queue=8)
    server, port = _start_server(handler, pipe, batcher)
    arr = np.frombuffer(short, np.float32)
    for bucket in (1, 4):
        pipe.transcribe_batch([arr] * bucket)
    wall, lats, codes = fire(port, [(short, "")] * burst, burst)
    _stop_server(server)
    batcher.close()
    n503 = sum(1 for c in codes if c == 503)
    rejected_lats = [
        lat for lat, c in zip(lats, codes) if c == 503
    ]
    out = {
        "burst": burst, "max_queue": 8, "n_503": n503,
        "n_200": sum(1 for c in codes if c == 200),
        "reject_p99_s": round(float(np.percentile(rejected_lats, 99)), 3)
        if rejected_lats else None,
    }
    print("backpressure", out, flush=True)
    return out


def _fire_open(port: int, requests: list, starts: list):
    """Open-loop load: request i fires at ``starts[i]`` seconds regardless
    of completions (the closed-loop ``fire`` hides queueing delay: an
    arrival during a running batch is exactly what this measures)."""
    lats, codes = [], []
    lock = threading.Lock()
    t_origin = time.perf_counter()

    def one(body, query, at):
        delay = t_origin + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t0 = time.perf_counter()
        code = _post(port, body, query)
        lat = time.perf_counter() - t0
        with lock:
            lats.append(lat)
            codes.append(code)

    threads = [
        threading.Thread(target=one, args=(b, q, at))
        for (b, q), at in zip(requests, starts)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t_origin, lats, codes


def bench_continuous(handler, pipe, short: bytes, n_req: int = N_REQ,
                     concurrency: int = CONCURRENCY) -> dict:
    """Continuous (slot) engine vs dynamic batcher.

    With random weights every request decodes the full token budget, so
    the engine's straggler elimination does not show here (it needs a real
    checkpoint's EOS variance); what is measurable offline is arrival
    latency: a request arriving mid-batch waits a full batch decode under
    the dynamic batcher but joins the very next chunk under the engine.
    Measured with open-loop Poisson arrivals at 0.75x the batched closed-
    loop capacity."""
    from tiny_audio_tpu_torch.batching import DynamicBatcher
    from tiny_audio_tpu_torch.continuous import ContinuousEngine
    from tiny_audio_tpu_torch.processing import bucket_frames

    arr = np.frombuffer(short, np.float32)
    # warm only the clip's bucket
    mel_bucket = bucket_frames(
        int(len(arr) / 160) + 1, pipe.processor.mel_buckets
    )

    out = {}
    # --- capacity probe on the dynamic batcher (also warms its shapes)
    batcher = DynamicBatcher(pipe, max_batch=16, max_wait_ms=25)
    server, port = _start_server(handler, pipe, batcher)
    for bucket in pipe.BATCH_BUCKETS:
        pipe.transcribe_batch([arr] * bucket)
    wall, _, _ = fire(port, [(short, "")] * n_req, concurrency)
    cap_req_s = n_req / wall
    rate = 0.75 * cap_req_s
    rng = np.random.default_rng(3)
    starts = np.cumsum(rng.exponential(1.0 / rate, n_req)).tolist()

    wall, lats, codes = _fire_open(port, [(short, "")] * n_req, starts)
    _stop_server(server)
    batcher.close()
    out["dynamic_open_loop"] = {
        "req_per_s": round(n_req / wall, 2),
        **_percentiles(lats),
        "non200": sum(1 for c in codes if c != 200),
    }
    print("dynamic_open_loop", out["dynamic_open_loop"], flush=True)

    # --- continuous engine, same arrival trace
    engine = ContinuousEngine(pipe, n_slots=16, chunk_steps=8, start=False)
    engine.warmup(buckets=(mel_bucket,))
    engine.start()
    server, port = _start_server(handler, pipe, engine)
    fire(port, [(short, "")] * 4, 4)  # settle
    wall_c, lats_c, codes_c = _fire_open(port, [(short, "")] * n_req, starts)
    # closed-loop throughput for the capacity comparison
    wall_cl, _, _ = fire(port, [(short, "")] * n_req, concurrency)
    _stop_server(server)
    engine.close()
    out["continuous_open_loop"] = {
        "req_per_s": round(n_req / wall_c, 2),
        **_percentiles(lats_c),
        "non200": sum(1 for c in codes_c if c != 200),
    }
    out["continuous_closed_loop_req_per_s"] = round(n_req / wall_cl, 2)
    out["dynamic_closed_loop_req_per_s"] = round(cap_req_s, 2)
    out["offered_rate_req_per_s"] = round(rate, 2)
    print("continuous_open_loop", out["continuous_open_loop"], flush=True)
    return out


def bench_streaming_longform(pipe, seconds: float = 120.0) -> dict:
    """Sustained RTF + per-chunk TTFB for chained 30 s-window streaming."""
    rng = np.random.default_rng(2)
    audio = np.clip(rng.standard_normal(int(seconds * 16000)) * 0.1, -1, 1
                    ).astype(np.float32)
    # warm: the first fragment, then a whole 30 s stream
    for _ in pipe.transcribe_streaming(audio[: 16000 * 30]):
        break
    list(pipe.transcribe_streaming(audio[: 16000 * 30]))

    window_s = pipe.model.mel_window_frames() / 100.0  # frames -> seconds
    t0 = time.perf_counter()
    last = t0
    gaps = []
    n_frags = 0
    ttfb_first = None
    for _ in pipe.transcribe_streaming(audio):
        now = time.perf_counter()
        if ttfb_first is None:
            ttfb_first = now - t0
        gaps.append(now - last)
        last = now
        n_frags += 1
    wall = time.perf_counter() - t0
    # per-chunk TTFB ~ the largest inter-fragment gaps (one per re-primed
    # window: encoder prefill of the next chunk)
    n_chunks = int(np.ceil(seconds / window_s))
    chunk_gaps = sorted(gaps, reverse=True)[: max(n_chunks - 1, 1)]
    out = {
        "audio_s": seconds,
        "wall_s": round(wall, 2),
        "sustained_rtf_x": round(seconds / wall, 1),
        "first_ttfb_s": round(ttfb_first or 0.0, 3),
        "per_chunk_ttfb_s": round(float(np.median(chunk_gaps)), 3),
        "fragments": n_frags,
        "n_chunks": n_chunks,
    }
    print("streaming_longform", out, flush=True)
    return out


def main(argv=None) -> None:
    from tiny_audio_tpu_torch.config import ASRConfig
    from tiny_audio_tpu_torch.device import require_device
    from tiny_audio_tpu_torch.handler import EndpointHandler
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    parser = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.tools.bench_serving")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = require_device(args.device)
    which = os.environ.get("TA_BENCH_SERVING", "all")
    cfg = ASRConfig()
    cfg.max_new_tokens = MAX_NEW_TOKENS
    cfg.kv_cache_dtype = "int8"
    model = ASRModel(cfg, seed=0, device=device)
    pipe = ASRPipeline(model)
    handler = EndpointHandler(pipeline=pipe)

    short = _clip(CLIP_S, 0)
    long_clip = _clip(LONG_CLIP_S, 1)

    report = {}
    if which in ("all", "throughput"):
        report["throughput"] = bench_throughput(handler, pipe, short)
    if which in ("all", "mixes"):
        report["mixes"] = bench_mixes(handler, pipe, short, long_clip)
        report["backpressure"] = bench_backpressure(handler, pipe, short)
    if which in ("all", "continuous"):
        report["continuous"] = bench_continuous(handler, pipe, short)
    if which in ("all", "streaming"):
        report["streaming_longform"] = bench_streaming_longform(pipe)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
