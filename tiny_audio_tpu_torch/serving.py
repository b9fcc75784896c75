"""HTTP serving: a dependency-free transcription server over the pipeline.

Port of :mod:`tiny_audio_tpu.serving`.  Stdlib ``ThreadingHTTPServer``
accepts concurrent uploads; work on the card is serialized through a lock
while wav decoding runs on request threads.

Routes:
    POST /transcribe        body: wav bytes (or raw f32 PCM with
                            ``Content-Type: application/pcm-f32``)
                            query params: timestamps=1, speakers=1,
                            confidence=1, prompt=...
    GET  /healthz           liveness + model info
    GET  /metrics           Prometheus text format: request counters,
                            transcribe latency histogram, queue depth
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from tiny_audio_tpu_torch.batching import BacklogFull, DynamicBatcher
from tiny_audio_tpu_torch.handler import EndpointHandler


class ServerMetrics:
    """Thread-safe request counters + latency histogram, rendered in the
    Prometheus text exposition format at ``GET /metrics``.  Stdlib-only
    (no prometheus_client dependency), like the rest of this server."""

    #: histogram upper bounds (seconds): a warm single call through
    #: cold-start outliers
    BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0, 600.0)

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: dict[tuple[str, int], int] = {}
        self._hist = [0] * (len(self.BUCKETS) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._started = time.monotonic()
        #: extra gauges: name -> zero-arg callable sampled at render time
        #: (e.g. the co-hosted realtime server's live session count)
        self.gauge_fns: dict[str, callable] = {}

    def observe(self, route: str, code: int, seconds: float) -> None:
        with self._lock:
            key = (route, code)
            self._requests[key] = self._requests.get(key, 0) + 1
            if route == "/transcribe":
                self._sum += seconds
                self._count += 1
                for i, ub in enumerate(self.BUCKETS):
                    if seconds <= ub:
                        self._hist[i] += 1
                        break
                else:
                    self._hist[-1] += 1

    def render(self, pending: Optional[int] = None) -> str:
        with self._lock:
            lines = [
                "# TYPE ta_requests_total counter",
                *(
                    f'ta_requests_total{{route="{r}",code="{c}"}} {n}'
                    for (r, c), n in sorted(self._requests.items())
                ),
                "# TYPE ta_transcribe_latency_seconds histogram",
            ]
            cum = 0
            for ub, n in zip(self.BUCKETS, self._hist):
                cum += n
                lines.append(
                    f'ta_transcribe_latency_seconds_bucket{{le="{ub}"}} {cum}'
                )
            lines.append(
                f'ta_transcribe_latency_seconds_bucket{{le="+Inf"}} '
                f"{cum + self._hist[-1]}"
            )
            lines.append(f"ta_transcribe_latency_seconds_sum {self._sum:.6f}")
            lines.append(f"ta_transcribe_latency_seconds_count {self._count}")
            lines.append("# TYPE ta_uptime_seconds gauge")
            lines.append(
                f"ta_uptime_seconds {time.monotonic() - self._started:.1f}"
            )
            if pending is not None:
                lines.append("# TYPE ta_pending_requests gauge")
                lines.append(f"ta_pending_requests {pending}")
            for name, fn in self.gauge_fns.items():
                try:
                    value = fn()
                except Exception:  # a gauge must never break the scrape
                    continue
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {value}")
            return "\n".join(lines) + "\n"


def make_server(
    handler, host: str = "0.0.0.0", port: int = 8000,
    batcher=None, result_timeout_s: float = 600.0,
    lock: Optional[threading.Lock] = None,
) -> ThreadingHTTPServer:
    """``handler``: an :class:`~tiny_audio_tpu_torch.handler.EndpointHandler`.

    ``batcher``: optional :class:`~tiny_audio_tpu_torch.batching.DynamicBatcher`.
    Plain short-clip transcriptions (no timestamps/speakers, <= 30 s) from
    concurrent requests then coalesce into ONE batched generate — decode
    reads every weight once per step, so the batch shares that pass;
    everything else takes the lock-serialized solo path.  Solo and batched
    work serialize on the SAME lock.

    ``lock``: share the card's serialization with a co-hosted server;
    defaults to the batcher's lock or a fresh one."""
    if lock is None:
        lock = batcher.lock if batcher is not None else threading.Lock()
    metrics = ServerMetrics()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: dict) -> None:
            self._last_code = code
            payload = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                body = {"status": "ok", "framework": "tiny_audio_tpu_torch"}
                if batcher is not None:  # load-balancer backpressure gauge
                    body["pending_requests"] = batcher.pending()
                self._send(200, body)
            elif path == "/metrics":
                pending = batcher.pending() if batcher is not None else None
                payload = metrics.render(pending).encode()
                self._last_code = 200
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            else:
                self._send(404, {"error": "not found"})
            metrics.observe(path if path in ("/healthz", "/metrics")
                            else "/other", self._last_code, 0.0)

        def do_POST(self):
            t0 = time.monotonic()
            self._last_code = 0
            try:
                self._post()
            finally:
                path = urlparse(self.path).path
                metrics.observe(
                    path if path == "/transcribe" else "/other",
                    self._last_code, time.monotonic() - t0,
                )

        def _post(self):
            url = urlparse(self.path)
            if url.path != "/transcribe":
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if ctype == "application/pcm-f32":
                inputs = np.frombuffer(raw, np.float32).copy()
            else:
                inputs = raw  # wav bytes
            q = parse_qs(url.query)
            params = {}
            if q.get("timestamps", ["0"])[0] == "1":
                params["return_timestamps"] = True
            if q.get("speakers", ["0"])[0] == "1":
                params["return_speakers"] = True
            if q.get("confidence", ["0"])[0] == "1":
                params["return_confidence"] = True
            if "prompt" in q:
                params["user_prompt"] = q["prompt"][0]

            if (
                batcher is not None
                and not params.get("return_timestamps")
                and not params.get("return_speakers")
                and not params.get("return_confidence")  # solo path (scored generate)
            ):
                try:
                    audio = batcher.pipe.extract_audio(inputs)["array"]
                except Exception:
                    audio = None  # undecodable: solo path reports the error
                limit = int(batcher.pipe.MAX_CHUNK_SECONDS * 16000)
                if audio is not None and len(audio) <= limit:
                    try:
                        # generous timeout (a cold start builds the kernels);
                        # futures.TimeoutError str()s to "", so it is named
                        text = batcher.submit(
                            audio, params.get("user_prompt")
                        ).result(timeout=result_timeout_s)
                        self._send(200, {"text": text})
                    except BacklogFull as e:
                        # overload backpressure, not a server fault
                        self._send(503, {"error": f"overloaded: {e}",
                                         "retry": True})
                    except Exception as e:
                        self._send(
                            500, {"error": f"{type(e).__name__}: {e}"}
                        )
                    return
            with lock:  # serialize work on the card
                result = handler({"inputs": inputs, "parameters": params})
            self._send(200 if "error" not in result else 500, result)

    server = ThreadingHTTPServer((host, port), Handler)
    server.metrics = metrics  # exposed for tests / embedding
    return server


def serve(model_path: str, host: str = "0.0.0.0", port: int = 8000,
          warmup: bool = True, dynamic_batching: bool = True,
          max_batch: int = 16, max_wait_ms: float = 20.0,
          engine: str = "dynamic", tp: int = 1,
          dp: Optional[int] = None,
          realtime_port: Optional[int] = None,
          wq_decode: bool = False, w8a8_head: bool = False,
          w8a8_decode: bool = False, device="cuda") -> None:
    """Serve ``model_path`` (a checkpoint of the JAX package's layout) over
    HTTP until interrupted.  The parameters are the JAX package's, in its
    order, with ``device`` last.

    ``engine``: ``"dynamic"`` (:class:`~tiny_audio_tpu_torch.batching.
    DynamicBatcher`: coalesce arrivals into batched generate calls) or
    ``"none"`` (the lock-serialized solo path only);
    ``dynamic_batching=False`` means ``"none"``.  The continuous engine
    (ROADMAP.md Queue 1 #12) and ``tp``/``dp`` meshes (Queue 1 #13) are not
    ported and raise.  ``realtime_port``: also run the realtime WebSocket
    server (:class:`~tiny_audio_tpu_torch.realtime.RealtimeServer`) on that
    port, on this server's pipeline, lock and batcher; ``/metrics`` then
    exports its live sessions as ``ta_realtime_sessions`` and the failures
    it swallowed to keep sessions alive as ``ta_realtime_errors``.
    ``wq_decode``/``w8a8_head``/``w8a8_decode`` enable the int8 decode
    modes (``EndpointHandler``).
    """
    if not dynamic_batching:  # the JAX CLI's --no-batching
        engine = "none"
    if engine == "continuous":
        raise NotImplementedError(
            "engine='continuous' is not ported to PyTorch yet (ROADMAP.md Queue 1 #12)")
    handler = EndpointHandler(model_path, tp=tp, dp=dp, wq_decode=wq_decode,
                              w8a8_head=w8a8_head, w8a8_decode=w8a8_decode,
                              device=device)
    if handler.pipe.model.wq is not None:
        wq_vars = handler.pipe.model.wq
        w8a8_layers = any(k.endswith("_t_i8") for k in wq_vars.get("layers", {}))
        modes = [m for m, on in (
            ("w8a8 layer matmuls", w8a8_layers),
            ("wq layer matmuls", "layers" in wq_vars and not w8a8_layers),
            ("w8a8 head", "head_t_i8" in wq_vars),
        ) if on]
        print(f"[serve] int8 decode enabled: {', '.join(modes)}")
    if warmup:
        print("[serve] warming up (the first run builds the kernels)...")
        total = handler.warmup(batched=engine == "dynamic")
        print(f"[serve] warmup done in {total:.1f}s")
    batcher = None
    if engine == "dynamic":
        cap = handler.pipe.BATCH_BUCKETS[-1]
        if max_batch > cap:
            # larger groups would split into cap-sized sub-batches anyway
            print(f"[serve] clamping --max-batch {max_batch} -> {cap} "
                  "(largest batch bucket)")
            max_batch = cap
        batcher = DynamicBatcher(handler.pipe, max_batch=max_batch,
                                 max_wait_ms=max_wait_ms)
    lock = batcher.lock if batcher is not None else threading.Lock()
    rt = None
    if realtime_port is not None:
        from tiny_audio_tpu_torch.realtime import RealtimeServer

        # realtime turn decodes coalesce with HTTP traffic in the batcher
        rt = RealtimeServer(handler.pipe, host=host, port=realtime_port, lock=lock,
                            batcher=batcher).start()
        print(f"[serve] realtime websocket on ws://{host}:{rt.port} "
              "(PCM16 in, Turn events out; "
              + ("turn decodes batch with HTTP traffic)"
                 if batcher is not None else "shares the device lock)"))
    server = make_server(handler, host, port, batcher=batcher, lock=lock)
    if rt is not None:
        server.metrics.gauge_fns["ta_realtime_sessions"] = rt.active_sessions
        server.metrics.gauge_fns["ta_realtime_errors"] = lambda: sum(rt.errors().values())
    mode = f" (dynamic batching <= {max_batch})" if engine == "dynamic" else ""
    print(f"[serve] listening on {host}:{port}{mode}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down...")
    finally:
        # realtime first, then the batcher (failing still-queued futures fast
        # instead of HTTP threads waiting out the result timeout), then HTTP
        if rt is not None:
            rt.shutdown()
        if batcher is not None:
            batcher.close()
        server.shutdown()
