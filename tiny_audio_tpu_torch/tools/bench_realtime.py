"""Benchmark the realtime WebSocket server: concurrent real-time-paced sessions.

    python -m tiny_audio_tpu_torch.tools.bench_realtime [--device cuda]

Port of ``scripts/bench_realtime.py``.  Drives N concurrent client sessions
at real-time pace (100 ms PCM16 chunks, the AAI client's cadence) through
:class:`~tiny_audio_tpu_torch.realtime.RealtimeServer`, in process, over the
port's own WebSocket client, and measures what a voice agent feels:

- ``first_partial_s``: speech onset (wall) -> first partial transcript;
- ``endpoint_latency_s``: last speech chunk sent -> the final Turn after
  it.  Its floor is the endpointer's silence window (0.64 s) plus one
  decode;
- finals delivered per session (every session must get one).

Audio is formant-synthesized speech (``utils/speech_synth.py``), so
endpointing runs the trained neural VAD.  Weights are random from seed 0
(latency does not depend on their values).  The model runs on ``--device``
(the card unless ``cpu`` is asked for).

Environment knobs, as the JAX script's: ``TA_BENCH_RT_SESSIONS`` (default
4), ``TA_BENCH_RT_SPEECH_S`` (default 4), ``TA_BENCH_RT_BATCHER=1`` (turn
decodes coalesce through the dynamic batcher), ``TA_BENCH_RT_SOAK_S=<s>``
(soak: one long-lived session cycling speech/silence turns for that long;
endpoint-latency drift first vs last quarter, process RSS and
``torch.cuda.memory_allocated`` growth), ``TA_BENCH_RT_TINY=1`` (the tiny
fp32 towers) and ``TA_BENCH_KV`` (cache dtype, default int8).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np

CHUNK_S = 0.1  # 100 ms frames, 16 kHz
SILENCE_WINDOW_S = 0.64  # the endpointer's floor inside the endpoint latency


def build_session_audio(seed: int, speech_s: float, speech_fraction: float = 0.65):
    """1 s lead-in silence + speech + 1.5 s tail silence at 16 kHz; returns
    (audio, index of the first and of the last chunk holding speech)."""
    from tiny_audio_tpu_torch.utils.speech_synth import synth_utterance

    utt, mask = synth_utterance(speech_s, 16000, seed=seed, speech_fraction=speech_fraction)
    lead = np.zeros(16000, np.float32)
    tail = np.zeros(24000, np.float32)
    audio = np.concatenate([lead, utt, tail])
    speech_idx = np.flatnonzero(mask)
    chunk = int(CHUNK_S * 16000)
    return (audio, (len(lead) + int(speech_idx[0])) // chunk,
            (len(lead) + int(speech_idx[-1])) // chunk)


def _pcm(audio: np.ndarray) -> bytes:
    return (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()


def run_session(port: int, seed: int, speech_s: float, out: dict, options: str = "",
                sample_rate: int = 16000, speech_fraction: float = 0.65,
                timeout: float = 300.0) -> None:
    """One real-time-paced session at ``sample_rate`` (the audio resampled
    by the client) with the URL's ``options`` (``&``-joined, e.g.
    ``timestamps=true``); fills ``out`` with its ``events`` ([(wall time,
    message)]), ``n_finals``, ``n_partials`` and, when measured,
    ``first_partial_s`` and ``endpoint_latency_s``."""
    from tiny_audio_tpu_torch.utils.audio_io import resample
    from tiny_audio_tpu_torch.utils.websocket import connect

    audio, first_chunk, last_chunk = build_session_audio(seed, speech_s, speech_fraction)
    pcm = _pcm(resample(audio, 16000, sample_rate))
    chunk_bytes = int(CHUNK_S * sample_rate) * 2
    events: list = []
    t_first_speech = t_last_speech = None
    query = "&".join([f"sample_rate={sample_rate}"] + ([options] if options else []))

    with connect(f"ws://127.0.0.1:{port}/?{query}") as ws:
        done = threading.Event()

        def reader():
            try:
                while True:
                    msg = json.loads(ws.recv(timeout=timeout))
                    events.append((time.time(), msg))
                    if msg["type"] == "Termination":
                        break
            except Exception:
                pass
            done.set()

        threading.Thread(target=reader, daemon=True).start()
        next_t = time.time()
        for i in range(0, len(pcm), chunk_bytes):
            ws.send(pcm[i: i + chunk_bytes])
            ci = i // chunk_bytes
            if ci == first_chunk:
                t_first_speech = time.time()
            if ci == last_chunk:
                t_last_speech = time.time()
            next_t += CHUNK_S  # real-time pacing
            delay = next_t - time.time()
            if delay > 0:
                time.sleep(delay)
        ws.send(json.dumps({"type": "Terminate"}))
        done.wait(timeout=timeout)

    partials = [(t, m) for t, m in events if m["type"] == "Turn" and not m["end_of_turn"]]
    finals = [(t, m) for t, m in events if m["type"] == "Turn" and m["end_of_turn"]]
    out["events"] = events
    out["n_finals"] = len(finals)
    out["n_partials"] = len(partials)
    if partials and t_first_speech:
        out["first_partial_s"] = partials[0][0] - t_first_speech
    if finals and t_last_speech:
        # word pauses can exceed the endpoint window and split the utterance
        # into several turns: the latency is the first final after the last
        # speech chunk
        closing = [t for t, _ in finals if t >= t_last_speech]
        if closing:
            out["endpoint_latency_s"] = closing[0] - t_last_speech


def session_faults(events: list) -> list[str]:
    """What a session's message stream breaks of the protocol: no Begin or
    Termination, no final, two finals for one turn, a partial after its
    turn's final."""
    msgs = [m for _, m in events]
    faults = []
    if not msgs or msgs[0].get("type") != "Begin":
        faults.append("no Begin first")
    if not msgs or msgs[-1].get("type") != "Termination":
        faults.append("no Termination last")
    finals: dict = {}
    for m in msgs:
        if m.get("type") != "Turn":
            continue
        order = m["turn_order"]
        if m["end_of_turn"]:
            if order in finals:
                faults.append(f"two finals for turn {order}")
            finals[order] = True
        elif order in finals:
            faults.append(f"a partial after turn {order}'s final")
    if not finals:
        faults.append("no final")
    partial_turns = {m["turn_order"] for m in msgs if m.get("type") == "Turn"}
    missing = sorted(partial_turns - set(finals))
    if missing:
        faults.append(f"turns without a final: {missing}")
    return faults


def run_sessions(port: int, n_sessions: int, speech_s: float,
                 first_seed: int = 7) -> tuple[list, float]:
    """``n_sessions`` concurrent sessions (seeds ``first_seed`` + i);
    returns their result dicts and the wall seconds."""
    results = [dict() for _ in range(n_sessions)]
    threads = [threading.Thread(target=run_session,
                                args=(port, first_seed + i, speech_s, results[i]))
               for i in range(n_sessions)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, time.time() - t0


def summarize(results: list) -> dict:
    """p50 / p95 / p99 / max of both latencies, finals and partials per
    session."""
    out: dict = {}
    for key in ("first_partial_s", "endpoint_latency_s"):
        vals = [r[key] for r in results if key in r]
        out[key] = ({"p50": float(np.median(vals)), "p95": float(np.percentile(vals, 95)),
                     "p99": float(np.percentile(vals, 99)), "max": float(np.max(vals)),
                     "n": len(vals)} if vals else None)
    out["finals_per_session"] = [r.get("n_finals", 0) for r in results]
    out["partials_per_session"] = [r.get("n_partials", 0) for r in results]
    out["all_sessions_got_finals"] = all(r.get("n_finals", 0) >= 1 for r in results)
    return out


def _rss_mb() -> float:
    """This process's resident set (the server runs in process)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def _device_mb() -> float:
    import torch

    return torch.cuda.memory_allocated() / 2**20 if torch.cuda.is_available() else 0.0


def run_soak_session(port: int, seconds: float, speech_s: float, out: dict) -> None:
    """One long-lived session: speech/silence cycles at real-time pace for
    ``seconds``; per cycle its endpoint latency, RSS and device memory, so
    drift (leaking per-session state, growing latency) shows."""
    from tiny_audio_tpu_torch.utils.websocket import connect

    chunk = int(CHUNK_S * 16000)
    events: list = []
    latencies, rss, dev = [], [], []

    with connect(f"ws://127.0.0.1:{port}/?sample_rate=16000") as ws:
        done = threading.Event()

        def reader():
            try:
                while True:
                    msg = json.loads(ws.recv(timeout=300))
                    events.append((time.time(), msg))
                    if msg["type"] == "Termination":
                        break
            except Exception:
                pass
            done.set()

        threading.Thread(target=reader, daemon=True).start()
        t_end = time.time() + seconds
        next_t = time.time()
        cycle = 0
        while time.time() < t_end:
            audio, _, last_chunk = build_session_audio(100 + cycle, speech_s)
            pcm = _pcm(audio)
            t_last_speech = None
            for i in range(0, len(pcm), chunk * 2):
                ws.send(pcm[i: i + chunk * 2])
                if i // (chunk * 2) == last_chunk:
                    t_last_speech = time.time()
                next_t += CHUNK_S
                delay = next_t - time.time()
                if delay > 0:
                    time.sleep(delay)
            # keep feeding paced silence until this cycle's final arrives
            silence = bytes(chunk * 2)
            deadline = time.time() + 60
            got = None
            while time.time() < deadline:
                got = next((t for t, m in events
                            if m["type"] == "Turn" and m["end_of_turn"]
                            and t_last_speech and t >= t_last_speech), None)
                if got is not None:
                    break
                ws.send(silence)
                next_t += CHUNK_S
                delay = next_t - time.time()
                if delay > 0:
                    time.sleep(delay)
            if got is not None and t_last_speech is not None:
                latencies.append(got - t_last_speech)
            rss.append(_rss_mb())
            dev.append(_device_mb())
            cycle += 1
        ws.send(json.dumps({"type": "Terminate"}))
        done.wait(timeout=60)

    out.update(latencies=latencies, rss_mb=rss, device_mb=dev, cycles=cycle,
               finals=sum(1 for _, m in events if m["type"] == "Turn" and m["end_of_turn"]))


def build_handler(device, tiny: bool, kv: str):
    """An ``EndpointHandler`` over random weights from seed 0: the flagship
    configuration with a ``kv`` cache, or the tiny fp32 towers."""
    from tiny_audio_tpu_torch.config import ASRConfig, tiny_test_config
    from tiny_audio_tpu_torch.handler import EndpointHandler
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    cfg = tiny_test_config(model_dtype="float32") if tiny else ASRConfig(kv_cache_dtype=kv)
    return EndpointHandler(pipeline=ASRPipeline(ASRModel(cfg, seed=0, device=device)))


def _round(d):
    return {k: (round(v, 3) if isinstance(v, float) else v) for k, v in d.items()}


def main(argv=None) -> None:
    import torch

    from tiny_audio_tpu_torch.batching import DynamicBatcher
    from tiny_audio_tpu_torch.device import require_device
    from tiny_audio_tpu_torch.realtime import RealtimeServer

    parser = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.tools.bench_realtime")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = require_device(args.device)

    n_sessions = int(os.environ.get("TA_BENCH_RT_SESSIONS", "4"))
    speech_s = float(os.environ.get("TA_BENCH_RT_SPEECH_S", "4"))
    tiny = bool(os.environ.get("TA_BENCH_RT_TINY"))
    use_batcher = bool(os.environ.get("TA_BENCH_RT_BATCHER"))
    handler = build_handler(device, tiny, os.environ.get("TA_BENCH_KV", "int8"))
    t0 = time.time()
    if tiny:
        # the tiny towers' window is smaller than the flagship's mel buckets
        handler.pipe({"array": np.zeros(16000, np.float32), "sampling_rate": 16000})
    elif use_batcher:
        # the shapes this bench dispatches: solo and the batch buckets at
        # the session's turn lengths
        for n in (1600, int((speech_s + 2.0) * 16000)):
            for rows in handler.pipe.BATCH_BUCKETS:
                handler.pipe.transcribe_batch([np.zeros(n, np.float32)] * rows)
    else:
        # turns are force-closed at 28 s: no long-form shape runs here
        handler.warmup(batched=False, longform=False, log=lambda *_: None)
    warmup_s = time.time() - t0

    batcher = (DynamicBatcher(handler.pipe, max_batch=16, max_wait_ms=30.0)
               if use_batcher else None)
    server = RealtimeServer(handler.pipe, host="127.0.0.1", port=0, partial_every_s=0.5,
                            batcher=batcher).start()
    where = {"device": str(device),
             "device_name": (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu")}
    try:
        soak_s = float(os.environ.get("TA_BENCH_RT_SOAK_S", "0"))
        if soak_s > 0:
            out: dict = {}
            rss0, dev0 = _rss_mb(), _device_mb()
            run_soak_session(server.port, soak_s, speech_s, out)
            lat, rss, dev = out["latencies"], out["rss_mb"], out["device_mb"]
            q = max(len(lat) // 4, 1)
            print(json.dumps({
                "metric": "realtime_ws_soak_endpoint_latency_p50",
                "value": float(np.median(lat)) if lat else None, "unit": "s",
                "extra": {
                    "soak_s": soak_s, "cycles": out["cycles"], "finals": out["finals"],
                    "latency_first_quarter_p50_s": float(np.median(lat[:q])) if lat else None,
                    "latency_last_quarter_p50_s": float(np.median(lat[-q:])) if lat else None,
                    "latency_max_s": float(np.max(lat)) if lat else None,
                    "rss_start_mb": rss0, "rss_last_cycle_mb": rss[-1] if rss else None,
                    "rss_max_mb": float(np.max(rss)) if rss else None,
                    "device_mb_start": dev0, "device_mb_last_cycle": dev[-1] if dev else None,
                    "device_mb_max": float(np.max(dev)) if dev else None,
                    "warmup_s": warmup_s, **where,
                },
            }), flush=True)
            return

        results, wall = run_sessions(server.port, n_sessions, speech_s)
        summary = summarize(results)
        ep = summary["endpoint_latency_s"]
        fp = summary["first_partial_s"]
        print(json.dumps({
            "metric": "realtime_ws_endpoint_latency_p50",
            "value": ep["p50"] if ep else None, "unit": "s",
            "extra": {
                "sessions": n_sessions, "speech_s_per_session": speech_s,
                "all_sessions_got_finals": summary["all_sessions_got_finals"],
                "endpoint_latency_s": _round(ep) if ep else None,
                "first_partial_s": _round(fp) if fp else None,
                "finals_per_session": summary["finals_per_session"],
                "partials_per_session": summary["partials_per_session"],
                "faults": [session_faults(r.get("events", [])) for r in results],
                "silence_window_s": SILENCE_WINDOW_S, "wall_s": wall,
                "warmup_s": warmup_s, "batched_decodes": use_batcher, **where,
            },
        }), flush=True)
    finally:
        server.shutdown()
        if batcher is not None:
            batcher.close()


if __name__ == "__main__":
    main()
