"""The port's realtime server against the JAX package's, on the CPU.

The endpointer's events equal JAX's over four chunkings in batch mode (an
amplitude oracle) and in stream mode (the oracle streamed, and each
package's neural ``StreamingVad`` on synthesized speech); the live speaker
tracker gives JAX's labels on the same embeddings.  Whole sessions go to
JAX's server and to the port's over the same tiny fp32 weights (carried by
``bridge.load_jax_params``) and the same amplitude VAD: every message equal
(transcripts exactly, word times within 1 ms, speaker labels, confidence
within 1e-5, ``audio_duration_seconds``), also with 8 kHz input, garbage
messages and an invalid rate.  The batcher path, co-hosting with
``serve(realtime_port=...)`` and its gauge, and the two faults of the JAX
server the port does not have: a client that stops reading does not delay
another session's final, and a partial never follows its turn's final
(every send runs on the session's sender thread).
"""

import json
import re
import threading
import time
import urllib.request
from concurrent.futures import Future
from contextlib import contextmanager
from unittest.mock import MagicMock

import numpy as np
import pytest
import jax
import torch

from tiny_audio_tpu import alignment as jax_alignment
from tiny_audio_tpu import diarization as jax_diarization
from tiny_audio_tpu import realtime as jax_realtime
from tiny_audio_tpu import vad as jax_vad
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.pipeline import ASRPipeline as JaxASRPipeline
from tiny_audio_tpu_torch import alignment, diarization, realtime, serving, vad
from tiny_audio_tpu_torch.batching import BacklogFull, DynamicBatcher
from tiny_audio_tpu_torch.bridge import load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.pipeline import ASRPipeline
from tiny_audio_tpu_torch.realtime import (
    EndpointerConfig,
    OnlineSpeakerTracker,
    RealtimeServer,
    TurnEndpointer,
)
from tiny_audio_tpu_torch.utils.speech_synth import synth_utterance
from tiny_audio_tpu_torch.utils.websocket import connect

torch.set_num_threads(1)

HOP, SR = vad.HOP, vad.SAMPLE_RATE
CONFIDENCE_ATOL = 1e-5
WORD_MS_ATOL = 1


def amp_vad(audio: np.ndarray, level: float = 0.05) -> np.ndarray:
    n = len(audio) // HOP
    return np.abs(audio[: n * HOP]).reshape(n, HOP).mean(axis=1) > level


def synth_vad(audio):
    """The amplitude oracle at a bar that peak-normalized synthetic speech
    clears."""
    return amp_vad(audio, 0.02)


def tone(seconds: float, amp: float = 0.3, hz: float = 220.0) -> np.ndarray:
    t = np.arange(int(seconds * SR)) / SR
    return (amp * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def silence(seconds: float) -> np.ndarray:
    return np.zeros(int(seconds * SR), np.float32)


def pcm(audio: np.ndarray) -> bytes:
    return (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()


CFG = dict(update_samples=1)  # rescan on every feed


class StreamAmpOracle:
    """A ``StreamingVad``-shaped amplitude oracle: scores each HOP block once."""

    def __init__(self):
        self._pending = np.zeros(0, np.float32)

    def feed(self, samples):
        self._pending = np.concatenate([self._pending, np.asarray(samples, np.float32).ravel()])
        k = self._pending.size // HOP
        if k == 0:
            return np.zeros(0, bool)
        dec = amp_vad(self._pending[: k * HOP])
        self._pending = self._pending[k * HOP:]
        return dec

    def reset(self, keep_level: bool = True):
        self._pending = np.zeros(0, np.float32)


# ------------------------------------------------------------------ endpointer


def _events(ep, chunks):
    events = []
    for c in chunks:
        events += ep.feed(c)
    return events + ep.flush()


def _assert_same_events(got, want):
    assert [e[0] for e in got] == [e[0] for e in want]
    for g, w in zip(got, want):
        if g[0] == "final":
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2] == w[2]


SESSION = np.concatenate([silence(0.4), tone(0.9), silence(1.2), tone(0.6, amp=0.2),
                          silence(0.9), tone(1.3), silence(0.8), tone(1.6)])


@pytest.mark.parametrize("chunk_s", [0.05, 0.1, 0.256, 1.0])
@pytest.mark.parametrize("mode", ["batch", "stream"])
def test_endpointer_events_match_jax(chunk_s, mode):
    step = int(chunk_s * SR)
    chunks = [SESSION[i: i + step] for i in range(0, len(SESSION), step)]
    for cfg in ({}, {"update_samples": 1}, {"max_turn_s": 1.0, "update_samples": 1}):
        if mode == "batch":
            got = _events(TurnEndpointer(amp_vad, EndpointerConfig(**cfg)), chunks)
            want = _events(jax_realtime.TurnEndpointer(amp_vad, jax_realtime.EndpointerConfig(**cfg)),
                           chunks)
        else:
            got = _events(TurnEndpointer(None, EndpointerConfig(**cfg),
                                         vad_stream=StreamAmpOracle()), chunks)
            want = _events(jax_realtime.TurnEndpointer(None, jax_realtime.EndpointerConfig(**cfg),
                                                       vad_stream=StreamAmpOracle()), chunks)
        assert sum(e[0] == "final" for e in got) >= 3
        _assert_same_events(got, want)


@pytest.mark.parametrize("chunk_s", [0.05, 0.1, 0.256, 1.0])
def test_neural_stream_endpointer_matches_jax(chunk_s):
    utt1, _ = synth_utterance(1.5, seed=21)
    utt2, _ = synth_utterance(1.2, seed=22)
    session = np.concatenate([silence(0.5), utt1, silence(1.2), utt2, silence(1.0)])
    step = int(chunk_s * SR)
    chunks = [session[i: i + step] for i in range(0, len(session), step)]
    got = _events(TurnEndpointer(None, vad_stream=vad.StreamingVad.make()), chunks)
    want = _events(jax_realtime.TurnEndpointer(None, vad_stream=jax_vad.StreamingVad.make()),
                   chunks)
    assert sum(e[0] == "final" for e in got) == 2
    _assert_same_events(got, want)


def test_endpointer_requires_exactly_one_source():
    with pytest.raises(ValueError):
        TurnEndpointer(amp_vad, vad_stream=StreamAmpOracle())
    with pytest.raises(ValueError):
        TurnEndpointer(None)


@pytest.mark.parametrize("kwargs", [{}, {"threshold": 0.8}, {"max_speakers": 2}])
def test_speaker_tracker_matches_jax(kwargs):
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((4, 16)).astype(np.float32)
    embs = [centers[i % 4] + 0.4 * rng.standard_normal(16).astype(np.float32)
            for i in rng.permutation(40)]
    got, want = OnlineSpeakerTracker(**kwargs), jax_realtime.OnlineSpeakerTracker(**kwargs)
    labels = [got.assign(e) for e in embs]
    assert labels == [want.assign(e) for e in embs]
    assert len(set(labels)) > 1


def test_server_defaults_to_the_neural_stream_vad():
    srv = RealtimeServer(pipe=None)  # the constructor binds no socket
    assert srv.vad_fn is None and srv._make_endpointer().vad_stream is not None


# ---------------------------------------------------------- sessions vs JAX


@pytest.fixture(scope="module")
def pipes():
    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 12
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return JaxASRPipeline(jm), ASRPipeline(tm)


@pytest.fixture()
def no_aligner_synthetic_ecapa(monkeypatch):
    """Both packages without aligner weights (uniform word spread) and with
    the checked-in synthetic ECAPA tier."""
    monkeypatch.setattr(jax_alignment.ForcedAligner, "_params", None)
    monkeypatch.setattr(alignment.ForcedAligner, "_tree", None)
    monkeypatch.setattr(jax_diarization.EcapaEmbedder, "_instance",
                        jax_diarization.EcapaEmbedder.from_synthetic())
    monkeypatch.setattr(diarization.EcapaEmbedder, "_instances", {})


@contextmanager
def servers(pipes, vad_fn=amp_vad, **kwargs):
    """JAX's server and the port's over the same weights."""
    kwargs = {"partial_every_s": 1e9, **kwargs}
    jax_srv = jax_realtime.RealtimeServer(
        pipes[0], host="127.0.0.1", port=0, vad_fn=vad_fn,
        endpointer_config=jax_realtime.EndpointerConfig(**CFG), **kwargs).start()
    port_srv = RealtimeServer(pipes[1], host="127.0.0.1", port=0, vad_fn=vad_fn,
                              endpointer_config=EndpointerConfig(**CFG), **kwargs).start()
    try:
        yield jax_srv, port_srv
    finally:
        jax_srv.shutdown()
        port_srv.shutdown()


def session(port: int, chunks=(), query: str = "sample_rate=16000", before=(), commands=(),
            gap_s: float = 0.0):
    """Send ``before`` (raw messages), the PCM16 ``chunks`` (``gap_s``
    apart), ``commands`` (JSON), Terminate; return every server message."""
    msgs = []
    with connect(f"ws://127.0.0.1:{port}/ws?{query}") as ws:
        for m in before:
            ws.send(m)
        for c in chunks:
            ws.send(c if isinstance(c, bytes) else pcm(c))
            time.sleep(gap_s)
        for m in commands:
            ws.send(json.dumps(m))
        ws.send(json.dumps({"type": "Terminate"}))
        while True:
            msgs.append(json.loads(ws.recv(timeout=120)))
            if msgs[-1]["type"] == "Termination":
                break
    return msgs


def assert_same_session(got, want):
    assert [m["type"] for m in got] == [m["type"] for m in want]
    assert got[0]["type"] == "Begin" and got[-1]["type"] == "Termination"
    for g, w in zip(got[1:-1], want[1:-1]):
        for key in ("turn_order", "transcript", "end_of_turn", "turn_is_formatted", "speaker"):
            assert g.get(key) == w.get(key), (key, g, w)
        assert ("confidence" in g) == ("confidence" in w)
        if "confidence" in g:
            assert abs(g["confidence"] - w["confidence"]) <= CONFIDENCE_ATOL
        assert len(g.get("words", [])) == len(w.get("words", []))
        for gw, ww in zip(g.get("words", []), w.get("words", [])):
            assert gw["text"] == ww["text"] and gw.get("fallback") == ww.get("fallback")
            assert abs(gw["start"] - ww["start"]) <= WORD_MS_ATOL
            assert abs(gw["end"] - ww["end"]) <= WORD_MS_ATOL
    assert got[-1]["audio_duration_seconds"] == want[-1]["audio_duration_seconds"]


def test_full_protocol_matches_jax(pipes, no_aligner_synthetic_ecapa):
    voices = [dict(f0=120.0, vocal_tract_scale=1.0), dict(f0=210.0, vocal_tract_scale=1.18)]
    chunks = [silence(0.5)]
    for i, voice in enumerate((voices[0], voices[1], voices[0])):
        utt, _ = synth_utterance(2.0, 16000, seed=i, level=0.3, speech_fraction=0.85, **voice)
        chunks += [utt, silence(1.0)]
    query = "sample_rate=16000&timestamps=true&speakers=true&confidence=true"
    with servers(pipes, vad_fn=synth_vad) as (jax_srv, port_srv):
        want = session(jax_srv.port, chunks, query)
        got = session(port_srv.port, chunks, query)
    assert_same_session(got, want)
    finals = [m for m in got if m["type"] == "Turn" and m["end_of_turn"]]
    assert [f["turn_order"] for f in finals] == [0, 1, 2]
    assert [f["speaker"] for f in finals] == ["SPEAKER_00", "SPEAKER_01", "SPEAKER_00"]
    assert all(0.0 < f["confidence"] <= 1.0 for f in finals)
    words = [w for f in finals for w in f.get("words", [])]
    assert words and all(isinstance(w["start"], int) and w["start"] <= w["end"] for w in words)


def test_plain_session_force_endpoint_and_8k_match_jax(pipes):
    t = np.arange(int(0.8 * 8000)) / 8000
    speech8k = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    cases = [
        ([silence(0.3), tone(1.2), silence(1.0), tone(0.8, hz=330), silence(1.0)],
         "sample_rate=16000", ()),
        ([tone(0.8)], "sample_rate=16000", ({"type": "ForceEndpoint"},)),
        ([tone(0.8)], "sample_rate=16000", ()),  # Terminate flushes the open turn
        ([pcm(speech8k), np.zeros(8000, "<i2").tobytes()], "sample_rate=8000", ()),
    ]
    with servers(pipes) as (jax_srv, port_srv):
        for chunks, query, commands in cases:
            got = session(port_srv.port, chunks, query, commands=commands)
            assert_same_session(got, session(jax_srv.port, chunks, query, commands=commands))
            assert sum(m["type"] == "Turn" and m["end_of_turn"] for m in got) >= 1


@pytest.mark.parametrize("query,before,seconds", [
    ("sample_rate=16000", ("not json at all", json.dumps([1, 2, 3]),
                           json.dumps({"no_type": True}), b"\x01"), 1.8),
    ("sample_rate=0", (), 1.8),
])
def test_garbage_messages_and_invalid_rate_match_jax(pipes, query, before, seconds):
    chunks = [tone(0.8), silence(1.0)]
    with servers(pipes) as (jax_srv, port_srv):
        got = session(port_srv.port, chunks, query, before=before)
        assert_same_session(got, session(jax_srv.port, chunks, query, before=before))
    assert sum(m["type"] == "Turn" and m["end_of_turn"] for m in got) == 1
    assert got[-1]["audio_duration_seconds"] == pytest.approx(seconds, abs=0.01)


def test_aai_streaming_client_matches_jax(pipes, monkeypatch):
    """The AssemblyAI-v3 streaming evaluator, each package's against its own
    server (the port's over the port's transport, JAX's over
    websocket-client), gives the same transcript."""
    pytest.importorskip("websocket")
    from tiny_audio_tpu.eval.evaluators.asr import (
        AssemblyAIStreamingEvaluator as JaxStreamingEvaluator,
    )
    from tiny_audio_tpu_torch.eval.evaluators.asr import AssemblyAIStreamingEvaluator

    monkeypatch.setenv("ASSEMBLYAI_API_KEY", "local-test")
    audio = {"array": np.concatenate([tone(1.0), silence(1.0), tone(0.6, hz=330)]),
             "sampling_rate": 16000}
    with servers(pipes) as (jax_srv, port_srv):
        ev = AssemblyAIStreamingEvaluator(base_url=f"ws://127.0.0.1:{port_srv.port}/ws")
        got = ev.transcribe(audio, {})
        want = JaxStreamingEvaluator(base_url=f"ws://127.0.0.1:{jax_srv.port}/ws").transcribe(
            audio, {})
    assert got == want and isinstance(got, str) and ev.ttfbs


def test_active_sessions_gauge(pipes):
    server = RealtimeServer(pipes[1], host="127.0.0.1", port=0, vad_fn=amp_vad).start()
    try:
        assert server.active_sessions() == 0
        with connect(f"ws://127.0.0.1:{server.port}/ws"):
            deadline = time.time() + 10
            while server.active_sessions() != 1 and time.time() < deadline:
                time.sleep(0.01)
            assert server.active_sessions() == 1
        deadline = time.time() + 10
        while server.active_sessions() != 0 and time.time() < deadline:
            time.sleep(0.01)
        assert server.active_sessions() == 0
    finally:
        server.shutdown()


# ------------------------------------------------------------------ batcher


@pytest.fixture()
def batched(pipes):
    batcher = DynamicBatcher(pipes[1], max_batch=4, max_wait_ms=30.0)
    server = RealtimeServer(pipes[1], host="127.0.0.1", port=0, partial_every_s=0.0,
                            vad_fn=amp_vad, batcher=batcher,
                            endpointer_config=EndpointerConfig(**CFG))
    yield server, batcher
    server.shutdown()
    batcher.close()


def _partials_before_finals(msgs):
    finals = set()
    for m in msgs:
        if m["type"] != "Turn":
            continue
        assert m["turn_order"] not in finals, f"a message after turn {m['turn_order']}'s final"
        if m["end_of_turn"]:
            finals.add(m["turn_order"])
    return finals


def test_batcher_path_every_send_on_the_sender_thread(batched):
    server, batcher = batched
    assert server.lock is batcher.lock
    submitted, senders = [], []
    orig_submit = batcher.submit

    def spy(audio, user_prompt=None):
        submitted.append(np.asarray(audio).size)
        return orig_submit(audio, user_prompt)

    batcher.submit = spy

    class Recording:
        def __init__(self, ws):
            self.ws, self.request = ws, ws.request

        def __iter__(self):
            return iter(self.ws)

        def send(self, message):
            senders.append(threading.current_thread().name)
            self.ws.send(message)

        def abort(self):
            self.ws.abort()

    orig_handle = server._handle
    server._handle = lambda ws: orig_handle(Recording(ws))
    server.start()
    results = [None] * 3

    def run(i):
        # the gap lets each turn's partial resolve before its final starts
        results[i] = session(server.port, [tone(0.8 + 0.1 * i), silence(1.0)], gap_s=0.5)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for msgs in results:
        assert msgs is not None and _partials_before_finals(msgs) == {0}
    partials = sum(m["type"] == "Turn" and not m["end_of_turn"] for r in results for m in r)
    assert submitted and partials >= 1
    # Begin, partials, finals and Termination: all from the sessions' senders
    assert len(senders) == sum(len(r) for r in results)
    assert set(senders) == {"realtime-sender"}


class FakeBatcher:
    lock = threading.Lock()

    def __init__(self):
        self.futs = []

    def submit(self, audio, user_prompt=None):
        fut = Future()
        self.futs.append(fut)
        return fut

    def pending(self):
        return 0


class RecordingWS:
    request = None

    def __init__(self):
        self.sent, self.threads = [], []

    def send(self, message):
        self.threads.append(threading.current_thread())
        self.sent.append(json.loads(message))


def _fake_server():
    server = RealtimeServer(MagicMock(), host="127.0.0.1", port=0, vad_fn=amp_vad,
                            batcher=FakeBatcher())
    server._transcribe = MagicMock(return_value="final text")
    ws = RecordingWS()
    return server, server.batcher, ws, realtime._Session(ws)


def test_partial_submits_without_blocking_and_delivers():
    server, batcher, ws, sess = _fake_server()
    assert server._submit_partial_async(sess, silence(0.5), 3)
    assert sess.inflight
    assert not server._submit_partial_async(sess, silence(0.5), 3)  # one in flight
    batcher.futs[0].set_result("hello there")
    assert not sess.inflight
    assert server._submit_partial_async(sess, silence(0.5), 3)
    batcher.futs[1].set_exception(RuntimeError("batch died"))  # dropped silently
    assert server._submit_partial_async(sess, silence(0.5), 3)
    batcher.futs[2].set_result("")  # empty partials still ship
    assert sess.finish(5)
    assert ws.sent == [{"type": "Turn", "turn_order": 3, "transcript": t, "end_of_turn": False,
                        "turn_is_formatted": False} for t in ("hello there", "")]
    assert all(t is sess.sender for t in ws.threads)
    assert server.errors() == {"partial: RuntimeError": 1}  # the dropped one is counted


def test_stale_partial_is_dropped():
    server, batcher, ws, sess = _fake_server()
    assert server._submit_partial_async(sess, silence(0.5), 0)
    assert server._dispatch(sess, [("final", tone(0.5), 0)], 0) == 1 and sess.gen == 1
    batcher.futs[0].set_result("stale partial")
    assert not sess.inflight
    assert sess.finish(5)
    assert [m["transcript"] for m in ws.sent] == ["final text"]


class TextPipe:
    """A pipeline stub: counts calls, answers ``text`` or raises."""

    def __init__(self, text="hello world", fault=None):
        self.text, self.fault, self.calls = text, fault, 0

    def __call__(self, inputs, **kwargs):
        self.calls += 1
        if self.fault is not None:
            raise self.fault
        return {"text": self.text, "confidence": 0.5}


def _raise(*args, **kwargs):
    raise RuntimeError("device fault")


@pytest.mark.parametrize("where", ["final", "batched_final", "scored_final", "align",
                                   "speaker"])
def test_swallowed_failures_are_counted(where, monkeypatch):
    """A failure the server swallows to keep the session alive still ships
    the turn (empty, without words or without a speaker) and is counted
    in ``errors()`` by where and what it was."""
    fault = RuntimeError("device fault") if where in ("final", "scored_final") else None
    batcher = None
    if where == "batched_final":
        batcher = FakeBatcher()
        batcher.submit = lambda audio, user_prompt=None: _failed_future(RuntimeError("oom"))
    server = RealtimeServer(TextPipe(fault=fault), host="127.0.0.1", port=0, vad_fn=amp_vad,
                            batcher=batcher)
    monkeypatch.setattr(alignment.ForcedAligner, "align", _raise)
    monkeypatch.setattr(realtime, "turn_embedding", _raise)
    ws = RecordingWS()
    sess = realtime._Session(ws)
    assert server._dispatch(sess, [("final", tone(0.6), 0)], 0,
                            tracker=OnlineSpeakerTracker() if where == "speaker" else None,
                            timestamps=where == "align",
                            confidence=where == "scored_final") == 1
    assert sess.finish(5)
    (final,) = ws.sent
    assert final["end_of_turn"] and "speaker" not in final
    assert final["transcript"] == ("hello world" if where in ("align", "speaker") else "")
    assert final.get("words", []) == []
    assert server.errors() == {f"{where.removeprefix('batched_')}: RuntimeError": 1}


def _failed_future(exc):
    fut = Future()
    fut.set_exception(exc)
    return fut


def test_a_partial_refused_by_a_full_backlog_is_not_a_failure():
    batcher = FakeBatcher()

    def full(audio, user_prompt=None):
        raise BacklogFull("backlog full")

    batcher.submit = full
    server = RealtimeServer(TextPipe(), host="127.0.0.1", port=0, vad_fn=amp_vad,
                            batcher=batcher)
    assert server._transcribe(tone(0.5), blocking=False) is None
    assert server.errors() == {}
    assert server._transcribe(tone(0.5), blocking=True) == ""  # a final it refuses is one
    assert server.errors() == {"final: BacklogFull": 1}


@pytest.mark.parametrize("every, partials", [(None, 0), (1e9, 1)])
def test_partial_every_s_none_sends_no_partials(every, partials):
    """``None`` sends no partials; any number lets the session's first
    partial out at once, as the JAX server does (so 1e9 sends one)."""
    pipe = TextPipe()
    server = RealtimeServer(pipe, host="127.0.0.1", port=0, vad_fn=amp_vad,
                            endpointer_config=EndpointerConfig(**CFG),
                            partial_every_s=every).start()
    try:
        msgs = session(server.port, [silence(0.3), tone(1.0), silence(1.0)])
    finally:
        server.shutdown()
    turns = [m for m in msgs if m["type"] == "Turn"]
    assert [m["end_of_turn"] for m in turns] == [False] * partials + [True]
    assert pipe.calls == len(turns) and server.errors() == {}


def test_partial_never_follows_its_final_under_a_forced_interleaving():
    """Pause ``deliver`` after its staleness check, before its enqueue, and
    close the turn meanwhile: the final waits on the session lock, so the
    partial goes out first (JAX's server sends the final, then the stale
    partial)."""
    server, batcher, ws, sess = _fake_server()
    paused, release = threading.Event(), threading.Event()
    enqueue = sess.send

    def paused_send(payload):
        if payload.get("end_of_turn") is False:
            paused.set()
            release.wait(10)
        enqueue(payload)

    sess.send = paused_send
    assert server._submit_partial_async(sess, silence(0.5), 0)
    resolver = threading.Thread(target=batcher.futs[0].set_result, args=("partial",))
    resolver.start()
    assert paused.wait(10)
    closer = threading.Thread(target=server._dispatch,
                              args=(sess, [("final", tone(0.5), 0)], 0))
    closer.start()
    time.sleep(0.3)
    assert closer.is_alive() and sess.gen == 0  # the final waits for the partial's enqueue
    release.set()
    resolver.join(10)
    closer.join(10)
    assert sess.finish(5)
    assert [(m["transcript"], m["end_of_turn"]) for m in ws.sent] == [
        ("partial", False), ("final text", True)]
    assert all(t is sess.sender for t in ws.threads)


def test_partials_never_follow_finals_under_stress():
    """Sessions on more threads than cores, each racing every turn's
    partial (resolved on a thread of its own) against the turn's final,
    with a short switch interval: no partial after its final, no lost
    final."""
    import sys

    def run(sess, server, batcher, errors):
        try:
            for turn in range(30):
                assert server._submit_partial_async(sess, silence(0.3), turn)
                resolver = threading.Thread(target=batcher.futs[-1].set_result,
                                            args=(f"partial {turn}",))
                resolver.start()
                server._dispatch(sess, [("final", tone(0.3), 0)], turn)
                resolver.join(10)
                assert not resolver.is_alive()
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    sessions = [_fake_server() for _ in range(12)]
    errors: list = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(sess, server, batcher, errors))
                   for server, batcher, _, sess in sessions]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    for _, _, ws, sess in sessions:
        assert sess.finish(10)
        finals = set()
        for m in ws.sent:
            assert m["turn_order"] not in finals, "a partial after its turn's final"
            if m["end_of_turn"]:
                finals.add(m["turn_order"])
        assert finals == set(range(30))
        assert all(t is sess.sender for t in ws.threads)


def test_a_stalled_client_does_not_delay_another_sessions_final(batched):
    """A client that stops reading blocks only its own sender: the batcher
    thread, which resolves every session's partials and finals, never
    touches a socket."""
    server, batcher = batched
    stalled, release = threading.Event(), threading.Event()

    class StoppedReading:  # the client's receive window is full: sends block
        def __init__(self, ws):
            self.ws, self.request, self.sends = ws, ws.request, 0

        def __iter__(self):
            return iter(self.ws)

        def send(self, message):
            self.sends += 1
            if self.sends > 1:  # after Begin
                stalled.set()
                release.wait(60)
            self.ws.send(message)

        def abort(self):
            self.ws.abort()

    orig_handle = server._handle
    server._handle = lambda ws: orig_handle(StoppedReading(ws) if "stall" in ws.request.path
                                            else ws)
    server.start()
    chunks = [tone(0.8), silence(1.0)]
    session(server.port, chunks)  # warm
    t0 = time.monotonic()
    session(server.port, chunks)
    baseline = time.monotonic() - t0

    stop = threading.Event()

    def stalled_client():
        with connect(f"ws://127.0.0.1:{server.port}/ws?stall=1") as ws:
            while not stop.is_set():  # speech, so its partials keep resolving
                ws.send(pcm(tone(0.1)))
                time.sleep(0.02)

    talker = threading.Thread(target=stalled_client, daemon=True)
    talker.start()
    try:
        assert stalled.wait(30)
        t0 = time.monotonic()
        msgs = session(server.port, chunks)
        elapsed = time.monotonic() - t0
    finally:
        stop.set()
        release.set()
        talker.join(10)
    assert sum(m["type"] == "Turn" and m["end_of_turn"] for m in msgs) == 1
    assert elapsed <= baseline + 2.0, (elapsed, baseline)


# ---------------------------------------------------------------- co-hosting


def test_serve_cohosts_the_realtime_server(pipes, tmp_path, monkeypatch):
    """``serve(realtime_port=...)``: HTTP and WebSocket on one pipeline,
    lock and batcher; ``/metrics`` exports ``ta_realtime_sessions``; the
    shutdown stops the realtime server, then the batcher, then HTTP."""
    pipes[0].model.save_pretrained(tmp_path)
    started, order = {}, []
    make_server = serving.make_server

    def capture(*args, **kwargs):
        server = make_server(*args, **kwargs)
        started["http"] = server
        return server

    monkeypatch.setattr(serving, "make_server", capture)
    for cls, name in ((RealtimeServer, "realtime"), (DynamicBatcher, "batcher")):
        orig = cls.shutdown if name == "realtime" else cls.close

        def recorded(self, orig=orig, name=name):
            order.append(name)
            return orig(self)

        monkeypatch.setattr(cls, "shutdown" if name == "realtime" else "close", recorded)
    thread = threading.Thread(target=serving.serve, args=(str(tmp_path),), daemon=True,
                              kwargs=dict(host="127.0.0.1", port=0, warmup=False,
                                          realtime_port=0, device="cpu"))
    thread.start()
    deadline = time.time() + 60
    while "http" not in started and time.time() < deadline:
        time.sleep(0.05)
    http = started["http"]
    while not http.metrics.gauge_fns and time.time() < deadline:
        time.sleep(0.05)
    rt = http.metrics.gauge_fns["ta_realtime_sessions"].__self__
    assert isinstance(rt, RealtimeServer) and rt.batcher is not None and rt.lock is rt.batcher.lock
    url = f"http://127.0.0.1:{http.server_address[1]}"

    def gauge():
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            return int(re.search(r"^ta_realtime_sessions (\d+)$", r.read().decode(), re.M)[1])

    with connect(f"ws://127.0.0.1:{rt.port}/ws") as ws:
        while gauge() != 1 and time.time() < deadline:
            time.sleep(0.05)
        assert gauge() == 1
        # serve's server runs the neural stream VAD: synthesized speech
        for chunk in (silence(0.5), synth_utterance(1.5, seed=21)[0], silence(1.2)):
            ws.send(pcm(chunk))
        ws.send(json.dumps({"type": "Terminate"}))
        msgs = []
        while not msgs or msgs[-1]["type"] != "Termination":
            msgs.append(json.loads(ws.recv(timeout=60)))
    assert sum(m["type"] == "Turn" and m["end_of_turn"] for m in msgs) == 1
    req = urllib.request.Request(f"{url}/transcribe", data=tone(0.5).tobytes(),
                                 headers={"Content-Type": "application/pcm-f32"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert isinstance(json.loads(r.read())["text"], str)
    while gauge() != 0 and time.time() < deadline:
        time.sleep(0.05)
    assert gauge() == 0
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        assert re.search(r"^ta_realtime_errors 0$", r.read().decode(), re.M)
    http.shutdown()  # serve_forever returns; serve's shutdown sequence runs
    thread.join(30)
    assert not thread.is_alive() and order == ["realtime", "batcher"]
    with pytest.raises(OSError):
        connect(f"ws://127.0.0.1:{rt.port}/ws", open_timeout=2)


def test_bench_realtime_tool_on_the_cpu(monkeypatch, capsys):
    """``tools/bench_realtime`` on the tiny fp32 towers on the CPU: one
    real-time-paced session through the batcher, its JSON line."""
    from tiny_audio_tpu_torch.tools import bench_realtime

    for knob, value in (("TA_BENCH_RT_TINY", "1"), ("TA_BENCH_RT_SESSIONS", "2"),
                        ("TA_BENCH_RT_SPEECH_S", "1.5"), ("TA_BENCH_RT_BATCHER", "1")):
        monkeypatch.setenv(knob, value)
    bench_realtime.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    extra = line["extra"]
    assert line["metric"] == "realtime_ws_endpoint_latency_p50" and line["value"] > 0.0
    assert extra["all_sessions_got_finals"] and extra["faults"] == [[], []]
    assert extra["device"] == "cpu" and extra["batched_decodes"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_realtime.main([])
