"""Realtime WebSocket transcription: continuous audio in, turn transcripts out.

Port of :mod:`tiny_audio_tpu.realtime`.  16 kHz PCM16 frames stream in over a
WebSocket, the causal neural VAD (:class:`~tiny_audio_tpu_torch.vad.
StreamingVad`, numpy on the host) segments speech into turns online, and
each turn is transcribed on the pipeline's device: partial transcripts while
the speaker is still talking, a final one when the endpointer closes the
turn.

The wire protocol is the AssemblyAI-v3 subset the eval harness's streaming
client speaks (:class:`~tiny_audio_tpu_torch.eval.evaluators.asr.
AssemblyAIStreamingEvaluator`)::

    client -> binary frames   16-bit LE mono PCM (any chunking)
    client -> {"type": "Terminate"}          flush + end session
    client -> {"type": "ForceEndpoint"}      close the current turn now
    server -> {"type": "Begin", "id": ...}
    server -> {"type": "Turn", "turn_order": n, "transcript": ...,
               "end_of_turn": bool, "turn_is_formatted": bool}
    server -> {"type": "Termination", "audio_duration_seconds": ...}

Connect-URL options: ``?sample_rate=<hz>`` (input resampled to 16 kHz),
``?speakers=true`` (finals carry a ``speaker`` label: leader clustering over
turn ECAPA embeddings), ``?timestamps=true`` (finals carry AAI-format
``words``, text/start/end in session-absolute ms from the forced aligner),
``?confidence=true`` (finals carry a (0, 1] ``confidence``: exp of the mean
chosen-token log-probability, from the solo scored decode).

Where the port departs from the JAX server:

- the transport is the port's own (:mod:`tiny_audio_tpu_torch.utils.
  websocket`), so the server needs no ``websockets`` package;
- ECAPA and the aligner run on the pipeline model's device (the JAX server
  takes the default device);
- every message of a session goes out through that session's queue and
  sender thread, so a client that stops reading stalls only its own sender,
  never the batcher thread that resolves partials (and with it every
  session's finals);
- a per-session lock is held across a partial's staleness check and its
  enqueue, and across the turn's generation bump when its final starts, so
  a partial can never follow its turn's final;
- a failure that the server swallows to keep a session alive (a decode, the
  aligner, ECAPA) is counted in :meth:`RealtimeServer.errors` by where and
  what it was, so that a turn shipped empty or bare is visible;
- ``partial_every_s=None`` sends no partials (the JAX server's 1e9 idiom
  still sends each session's first one).

Work on the device (decodes, ECAPA, the aligner) is serialized by ``lock``
and stays on the default CUDA stream: the kernels' merge counters are kept
per device and are safe on one stream only.

Endpointing runs on the VAD's frame grid (HOP = 256 => 16 ms): a turn opens
after ``start_frames`` consecutive speech frames, closes after
``end_silence_frames`` of trailing silence, and is force-closed at
``max_turn_s`` so that turn audio fits the 30 s encoder window.
"""

from __future__ import annotations

import json
import math
import queue
import threading
import time
import uuid
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from tiny_audio_tpu_torch.batching import BacklogFull
from tiny_audio_tpu_torch.vad import HOP, SAMPLE_RATE, WIN

# ------------------------------------------------------------------ endpointer


@dataclass
class EndpointerConfig:
    """Frame counts are on the VAD grid: HOP/SAMPLE_RATE = 16 ms per frame."""

    start_frames: int = 8          # ~128 ms of speech opens a turn
    end_silence_frames: int = 40   # ~640 ms of silence closes it
    pre_roll_frames: int = 12      # ~192 ms kept before the detected onset
    hangover_frames: int = 12      # ~192 ms kept after the last speech frame
    max_turn_s: float = 28.0       # force-close before the 30 s encoder cap
    update_samples: int = 4096     # rescan cadence (~256 ms of new audio)
    idle_tail_s: float = 1.0       # silence kept while waiting for an onset


class TurnEndpointer:
    """Online speech/turn segmentation over a growing sample buffer.

    A state machine around either an injected ``vad_fn`` ([n] float32
    samples -> [n // HOP] bool decisions; the whole buffer is rescored each
    scan) or a ``vad_stream`` (:class:`~tiny_audio_tpu_torch.vad.
    StreamingVad`: decisions for new audio only).  :meth:`feed` returns a
    list of events::

        ("start",)                  a turn opened
        ("final", audio, start)     a turn closed; ``audio`` is the float32
                                    turn clip, ``start`` its first sample's
                                    session-absolute offset

    Partial-transcript cadence is the caller's business; the endpointer only
    segments.
    """

    def __init__(self, vad_fn: Optional[Callable[[np.ndarray], np.ndarray]],
                 config: Optional[EndpointerConfig] = None,
                 vad_stream=None):
        if (vad_fn is None) == (vad_stream is None):
            raise ValueError("pass exactly one of vad_fn / vad_stream")
        self.vad_fn = vad_fn
        # streaming mode: decisions accumulate in self._dec, aligned with
        # buf's frame grid (every trim below is hop-aligned)
        self.vad_stream = vad_stream
        self._dec = np.zeros(0, bool)
        self.cfg = config or EndpointerConfig()
        self.buf = np.zeros(0, np.float32)
        self.turn_open = False
        self._since_scan = 0
        self._fed = 0  # total samples ever fed: buf starts at _fed - len(buf)

    @property
    def turn_audio(self) -> np.ndarray:
        """Samples of the current (open) turn so far: what a partial
        transcribes."""
        return self.buf

    def feed(self, samples: np.ndarray) -> list[tuple]:
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._fed += samples.size
        self.buf = np.concatenate([self.buf, samples]) if self.buf.size else samples
        if self.vad_stream is not None and samples.size:
            new = self.vad_stream.feed(samples)
            if new.size:
                self._dec = np.concatenate([self._dec, new])
        self._since_scan += samples.size
        if self._since_scan < self.cfg.update_samples:
            return []
        self._since_scan = 0
        return self._scan()

    def flush(self) -> list[tuple]:
        """End of stream: close any open turn on whatever audio remains."""
        if self.vad_stream is not None and self.buf.size >= HOP:
            # complete the final analysis window so trailing frames score
            new = self.vad_stream.feed(np.zeros(WIN - HOP, np.float32))
            if new.size:
                self._dec = np.concatenate([self._dec, new])
        events = self._scan() if self.buf.size >= HOP else []
        if self.turn_open:
            events.append(("final", self.buf, self._buf_start()))
            self._clear()
        return events

    def force_endpoint(self) -> list[tuple]:
        """Client-requested turn close (AAI ``ForceEndpoint``)."""
        if not self.turn_open:
            return []
        audio, start = self.buf, self._buf_start()
        self._clear()
        return [("final", audio, start)]

    # ------------------------------------------------------------- internals

    def _buf_start(self) -> int:
        """Session-absolute sample offset of ``buf[0]``."""
        return self._fed - self.buf.size

    def _clear(self) -> None:
        """Drop all buffered state (turn closed on the full buffer)."""
        self.buf = np.zeros(0, np.float32)
        self.turn_open = False
        self._dec = np.zeros(0, bool)
        if self.vad_stream is not None:
            # conv/GRU context resets at the hard boundary; the running level
            # estimate is kept
            self.vad_stream.reset(keep_level=True)

    def _trim(self, frames: int) -> None:
        """Drop ``frames`` whole VAD frames from the buffer front
        (hop-aligned, so streaming decisions stay on the same grid)."""
        if frames <= 0:
            return
        self.buf = self.buf[frames * HOP:]
        self._dec = self._dec[frames:]

    def _scan(self) -> list[tuple]:
        cfg = self.cfg
        if self.vad_stream is not None:
            decisions = self._dec
        else:
            n_frames = self.buf.size // HOP
            decisions = (np.asarray(self.vad_fn(self.buf), bool)[:n_frames]
                         if n_frames else np.zeros(0, bool))
        if decisions.size == 0:
            return []
        events: list[tuple] = []

        if not self.turn_open:
            onset = self._find_onset(decisions)
            if onset is None:
                # bound idle memory: keep only enough tail to still catch an
                # onset that straddles the next chunk boundary
                keep_frames = int(cfg.idle_tail_s * SAMPLE_RATE) // HOP
                self._trim(self.buf.size // HOP - keep_frames)
                return events
            self.turn_open = True
            self._trim(max(0, onset - cfg.pre_roll_frames))
            decisions = self._dec if self.vad_stream is not None \
                else decisions[max(0, onset - cfg.pre_roll_frames):]
            events.append(("start",))

        speech_idx = np.flatnonzero(decisions)
        last_speech = int(speech_idx[-1]) if speech_idx.size else -1
        trailing = decisions.size - 1 - last_speech
        start = self._buf_start()
        if trailing >= cfg.end_silence_frames:
            cut_frames = last_speech + 1 + cfg.hangover_frames
            if cut_frames * HOP >= self.buf.size:
                events.append(("final", self.buf, start))
                self._clear()
            else:
                events.append(("final", self.buf[:cut_frames * HOP], start))
                self._trim(cut_frames)
                self.turn_open = False
        elif self.buf.size >= int(cfg.max_turn_s * SAMPLE_RATE):
            events.append(("final", self.buf, start))
            self._clear()
        return events

    def _find_onset(self, decisions: np.ndarray) -> Optional[int]:
        """First index where ``start_frames`` consecutive frames are speech."""
        k = self.cfg.start_frames
        if decisions.size < k:
            return None
        runs = np.convolve(decisions.astype(np.int32), np.ones(k, np.int32),
                           mode="valid")
        hits = np.flatnonzero(runs >= k)
        return int(hits[0]) if hits.size else None


# -------------------------------------------------------------- live speakers


class OnlineSpeakerTracker:
    """Leader clustering over turn-level ECAPA embeddings.

    A live session cannot wait for the whole conversation, so each finalized
    turn joins its closest centroid (cosine >= ``threshold``) or founds a
    new speaker.  Centroids are running means in the unnormalized space,
    re-normalized per comparison.
    """

    def __init__(self, threshold: float = 0.5, max_speakers: int = 10):
        self.threshold = threshold
        self.max_speakers = max_speakers
        self._sums: list[np.ndarray] = []
        self._counts: list[int] = []

    def assign(self, emb: np.ndarray) -> int:
        emb = np.asarray(emb, np.float32)
        emb = emb / max(float(np.linalg.norm(emb)), 1e-8)
        if self._sums:
            cents = np.stack([s / c for s, c in
                              zip(self._sums, self._counts)])
            cents /= np.maximum(
                np.linalg.norm(cents, axis=1, keepdims=True), 1e-8
            )
            sims = cents @ emb
            best = int(np.argmax(sims))
            if (sims[best] >= self.threshold
                    or len(self._sums) >= self.max_speakers):
                self._sums[best] += emb
                self._counts[best] += 1
                return best
        self._sums.append(emb.copy())
        self._counts.append(1)
        return len(self._sums) - 1


def turn_embedding(audio: np.ndarray, device="cuda") -> Optional[np.ndarray]:
    """Mean of window-level ECAPA embeddings (on ``device``) over the turn
    clip, or None for clips too short to window.  The caller holds the
    device lock."""
    from tiny_audio_tpu_torch.diarization import EcapaEmbedder, sliding_windows

    windows, _ = sliding_windows(
        audio, [(0.0, audio.size / SAMPLE_RATE)]
    )
    if windows.shape[0] == 0:
        return None
    embs = EcapaEmbedder.get(device).embed_windows(windows)
    m = embs.mean(axis=0)
    return m / max(float(np.linalg.norm(m)), 1e-8)


# ---------------------------------------------------------------------- server


class _Session:
    """One connection's outbound side: a FIFO of encoded messages drained by
    one sender thread (the only caller of ``ws.send`` for the session), and
    the state of its asynchronous partials under ``lock``: ``gen`` bumps
    when a turn's final starts, ``inflight`` marks a partial awaiting its
    batch."""

    def __init__(self, ws):
        self.ws = ws
        self.lock = threading.Lock()
        self.gen = 0
        self.inflight = False
        self.failed = False  # a send raised: the connection is gone
        self._out: queue.Queue = queue.Queue()
        self.sender = threading.Thread(target=self._drain, daemon=True,
                                       name="realtime-sender")
        self.sender.start()

    def send(self, payload: dict) -> None:
        """Queue one message; never blocks on the socket."""
        self._out.put(json.dumps(payload))

    def _drain(self) -> None:
        while True:
            message = self._out.get()
            if message is None:
                return
            if self.failed:
                continue
            try:
                self.ws.send(message)
            except Exception:
                self.failed = True  # the session thread sees the closed socket

    def finish(self, timeout: Optional[float]) -> bool:
        """Send what is queued, then stop; False if the sender is still
        blocked after ``timeout`` seconds."""
        self._out.put(None)
        self.sender.join(timeout)
        return not self.sender.is_alive()


class RealtimeServer:
    """Threaded realtime transcription server over a warmed pipeline.

    One connection = one session = one handler thread, plus that session's
    sender thread.  Device work from all sessions serializes on ``lock``;
    pass the HTTP server's batcher lock to co-host both on one card.

    With a ``batcher`` (:class:`~tiny_audio_tpu_torch.batching.
    DynamicBatcher`), turn decodes from concurrent sessions coalesce into
    one batched generate.  Finals submit and wait (the turn is closed and
    its ordering with its own partials matters); partials submit without
    waiting, at most one in flight per session, and are queued from the
    batcher thread when their batch resolves, or dropped if their turn
    closed meanwhile.

    Partials are best-effort: emitted at most every ``partial_every_s``
    (the session's first one as soon as a turn holds 0.25 s, as in the JAX
    server; ``None`` sends none) and only when no earlier partial is still
    in flight (solo mode: only when the device lock is free), so a busy
    device degrades to final-only turns instead of queueing stale partial
    work.

    A failure that keeps the session alive (a final shipped empty, a
    partial dropped, words or a speaker left out) is counted in
    :meth:`errors`; a partial refused by a full backlog is not a failure.
    """

    #: seconds a finished session waits for its sender before dropping the
    #: connection (a client that stopped reading)
    SEND_TIMEOUT = 30.0

    def __init__(self, pipe, host: str = "0.0.0.0", port: int = 8765,
                 lock: Optional[threading.Lock] = None,
                 partial_every_s: Optional[float] = 1.0,
                 endpointer_config: Optional[EndpointerConfig] = None,
                 vad_fn: Optional[Callable] = None,
                 batcher=None):
        self.pipe = pipe
        self.host, self._port = host, port
        self.batcher = batcher
        if lock is None and batcher is not None:
            lock = batcher.lock
        self.lock = lock if lock is not None else threading.Lock()
        self.partial_every_s = partial_every_s
        self.ep_config = endpointer_config or EndpointerConfig()
        #: ECAPA and the aligner run where the pipeline's model runs
        self.device = getattr(getattr(pipe, "model", None), "device", None) or "cuda"
        # An injected vad_fn (tests, custom oracles) runs in batch mode; the
        # default is the trained VAD streaming on the host (numpy, O(new
        # audio)), or the batch scorer when no weights are present.
        self.vad_fn = vad_fn
        if vad_fn is None:
            from tiny_audio_tpu_torch.vad import StreamingVad, frame_vad_auto

            if StreamingVad.make() is None:
                self.vad_fn = lambda a: frame_vad_auto(a, device=self.device)[0]  # noqa: E731
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._active = 0  # live websocket sessions (ops gauge)
        self._active_lock = threading.Lock()
        self._errors: Counter = Counter()  # swallowed failures, by where and type

    def errors(self) -> dict[str, int]:
        """The failures swallowed so far, as ``{"<where>: <exception type>":
        count}`` (``where``: final, scored_final, partial, align, speaker)."""
        with self._active_lock:
            return dict(self._errors)

    def _swallow(self, where: str, exc: BaseException) -> None:
        with self._active_lock:
            self._errors[f"{where}: {type(exc).__name__}"] += 1

    def active_sessions(self) -> int:
        """Currently connected sessions (exported to /metrics when
        co-hosted with the HTTP server)."""
        with self._active_lock:
            return self._active

    def _make_endpointer(self) -> TurnEndpointer:
        if self.vad_fn is not None:
            return TurnEndpointer(self.vad_fn, self.ep_config)
        from tiny_audio_tpu_torch.vad import StreamingVad

        return TurnEndpointer(None, self.ep_config,
                              vad_stream=StreamingVad.make())

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "RealtimeServer":
        from tiny_audio_tpu_torch.utils.websocket import serve

        # the transport sends no keepalive pings: session end is
        # protocol-level (Terminate), dead sockets surface on the next send
        self._server = serve(self._handle, self.host, self._port)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._server.socket.getsockname()[1]

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------ connection

    def _handle(self, ws) -> None:
        with self._active_lock:
            self._active += 1
        try:
            self._handle_session(ws)
        finally:
            with self._active_lock:
                self._active -= 1

    def _handle_session(self, ws) -> None:
        from urllib.parse import parse_qs, urlparse

        from tiny_audio_tpu_torch.utils.websocket import ConnectionClosed

        sample_rate = 16000
        tracker = None
        timestamps = False
        confidence = False
        try:  # ?sample_rate=...&speakers=...&timestamps=...&confidence=...
            q = parse_qs(urlparse(ws.request.path).query)
            sample_rate = int(q.get("sample_rate", ["16000"])[0])
            if not 4000 <= sample_rate <= 192000:
                sample_rate = 16000  # 0/negative would divide-by-zero in resample
            if q.get("speakers", ["false"])[0].lower() in ("true", "1"):
                tracker = OnlineSpeakerTracker()
            if q.get("timestamps", ["false"])[0].lower() in ("true", "1"):
                timestamps = True
            if q.get("confidence", ["false"])[0].lower() in ("true", "1"):
                confidence = True
        except Exception:
            pass

        sess = _Session(ws)
        sess.send({"type": "Begin", "id": str(uuid.uuid4()),
                   "expires_at": int(time.time()) + 3600})
        ep = self._make_endpointer()
        turn_order = 0
        total_samples = 0
        t0 = time.time()
        last_partial = -math.inf  # the first partial is not held back
        try:
            for msg in ws:
                if isinstance(msg, (bytes, bytearray)):
                    audio = self._decode_pcm(msg, sample_rate)
                    total_samples += audio.size
                    turn_order = self._dispatch(sess, ep.feed(audio), turn_order,
                                                tracker, timestamps, confidence)
                    if (
                        self.partial_every_s is not None
                        and ep.turn_open
                        and time.time() - last_partial >= self.partial_every_s
                        and ep.turn_audio.size >= SAMPLE_RATE // 4
                    ):
                        if self.batcher is not None:
                            if self._submit_partial_async(sess, ep.turn_audio, turn_order):
                                last_partial = time.time()
                        else:
                            text = self._transcribe(ep.turn_audio, blocking=False)
                            if text is not None:
                                last_partial = time.time()
                                sess.send({"type": "Turn", "turn_order": turn_order,
                                           "transcript": text, "end_of_turn": False,
                                           "turn_is_formatted": False})
                    continue
                try:
                    cmd = json.loads(msg)
                except (TypeError, ValueError):
                    continue
                if not isinstance(cmd, dict):
                    continue  # valid JSON but not a command (e.g. a list)
                if cmd.get("type") == "ForceEndpoint":
                    turn_order = self._dispatch(sess, ep.force_endpoint(), turn_order,
                                                tracker, timestamps, confidence)
                elif cmd.get("type") == "Terminate":
                    turn_order = self._dispatch(sess, ep.flush(), turn_order,
                                                tracker, timestamps, confidence)
                    sess.send({"type": "Termination",
                               "audio_duration_seconds": total_samples / SAMPLE_RATE,
                               "session_duration_seconds": time.time() - t0})
                    break
        except ConnectionClosed:
            pass
        finally:
            with sess.lock:
                sess.gen += 1  # a partial still in flight is stale now
            if not sess.finish(self.SEND_TIMEOUT):
                ws.abort()  # the client stopped reading: drop it

    def _dispatch(self, sess: _Session, events: list[tuple], turn_order: int,
                  tracker: Optional[OnlineSpeakerTracker] = None,
                  timestamps: bool = False,
                  confidence: bool = False) -> int:
        for ev in events:
            if ev[0] != "final":
                continue
            with sess.lock:
                # a partial of this turn that has not been queued yet is
                # dropped from here on; one already queued goes out first
                sess.gen += 1
            audio = ev[1]
            turn_start = ev[2] if len(ev) > 2 else 0
            # sub-150 ms turns are VAD flicker: reported empty, not decoded
            text, conf = "", None
            if audio.size >= int(0.15 * SAMPLE_RATE):
                if confidence:
                    text, conf = self._transcribe_scored(audio)
                else:
                    text = self._transcribe(audio, blocking=True) or ""
            payload = {
                "type": "Turn", "turn_order": turn_order,
                "transcript": text, "end_of_turn": True,
                "turn_is_formatted": True,
            }
            if conf is not None:
                payload["confidence"] = conf
            if timestamps and text:
                payload["words"] = self._align_words(audio, text, turn_start)
            if tracker is not None and audio.size >= SAMPLE_RATE // 2:
                try:
                    with self.lock:  # ECAPA runs on the device
                        emb = turn_embedding(audio, self.device)
                    if emb is not None:
                        payload["speaker"] = f"SPEAKER_{tracker.assign(emb):02d}"
                except Exception as exc:  # the turn still ships, unattributed
                    self._swallow("speaker", exc)
            sess.send(payload)
            turn_order += 1
        return turn_order

    def _align_words(self, audio: np.ndarray, text: str,
                     turn_start: int) -> list[dict]:
        """AAI-v3-format word timestamps for a finalized turn: ``text`` /
        ``start`` / ``end`` in session-absolute milliseconds.  The aligner
        runs on the pipeline's device, under the lock."""
        from tiny_audio_tpu_torch.alignment import ForcedAligner

        try:
            with self.lock:
                words = ForcedAligner.align(audio, text, device=self.device)
        except Exception as exc:  # the turn still ships, without words
            self._swallow("align", exc)
            return []
        base_ms = turn_start * 1000.0 / SAMPLE_RATE
        out = []
        for w in words:
            entry = {
                "text": w["word"],
                "start": int(round(base_ms + w["start"] * 1000.0)),
                "end": int(round(base_ms + w["end"] * 1000.0)),
                "word_is_final": True,
            }
            if w.get("fallback"):  # no aligner weights: uniform spread
                entry["fallback"] = True
            out.append(entry)
        return out

    def _transcribe(self, audio: np.ndarray,
                    blocking: bool) -> Optional[str]:
        if self.batcher is not None:
            return self._transcribe_batched(audio, blocking)
        if not self.lock.acquire(blocking=blocking):
            return None  # partial path: device busy, skip this round
        try:
            out = self.pipe({"array": np.asarray(audio, np.float32),
                             "sampling_rate": SAMPLE_RATE})
            return out.get("text", "")
        except Exception as exc:  # keep the session alive on a bad clip
            self._swallow("final" if blocking else "partial", exc)
            return "" if blocking else None
        finally:
            self.lock.release()

    def _transcribe_scored(self, audio: np.ndarray) -> tuple[str, Optional[float]]:
        """A final's decode with its confidence (?confidence=true): always
        the solo scored path under the lock (the batcher's rows share one
        unscored generate)."""
        try:
            with self.lock:
                out = self.pipe({"array": np.asarray(audio, np.float32),
                                 "sampling_rate": SAMPLE_RATE},
                                return_confidence=True)
            return out.get("text", ""), out.get("confidence")
        except Exception as exc:  # keep the session alive on a bad clip
            self._swallow("scored_final", exc)
            return "", None

    def _transcribe_batched(self, audio: np.ndarray,
                            blocking: bool) -> Optional[str]:
        """Coalesce this turn's decode with other sessions' through the
        dynamic batcher.  Finals always queue; partials only when the
        queue is idle (stale partial work must not delay finals)."""
        if not blocking and self.batcher.pending() > 0:
            return None
        try:
            fut = self.batcher.submit(np.asarray(audio, np.float32))
            return fut.result(timeout=300)
        except Exception as exc:  # backlog full, or a bad clip: the session lives on
            if blocking or not isinstance(exc, BacklogFull):
                self._swallow("final" if blocking else "partial", exc)
            return "" if blocking else None

    def _submit_partial_async(self, sess: _Session, audio: np.ndarray,
                              turn_order: int) -> bool:
        """Batcher-mode partial without blocking the receive loop: submit,
        return, and queue the text from the batcher thread when the batch
        resolves, unless the turn closed meanwhile (``sess.gen`` moved).
        The check and the enqueue hold ``sess.lock``, as does the bump in
        :meth:`_dispatch`, so a partial never follows its final.

        Returns True when a partial was submitted (the rate-limit clock
        advances), False when throttled or rejected.
        """
        if sess.inflight:
            return False
        gen = sess.gen
        try:
            fut = self.batcher.submit(np.asarray(audio, np.float32))
        except RuntimeError:  # BacklogFull, or the batcher is closed
            return False
        sess.inflight = True

        def deliver(f) -> None:
            sess.inflight = False
            try:
                text = f.result()
            except Exception as exc:  # batch failed or drained: no partial
                self._swallow("partial", exc)
                return
            with sess.lock:
                if sess.gen != gen:
                    return  # the turn's final has started: stale
                # empty transcripts still ship: early-turn partials are often
                # empty and clients key time-to-first-byte off them
                sess.send({"type": "Turn", "turn_order": turn_order,
                           "transcript": text, "end_of_turn": False,
                           "turn_is_formatted": False})

        fut.add_done_callback(deliver)
        return True

    @staticmethod
    def _decode_pcm(raw: bytes, sample_rate: int) -> np.ndarray:
        audio = np.frombuffer(
            raw[: len(raw) - (len(raw) % 2)], "<i2"
        ).astype(np.float32) / 32768.0
        if sample_rate != SAMPLE_RATE and audio.size:
            from tiny_audio_tpu_torch.utils.audio_io import resample

            audio = resample(audio, sample_rate, SAMPLE_RATE)
        return audio


# ------------------------------------------------------------------ entrypoint


def serve_realtime(model_path: str, host: str = "0.0.0.0", port: int = 8765,
                   warmup: bool = True, partial_every_s: float = 1.0,
                   device="cuda") -> None:
    """Load ``model_path`` on ``device``, warm it (so that the first turn
    does not pay for the kernels' build), and run the WebSocket server until
    interrupted."""
    from tiny_audio_tpu_torch.handler import EndpointHandler

    handler = EndpointHandler(model_path, device=device)
    if warmup:
        print("[realtime] warming up (the first run builds the kernels)...")
        total = handler.warmup(batched=False)
        print(f"[realtime] warmup done in {total:.1f}s")
    server = RealtimeServer(
        handler.pipe, host=host, port=port, partial_every_s=partial_every_s
    ).start()
    print(f"[realtime] listening on ws://{host}:{server.port} "
          "(PCM16 in, Turn events out)")
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.shutdown()
