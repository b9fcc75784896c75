"""Dynamic request batching for serving.

Port of :mod:`tiny_audio_tpu.batching` (its semantics verbatim).  Decode
reads every decoder weight once per step whatever the batch, so requests
that arrive together should share ONE pass over the weights.
:class:`DynamicBatcher` coalesces concurrent short-clip requests into one
:meth:`~tiny_audio_tpu_torch.pipeline.ASRPipeline.transcribe_batch` call:

- a dispatcher thread takes the first queued request, then waits up to
  ``max_wait_ms`` for more (bounded by ``max_batch``);
- requests are grouped by ``user_prompt`` (different prompts produce
  different chat templates and must not share a generate call);
- the batch row count is padded to a bucket inside ``transcribe_batch``.

Latency trade: a lone request pays at most ``max_wait_ms`` extra; under
load, throughput scales with the coalesced batch instead of the request
rate.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional


class BacklogFull(RuntimeError):
    """Raised by :meth:`DynamicBatcher.submit` when the request queue exceeds
    ``max_queue`` — the server's backpressure signal (HTTP 503).  An
    unbounded queue just converts overload into 600 s result timeouts for
    every caller; rejecting early keeps admitted requests' latency bounded."""


class DynamicBatcher:
    def __init__(
        self,
        pipe,
        max_batch: int = 16,
        max_wait_ms: float = 20.0,
        lock: Optional[threading.Lock] = None,
        max_queue: Optional[int] = None,
    ):
        self.pipe = pipe
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        # Backpressure bound: ~8 full batches of backlog (~8 batch-latencies
        # of queueing delay) before new work is rejected with BacklogFull.
        self.max_queue = (
            int(max_queue) if max_queue is not None else 8 * self.max_batch
        )
        # shared with the solo serving path so batched and solo work never
        # run concurrently on the card
        self.lock = lock or threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------- API

    def submit(self, audio, user_prompt: Optional[str] = None) -> Future:
        """Enqueue one short-clip request; resolves to the transcript str.

        Raises :class:`BacklogFull` when the pending queue exceeds
        ``max_queue`` (callers translate to 503/retry), or
        :class:`RuntimeError` after :meth:`close` — a put that raced past
        the close-time drain would leave its Future unresolved and the
        caller blocked for the full result timeout."""
        if self._stop:
            raise RuntimeError("DynamicBatcher is closed")
        if self._q.qsize() >= self.max_queue:
            raise BacklogFull(
                f"request queue full ({self.max_queue} pending)"
            )
        fut: Future = Future()
        self._q.put((audio, user_prompt, fut))
        if self._stop:  # raced close(): its drain may have missed this put
            self._drain_pending()
        return fut

    def pending(self) -> int:
        """Requests waiting for a batch slot (approximate; used by the
        realtime server to emit partials only on an idle queue)."""
        return self._q.qsize()

    def close(self) -> None:
        self._stop = True
        self._q.put(None)  # wake the dispatcher
        self._thread.join(timeout=10)
        self._drain_pending()

    def _drain_pending(self) -> None:
        """Fail still-queued requests NOW: HTTP threads blocked in
        fut.result(timeout=600) must not hang through shutdown.  Called
        from close() and from a submit() that raced past it."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[2].done():
                item[2].set_exception(
                    RuntimeError("DynamicBatcher closed before dispatch")
                )

    # -------------------------------------------------------------- dispatch

    def _collect(self) -> list:
        """Block for the first request, then coalesce for up to max_wait_s."""
        first = self._q.get()
        if first is None:
            return []
        group = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            group.append(item)
        return group

    def _dispatch_loop(self) -> None:
        while not self._stop:
            group = self._collect()
            if not group:
                continue
            by_prompt: dict = {}
            for audio, prompt, fut in group:
                by_prompt.setdefault(prompt, []).append((audio, fut))
            for prompt, items in by_prompt.items():
                futs = [f for _, f in items]
                try:
                    with self.lock:
                        texts = self.pipe.transcribe_batch(
                            [a for a, _ in items], user_prompt=prompt
                        )
                    for f, text in zip(futs, texts):
                        if not f.done():  # shutdown drain may have failed it
                            f.set_result(text)
                except BaseException as e:  # one bad batch must not wedge callers
                    for f in futs:
                        if not f.done():
                            f.set_exception(e)
