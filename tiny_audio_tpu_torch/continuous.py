"""Continuous (slot-based) batching: requests join the decode loop mid-flight.

Port of :mod:`tiny_audio_tpu.continuous`.  The dynamic batcher
(:mod:`tiny_audio_tpu_torch.batching`) coalesces arrivals into uniform
batches, and a uniform batch decodes until its slowest row finishes.  This
engine keeps N persistent decode slots over one KV cache, each at its own
sequence length:

- arriving requests are prefilled (encoder, projector, prompt; prompts
  right-padded to PROMPT_BUCKET multiples, groups cut into PREFILL_BUCKETS
  sizes) and scattered into free slots (``generation.insert_slots``);
- one chunk of ``chunk_steps`` greedy steps advances every slot
  (``generation.decode_chunk``) with per-row positions, per-row cache writes
  and, on the card, the decode kernels' per-row lengths (#4 on the fused
  step, the default; #3 on the module step);
- after each chunk the host reads the chunk's tokens once, resolves the
  finished slots' futures and admits queued work into the freed slots.

Scope: the greedy serving default only (no beams, repetition penalty,
n-gram bans, sampling or ``min_new_tokens``); other generation configs are
refused, and ``serving.serve`` then falls back to the dynamic batcher.  A
slot's output ends at the first EOS or pad token.

The slot state and the calls that change it are :class:`EngineSlots`: on a
mesh every rank holds one (its shard of the cache) and each call runs on
every rank; dp ranks hold every slot (the engine's slots are not split over
dp).

One stream: every device call of the engine (prefill, insert, decode
chunks) runs on the default stream, under the engine's ``lock``, which the
HTTP server's solo path and a co-hosted realtime server share.  The decode
kernels' and int8 products' merge counters (``kernels.counter_buffer``) are
shared per device and are safe only for launches on one stream.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from tiny_audio_tpu_torch.batching import BacklogFull
from tiny_audio_tpu_torch.generation import (
    GenerationConfig,
    decode_chunk,
    init_slot_state,
    insert_slots,
    prefill_prompt_cache,
)
from tiny_audio_tpu_torch.parallel.launch import mesh_call, message_class


class EngineSlots:
    """The engine's device work: the slot state of ``model`` and its
    prefill-and-insert and decode-chunk calls.  On a mesh (:meth:`create`
    places one on every rank) rank 0's calls run on every rank."""

    def __init__(self, model, n_slots: int, s_max: int, pad_token_id: int):
        self.model = model
        self.mesh = model.mesh
        self.state = init_slot_state(model.decoder, n_slots, s_max, pad_token_id)

    @classmethod
    def create(cls, model, n_slots: int, s_max: int, pad_token_id: int) -> "EngineSlots":
        slots = cls(model, n_slots, s_max, pad_token_id)
        if model.mesh is not None:
            model.mesh.place(slots, _SlotsBuilder(model._mesh_handle, n_slots, s_max,
                                                  pad_token_id))
        return slots

    @mesh_call
    @torch.inference_mode()
    def prefill(self, input_features, audio_attention_mask, input_ids, t_real: int,
                slot_ids: list, eos_ids, max_new_tokens: int):
        """Prefill a group of requests and insert them into ``slot_ids``;
        returns (first tokens, finished at the prefill) as numpy."""
        model = self.model
        device = model.device
        input_ids = torch.as_tensor(input_ids, device=device)
        embeds = model._splice_embeds(input_features, audio_attention_mask, input_ids)
        tok0_dev, pcache = prefill_prompt_cache(model.decoder, embeds, t_real)
        tok0 = tok0_dev.cpu().numpy()
        first_finished = np.array([int(t) in eos_ids or max_new_tokens <= 1 for t in tok0])
        n = len(slot_ids)
        insert_slots(
            self.state, pcache, tok0_dev,
            torch.tensor(slot_ids, dtype=torch.long, device=device),
            torch.full((n,), t_real, dtype=torch.int32, device=device),
            torch.from_numpy(first_finished).to(device),
        )
        return tok0, first_finished

    @mesh_call
    def decode(self, gen: GenerationConfig, n_steps: int) -> np.ndarray:
        """``n_steps`` decode steps over every slot; the tokens ``[N,
        n_steps]`` as numpy (the chunk's one read back to the host)."""
        self.state, toks = decode_chunk(self.model.decoder, self.state, gen, n_steps)
        return toks.cpu().numpy()


@message_class
class _SlotsBuilder:
    """A rank's :class:`EngineSlots` over the model placed under ``handle``."""

    def __init__(self, handle: int, n_slots: int, s_max: int, pad_token_id: int):
        self.handle, self.args = handle, (n_slots, s_max, pad_token_id)

    def __call__(self, mesh, objects) -> EngineSlots:
        return EngineSlots(objects[self.handle], *self.args)


class ContinuousEngine:
    #: admitted-prefill row buckets (power-of-2 pad like transcribe_batch)
    PREFILL_BUCKETS = (1, 2, 4, 8)

    def __init__(
        self,
        pipe,
        n_slots: int = 16,
        chunk_steps: int = 8,
        lock: Optional[threading.Lock] = None,
        max_queue: Optional[int] = None,
        start: bool = True,
    ):
        model = pipe.model
        gen = model.gen_config
        if (
            gen.num_beams > 1
            or gen.repetition_penalty != 1.0
            or gen.no_repeat_ngram_size != 0
            or gen.do_sample
            or gen.min_new_tokens > 0
        ):
            raise ValueError(
                "ContinuousEngine supports the greedy serving default only "
                "(no beams/penalty/ngram/sampling/min_new_tokens); use "
                "DynamicBatcher for non-default generation configs"
            )
        self.pipe = pipe
        self.model = model
        self.gen = gen
        self.n_slots = int(n_slots)
        self.chunk_steps = int(chunk_steps)
        self.max_queue = int(max_queue) if max_queue is not None else 8 * self.n_slots
        self.lock = lock or threading.Lock()
        self._eos = set(gen.eos_token_ids) | {gen.pad_token_id}

        # widest prompt: the full encoder window's audio tokens
        max_prompt = len(model.build_prompt_ids(
            model._num_audio_tokens(model.mel_window_frames())))
        self.s_max = -(-(max_prompt + gen.max_new_tokens + 1) // 16) * 16
        self._device = EngineSlots.create(model, self.n_slots, self.s_max, gen.pad_token_id)
        # host-side per-slot bookkeeping: None = free
        self._slots: list[Optional[dict]] = [None] * self.n_slots
        self._free: list[int] = list(range(self.n_slots))

        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._drive, daemon=True)
        if start:  # tests drive _admit / _prefill_and_insert / _decode_one_chunk
            self._thread.start()

    # ------------------------------------------------------------------- API

    def start(self) -> None:
        """Start the driver thread (idempotent).  ``serve`` constructs the
        engine with ``start=False``, warms up, then starts: warmup mutates
        slot state and must not race the driver."""
        if self._thread.ident is None and not self._stop:
            self._thread.start()

    def warmup(self, log=print, buckets=None) -> float:
        """Run the engine's shape grid once: both ends of each mel bucket
        (a bucket's audio-token range spans at most two prompt buckets) times
        every prefill bucket, each with a decode chunk.  On the card this
        builds the kernels and makes each shape's first launch before
        traffic.  Call before :meth:`start`.  ``buckets``: a subset of the
        mel bucket frame counts to run.  Returns total seconds."""
        from tiny_audio_tpu_torch.ops import mel

        t_all = time.time()
        proc = self.pipe.processor
        prev = 0
        for bi, frames in enumerate(proc.mel_buckets):
            if buckets is not None and frames not in buckets:
                prev = frames
                continue
            lengths = sorted({(prev + 1) * mel.HOP_LENGTH, frames * mel.HOP_LENGTH})
            prev = frames
            for n in lengths:
                clip = np.zeros(n, np.float32)
                for b in self.PREFILL_BUCKETS:
                    if b > self.n_slots:
                        continue
                    t0 = time.time()
                    reqs = [{"audio": clip, "prompt": None, "future": Future()}
                            for _ in range(b)]
                    self._prefill_group(None, reqs)
                    if self._active():
                        self._decode_one_chunk()
                    for sid, slot in enumerate(self._slots):
                        if slot is not None:
                            slot["future"].cancel()
                            self._release(sid)
                    log(f"[engine-warmup] mel bucket {bi} ({frames}f, {n / 16000:.1f}s) "
                        f"x b{b}: {time.time() - t0:.1f}s")
        total = time.time() - t_all
        log(f"[engine-warmup] total {total:.1f}s ({len(proc.mel_buckets)} mel buckets x "
            f"2 ends x {len(self.PREFILL_BUCKETS)} prefill shapes + decode chunk)")
        return total

    def submit(self, audio, user_prompt: Optional[str] = None) -> Future:
        """Enqueue one short clip; the Future resolves to the transcript.

        Raises after :meth:`close` (as :meth:`DynamicBatcher.submit` does: a
        put racing past the close-time drain must not leave its Future
        unresolved)."""
        if self._stop:
            raise RuntimeError("ContinuousEngine is closed")
        if self._q.qsize() >= self.max_queue:
            raise BacklogFull(f"request queue full ({self.max_queue} pending)")
        fut: Future = Future()
        limit = int(self.pipe.MAX_CHUNK_SECONDS * 16000)
        arr = self.pipe.extract_audio(audio)["array"]
        if len(arr) > limit:
            raise ValueError(
                f"ContinuousEngine takes clips <= {self.pipe.MAX_CHUNK_SECONDS}"
                " s; route long-form inputs through the pipeline"
            )
        self._q.put({"audio": arr, "prompt": user_prompt, "future": fut})
        if self._stop:  # raced close(): its drain may have missed this put
            self._drain_pending()
        return fut

    def pending(self) -> int:
        """Requests waiting for a slot (approximate): the realtime server
        sends partials only on an idle queue."""
        return self._q.qsize()

    def close(self) -> None:
        self._stop = True
        self._q.put(None)
        if self._thread.ident is not None:  # never started in manual mode
            self._thread.join(timeout=30)
        for slot in self._slots:
            if slot is not None and not slot["future"].done():
                slot["future"].set_exception(RuntimeError("ContinuousEngine closed mid-decode"))
        self._drain_pending()

    def _drain_pending(self) -> None:
        """Fail still-queued requests (from close() and from a submit() that
        raced past it)."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item["future"].done():
                item["future"].set_exception(
                    RuntimeError("ContinuousEngine closed before dispatch"))

    # ---------------------------------------------------------------- driver

    def _active(self) -> bool:
        return any(s is not None for s in self._slots)

    def _drive(self) -> None:
        while not self._stop:
            admitted = self._admit()
            if admitted:
                try:
                    self._prefill_and_insert(admitted)
                except BaseException as e:  # noqa: BLE001 — resolve the futures
                    for req in admitted:
                        if not req["future"].done():
                            req["future"].set_exception(e)
            if self._active():
                try:
                    self._decode_one_chunk()
                except BaseException as e:  # noqa: BLE001
                    for sid, slot in enumerate(self._slots):
                        if slot is not None:
                            if not slot["future"].done():
                                slot["future"].set_exception(e)
                            self._release(sid)

    def _admit(self) -> list[dict]:
        """Pull queued requests into free slots; blocks briefly only when
        the engine is otherwise idle."""
        admitted: list[dict] = []
        block = not self._active()
        while len(admitted) < len(self._free):
            try:
                item = self._q.get(timeout=0.05 if block and not admitted else 0)
            except queue.Empty:
                break
            if item is None:
                break
            admitted.append(item)
            block = False
        return admitted

    def _prefill_and_insert(self, admitted: list[dict]) -> None:
        """Prefill the admitted requests, grouped by user prompt (prompts
        change the chat template) and cut into PREFILL_BUCKETS sizes (5 ->
        4 + 1), and scatter them into slots."""
        by_prompt: dict = {}
        for req in admitted:
            by_prompt.setdefault(req["prompt"], []).append(req)
        for prompt, reqs in by_prompt.items():
            i = 0
            while i < len(reqs):
                size = next(b for b in reversed(self.PREFILL_BUCKETS) if b <= len(reqs) - i)
                self._prefill_group(prompt, reqs[i: i + size])
                i += size

    def _prefill_group(self, prompt: Optional[str], reqs: list[dict]) -> None:
        model = self.model
        n_real = len(reqs)
        assert n_real in self.PREFILL_BUCKETS, n_real  # decomposed upstream
        # the mel runs on the device too: under the lock with the rest
        with self.lock:
            feats = self.pipe.processor.extract_features([r["audio"] for r in reqs])
        n_audio = model._num_audio_tokens(int(np.max(feats["mel_lengths"])))
        ids = model.build_prompt_ids(n_audio, prompt)
        # Right-pad to the PROMPT_BUCKET multiple (ASRModel.generate's
        # contract): pad rows are causally invisible in the prefill, and the
        # slot records the real length, so decode resumes at t_real and
        # overwrites the pad rows.
        t_real = len(ids)
        t_pad = model._bucket_prompt_len(t_real, n_audio)
        ids_np = np.full((n_real, t_pad), self.gen.pad_token_id, np.int64)
        ids_np[:, :t_real] = ids
        # allocate slots up front, commit only on success (a failed prefill
        # must not leak them)
        slot_ids = self._free[-n_real:]
        assert len(slot_ids) == n_real, "admitted more than free slots"
        with self.lock:
            tok0, first_finished = self._device.prefill(
                feats["input_features"], feats["audio_attention_mask"],
                torch.from_numpy(ids_np), t_real, list(slot_ids), self._eos,
                self.gen.max_new_tokens)
        del self._free[-n_real:]  # commit the allocation
        for i, (req, sid) in enumerate(zip(reqs, slot_ids)):
            slot = {"future": req["future"], "tokens": [int(tok0[i])], "done": False}
            if first_finished[i]:
                # finished at the prefill: resolve now, the slot never decodes
                self._finish(slot)
                self._free.append(sid)
            else:
                self._slots[sid] = slot

    def _decode_one_chunk(self) -> None:
        with self.lock:  # the chunk's one read back to the host
            toks = self._device.decode(self.gen, self.chunk_steps)
        for sid, slot in enumerate(self._slots):
            if slot is None:
                continue
            for t in toks[sid]:
                t = int(t)
                if t in self._eos:
                    slot["done"] = True
                    break
                slot["tokens"].append(t)
                if len(slot["tokens"]) >= self.gen.max_new_tokens:
                    slot["done"] = True
                    break
            if slot["done"]:
                self._finish(slot)
                self._release(sid)

    def _finish(self, slot: dict) -> None:
        slot["done"] = True
        if not slot["future"].done():
            slot["future"].set_result(self.pipe.postprocess_tokens(slot["tokens"]))

    def _release(self, sid: int) -> None:
        self._slots[sid] = None
        self._free.append(sid)
