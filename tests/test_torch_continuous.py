"""The continuous (slot-based) engine and its slot functions against the JAX
package's, on the CPU.

The tiny towers in fp32 (``tiny_test_config``, weights carried by
``bridge.load_jax_params``), bf16-kind (here fp32) and int8 KV caches, both
decode steps of the port (``fused_decode=True`` runs the fused step's plain
version on the CPU):

- the slot functions: ``prefill_prompt_cache`` (the first token exactly,
  the cache within ``CACHE_ATOL`` / one int8 count), ``insert_slots`` (the
  state bitwise) and ``decode_chunk`` over staggered slot lengths (tokens,
  ``pos`` and ``finished`` exactly; every cache row below each ``pos``
  within ``CACHE_ATOL`` / one int8 count; the step is teacher-free: both
  run from the same state);
- every case of JAX's ``tests/test_continuous.py``, with the port's
  transcripts equal to the JAX engine's on the same arrivals and to the
  port's ``transcribe_batch``; the engine cases of ``tests/test_wq_decode.py``,
  ``tests/test_w8a8_decode.py`` and ``tests/test_realtime.py``; and
  ``serve(engine="continuous")``'s fallback to dynamic batching.
"""

import dataclasses
import functools
import io
import json
import threading
import time
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tiny_audio_tpu import continuous as jax_continuous
from tiny_audio_tpu import generation as jax_generation
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.pipeline import ASRPipeline as JaxASRPipeline
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch import continuous, generation, serving
from tiny_audio_tpu_torch.batching import BacklogFull
from tiny_audio_tpu_torch.bridge import load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.continuous import ContinuousEngine
from tiny_audio_tpu_torch.handler import EndpointHandler
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.pipeline import ASRPipeline
from tiny_audio_tpu_torch.processing import ASRProcessor
from tiny_audio_tpu_torch.serving import make_server

torch.set_num_threads(1)

#: a cache entry the two frameworks computed from the same inputs (fp32
#: projections differ by ulps), relative to 1 + |want|
CACHE_ATOL = 1e-5
KV_KINDS = ("bfloat16", "int8")


def _pair(kvd: str, mode=None):
    """The JAX pipeline and the port's over the same tiny fp32 weights,
    the processors on JAX's test buckets (100 frames)."""
    cfg = tiny_test_config(model_dtype="float32", kv_cache_dtype=kvd)
    cfg.max_new_tokens = 8
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    if mode is not None:
        getattr(jm, mode)()
        getattr(tm, mode)()
    jproc = JaxASRProcessor(jm.tokenizer, projector=jm.projector,
                            num_mel_bins=cfg.encoder.num_mel_bins, mel_buckets=(100,))
    tproc = ASRProcessor(tm.tokenizer, projector=tm.projector,
                         num_mel_bins=cfg.encoder.num_mel_bins,
                         encoder_conv_layers=cfg.encoder_conv_layers, mel_buckets=(100,),
                         device="cpu")
    return JaxASRPipeline(jm, jproc), ASRPipeline(tm, tproc)


@pytest.fixture(scope="module")
def pairs():
    return {kvd: _pair(kvd) for kvd in KV_KINDS}


def _clip(seed: int, n: int = 12000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.1).astype(np.float32)


def _engine(pipe, **kw):
    """The package's engine of ``pipe`` in manual mode."""
    cls = ContinuousEngine if isinstance(pipe, ASRPipeline) else jax_continuous.ContinuousEngine
    kw.setdefault("n_slots", 4)
    kw.setdefault("chunk_steps", 3)
    return cls(pipe, start=False, **kw)


@pytest.fixture(params=[False, True], ids=["module_step", "fused_step"])
def fused(request, monkeypatch):
    """Run the engine's chunks on one decode step (the CPU's default is the
    module step; True runs the fused step's plain version)."""
    monkeypatch.setattr(continuous, "decode_chunk", functools.partial(
        generation.decode_chunk, fused_decode=request.param))
    return request.param


def _run_until_done(eng, futures, max_rounds=50):
    for _ in range(max_rounds):
        admitted = eng._admit()
        if admitted:
            eng._prefill_and_insert(admitted)
        if eng._active():
            eng._decode_one_chunk()
        if all(f.done() for f in futures):
            return
    raise AssertionError("engine did not finish")


# ---------------------------------------------------------- slot functions


def _to_torch(x):
    return torch.from_numpy(np.array(x))


def _cache_close(got: torch.Tensor, want, rows=None):
    """Cache entries within CACHE_ATOL (fp32) or one count (int8);
    ``rows`` [L, N, S] bool selects the entries compared."""
    got, want = got.numpy(), np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    diff = np.abs(got.astype(np.float64) - want)
    limit = 1 if got.dtype == np.int8 else CACHE_ATOL * (1 + np.abs(want).astype(np.float64))
    assert (diff <= limit).all(), diff.max()


@pytest.mark.parametrize("kvd", KV_KINDS)
def test_prefill_prompt_cache_matches_jax(pairs, kvd):
    jpipe, tpipe = pairs[kvd]
    jm, tm = jpipe.model, tpipe.model
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal((2, 37, tm.config.decoder.hidden_size)).astype(np.float32)
    tok_j, cache_j = jax_generation.prefill_prompt_cache(
        jm.decoder, jm.decoder_variables(), jnp.asarray(embeds), jnp.int32(30))
    tok_t, cache_t = generation.prefill_prompt_cache(tm.decoder, torch.from_numpy(embeds), 30)
    assert tok_t.dtype == torch.int32 and np.array_equal(tok_t.numpy(), np.asarray(tok_j))
    assert set(cache_t) == set(cache_j)
    for name, x in cache_j.items():
        assert tuple(cache_t[name].shape) == x.shape == x.shape[:2] + (48,) + x.shape[3:]
        _cache_close(cache_t[name], x)


def _staggered(jm, tm, n_slots=4, s_max=64):
    """Both packages' engine states with three prompts inserted at different
    lengths (slot 3 stays free), from the JAX prefill's caches."""
    gen_j = jm.gen_config
    state_j = jax_generation.init_slot_state(jm.decoder, n_slots, s_max, gen_j.pad_token_id)
    state_t = generation.init_slot_state(tm.decoder, n_slots, s_max, gen_j.pad_token_id)
    rng = np.random.default_rng(9)
    hidden = tm.config.decoder.hidden_size
    for slots, t_pad, t_real in (([2], 20, 17), ([0, 1], 40, 33)):
        embeds = rng.standard_normal((len(slots), t_pad, hidden)).astype(np.float32)
        tok0, pcache = jax_generation.prefill_prompt_cache(
            jm.decoder, jm.decoder_variables(), jnp.asarray(embeds), jnp.int32(t_real))
        done = np.zeros(len(slots), bool)
        state_j = jax_generation.insert_slots(
            state_j, pcache, tok0, jnp.asarray(slots, jnp.int32),
            jnp.full((len(slots),), t_real, jnp.int32), jnp.asarray(done))
        generation.insert_slots(
            state_t, {k: _to_torch(v) for k, v in pcache.items()}, _to_torch(tok0),
            torch.tensor(slots), torch.full((len(slots),), t_real, dtype=torch.int32),
            torch.from_numpy(done))
    return state_j, state_t


@pytest.mark.parametrize("kvd", KV_KINDS)
def test_insert_slots_matches_jax(pairs, kvd):
    jpipe, tpipe = pairs[kvd]
    state_j, state_t = _staggered(jpipe.model, tpipe.model)
    for key in ("cur", "pos", "start", "finished"):
        assert np.array_equal(state_t[key].numpy(), np.asarray(state_j[key])), key
    assert state_t["pos"].tolist() == [33, 33, 17, 0]
    for name, x in state_j["cache"].items():
        assert np.array_equal(state_t["cache"][name].numpy(), np.asarray(x)), name


@pytest.mark.parametrize("kvd", KV_KINDS)
@pytest.mark.parametrize("fused_step", [False, True])
def test_decode_chunk_matches_jax(pairs, kvd, fused_step):
    """Two chunks of 5 steps over slots at 33, 33 and 17 (one free): tokens,
    positions and finished flags exactly, the cache rows below each
    position within CACHE_ATOL / one int8 count; the budget (8 tokens)
    finishes every slot within the second chunk."""
    jpipe, tpipe = pairs[kvd]
    jm, tm = jpipe.model, tpipe.model
    state_j, state_t = _staggered(jm, tm)
    gen_t = tm.gen_config
    for chunk in range(2):
        state_j, toks_j = jax_generation.decode_chunk(
            jm.decoder, jm.decoder_variables(), state_j, jm.gen_config, 5)
        state_t, toks_t = generation.decode_chunk(tm.decoder, state_t, gen_t, 5,
                                                  fused_decode=fused_step)
        assert toks_t.shape == (4, 5) and toks_t.dtype == torch.int32
        assert np.array_equal(toks_t.numpy(), np.asarray(toks_j)), chunk
        for key in ("cur", "pos", "start", "finished"):
            assert np.array_equal(state_t[key].numpy(), np.asarray(state_j[key])), (chunk, key)
        pos = state_t["pos"].numpy()
        for name, x in state_j["cache"].items():
            rows = np.arange(x.shape[2])[None, None, :] < pos[None, :, None]
            rows = np.broadcast_to(rows, x.shape[:3])
            _cache_close(state_t["cache"][name], x, rows)
    assert state_t["finished"].all()
    assert toks_t[3].eq(gen_t.pad_token_id).all()  # the free slot emits pad


# ---------------------------------------------------- the engine: parity


_JAX_RESULTS: dict = {}


def _jax_transcripts(pairs, kvd, case, run):
    """JAX's engine transcripts of one arrival pattern (cached per cache kind:
    the port's decode steps compare to the same run)."""
    key = (kvd, case)
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = run(pairs[kvd][0])
    return _JAX_RESULTS[key]


def _solo(pipe, **kw):
    eng = _engine(pipe, **kw)
    fut = eng.submit(_clip(1))
    _run_until_done(eng, [fut])
    return [fut.result(timeout=5)]


def _coalesced(pipe, **kw):
    audios = [_clip(s, n) for s, n in ((2, 12000), (3, 9000), (4, 15000))]
    eng = _engine(pipe, **kw)
    futs = [eng.submit(a) for a in audios]
    _run_until_done(eng, futs)
    return [f.result(timeout=5) for f in futs]


def _staggered_join(pipe, **kw):
    eng = _engine(pipe, **kw)
    fut_a = eng.submit(_clip(5))
    adm = eng._admit()
    assert len(adm) == 1
    eng._prefill_and_insert(adm)
    eng._decode_one_chunk()  # a is mid-flight
    fut_b = eng.submit(_clip(6, 10000))
    _run_until_done(eng, [fut_a, fut_b])
    return [fut_a.result(timeout=5), fut_b.result(timeout=5)]


def _slot_reuse(pipe, **kw):
    audios = [_clip(10 + i, 8000 + 1000 * i) for i in range(5)]
    eng = _engine(pipe, n_slots=2, **kw)
    futs = [eng.submit(a) for a in audios]
    _run_until_done(eng, futs, max_rounds=200)
    return [f.result(timeout=5) for f in futs]


CASES = {
    # case: (arrivals, the port's transcribe_batch calls giving the same texts)
    "solo": (_solo, [[_clip(1)]]),
    "coalesced": (_coalesced, [[_clip(2, 12000), _clip(3, 9000), _clip(4, 15000)]]),
    "staggered_join": (_staggered_join, [[_clip(5)], [_clip(6, 10000)]]),
    "slot_reuse": (_slot_reuse, [[_clip(10 + i, 8000 + 1000 * i)] for i in range(5)]),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kvd", KV_KINDS)
def test_engine_matches_jax_and_the_batch_path(pairs, case, kvd, fused):
    """The engine's transcripts on one arrival pattern (JAX's solo,
    coalesced, staggered join and slot reuse cases): equal to JAX's engine
    on the same arrivals and to the port's ``transcribe_batch`` (a
    coalesced group shares one batch's prompt length, as in JAX)."""
    run, batches = CASES[case]
    tpipe = pairs[kvd][1]
    want = _jax_transcripts(pairs, kvd, case, run)
    got = run(tpipe)
    assert got == want
    assert got == [text for audios in batches for text in tpipe.transcribe_batch(audios)]


# ------------------------------------------------- the engine: lifecycle


def test_backpressure(pairs):
    eng = _engine(pairs["int8"][1], max_queue=1)
    eng.submit(_clip(20))
    with pytest.raises(BacklogFull):
        eng.submit(_clip(21))


def test_long_clip_rejected(pairs):
    eng = _engine(pairs["int8"][1])
    with pytest.raises(ValueError, match="clips <="):
        eng.submit(np.zeros(16000 * 60, np.float32))


def test_close_fails_pending(pairs):
    eng = _engine(pairs["int8"][1])
    fut = eng.submit(_clip(22))
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(_clip(23))


@pytest.mark.parametrize("change", [{"repetition_penalty": 1.3}, {"num_beams": 2},
                                    {"do_sample": True}, {"no_repeat_ngram_size": 3},
                                    {"min_new_tokens": 2}])
def test_non_default_generation_refused(pairs, change):
    jpipe, tpipe = pairs["int8"]
    for pipe, cls in ((tpipe, ContinuousEngine), (jpipe, jax_continuous.ContinuousEngine)):
        old = pipe.model.gen_config
        pipe.model.gen_config = dataclasses.replace(old, **change)
        try:
            with pytest.raises(ValueError, match="greedy serving default"):
                cls(pipe, start=False)
        finally:
            pipe.model.gen_config = old


def test_warmup_runs_the_grid_and_leaves_the_engine_clean(pairs):
    jpipe, tpipe = pairs["int8"]
    eng = _engine(tpipe, n_slots=4)
    logs = []
    total = eng.warmup(log=logs.append)
    assert total > 0
    # one mel bucket, its two ends, prefill groups of 1, 2 and 4 (8 > 4 slots)
    assert len(logs) == 2 * 3 + 1 and "total" in logs[-1]
    assert all(s is None for s in eng._slots)
    assert sorted(eng._free) == list(range(4))
    fut = eng.submit(_clip(50))
    _run_until_done(eng, [fut])
    jeng = _engine(jpipe)
    jfut = jeng.submit(_clip(50))
    _run_until_done(jeng, [jfut])
    assert fut.result(timeout=5) == jfut.result(timeout=5)


def test_http_server_integration(pairs):
    """make_server takes the engine as its batcher (the same submit API)."""
    jpipe, tpipe = pairs["int8"]
    audio = _clip(40)
    want = tpipe.transcribe_batch([audio])[0]
    jeng = _engine(jpipe, n_slots=2)
    jfut = jeng.submit(audio)
    _run_until_done(jeng, [jfut])
    assert jfut.result(timeout=5) == want
    handler = EndpointHandler(pipeline=tpipe)
    eng = ContinuousEngine(tpipe, n_slots=2, chunk_steps=3)
    server = make_server(handler, host="127.0.0.1", port=0, batcher=eng)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/transcribe", data=audio.tobytes(),
            headers={"Content-Type": "application/pcm-f32"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["text"] == want
    finally:
        server.shutdown()
        eng.close()


def test_prefill_one_shape_per_prompt_bucket(pairs, monkeypatch):
    """Clips of different durations inside one prompt bucket share one
    prefill shape: the engine right-pads prompts to PROMPT_BUCKET multiples
    (9000 and 15000 samples: real prompt lengths 100 and 104)."""
    tpipe = pairs["int8"][1]
    shapes = []
    real = generation.prefill_prompt_cache

    def spy(decoder, embeds, prompt_len=None):
        shapes.append((tuple(embeds.shape), prompt_len))
        return real(decoder, embeds, prompt_len)

    monkeypatch.setattr(continuous, "prefill_prompt_cache", spy)
    eng = _engine(tpipe)
    for seed, n in ((60, 8000), (61, 9000), (62, 15000)):
        fut = eng.submit(_clip(seed, n))
        _run_until_done(eng, [fut])
    assert len({shape for shape, _ in shapes}) == 1, shapes
    assert len({n for _, n in shapes}) > 1, shapes


def test_slot_pool_survives_prefill_failure(pairs, monkeypatch):
    """A prefill that raises fails its futures without leaking the slots it
    had taken."""
    tpipe = pairs["int8"][1]
    eng = _engine(tpipe, n_slots=4)

    def fail(*args, **kwargs):
        raise RuntimeError("injected prefill failure")

    monkeypatch.setattr(eng.model, "_splice_embeds", fail)
    eng.submit(_clip(70))
    admitted = eng._admit()
    with pytest.raises(RuntimeError, match="injected"):
        eng._prefill_and_insert(admitted)
    monkeypatch.undo()
    assert sorted(eng._free) == list(range(4))  # nothing leaked
    fut2 = eng.submit(_clip(71))
    _run_until_done(eng, [fut2])
    assert fut2.result(timeout=5) == tpipe.transcribe_batch([_clip(71)])[0]


def test_threaded_end_to_end(pairs):
    """The real driver thread, with staggered submits from the caller."""
    jpipe, tpipe = pairs["int8"]
    audios = [_clip(30 + i) for i in range(3)]
    want = [tpipe.transcribe_batch([a])[0] for a in audios]
    results = {}
    for name, pipe, cls in (("port", tpipe, ContinuousEngine),
                            ("jax", jpipe, jax_continuous.ContinuousEngine)):
        eng = cls(pipe, n_slots=2, chunk_steps=3)
        try:
            futs = []
            for a in audios:
                futs.append(eng.submit(a))
                time.sleep(0.05)
            results[name] = [f.result(timeout=120) for f in futs]
        finally:
            eng.close()
    assert results["port"] == results["jax"] == want


# -------------------------------------------- int8 modes, realtime, serve


@pytest.mark.parametrize("mode", ["enable_wq_decode", "enable_w8a8_decode"])
def test_engine_matches_batch_under_int8_modes(mode):
    """The engine decodes through the model's int8 weights (kernels #6 /
    #5 on the card) and stays token-exact with the uniform path and with
    JAX's engine (tests/test_wq_decode.py, tests/test_w8a8_decode.py)."""
    jpipe, tpipe = _pair("int8", mode)
    audios = [_clip(4), _clip(5, 9000)]
    want = tpipe.transcribe_batch(audios)
    got = {}
    for name, pipe in (("port", tpipe), ("jax", jpipe)):
        eng = _engine(pipe)
        futs = [eng.submit(a) for a in audios]
        _run_until_done(eng, futs, max_rounds=100)
        got[name] = [f.result(timeout=5) for f in futs]
    assert got["port"] == got["jax"] == want


def test_continuous_engine_as_the_realtime_batcher(pairs):
    """The engine duck-types submit()/pending()/lock, so a realtime turn's
    decode joins its slots (serve --engine continuous --realtime-port); the
    final equals JAX's server on JAX's engine (tests/test_realtime.py)."""
    from tiny_audio_tpu import realtime as jax_realtime
    from tiny_audio_tpu_torch import realtime
    from tiny_audio_tpu_torch.utils.websocket import connect

    def amp_vad(audio, level=0.05):
        n = len(audio) // 256
        return np.abs(audio[: n * 256]).reshape(n, 256).mean(axis=1) > level

    t = np.arange(int(0.8 * 16000)) / 16000
    pcm = np.concatenate([0.3 * np.sin(2 * np.pi * 220 * t), np.zeros(16000)])
    pcm = (pcm * 32767).astype("<i2").tobytes()
    finals = {}
    for name, pipe, mod, cls in (
            ("port", pairs["int8"][1], realtime, ContinuousEngine),
            ("jax", pairs["int8"][0], jax_realtime, jax_continuous.ContinuousEngine)):
        eng = cls(pipe, n_slots=2, chunk_steps=3)
        server = mod.RealtimeServer(pipe, host="127.0.0.1", port=0, partial_every_s=0.0,
                                    vad_fn=amp_vad, batcher=eng,
                                    endpointer_config=mod.EndpointerConfig(update_samples=1)
                                    ).start()
        try:
            assert server.lock is eng.lock
            msgs = []
            with connect(f"ws://127.0.0.1:{server.port}/ws") as ws:
                ws.send(pcm)
                ws.send(json.dumps({"type": "Terminate"}))
                while not msgs or msgs[-1]["type"] != "Termination":
                    msgs.append(json.loads(ws.recv(timeout=120)))
        finally:
            server.shutdown()
            eng.close()
        finals[name] = [m["transcript"] for m in msgs
                        if m["type"] == "Turn" and m["end_of_turn"]]
    assert len(finals["port"]) == 1 and isinstance(finals["port"][0], str)
    assert finals["port"] == finals["jax"]


def test_serve_falls_back_to_dynamic_for_a_non_greedy_config(monkeypatch, tmp_path):
    cfg = tiny_test_config(model_dtype="float32")
    cfg.num_beams = 2
    JaxASRModel(cfg, seed=0).save_pretrained(tmp_path)
    made = {}

    class Interrupted:
        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            pass

    def fake_make_server(handler, host, port, batcher=None, lock=None):
        made.update(batcher=batcher)
        return Interrupted()

    monkeypatch.setattr(serving, "make_server", fake_make_server)
    with redirect_stdout(io.StringIO()) as out:
        serving.serve(str(tmp_path), warmup=False, engine="continuous", device="cpu")
    text = out.getvalue()
    assert ("[serve] continuous engine unavailable (ContinuousEngine supports the greedy "
            "serving default only") in text
    assert "falling back to dynamic batching" in text and "dynamic batching <= 16" in text
    assert type(made["batcher"]).__name__ == "DynamicBatcher"
