"""The port's serving layer on the CPU: handler, HTTP server, dynamic batcher.

After ``tests/test_serving.py``: the handler contract, the int8 decode flags
and their environment variables, ``/transcribe`` (pcm-f32 and wav),
``/healthz``, ``/metrics``, 404, malformed bodies, backpressure, and
requests coalesced by the batcher.  The server runs over a handler with
``w8a8_decode=True`` and must answer with the text of the port's pipeline
and of the JAX package's handler on equal weights.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import jax
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.handler import EndpointHandler as JaxEndpointHandler
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.pipeline import ASRPipeline as JaxASRPipeline
from tiny_audio_tpu.utils.audio_io import write_wav
from tiny_audio_tpu_torch import serving
from tiny_audio_tpu_torch.batching import BacklogFull, DynamicBatcher
from tiny_audio_tpu_torch.bridge import load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.handler import EndpointHandler
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.pipeline import ASRPipeline
from tiny_audio_tpu_torch.serving import ServerMetrics, make_server

torch.set_num_threads(1)


def _models():
    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 12
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


def _clip(seed: int, n: int = 12000) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def handlers():
    jm, tm = _models()
    return (JaxEndpointHandler(pipeline=JaxASRPipeline(jm), w8a8_decode=True),
            EndpointHandler(pipeline=ASRPipeline(tm), w8a8_decode=True))


class TestEndpointHandler:
    def test_array_and_wav_inputs_match_jax(self, handlers, tmp_path):
        jax_handler, handler = handlers
        audio = _clip(1)
        out = handler({"inputs": audio})
        assert isinstance(out["text"], str)
        assert out == jax_handler({"inputs": audio})
        write_wav(tmp_path / "a.wav", audio)
        assert handler({"inputs": (tmp_path / "a.wav").read_bytes()}) == out

    def test_missing_inputs(self, handlers):
        assert "error" in handlers[1]({})

    def test_parameters_forwarded(self, handlers):
        out = handlers[1]({"inputs": np.zeros(8000, np.float32),
                           "parameters": {"return_timestamps": True}})
        assert "words" in out

    def test_bad_request_does_not_raise(self, handlers):
        assert "error" in handlers[1]({"inputs": object()})

    def test_mesh_raises(self, handlers):
        """A grid the model cannot be split over raises before any rank
        starts (tests/test_torch_parallel.py serves over real grids)."""
        with pytest.raises(ValueError, match=r"tp=3 does not divide the decoder query heads"):
            EndpointHandler(pipeline=handlers[1].pipe, tp=3)
        with pytest.raises(ValueError, match=r"tp=3 does not divide"):
            EndpointHandler(pipeline=handlers[1].pipe, tp=3, dp=2)


@pytest.mark.parametrize("flag,env,keys", [
    ("wq_decode", "TA_WQ_DECODE", ("q_proj_i8", "head_i8")),
    ("w8a8_head", "TA_W8A8_HEAD", ("head_t_i8",)),
    ("w8a8_decode", "TA_W8A8_DECODE", ("q_proj_t_i8", "head_t_i8")),
])
def test_handler_flags_and_env_enable_each_mode(monkeypatch, flag, env, keys):
    _, tm = _models()
    for how in ("flag", "env"):
        tm.wq = None
        if how == "env":
            monkeypatch.setenv(env, "1")
        h = EndpointHandler(pipeline=ASRPipeline(tm), **({flag: True} if how == "flag" else {}))
        wq = h.pipe.model.wq
        assert wq is not None
        for key in keys:
            assert key in wq or key in wq.get("layers", {}), (how, key)
        monkeypatch.delenv(env, raising=False)
    tm.wq = None
    assert EndpointHandler(pipeline=ASRPipeline(tm)).pipe.model.wq is None


def test_handler_loads_a_jax_checkpoint(tmp_path):
    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 8
    jm = JaxASRModel(cfg, seed=2)
    jm.save_pretrained(tmp_path)
    handler = EndpointHandler(str(tmp_path), device="cpu", w8a8_decode=True)
    assert handler.pipe.model.device.type == "cpu"
    audio = _clip(4, 9000)
    want = JaxEndpointHandler(str(tmp_path), w8a8_decode=True)({"inputs": audio})
    assert handler({"inputs": audio}) == want


def _post(url, body: bytes, ctype="application/pcm-f32", timeout=120):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class TestHTTPServer:
    @pytest.fixture(scope="class")
    def server(self, request, handlers):
        handler = handlers[1]
        batcher = DynamicBatcher(handler.pipe, max_batch=4, max_wait_ms=5)
        server = make_server(handler, host="127.0.0.1", port=0, batcher=batcher)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()

        def stop():
            batcher.close()
            server.shutdown()

        request.addfinalizer(stop)
        return f"http://127.0.0.1:{server.server_address[1]}", server

    def test_healthz(self, server):
        with urllib.request.urlopen(f"{server[0]}/healthz") as r:
            body = json.loads(r.read())
        assert body["status"] == "ok" and body["pending_requests"] == 0

    def test_transcribe_pcm_and_wav_match_pipeline_and_jax(self, server, handlers, tmp_path):
        jax_handler, handler = handlers
        audio = _clip(5)
        want = handler.pipe.transcribe_batch([audio])[0]
        assert want == jax_handler.pipe.transcribe_batch([audio])[0]
        assert _post(f"{server[0]}/transcribe", audio.tobytes()) == {"text": want}
        write_wav(tmp_path / "b.wav", audio)
        got = _post(f"{server[0]}/transcribe", (tmp_path / "b.wav").read_bytes(),
                    "application/octet-stream")
        assert got == {"text": want}

    def test_confidence_takes_the_solo_path(self, server):
        body = _post(f"{server[0]}/transcribe?confidence=1", np.zeros(8000, np.float32).tobytes())
        assert isinstance(body["text"], str) and 0.0 < body["confidence"] <= 1.0

    def test_unknown_route_404(self, server):
        for req in (urllib.request.Request(f"{server[0]}/nope", data=b"x"),
                    urllib.request.Request(f"{server[0]}/nope")):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 404

    def test_metrics_endpoint(self, server):
        _post(f"{server[0]}/transcribe", np.zeros(8000, np.float32).tobytes())
        with urllib.request.urlopen(f"{server[0]}/metrics") as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        assert 'ta_requests_total{route="/transcribe",code="200"}' in text
        count = [ln for ln in text.splitlines()
                 if ln.startswith("ta_transcribe_latency_seconds_count")]
        assert count and int(count[0].split()[-1]) >= 1
        assert "ta_pending_requests 0" in text and "ta_uptime_seconds" in text

    @pytest.mark.parametrize("name,body,ctype", [
        ("garbage", b"\x00\x01NOTAWAV" * 64, "application/octet-stream"),
        ("truncated-riff", b"RIFF\x24\x00\x00\x00WAVE", "application/octet-stream"),
        ("empty", b"", "application/octet-stream"),
        ("nan-pcm", np.full(1000, np.nan, np.float32).tobytes(), "application/pcm-f32"),
    ])
    def test_malformed_bodies_yield_json_errors(self, server, name, body, ctype):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{server[0]}/transcribe", body, ctype)
        assert e.value.code == 500
        assert json.loads(e.value.read())["error"]


def test_metrics_extra_gauges():
    m = ServerMetrics()
    m.gauge_fns["ta_live_sessions"] = lambda: 3
    m.gauge_fns["ta_broken_gauge"] = lambda: 1 / 0  # must not break the scrape
    text = m.render()
    assert "ta_live_sessions 3" in text and "ta_broken_gauge" not in text
    assert text.endswith("\n")


def test_backlog_full_is_503(handlers):
    batcher = DynamicBatcher(handlers[1].pipe, max_queue=0)
    with pytest.raises(BacklogFull):
        batcher.submit(_clip(0))
    server = make_server(handlers[1], host="127.0.0.1", port=0, batcher=batcher)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{server.server_address[1]}/transcribe",
                  np.zeros(8000, np.float32).tobytes())
        assert e.value.code == 503
        body = json.loads(e.value.read())
        assert body["retry"] is True and "overloaded" in body["error"]
    finally:
        batcher.close()
        server.shutdown()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(_clip(0))


def test_a_burst_gets_503s_while_the_accept_loop_lags(handlers):
    """40 clients connecting at once while the accept loop lags 50 ms a
    connection (as when it waits for the interpreter lock): every one is
    answered 503, none is reset by a full listen backlog."""
    batcher = DynamicBatcher(handlers[1].pipe, max_queue=0)
    server = make_server(handlers[1], host="127.0.0.1", port=0, batcher=batcher)
    accept = server.process_request

    def lagging(request, client_address):
        time.sleep(0.05)
        accept(request, client_address)

    server.process_request = lagging
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/transcribe"
    codes, errors, lock = [], [], threading.Lock()

    def one():
        try:
            _post(url, np.zeros(8000, np.float32).tobytes())
        except urllib.error.HTTPError as e:
            with lock:
                codes.append(e.code)
        except OSError as e:
            with lock:
                errors.append(type(e).__name__)

    threads = [threading.Thread(target=one) for _ in range(40)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
        server.shutdown()
        server.server_close()
    assert errors == [] and codes == [503] * 40


def test_concurrent_requests_coalesce_into_one_batch(handlers):
    pipe = handlers[1].pipe
    audios = [_clip(6), _clip(7, 9000)]
    want = pipe.transcribe_batch(audios)
    calls = []
    original = pipe.transcribe_batch

    def spy(batch, **kwargs):
        calls.append(len(batch))
        return original(batch, **kwargs)

    pipe.transcribe_batch = spy
    batcher = DynamicBatcher(pipe, max_batch=4, max_wait_ms=2000)
    try:
        futures = [None, None]

        def submit(i):
            futures[i] = batcher.submit(audios[i])

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got = [f.result(timeout=120) for f in futures]
    finally:
        batcher.close()
        del pipe.transcribe_batch
    assert calls == [2]
    assert sorted(got) == sorted(want)


def test_serve_prints_the_int8_modes_and_refuses_unported_engines(monkeypatch, tmp_path):
    cfg = tiny_test_config(model_dtype="float32")
    JaxASRModel(cfg, seed=0).save_pretrained(tmp_path)

    # engine="continuous" builds the engine, warms it before starting it
    # (one mel bucket here: the tiny encoder's window), serves, and closes it
    from tiny_audio_tpu_torch.continuous import ContinuousEngine

    engines = []
    real_warmup = ContinuousEngine.warmup

    def warmup(self, log=print, buckets=None):
        assert self._thread.ident is None  # not started yet
        engines.append(self)
        return real_warmup(self, log=log, buckets=(500,))

    monkeypatch.setattr(ContinuousEngine, "warmup", warmup)
    monkeypatch.setattr(EndpointHandler, "warmup", lambda self, **kw: 0.0)

    class Served:  # the server make_server would give: one request, then interrupted
        def serve_forever(self):
            eng = engines[0]
            assert eng._thread.is_alive()
            assert isinstance(eng.submit(_clip(3)).result(timeout=120), str)
            raise KeyboardInterrupt

        def shutdown(self):
            pass

    monkeypatch.setattr(serving, "make_server",
                        lambda handler, host, port, batcher=None, lock=None: Served())
    with redirect_stdout(io.StringIO()) as out:
        serving.serve(str(tmp_path), engine="continuous", max_batch=2, device="cpu")
    assert "(continuous batching, 2 slots)" in out.getvalue()
    assert len(engines) == 1 and engines[0].n_slots == 2
    assert engines[0]._stop and not engines[0]._thread.is_alive()
    monkeypatch.undo()

    # realtime_port co-hosts the realtime server, and the shutdown stops it
    from tiny_audio_tpu_torch.realtime import RealtimeServer
    from tiny_audio_tpu_torch.utils.websocket import connect

    started = []
    monkeypatch.setattr(RealtimeServer, "start",
                        lambda self, start=RealtimeServer.start: started.append(self) or
                        start(self))

    class Interrupted:  # the server make_server would give, interrupted at once
        metrics = ServerMetrics()

        def serve_forever(self):
            rt = started[0]
            with connect(f"ws://127.0.0.1:{rt.port}/ws") as ws:
                ws.send(json.dumps({"type": "Terminate"}))
                assert json.loads(ws.recv(timeout=30))["type"] == "Begin"
                assert json.loads(ws.recv(timeout=30))["type"] == "Termination"
            raise KeyboardInterrupt

        def shutdown(self):
            pass

    monkeypatch.setattr(serving, "make_server", lambda *a, **k: Interrupted())
    with redirect_stdout(io.StringIO()) as out:
        serving.serve(str(tmp_path), host="127.0.0.1", warmup=False, realtime_port=0,
                      device="cpu")
    assert "[serve] realtime websocket on ws://127.0.0.1:" in out.getvalue()
    assert Interrupted.metrics.gauge_fns["ta_realtime_sessions"] == started[0].active_sessions
    with pytest.raises(OSError):  # shut down with the HTTP server
        connect(f"ws://127.0.0.1:{started[0].port}/ws", open_timeout=2)
    monkeypatch.undo()

    class Stopped:  # the server make_server would give, interrupted at once
        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            self.down = time.monotonic()

    stopped = Stopped()
    monkeypatch.setattr(serving, "make_server", lambda *a, **k: stopped)
    out = io.StringIO()
    with redirect_stdout(out):
        serving.serve(str(tmp_path), warmup=False, w8a8_decode=True, device="cpu")
    text = out.getvalue()
    assert "[serve] int8 decode enabled: w8a8 layer matmuls, w8a8 head" in text
    assert "dynamic batching <= 16" in text and hasattr(stopped, "down")


def test_serve_signature_is_the_jax_packages():
    """The JAX package's parameters in its order, ``device`` last;
    ``dynamic_batching=False`` is the solo path."""
    import inspect

    from tiny_audio_tpu import serving as jax_serving

    ours = list(inspect.signature(serving.serve).parameters.values())
    theirs = list(inspect.signature(jax_serving.serve).parameters.values())
    assert [(p.name, p.default) for p in ours[:-1]] == [(p.name, p.default) for p in theirs]
    assert ours[-1].name == "device" and ours[-1].default == "cuda"


def test_model_signatures_are_the_jax_packages():
    """``ASRModel(config, tokenizer, params, seed, mesh)`` in JAX's order
    with ``device`` last; ``from_pretrained(path, tokenizer, **kwargs)``."""
    import inspect

    def params(fn):
        return [(p.name, p.default, p.kind) for p in inspect.signature(fn).parameters.values()]

    ours, theirs = params(ASRModel.__init__), params(JaxASRModel.__init__)
    assert ours[:-1] == theirs
    assert ours[-1][:2] == ("device", "cuda")
    assert params(ASRModel.from_pretrained) == params(JaxASRModel.from_pretrained)


def test_model_takes_jax_params_by_position():
    """The third positional argument is a JAX-layout params tree: the model
    decodes the JAX model's tokens, whatever its own seed draws."""
    from tiny_audio_tpu_torch.tokenization import ByteTokenizer

    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 8
    jm = JaxASRModel(cfg, None, None, 2)
    port_cfg = PortASRConfig.from_dict(cfg.to_dict())
    tm = ASRModel(port_cfg, ByteTokenizer(port_cfg.decoder.vocab_size),
                  jax.tree.map(np.asarray, jm.params), 5, device="cpu")
    feats = np.random.default_rng(0).standard_normal((2, 80, 100)).astype(np.float32)
    mask = np.ones((2, 100), np.int32)
    np.testing.assert_array_equal(tm.generate(feats, mask), np.asarray(jm.generate(feats, mask)))
    with pytest.raises(KeyError, match="left unset"):
        ASRModel(port_cfg, None, {"projector": jax.tree.map(np.asarray, jm.params["projector"])},
                 device="cpu")


def test_from_pretrained_seeds_a_tower_without_a_file(tmp_path):
    """``from_pretrained(path, seed=3)``: the encoder, which has no file,
    takes the seed-3 draw of the package's own initializers, in both
    packages; the projector comes from its file."""
    from tiny_audio_tpu_torch.bridge import state_dict_to_jax

    cfg = tiny_test_config(model_dtype="float32")
    JaxASRModel(cfg, seed=0).save_pretrained(tmp_path, save_towers=False)
    assert not (tmp_path / "towers.msgpack").exists()

    def leaves(tree):
        return [np.asarray(x) for x in jax.tree.leaves(tree)]

    jax_loaded = JaxASRModel.from_pretrained(tmp_path, seed=3)
    for got, want in zip(leaves(jax_loaded.params["encoder"]),
                         leaves(JaxASRModel(cfg, seed=3).params["encoder"])):
        np.testing.assert_array_equal(got, want)
    loaded = ASRModel.from_pretrained(tmp_path, seed=3, device="cpu")
    port_cfg = PortASRConfig.from_dict(cfg.to_dict())
    got = state_dict_to_jax(loaded)
    seeded = {seed: state_dict_to_jax(ASRModel(port_cfg, seed=seed, device="cpu"))
              for seed in (0, 3)}
    differ = 0
    for a, b, c in zip(leaves(got["encoder"]), leaves(seeded[3]["encoder"]),
                       leaves(seeded[0]["encoder"])):
        np.testing.assert_array_equal(a, b)
        differ += not np.array_equal(a, c)
    assert differ  # the random leaves are seed 3's, not seed 0's
    for a, b in zip(leaves(got["projector"]), leaves(jax_loaded.params["projector"])):
        np.testing.assert_array_equal(a, b)


def test_mesh_goes_through_the_constructor_and_from_pretrained(tmp_path):
    """``mesh=`` places the model on the port's grid: given to the
    constructor (with JAX ``params``) or to ``from_pretrained`` (after the
    files are loaded), the grid decodes the one-device tokens."""
    from tiny_audio_tpu_torch.parallel import mesh as port_mesh

    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 6
    jm = JaxASRModel(cfg, seed=1)
    jm.save_pretrained(tmp_path)
    port_cfg = PortASRConfig.from_dict(cfg.to_dict())
    params = jax.tree.map(np.asarray, jm.params)
    single = ASRModel(port_cfg, params=params, device="cpu")
    feats = np.random.default_rng(3).standard_normal((2, 80, 50)).astype(np.float32)
    mask = np.ones((2, 50), np.int32)
    want = single.generate(feats, mask)
    np.testing.assert_array_equal(want, np.asarray(jm.generate(feats, mask)))
    mesh = port_mesh.make_mesh(dp=1, tp=2, devices=["cpu", "cpu"], timeout=120.0)
    try:
        built = ASRModel(port_cfg, None, params, 0, mesh, device="cpu")
        loaded = ASRModel.from_pretrained(tmp_path, mesh=mesh, device="cpu")
        for model in (built, loaded):
            assert model.mesh is mesh and model.decoder.layers[0].num_heads == 2
            np.testing.assert_array_equal(model.generate(feats, mask), want)
    finally:
        mesh.close()


def test_serve_without_dynamic_batching_takes_the_solo_path(monkeypatch, tmp_path):
    JaxASRModel(tiny_test_config(model_dtype="float32"), seed=0).save_pretrained(tmp_path)
    made = {}

    class Interrupted:
        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            pass

    def fake_make_server(handler, host, port, batcher=None, lock=None):
        made.update(batcher=batcher, lock=lock)
        return Interrupted()

    monkeypatch.setattr(serving, "make_server", fake_make_server)
    with redirect_stdout(io.StringIO()) as out:
        # positionally, as the JAX CLI's callers pass it
        serving.serve(str(tmp_path), "127.0.0.1", 0, False, False, device="cpu")
    assert made["batcher"] is None and made["lock"] is not None
    assert "dynamic batching" not in out.getvalue()
