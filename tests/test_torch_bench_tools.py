"""The port's serving measurement tools against the JAX package, on the CPU.

``tools/bench_stages.py`` (``scripts/bench_stages.py``): on the tiny fp32
towers with an int8 KV cache, its inputs are the script's (audio bitwise,
prompt shape equal to the JAX model's), its front-end, encoder + splice and
prefill stages compute what the JAX package's ``log_mel_spectrogram`` /
``frame_attention_mask``, ``_splice_embeds_jit`` and
``prefill_prompt_cache`` compute on the same input (fp32 features within
``MEL_ATOL``, embeddings within ``EMBED_TOL``, the first token exactly, the
cache within ``CACHE_ATOL`` or one int8 count), and its measuring function
returns the script's report.

``tools/bench_serving.py`` (``scripts/bench_serving.py``): each part runs on
the tiny towers with small request counts over the port's HTTP server.  Every
response is recorded: the 200s' bodies must equal the JAX package's
``EndpointHandler`` on the same clip and query.  The mixes and the Poisson
starts must be the draws of the script's seeds; backpressure is checked with
the batcher's pipe held until the whole burst has been queued or refused.
"""

import json
import math
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tiny_audio_tpu import alignment as jax_alignment
from tiny_audio_tpu import generation as jax_generation
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.handler import EndpointHandler as JaxEndpointHandler
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.ops import mel as jax_mel
from tiny_audio_tpu.pipeline import ASRPipeline as JaxASRPipeline
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch import alignment
from tiny_audio_tpu_torch.batching import DynamicBatcher
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.handler import EndpointHandler
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.pipeline import ASRPipeline
from tiny_audio_tpu_torch.processing import ASRProcessor
from tiny_audio_tpu_torch.tools import bench_serving, bench_stages

torch.set_num_threads(1)

#: fp32 log-mel features of the two packages (tests/test_torch_mel.py's limit)
MEL_ATOL = 1e-4
#: fp32 prefill embeddings after the tiny encoder, projector and splice
EMBED_TOL = 1e-4
#: an fp32 cache entry, relative to 1 + |want| (int8 entries: one count)
CACHE_ATOL = 1e-5
#: the tiny towers' clips: a 5 s stage clip fills one 500-frame mel bucket
#: (the encoder's window is 512 frames); serving clips are 1 s, long-form 7 s
STAGE_CLIP_S = 5.0
SHORT_S, LONG_S, CHUNK_S = 1.0, 7.0, 5.0
NEW_TOKENS = 8


@pytest.fixture(scope="module")
def models():
    """The JAX model (seed 2: its tiny towers print text) and the port's
    built from its params, int8 KV, fp32."""
    cfg = tiny_test_config(model_dtype="float32", kv_cache_dtype="int8")
    cfg.max_new_tokens = NEW_TOKENS
    jm = JaxASRModel(cfg, seed=2)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()),
                  params=jax.tree.map(np.asarray, jm.params), device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def pipes(models):
    """Both pipelines on 500-frame mel buckets with 5 s long-form chunks (the
    tiny encoder's window), and the JAX handler over its pipeline."""
    jm, tm = models
    jproc = JaxASRProcessor(jm.tokenizer, projector=jm.projector,
                            num_mel_bins=jm.config.encoder.num_mel_bins, mel_buckets=(500,))
    tproc = ASRProcessor(tm.tokenizer, projector=tm.projector,
                         num_mel_bins=tm.config.encoder.num_mel_bins,
                         encoder_conv_layers=tm.config.encoder_conv_layers, mel_buckets=(500,),
                         device="cpu")
    jpipe, tpipe = JaxASRPipeline(jm, jproc), ASRPipeline(tm, tproc)
    jpipe.MAX_CHUNK_SECONDS = tpipe.MAX_CHUNK_SECONDS = CHUNK_S
    return jpipe, tpipe, JaxEndpointHandler(pipeline=jpipe), EndpointHandler(pipeline=tpipe)


# --------------------------------------------------------------- bench_stages


def test_stage_inputs_are_the_scripts(models):
    jm, tm = models
    inputs = bench_stages.stage_inputs(tm, 3, STAGE_CLIP_S)
    n_samples = int(STAGE_CLIP_S * 16000)
    want = np.clip(np.random.default_rng(0).standard_normal((3, n_samples)) * 0.1, -1, 1)
    np.testing.assert_array_equal(inputs["audio"].numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))
    n_frames = n_samples // jax_mel.HOP_LENGTH
    n_audio = jm._num_audio_tokens(n_frames)
    ids = jm.build_prompt_ids(n_audio)
    t_pad = jm._bucket_prompt_len(len(ids), n_audio)
    assert (inputs["n_frames"], inputs["n_audio"], inputs["t_real"], inputs["t_pad"]) == \
        (n_frames, n_audio, len(ids), t_pad)
    assert inputs["input_ids"].shape == (3, t_pad)
    assert (inputs["input_ids"][:, :len(ids)].numpy() == np.asarray(ids)).all()
    assert (inputs["input_ids"][:, len(ids):] == jm.gen_config.pad_token_id).all()
    assert (inputs["lengths"] == n_samples).all()


def _cache_close(got: torch.Tensor, want):
    got, want = got.numpy(), np.asarray(want)
    diff = np.abs(got.astype(np.float64) - want)
    limit = 1 if got.dtype == np.int8 else CACHE_ATOL * (1 + np.abs(want).astype(np.float64))
    assert (diff <= limit).all(), diff.max()


def test_stages_compute_the_jax_packages_stages(models):
    """Each stage on the same input as the JAX function it times."""
    jm, tm = models
    inputs = bench_stages.stage_inputs(tm, 2, STAGE_CLIP_S)
    audio = jnp.asarray(inputs["audio"].numpy())
    lengths = jnp.asarray(inputs["lengths"].numpy())

    feats, mask = bench_stages.frontend(tm, inputs["audio"], inputs["lengths"], inputs["n_frames"])
    feats_j = jax_mel.log_mel_spectrogram(audio, num_mel_bins=jm.config.encoder.num_mel_bins)
    mask_j = jax_mel.frame_attention_mask(lengths, inputs["n_frames"])
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_j), rtol=0, atol=MEL_ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))

    ids_j = jnp.asarray(inputs["input_ids"].numpy())
    embeds_j = np.array(jm._splice_embeds_jit(jm.params, feats_j, mask_j, ids_j))
    embeds = bench_stages.splice(tm, torch.from_numpy(np.array(feats_j)), mask, inputs["input_ids"])
    np.testing.assert_allclose(embeds.numpy(), embeds_j, rtol=EMBED_TOL, atol=EMBED_TOL)

    tok_j, cache_j = jax_generation.prefill_prompt_cache(
        jm.decoder, jm.decoder_variables(), jnp.asarray(embeds_j),
        prompt_len=jnp.int32(inputs["t_real"]))
    tok, cache = bench_stages.prefill(tm, torch.from_numpy(embeds_j), inputs["t_real"])
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    assert set(cache) == set(cache_j)
    for name, x in cache_j.items():
        assert tuple(cache[name].shape) == x.shape
        _cache_close(cache[name], x)


def test_measure_stages_reports_the_scripts_numbers(models):
    jm, tm = models
    r = bench_stages.measure_stages(tm, 2, reps=2, clip_s=STAGE_CLIP_S)
    n_frames = int(STAGE_CLIP_S * 16000) // jax_mel.HOP_LENGTH
    n_audio = jm._num_audio_tokens(n_frames)
    t_real = len(jm.build_prompt_ids(n_audio))
    assert (r["batch"], r["n_audio"], r["t_real"], r["t_pad"]) == \
        (2, n_audio, t_real, jm._bucket_prompt_len(t_real, n_audio))
    assert {name: s["count"] for name, s in r["stages"].items()} == {
        "frontend": 2, "encoder+proj+splice": 2, "prefill": 2, "e2e generate": 2}
    for key in ("frontend_ms", "splice_ms", "prefill_ms", "e2e_ms"):
        assert r[key] > 0
    assert r["decode_ms"] == pytest.approx(
        r["e2e_ms"] - r["frontend_ms"] - r["splice_ms"] - r["prefill_ms"])
    assert r["decode_step_ms"] == pytest.approx(r["decode_ms"] / NEW_TOKENS)
    assert r["rtfx"] == pytest.approx(2 * STAGE_CLIP_S / (r["e2e_ms"] / 1e3))
    lines = bench_stages.report_lines(r)
    assert lines[0] == f"batch=2 prompt t_real={r['t_real']} t_pad={r['t_pad']} n_audio={n_audio}"
    assert [ln.split()[0] for ln in lines[1:]] == [
        "frontend", "encoder+proj+splice", "prefill", "e2e", "decode", "RTFx"]


@pytest.mark.parametrize("tool", [bench_stages, bench_serving], ids=["stages", "serving"])
def test_main_raises_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


@pytest.mark.parametrize("tool", [bench_stages, bench_serving], ids=["stages", "serving"])
def test_main_takes_no_option_but_the_device(tool, capsys):
    with pytest.raises(SystemExit):
        tool.main(["--tiny"])
    assert "--device" in capsys.readouterr().err


# -------------------------------------------------------------- bench_serving


def _clip(seconds: float, seed: int) -> bytes:
    return bench_serving._clip(seconds, seed)


@pytest.fixture
def responses(monkeypatch, pipes):
    """Every ``/transcribe`` response the tool receives, as (body bytes,
    query, status, json); the JAX handler's answer for each (clip, query);
    both packages' aligners without weights (the uniform word spread)."""
    monkeypatch.setattr(jax_alignment.ForcedAligner, "_params", None)
    monkeypatch.setattr(alignment.ForcedAligner, "_tree", None)
    seen, lock = [], threading.Lock()
    real = urllib.request.urlopen

    class Replay:
        def __init__(self, resp, body):
            self.status, self._body = resp.status, body

        def read(self):
            return self._body

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def recording(req, timeout=None):
        query = urllib.parse.urlparse(req.full_url).query
        try:
            with real(req, timeout=timeout) as resp:
                body = resp.read()
                with lock:
                    seen.append((req.data, query, resp.status, json.loads(body)))
                return Replay(resp, body)
        except urllib.error.HTTPError as e:
            with lock:
                seen.append((req.data, query, e.code, json.loads(e.read())))
            raise

    monkeypatch.setattr(urllib.request, "urlopen", recording)
    jax_handler = pipes[2]
    answers = {}

    def jax_answer(data: bytes, query: str) -> dict:
        key = (data, query)
        if key not in answers:
            params = {"return_timestamps": True} if query == "timestamps=1" else {}
            answers[key] = jax_handler({"inputs": np.frombuffer(data, np.float32).copy(),
                                        "parameters": params})
        return answers[key]

    def check(n_expected: int, allow_503: bool = False) -> None:
        assert len(seen) == n_expected
        for data, query, status, body in seen:
            if status == 503 and allow_503:
                assert body["retry"] is True
                continue
            assert status == 200, body
            assert body == jax_answer(data, query)

    return seen, check


def _recorded(monkeypatch, name: str) -> list:
    """Calls of ``bench_serving.<name>`` recorded (args), passed through."""
    calls, real = [], getattr(bench_serving, name)

    def wrapper(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(bench_serving, name, wrapper)
    return calls


def test_throughput_batched_and_solo(pipes, responses):
    _, tpipe, _, handler = pipes
    seen, check = responses
    short = _clip(SHORT_S, 0)
    out = bench_serving.bench_throughput(handler, tpipe, short, n_req=6, concurrency=3)
    assert set(out) == {"batched", "solo", "speedup_batched_vs_solo"}
    for mode in ("batched", "solo"):
        assert out[mode]["non200"] == 0 and out[mode]["req_per_s"] > 0
        assert set(out[mode]) == {"req_per_s", "audio_s_per_s", "wall_s", "p50_s", "p99_s",
                                  "non200"}
    check(2 * (4 + 6))
    assert any(body["text"] for *_, body in seen)


def test_mixes_are_the_scripts_draws():
    """At the script's 32 requests a mix, the lists drawn from
    ``default_rng(1)`` as the script draws them."""
    short, long_clip = b"short", b"long"
    rng = np.random.default_rng(1)
    want = {
        "uniform_short": [(short, "")] * 32,
        "mixed_long_short": [(long_clip, "") if rng.random() < 0.3 else (short, "")
                             for _ in range(32)],
        "short_plus_timestamps": [(short, "timestamps=1") if rng.random() < 0.2 else (short, "")
                                  for _ in range(32)],
    }
    got = bench_serving.request_mixes(short, long_clip)
    assert got == want
    assert list(got) == list(want)
    assert sum(q == "timestamps=1" for _, q in got["short_plus_timestamps"]) > 0
    assert sum(b == long_clip for b, _ in got["mixed_long_short"]) > 0


def test_mixes_and_their_responses(monkeypatch, pipes, responses):
    _, tpipe, _, handler = pipes
    seen, check = responses
    fired = _recorded(monkeypatch, "fire")
    short, long_clip = _clip(SHORT_S, 0), _clip(LONG_S, 1)
    out = bench_serving.bench_mixes(handler, tpipe, short, long_clip, n_per_mix=10, concurrency=4)
    mixes = bench_serving.request_mixes(short, long_clip, 10)
    assert list(out) == list(mixes)
    assert [list(args[1]) for args in fired] == [
        reqs for name in mixes for reqs in (mixes[name][:4], mixes[name])]
    assert all(o["non200"] == 0 for o in out.values())
    check(3 * (4 + 10))
    queries = {q for _, q, *_ in seen}
    assert queries == {"", "timestamps=1"}
    assert any(d == long_clip for d, *_ in seen)


def test_backpressure_refuses_past_the_queue(monkeypatch, pipes, responses):
    """The batcher's pipe is held until all of the burst has been queued or
    refused: every request is answered 200 or 503, and at least the burst
    less the queue bound and one batch is refused."""
    _, tpipe, _, handler = pipes
    seen, check = responses
    burst, max_queue, max_batch = 40, 8, 4
    submitted, all_in, lock = [0], threading.Event(), threading.Lock()
    real_submit = DynamicBatcher.submit

    def counting_submit(self, *args, **kwargs):
        try:
            return real_submit(self, *args, **kwargs)
        finally:
            with lock:
                submitted[0] += 1
                if submitted[0] == burst:
                    all_in.set()

    real_batch = tpipe.transcribe_batch

    def held(*args, **kwargs):
        if threading.current_thread() is not threading.main_thread():
            assert all_in.wait(120), "the burst never finished arriving"
        return real_batch(*args, **kwargs)

    monkeypatch.setattr(DynamicBatcher, "submit", counting_submit)
    monkeypatch.setattr(tpipe, "transcribe_batch", held)
    out = bench_serving.bench_backpressure(handler, tpipe, _clip(SHORT_S, 0))
    assert submitted[0] == burst
    assert out["burst"] == burst and out["max_queue"] == max_queue
    assert out["n_200"] + out["n_503"] == burst
    assert out["n_503"] >= burst - max_queue - max_batch
    assert out["reject_p99_s"] is not None
    check(burst, allow_503=True)
    assert sum(status == 503 for _, _, status, _ in seen) == out["n_503"]


def test_continuous_against_dynamic_on_the_same_arrivals(monkeypatch, pipes, responses):
    _, tpipe, _, handler = pipes
    seen, check = responses
    opened = _recorded(monkeypatch, "_fire_open")
    n_req = 6
    out = bench_serving.bench_continuous(handler, tpipe, _clip(SHORT_S, 0), n_req=n_req,
                                         concurrency=3)
    assert set(out) == {"dynamic_open_loop", "continuous_open_loop",
                        "continuous_closed_loop_req_per_s", "dynamic_closed_loop_req_per_s",
                        "offered_rate_req_per_s"}
    assert out["dynamic_open_loop"]["non200"] == out["continuous_open_loop"]["non200"] == 0
    # the same arrival trace for both, the script's Poisson draws from
    # default_rng(3) at 0.75x the batcher's closed-loop capacity
    (_, _, starts_dyn), (_, _, starts_cont) = opened
    assert starts_dyn == starts_cont and len(starts_dyn) == n_req
    gaps = np.diff(np.concatenate([[0.0], starts_dyn]))
    draws = np.random.default_rng(3).standard_exponential(n_req)
    scale = gaps / draws
    np.testing.assert_allclose(scale, scale[0], rtol=1e-9)
    assert round(1.0 / scale[0], 2) == out["offered_rate_req_per_s"]
    check(n_req + n_req + 4 + n_req + n_req)


def test_streaming_longform(pipes):
    jpipe, tpipe, _, _ = pipes
    seconds = 7.0
    out = bench_serving.bench_streaming_longform(tpipe, seconds=seconds)
    window_s = tpipe.model.mel_window_frames() / 100.0
    assert out["n_chunks"] == math.ceil(seconds / window_s) == 2
    audio = np.clip(np.random.default_rng(2).standard_normal(int(seconds * 16000)) * 0.1, -1, 1
                    ).astype(np.float32)
    assert out["fragments"] == len(list(jpipe.transcribe_streaming(audio))) > 0
    assert out["audio_s"] == seconds and out["sustained_rtf_x"] > 0
    assert out["first_ttfb_s"] <= out["wall_s"]
