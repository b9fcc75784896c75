"""The port's span recorder (``utils/profiling.py``) and its spans on the
serving and training paths, on the CPU.

Off, a span is one shared object and reads no clock.  On, spans nest with
the right parents and roots, the ring keeps the newest, and host times sit
on ``torch.profiler``'s clock.  ``ASRModel.generate`` and a training update
record the spans the benchmark reads, and give the same tokens, loss and
parameters with spans on as off.
"""

import json
import time

import numpy as np
import pytest
import torch

from tiny_audio_tpu_torch.config import tiny_test_config
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture
def spans():
    """Spans on for the test, off (and drained) after it."""
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.drain()


def _no_clock(monkeypatch):
    def refuse():
        raise AssertionError("a clock was read")

    for name in ("perf_counter_ns", "time_ns", "perf_counter", "monotonic_ns"):
        monkeypatch.setattr(time, name, refuse)


def _named(records, name):
    return [r for r in records if r["name"] == name]


def _children(records, parent, name=None):
    return [r for r in records if r["parent"] == parent["id"]
            and (name is None or r["name"] == name)]


def test_spans_off_are_one_shared_object_and_read_no_clock(monkeypatch):
    profiling.disable()
    _no_clock(monkeypatch)
    a, b = profiling.span("generate", rows=2), profiling.sync("finished")
    assert a is b is profiling.span("decode_step")
    with a:
        with b:
            pass


def test_nesting_parents_roots_and_the_ring(spans, monkeypatch):
    with spans.span("outer", rows=3):
        with spans.span("inner"):
            with spans.sync("read"):
                pass
        with spans.span("second"):
            pass
    with spans.span("other root"):
        pass
    got = spans.drain()
    assert [r["name"] for r in got] == ["sync.read", "inner", "second", "outer", "other root"]
    by = {r["name"]: r for r in got}
    outer = by["outer"]
    assert outer["parent"] is None and outer["root"] == outer["id"]
    assert outer["attrs"] == {"rows": 3}
    assert by["inner"]["parent"] == outer["id"] and by["second"]["parent"] == outer["id"]
    assert by["sync.read"]["parent"] == by["inner"]["id"]
    assert {by[n]["root"] for n in ("inner", "second", "sync.read")} == {outer["id"]}
    assert by["other root"]["root"] == by["other root"]["id"] != outer["id"]
    for r in got:
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] is None
    assert by["outer"]["start_ns"] <= by["inner"]["start_ns"] <= by["sync.read"]["start_ns"]
    assert spans.drain() == []
    # a ring of 3 keeps the newest 3
    monkeypatch.setattr(spans, "RING", 3)
    spans.enable()
    for i in range(5):
        with spans.span("s", rows=i):
            pass
    assert [r["attrs"]["rows"] for r in spans.drain()] == [2, 3, 4]


def test_a_span_that_raises_is_closed(spans):
    with pytest.raises(ValueError):
        with spans.span("bad"):
            raise ValueError("step failed")
    with spans.span("after"):
        pass
    got = spans.drain()
    assert [r["name"] for r in got] == ["bad", "after"]
    assert got[1]["parent"] is None


def test_span_times_are_on_the_profilers_clock(spans):
    """A ``record_function`` opened inside a span lies within the span's
    host interval, both on the profiler's clock (1 ms of slack)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            time.sleep(0.002)
            with record_function("inner"):
                (a @ a).sum()
            time.sleep(0.002)
    outer = _named(spans.drain(), "outer")[0]
    inner = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    assert len(inner) == 1
    assert outer["start_ns"] - 1e6 <= inner[0].start_ns() <= inner[0].end_ns() \
        <= outer["end_ns"] + 1e6


def test_the_profiling_trace_shows_the_spans(tmp_path):
    profiling.disable()
    a = torch.randn(32, 32)
    with profiling.trace(tmp_path, device="cpu"):
        with profiling.span("program_span"):
            (a @ a).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "program_span" in names
    # off again after the block
    assert profiling.span("x") is profiling.span("y")
    profiling.drain()


@pytest.fixture(scope="module")
def tiny_model():
    return ASRModel(tiny_test_config(model_dtype="float32"), seed=3, device="cpu")


def _features(model, batch=2, seconds=1.0):
    from tiny_audio_tpu_torch.ops import mel

    rng = np.random.default_rng(5)
    audio = torch.from_numpy(rng.standard_normal((batch, int(16000 * seconds))).astype(
        np.float32) * 0.1)
    feats = mel.log_mel_spectrogram(audio, num_mel_bins=model.config.encoder.num_mel_bins)
    mask = torch.ones(feats.shape[0], feats.shape[-1], dtype=torch.int32)
    return feats, mask


@pytest.mark.parametrize("max_new,mel_given", [(1, False), (2, True), (6, False), (6, True)])
def test_generate_records_its_spans_and_the_same_tokens(tiny_model, max_new, mel_given):
    """One generate, encode and prefill; ``max_new - 1`` decode steps; the
    per-step read of ``finished`` as often as a ``while not all finished``
    loop reads it (after the first pick, then after every step but the
    last), each inside the span whose work it waits for; one fetch; the
    mel length read unless the caller gives it."""
    profiling.disable()
    feats, mask = _features(tiny_model)
    kw = dict(max_new_tokens=max_new, min_new_tokens=max_new)
    if mel_given:
        kw["mel_length"] = feats.shape[-1]
    plain = tiny_model.generate(feats, mask, **kw)
    profiling.enable()
    try:
        traced = tiny_model.generate(feats, mask, **kw)
    finally:
        profiling.disable()
    got = profiling.drain()
    np.testing.assert_array_equal(plain, traced)

    names = [r["name"] for r in got]
    for name in ("generate", "encode", "prefill", "sync.fetch", "sync.prompt_ids",
                 "sync.eos_ids"):
        assert names.count(name) == 1, name
    gen = _named(got, "generate")[0]
    assert gen["parent"] is None and gen["attrs"] == {"rows": 2}
    assert all(r["root"] == gen["id"] for r in got)
    prefill = _named(got, "prefill")[0]
    steps = _named(got, "decode_step")
    assert len(steps) == max_new - 1
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(steps, steps[1:]))
    reads = _named(got, "sync.finished")
    assert len(reads) == max_new - 1
    assert len(_children(got, prefill, "sync.finished")) == (1 if max_new > 1 else 0)
    assert [len(_children(got, s, "sync.finished")) for s in steps] == (
        [1] * (max_new - 2) + [0] if max_new > 1 else [])
    assert all(r["parent"] == gen["id"] for r in steps)
    assert _named(got, "sync.fetch")[0]["parent"] == gen["id"]
    assert names.count("sync.mel_length") == (0 if mel_given else 1)
    # every host read is a sync span: the reads of a generate call
    assert sum(n.startswith("sync.") for n in names) == max_new + 2 + (0 if mel_given else 1)


def test_postprocess_and_mel_are_spans(tiny_model):
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    profiling.enable()
    try:
        _features(tiny_model)
        ASRPipeline(tiny_model).postprocess_tokens(np.array([72, 105, 0]))
    finally:
        profiling.disable()
    assert [r["name"] for r in profiling.drain()] == ["mel", "postprocess"]


def _batch(model):
    """A collated two-clip training batch (numpy arrays, as the collator
    gives them)."""
    from tiny_audio_tpu_torch.train.collator import DataCollator

    collator = DataCollator(model.tokenizer, model.projector,
                            num_mel_bins=model.config.encoder.num_mel_bins, device="cpu")
    rng = np.random.default_rng(1)
    return collator([{"audio": (rng.standard_normal(12000) * 0.1).astype(np.float32),
                      "text": t} for t in ("hello there", "spans")])


def _train_once(seed_model, batch, spans_on):
    from tiny_audio_tpu_torch.train.optim import (
        OptimizerConfig, build_optimizer, init_grad_accum, make_accum_steps)

    model = ASRModel(seed_model.config, device="cpu")
    model.load_state_dict(seed_model.state_dict())
    opt, _ = build_optimizer(model.config, OptimizerConfig(lr_scheduler_type="constant",
                                                           max_grad_norm=0.5), model)
    accumulate, update = make_accum_steps(model, opt, 2)
    accum = init_grad_accum(opt)
    if spans_on:
        profiling.enable()
    try:
        losses = [accumulate(accum, batch)[0], update(accum, batch)[0]]
    finally:
        profiling.disable()
    return losses, {n: p.detach().clone() for n, p in opt.params.items()}


def test_an_update_step_records_its_spans_and_the_same_state(tiny_model):
    """Two micro-steps (accumulate, then update): each a ``micro_step`` root
    holding ``forward`` (``encode`` and ``ce_loss`` inside it) and
    ``backward``; one ``update`` holding the optimizer's two reads; the
    batch's three copies from host memory a micro-step are reads too.  Loss
    and parameters are the same with spans on as off."""
    profiling.disable()
    batch = _batch(tiny_model)
    profiling.drain()
    plain_loss, plain_params = _train_once(tiny_model, batch, False)
    traced_loss, traced_params = _train_once(tiny_model, batch, True)
    got = profiling.drain()
    for a, b in zip(plain_loss, traced_loss):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for name in plain_params:
        torch.testing.assert_close(plain_params[name], traced_params[name], rtol=0, atol=0)

    roots = [r for r in got if r["parent"] is None]
    assert [r["name"] for r in roots] == ["micro_step", "micro_step", "update"]
    for micro in roots[:2]:
        assert [r["name"] for r in _children(got, micro)] == ["forward", "backward"]
        forward = _children(got, micro, "forward")[0]
        assert {r["name"] for r in _children(got, forward)} == {"sync.batch", "encode",
                                                               "ce_loss"}
        assert len(_children(got, forward, "sync.batch")) == 3
        assert all(r["root"] == micro["id"] for r in got if r["root"] == micro["id"])
    update = roots[2]
    assert [r["name"] for r in _children(got, update)] == ["sync.finite", "sync.clip"]
    assert sum(r["name"].startswith("sync.") for r in got) == 2 * 3 + 2


def test_a_batch_of_tensors_reaches_the_model_without_a_host_read(tiny_model):
    """The loss copies a numpy batch's ids, labels and mask to the model's
    device, each copy a ``sync.batch`` read; a batch of tensors on the
    model's kind of device is moved there with no read, to the same loss."""
    profiling.disable()
    batch = _batch(tiny_model)
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    losses, reads = {}, {}
    for kind, b in (("numpy", batch), ("tensors", tensors)):
        profiling.drain()
        profiling.enable()
        try:
            losses[kind] = tiny_model.compute_loss(b, train=False)[0]
        finally:
            profiling.disable()
        reads[kind] = [r["name"] for r in profiling.drain() if r["name"].startswith("sync.")]
    assert reads == {"numpy": ["sync.batch"] * 3, "tensors": []}
    assert losses["tensors"].device == tiny_model.device
    torch.testing.assert_close(losses["numpy"], losses["tensors"], rtol=0, atol=0)


def _blocking_reads(block):
    """Run ``block`` with spans on under ``torch.cuda.set_sync_debug_mode
    ("warn")``: (the reads it warned of, as (file, line), the span records)."""
    import warnings

    torch.cuda.synchronize()
    profiling.enable()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            block()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.disable()
    reads = [(w.filename, w.lineno) for w in caught if "synchroniz" in str(w.message)]
    return reads, profiling.drain()


@pytest.mark.cuda
def test_every_blocking_read_on_the_card_is_a_sync_span():
    """On the card (fused decode, int8 cache, bf16): every read that
    ``set_sync_debug_mode`` reports in a ``generate`` call and in a
    training update is one ``sync.*`` span, no more and no fewer; the
    spans carry device times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels are built with nvcc for sm_90a)")
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.train.optim import (
        OptimizerConfig, build_optimizer, init_grad_accum, make_accum_steps)

    profiling.disable()
    model = ASRModel(tiny_test_config(model_dtype="bfloat16", kv_cache_dtype="int8"), seed=3,
                     device="cuda")
    feats, mask = (x.cuda() for x in _features(model, batch=4))
    kw = dict(max_new_tokens=6, min_new_tokens=6)
    model.generate(feats, mask, **kw)  # builds and warms
    for given in ({}, {"mel_length": feats.shape[-1]}):
        reads, got = _blocking_reads(lambda: model.generate(feats, mask, **kw, **given))
        syncs = [r for r in got if r["name"].startswith("sync.")]
        assert len(reads) == len(syncs) == 6 + 2 + (0 if given else 1), (
            reads, [r["name"] for r in syncs])
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0
               for r in got if not r["name"].startswith("sync."))

    collator = DataCollator(model.tokenizer, model.projector,
                            num_mel_bins=model.config.encoder.num_mel_bins, device="cuda")
    rng = np.random.default_rng(1)
    batch = collator([{"audio": (rng.standard_normal(12000) * 0.1).astype(np.float32),
                       "text": t} for t in ("hello there", "spans")])
    opt, _ = build_optimizer(model.config, OptimizerConfig(lr_scheduler_type="constant"), model)
    accumulate, update = make_accum_steps(model, opt, 2)
    accum = init_grad_accum(opt)
    accumulate(accum, batch)
    update(accum, batch)  # warms
    reads, got = _blocking_reads(lambda: (accumulate(accum, batch), update(accum, batch)))
    syncs = [r for r in got if r["name"].startswith("sync.")]
    assert len(reads) == len(syncs) == 2 * 3 + 2, (reads, [r["name"] for r in syncs])
