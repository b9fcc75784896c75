"""The port's eval harness against the JAX package's, on the CPU.

DER on seeded segments (to 1e-12), every evaluator's rows and metrics on the
same rows through one stub model, the vendor parsers and the API clients over
a fake ``requests``, the dataset registry, a ``load_from_disk`` directory,
``run_eval`` for every dataset type and the local, streaming and realtime
backends on a saved tiny fp32 checkpoint (WER equal to JAX's), ``main`` writing
JAX's result files, ``tools/bench_quality`` against ``scripts/bench_quality.py``,
and the pipecat service under a stub ``pipecat`` package.
"""

import asyncio
import importlib
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tiny_audio_tpu import alignment as jax_alignment
from tiny_audio_tpu import diarization as jax_diarization
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.eval import cli as jax_cli
from tiny_audio_tpu.eval import datasets as jax_datasets
from tiny_audio_tpu.eval import der as jax_der
from tiny_audio_tpu.eval.evaluators import alignment as jax_align_ev
from tiny_audio_tpu.eval.evaluators import api as jax_api
from tiny_audio_tpu.eval.evaluators import base as jax_base
from tiny_audio_tpu.eval.evaluators import classification as jax_cls
from tiny_audio_tpu.eval.evaluators import diarization as jax_diar_ev
from tiny_audio_tpu.eval.evaluators import mcq as jax_mcq
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu_torch import alignment, diarization
from tiny_audio_tpu_torch.eval import cli, datasets, der
from tiny_audio_tpu_torch.eval.evaluators import alignment as align_ev
from tiny_audio_tpu_torch.eval.evaluators import api
from tiny_audio_tpu_torch.eval.evaluators import asr as asr_ev
from tiny_audio_tpu_torch.eval.evaluators import base
from tiny_audio_tpu_torch.eval.evaluators import classification as cls_ev
from tiny_audio_tpu_torch.eval.evaluators import diarization as diar_ev
from tiny_audio_tpu_torch.eval.evaluators import mcq

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TIME_KEYS = ("time_s", "avg_time_s", "ttfb_avg_s", "ttfb_min_s", "ttfb_max_s",
             "processing_avg_s")


def _outcome(fn, *args):
    """``fn``'s result, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:
        return type(e)


def _assert_same(got, want):
    """Equal, NaN equal to NaN."""
    np.testing.assert_equal(got, want)


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in TIME_KEYS}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


# ------------------------------------------------------------------------ DER


def _segments(rng, n, speakers, extent=30.0):
    out = []
    for _ in range(n):
        a = float(rng.uniform(0, extent))
        out.append({"speaker": f"S{int(rng.integers(speakers))}", "start": a,
                    "end": a + float(rng.uniform(0.05, 4.0))})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_der_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ref = _segments(rng, int(rng.integers(1, 12)), 3)
    hyp = _segments(rng, int(rng.integers(0, 12)), 4)
    for kwargs in ({}, {"collar": 0.0}, {"collar": 0.5, "uem": (1.0, 20.0)}):
        got = der.diarization_error_rate(ref, hyp, **kwargs)
        want = jax_der.diarization_error_rate(ref, hyp, **kwargs)
        assert got.keys() == want.keys()
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    assert der.diarization_error_rate([], hyp) == jax_der.diarization_error_rate([], hyp)


# ----------------------------------------------------------------- evaluators


def _audio(seed, seconds=0.5):
    rng = np.random.default_rng(seed)
    return {"array": (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32),
            "sampling_rate": 16000}


def stub_model(audio, prompt=None):
    """A deterministic stand-in for a model: text from the audio's bytes."""
    x = np.asarray(audio["array"])
    if x.size and x[0] > 0.25:
        raise RuntimeError("stub failure")
    words = ["the", "cat", "sat", "on", "a", "mat", "male", "happy", "flute", "B", "(C)"]
    idx = (np.abs(x[:7]) * 1000).astype(int) % len(words)
    return " ".join(words[i] for i in idx[: 2 + int(abs(x[0]) * 100) % 5])


ASR_ROWS = [
    {"audio": _audio(i), "text": text} for i, text in enumerate(
        ["the cat sat", "ignore_time_segment_in_scoring", "", "a mat", "mm-hmm",
         "The Colour sat on twenty-five mats", "<inaudible> x", "the cat", "on a mat"])
] + [{"audio": {"array": np.full(8000, 0.5, np.float32), "sampling_rate": 16000},
      "text": "the stub fails here"}]


@pytest.mark.parametrize("workers", [1, 3])
def test_asr_evaluator_matches_jax(workers):
    def make(module):
        class Stub(module.Evaluator):
            def transcribe(self, audio, sample):
                return stub_model(audio)

        return Stub(num_workers=workers)

    got_rows, got = make(base).evaluate(ASR_ROWS, verbose=False)
    want_rows, want = make(jax_base).evaluate(ASR_ROWS, verbose=False)
    assert _untimed(got) == _untimed(want) and got["errors"] >= 1
    assert [(r.reference, r.prediction, r.wer, r.extra.get("error")) for r in got_rows] == \
        [(r.reference, r.prediction, r.wer, r.extra.get("error")) for r in want_rows]
    assert [base.should_skip_reference(r["text"]) for r in ASR_ROWS] == \
        [jax_base.should_skip_reference(r["text"]) for r in ASR_ROWS]


def test_alignment_evaluator_matches_jax():
    rows = []
    for i in range(4):
        words = [{"word": w, "start": 0.3 * j, "end": 0.3 * j + 0.2}
                 for j, w in enumerate(["Hello", "um", "world", ",", "again"][: 3 + i % 3])]
        rows.append({"audio": _audio(10 + i), "words": words})
    rows.append({"audio": _audio(20), "words": []})

    def align_fn(audio, sample):
        if sample is rows[3]:
            raise RuntimeError("aligner failed")
        return [{"word": w["word"].lower(), "start": w["start"] + 0.013, "end": w["end"] - 0.007}
                for w in sample["words"] if w["word"] != "world"]

    got_rows, got = align_ev.AlignmentEvaluator(align_fn).evaluate(rows, verbose=False)
    want_rows, want = jax_align_ev.AlignmentEvaluator(align_fn).evaluate(rows, verbose=False)
    assert _untimed(got_rows) == _untimed(want_rows) and got == want
    pairs = (["a", "b", "c", "d"], ["b", "x", "c", "d", "a"])
    assert align_ev.lcs_match(*pairs) == jax_align_ev.lcs_match(*pairs)


def test_diarization_evaluator_matches_jax():
    rng = np.random.default_rng(5)
    rows = [{"audio": _audio(30 + i, 3.0), "speakers": _segments(rng, 4, 2, 3.0)}
            for i in range(3)]
    rows.append({"audio": _audio(40), "speakers": ["A", "B"],
                 "timestamps": [[0.0, 1.0], [1.0, 2.0]]})

    def diarize_fn(audio, sample_rate=16000):
        r = np.random.default_rng(int(abs(audio[0]) * 1e6))
        return _segments(r, 3, 3, len(audio) / sample_rate)

    got_rows, got = diar_ev.DiarizationEvaluator(diarize_fn).evaluate(rows, verbose=False)
    want_rows, want = jax_diar_ev.DiarizationEvaluator(diarize_fn).evaluate(rows, verbose=False)
    assert _untimed(got_rows) == _untimed(want_rows) and got == want
    with pytest.raises(ValueError):
        diar_ev.DiarizationEvaluator.extract_reference({"speakers": ["A"], "timestamps": []})


def test_classification_and_mcq_evaluators_match_jax():
    labels = ["Angry", "male_masculine", "United States English", "fifties", "brisk", "?"]
    tasks = ["emotion", "gender", "accent", "age", "rate", "style"]
    for label, task in zip(labels, tasks):
        assert cls_ev.canonicalize(label, task) == jax_cls.canonicalize(label, task)
        text = f"I think the speaker sounds {label.lower()} and he is fast"
        assert cls_ev.extract_classes(text, task) == jax_cls.extract_classes(text, task)
    rows = [{"audio": _audio(50 + i), "label": lab} for i, lab in
            enumerate(["male", "female", "woman", "", "he"])]
    fn = lambda audio, prompt: stub_model(audio, prompt)  # noqa: E731
    got = cls_ev.ClassificationEvaluator(fn, task="gender").evaluate(rows, verbose=False)
    want = jax_cls.ClassificationEvaluator(fn, task="gender").evaluate(rows, verbose=False)
    assert _untimed(list(got)) == _untimed(list(want))

    choices = ["flute music", "a dog barking", "rain", "Car horn"]
    for pred in ("", "B", "(C) rain", "A flute is playing", "the answer is D.", "car horn",
                 "I heard rain", "a"):
        assert mcq.match_choice(pred, choices) == jax_mcq.match_choice(pred, choices)
    for answer in ("rain", "b", "2", "Rain.", "E"):
        assert mcq.resolve_gold_index(answer, choices) == jax_mcq.resolve_gold_index(answer,
                                                                                      choices)
    assert mcq.build_mcq_prompt("Q?", choices) == jax_mcq.build_mcq_prompt("Q?", choices)
    rows = [{"audio": _audio(60 + i), "question": "What?", "choices": choices,
             "answer": ans, "task": cat}
            for i, (ans, cat) in enumerate([("rain", "sound"), ("B", "music"), ("0", "sound")])]
    got = mcq.MCQEvaluator(fn).evaluate(rows, verbose=False)
    want = jax_mcq.MCQEvaluator(fn).evaluate(rows, verbose=False)
    assert _untimed(list(got)) == _untimed(list(want))


# ---------------------------------------------------- vendor parsers and APIs


ASSEMBLYAI = {"status": "completed", "text": "hello world goodbye",
              "utterances": [{"speaker": "A", "start": 0, "end": 2100},
                             {"speaker": "B", "start": 2500, "end": 5000}],
              "words": [{"text": "hello", "start": 0, "end": 480},
                        {"text": "world", "start": 520, "end": 1000},
                        {"text": "goodbye", "start": 2500, "end": 3200}]}
DEEPGRAM = {"results": {
    "utterances": [{"speaker": 0, "start": 0.0, "end": 2.1},
                   {"speaker": 1, "start": 2.5, "end": 5.0}],
    "channels": [{"alternatives": [{"transcript": "hello world goodbye", "words": [
        {"word": "hello", "start": 0.0, "end": 0.48}, {"word": "world", "start": 0.52, "end": 1.0},
        {"word": "goodbye", "start": 2.5, "end": 3.2}]}]}]}}
ELEVENLABS = {"text": "hello world goodbye", "words": [
    {"text": "hello", "start": 0.0, "end": 0.48, "type": "word", "speaker_id": "s0"},
    {"text": " ", "start": 0.48, "end": 0.52, "type": "spacing", "speaker_id": "s0"},
    {"text": "world", "start": 0.52, "end": 1.0, "type": "word", "speaker_id": "s0"},
    {"text": "goodbye", "start": 2.5, "end": 3.2, "type": "word", "speaker_id": "s1"},
    {"text": "x", "type": "word"}]}


@pytest.mark.parametrize("response", [ASSEMBLYAI, DEEPGRAM, ELEVENLABS, {}])
def test_vendor_parsers_match_jax(response):
    for name in ("assemblyai", "deepgram", "elevenlabs"):
        for kind, ours, theirs in (("words", align_ev, jax_align_ev),
                                   ("segments", diar_ev, jax_diar_ev)):
            fn = f"{name}_{kind}"
            assert _outcome(getattr(ours, fn), response) == \
                _outcome(getattr(theirs, fn), response), fn


def test_backend_wiring_and_mocked_transports(monkeypatch):
    for var in diar_ev.API_KEY_ENV.values():
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="DEEPGRAM_API_KEY"):
        diar_ev.make_diarization_evaluator("deepgram")
    with pytest.raises(ValueError, match="unsupported diarization"):
        diar_ev.make_diarization_evaluator("bogus")
    with pytest.raises(ValueError, match="unsupported alignment"):
        align_ev.make_alignment_evaluator("endpoint")
    for cls in (asr_ev.AssemblyAIEvaluator, asr_ev.AssemblyAIStreamingEvaluator,
                asr_ev.DeepgramEvaluator, asr_ev.ElevenLabsEvaluator):
        with pytest.raises(RuntimeError, match="API_KEY"):
            cls()
    assert sorted(asr_ev.BACKENDS) == sorted(__import__(
        "tiny_audio_tpu.eval.evaluators.asr", fromlist=["BACKENDS"]).BACKENDS)

    monkeypatch.setenv("DEEPGRAM_API_KEY", "k")
    monkeypatch.setenv("ASSEMBLYAI_API_KEY", "k")
    monkeypatch.setattr(api, "deepgram_transcribe", lambda wav, key, **kw: DEEPGRAM)
    monkeypatch.setattr(api, "assemblyai_transcribe", lambda wav, key, **kw: ASSEMBLYAI)
    monkeypatch.setattr(jax_api, "deepgram_transcribe", lambda wav, key, **kw: DEEPGRAM)
    monkeypatch.setattr(jax_api, "assemblyai_transcribe", lambda wav, key, **kw: ASSEMBLYAI)
    rows = [{"audio": {"array": np.zeros(16000 * 5, np.float32), "sampling_rate": 16000},
             "speakers": [{"speaker": "X", "start": 0.0, "end": 2.1},
                          {"speaker": "Y", "start": 2.5, "end": 5.0}],
             "words": [{"word": "hello", "start": 0.0, "end": 0.5},
                       {"word": "world", "start": 0.5, "end": 1.0},
                       {"word": "goodbye", "start": 2.5, "end": 3.2}]}]
    ev = diar_ev.make_diarization_evaluator("deepgram")
    got = ev.evaluate(rows, verbose=False)
    want = jax_diar_ev.make_diarization_evaluator("deepgram").evaluate(rows, verbose=False)
    assert ev.model_name == "deepgram-diarization" and _untimed(list(got)) == _untimed(list(want))
    assert got[1]["corpus_der"] < 1.0 and got[1]["errors"] == 0
    got = align_ev.make_alignment_evaluator("assemblyai").evaluate(rows, verbose=False)
    want = jax_align_ev.make_alignment_evaluator("assemblyai").evaluate(rows, verbose=False)
    assert _untimed(list(got)) == _untimed(list(want)) and got[1]["match_rate"] == 1.0
    wav = api.audio_to_wav_bytes(rows[0]["audio"])
    assert wav == jax_api.audio_to_wav_bytes(rows[0]["audio"]) and wav[:4] == b"RIFF"


class _Resp:
    def __init__(self, payload, status=200):
        self._payload, self.status_code = payload, status

    def json(self):
        return self._payload

    def raise_for_status(self):
        if self.status_code >= 400:
            raise RuntimeError(f"http {self.status_code}")


def _fake_requests(monkeypatch, posts, get_payload):
    calls = iter(posts)
    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(
        post=lambda *a, **k: next(calls), get=lambda *a, **k: _Resp(get_payload)))


def test_assemblyai_transport_submit_error_and_poll_deadline(monkeypatch):
    _fake_requests(monkeypatch, [_Resp({"upload_url": "u"}), _Resp({"error": "bad"}, 400)], {})
    with pytest.raises(RuntimeError, match="http 400"):
        api.assemblyai_transcribe(b"RIFF", "key")
    _fake_requests(monkeypatch, [_Resp({"upload_url": "u"}), _Resp({"id": "j1"})],
                   {"id": "j1", "status": "processing"})
    with pytest.raises(TimeoutError, match="j1"):
        api.assemblyai_transcribe(b"RIFF", "key", poll_s=0.01, poll_timeout_s=0.05)
    _fake_requests(monkeypatch, [_Resp({"upload_url": "u"}), _Resp({"id": "j2"})],
                   {"id": "j2", "status": "completed", "text": "done"})
    assert api.assemblyai_transcribe(b"RIFF", "key")["text"] == "done"
    _fake_requests(monkeypatch, [_Resp(DEEPGRAM), _Resp(ELEVENLABS)], {})
    assert api.deepgram_transcribe(b"RIFF", "key", diarize=True) == DEEPGRAM
    assert api.elevenlabs_transcribe(b"RIFF", "key", diarize=True) == ELEVENLABS
    with pytest.raises(RuntimeError, match="NOPE_KEY not set"):
        api.require_key("NOPE_KEY")


# ------------------------------------------------------------------- datasets


def test_registry_matches_jax():
    assert datasets.DATASET_REGISTRY.keys() == jax_datasets.DATASET_REGISTRY.keys()
    for name, cfg in datasets.DATASET_REGISTRY.items():
        assert vars(cfg) == vars(jax_datasets.DATASET_REGISTRY[name]), name
    assert datasets.ALL_GROUPS == jax_datasets.ALL_GROUPS
    names = ["all", "synthetic", "synthetic-diarization", "mmau"]
    assert datasets.validate_datasets(names) == jax_datasets.validate_datasets(names)
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.validate_datasets(["nope"])


@pytest.mark.parametrize("name,n", [("synthetic", 3), ("synthetic-alignment", 3),
                                    ("synthetic-diarization", 11)])
def test_synthetic_rows_match_jax(name, n):
    got = datasets.load_eval_dataset(name, num_samples=n, seed=1)
    want = jax_datasets.load_eval_dataset(name, num_samples=n, seed=1)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["audio"]["array"], w["audio"]["array"])
        assert {k: v for k, v in g.items() if k != "audio"} == \
            {k: v for k, v in w.items() if k != "audio"}


def test_load_from_disk_directory(tmp_path):
    hfd = pytest.importorskip("datasets")
    rows = {"audio": [{"array": _audio(i)["array"].tolist(), "sampling_rate": 16000}
                      for i in range(3)],
            "text": ["one", "two", "three"]}
    hfd.DatasetDict({"test": hfd.Dataset.from_dict(rows)}).save_to_disk(str(tmp_path / "d"))
    cfg = datasets.DatasetConfig("local", str(tmp_path / "d"))
    got = datasets.load_eval_dataset(cfg, num_samples=2)
    want = jax_datasets.load_eval_dataset(jax_datasets.DatasetConfig("local", str(tmp_path / "d")),
                                          num_samples=2)
    assert [r["text"] for r in got] == [r["text"] for r in want] == ["one", "two"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g["audio"]["array"]),
                                      np.asarray(w["audio"]["array"]))


# ------------------------------------------------------------------- run_eval


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 8
    JaxASRModel(cfg, seed=0).save_pretrained(path)
    return str(path)


@pytest.fixture()
def fresh_towers(monkeypatch):
    """No aligner weights (uniform word spread) and the synthetic ECAPA tier
    in both packages."""
    monkeypatch.setattr(jax_alignment.ForcedAligner, "_params", None)
    monkeypatch.setattr(alignment.ForcedAligner, "_tree", None)
    monkeypatch.setattr(jax_diarization.EcapaEmbedder, "_instance",
                        jax_diarization.EcapaEmbedder.from_synthetic())
    monkeypatch.setattr(diarization.EcapaEmbedder, "_instances", {})


@pytest.mark.parametrize("backend", ["local", "local-streaming", "realtime"])
def test_run_eval_asr_backends_match_jax(checkpoint, tmp_path, backend):
    got = cli.run_eval(checkpoint, "synthetic", num_samples=2, backend=backend,
                       output_dir=str(tmp_path / "port"), device="cpu")
    want = jax_cli.run_eval(checkpoint, "synthetic", num_samples=2, backend=backend,
                            output_dir=str(tmp_path / "jax"))
    assert _untimed(got) == _untimed(want) and got["num_samples"] == 2
    assert ("turns_avg" in got) == (backend == "realtime")


MCQ_ROWS = [{"audio": _audio(70 + i), "question": "Which sound?",
             "choices": ["rain", "a dog", "wind"], "answer": a, "task": t}
            for i, (a, t) in enumerate([("rain", "nature"), ("B", "animals")])]
CLS_ROWS = [{"audio": _audio(80 + i), "label": lab} for i, lab in enumerate(["happy", "sad"])]


@pytest.mark.parametrize("name", ["synthetic-diarization", "synthetic-alignment", "test-mcq",
                                  "test-classification"])
def test_run_eval_every_dataset_type_matches_jax(checkpoint, tmp_path, monkeypatch, fresh_towers,
                                                 name):
    extra = {"test-mcq": (jax_datasets.DatasetConfig(
                 "test-mcq", "local-rows", dataset_type="mcq", text_column="question",
                 extra={"choices_column": "choices", "answer_column": "answer",
                        "category_column": "task"}), MCQ_ROWS),
             "test-classification": (jax_datasets.DatasetConfig(
                 "test-classification", "local-rows", dataset_type="classification",
                 extra={"task": "emotion", "label_column": "label"}), CLS_ROWS)}
    if name in extra:
        cfg, rows = extra[name]
        port_cfg = datasets.DatasetConfig(**vars(cfg))
        monkeypatch.setitem(jax_datasets.DATASET_REGISTRY, name, cfg)
        monkeypatch.setitem(datasets.DATASET_REGISTRY, name, port_cfg)
        monkeypatch.setattr(jax_cli, "load_eval_dataset", lambda c, num_samples=None: rows)
        monkeypatch.setattr(cli, "load_eval_dataset", lambda c, num_samples=None: rows)
    n = 1 if name == "synthetic-diarization" else 2
    got = cli.run_eval(checkpoint, name, num_samples=n, output_dir=str(tmp_path / "port"),
                       device="cpu")
    want = jax_cli.run_eval(checkpoint, name, num_samples=n, output_dir=str(tmp_path / "jax"))
    _assert_same(_untimed(got), _untimed(want))
    assert got["num_samples"] == n
    port_files = sorted(p.name for p in (tmp_path / "port").glob("*/*"))
    assert port_files == sorted(p.name for p in (tmp_path / "jax").glob("*/*"))


def test_main_writes_jax_result_files(checkpoint, tmp_path):
    assert cli.main(["-m", checkpoint, "-d", "synthetic", "-n", "2", "--device", "cpu",
                     "--output-dir", str(tmp_path / "port")]) == 0
    assert jax_cli.main(["-m", checkpoint, "-d", "synthetic", "-n", "2",
                         "--output-dir", str(tmp_path / "jax")]) == 0
    (got,), (want,) = (list((tmp_path / d).iterdir()) for d in ("port", "jax"))
    assert got.name.split("_", 2)[2] == want.name.split("_", 2)[2]
    assert (got / "results.txt").read_text() == (want / "results.txt").read_text()

    def metrics(d):
        lines = (d / "metrics.txt").read_text().splitlines()
        return [ln for ln in lines if not ln.startswith(("Timestamp", "avg_time_s"))]

    assert metrics(got) == metrics(want)
    with pytest.raises(SystemExit):
        cli.main(["-m", checkpoint, "-d", "synthetic", "--backend", "nope"])


# ------------------------------------------------------------- bench_quality


def test_bench_quality_matches_the_jax_script(fresh_towers):
    from tiny_audio_tpu_torch.tools import bench_quality

    spec = importlib.util.spec_from_file_location("jax_bench_quality",
                                                  REPO / "scripts" / "bench_quality.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert bench_quality.bench_alignment(6, device="cpu") == script.bench_alignment(6)
    got = bench_quality.bench_diarization(1, device="cpu")
    want = script.bench_diarization(1)
    assert _untimed(got) == _untimed(want) and got["ecapa_tier"] == "synthetic"
    assert got["vad_trained"] and got["per_condition_der"].keys() == {"clean-2spk"}


# --------------------------------------------------------------------- pipecat


@pytest.fixture()
def stub_pipecat(monkeypatch):
    """A ``pipecat`` package with the five names the adapter imports."""
    frames = types.ModuleType("pipecat.frames.frames")

    class Frame:
        def __init__(self, text="", user_id="", timestamp=""):
            self.text, self.user_id, self.timestamp = text, user_id, timestamp

    for name in ("ErrorFrame", "InterimTranscriptionFrame", "TranscriptionFrame"):
        setattr(frames, name, type(name, (Frame,), {}))
    frames.Frame = Frame
    stt = types.ModuleType("pipecat.services.stt_service")

    class SegmentedSTTService:
        def __init__(self, sample_rate=16000, **kwargs):
            self.sample_rate = sample_rate

    stt.SegmentedSTTService = SegmentedSTTService
    clock = types.ModuleType("pipecat.utils.time")
    clock.time_now_iso8601 = lambda: "2026-01-01T00:00:00Z"
    for name, mod in (("pipecat", types.ModuleType("pipecat")),
                      ("pipecat.frames", types.ModuleType("pipecat.frames")),
                      ("pipecat.frames.frames", frames),
                      ("pipecat.services", types.ModuleType("pipecat.services")),
                      ("pipecat.services.stt_service", stt),
                      ("pipecat.utils", types.ModuleType("pipecat.utils")),
                      ("pipecat.utils.time", clock)):
        monkeypatch.setitem(sys.modules, name, mod)
    import tiny_audio_tpu.integrations.pipecat_stt as jax_adapter
    import tiny_audio_tpu_torch.integrations.pipecat_stt as adapter

    yield importlib.reload(adapter), importlib.reload(jax_adapter)
    monkeypatch.undo()
    importlib.reload(adapter)
    importlib.reload(jax_adapter)


def _frames(service, audio: bytes):
    async def collect():
        return [f async for f in service.run_stt(audio)]

    return [(type(f).__name__, f.text) for f in asyncio.run(collect())]


def test_pipecat_service_under_a_stub(stub_pipecat, checkpoint):
    adapter, jax_adapter = stub_pipecat
    assert adapter._HAVE_PIPECAT
    audio = (_audio(90, 1.0)["array"] * 32767).astype("<i2").tobytes()
    np.testing.assert_array_equal(adapter.pcm16_to_float32(audio),
                                  jax_adapter.pcm16_to_float32(audio))
    streamed = _frames(adapter.TinyAudioSTTService(model_path=checkpoint, device="cpu"), audio)
    assert streamed == _frames(jax_adapter.TinyAudioSTTService(model_path=checkpoint), audio)
    kinds = [k for k, _ in streamed]
    assert kinds[-1] in ("TranscriptionFrame", "InterimTranscriptionFrame") and \
        set(kinds) <= {"InterimTranscriptionFrame", "TranscriptionFrame"}
    service = adapter.TinyAudioSTTService(model_path=checkpoint, streaming=False, device="cpu")
    final = _frames(service, audio)
    text = service._pipe(adapter.pcm16_to_float32(audio))["text"]
    assert final == ([("TranscriptionFrame", text)] if text else [])


def test_pipecat_service_without_pipecat():
    from tiny_audio_tpu_torch.integrations import pipecat_stt

    if pipecat_stt._HAVE_PIPECAT:
        pytest.skip("pipecat-ai is installed")
    with pytest.raises(ImportError, match="pipecat-ai"):
        pipecat_stt.TinyAudioSTTService(model_path="unused", device="cpu")
