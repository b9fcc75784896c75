"""The port's ``ta`` CLI against the JAX package's, on the CPU.

``tiny_audio_tpu_torch.cli.main`` with ``--device cpu`` on a checkpoint the
JAX package saved: ``transcribe`` (one file, the bulk path that coalesces
short files into ``transcribe_batch``, ``--json``, ``--srt``/``--vtt``,
``--confidence``, ``--prompt``, ``--speakers``) prints what JAX's
``cli.main`` prints; ``debug``'s reports (router health, gradient flow,
weights, LoRA, drift) equal JAX's within 1e-5 relative; the analysis
commands print JAX's lines; ``doctor`` reports the missing card and exits
nonzero; ``dev`` runs its analyzers on the port's package; ``train``,
``serve`` and ``realtime`` reach the port's entry points with JAX's flags;
and no help text carries a TPU figure.
"""

import argparse
import io
import json
import re
import wave
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from tiny_audio_tpu import alignment as jax_alignment
from tiny_audio_tpu import cli as jax_cli
from tiny_audio_tpu import debug as jax_debug
from tiny_audio_tpu import diarization as jax_diarization
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu_torch import alignment, cli, debug, diarization
from tiny_audio_tpu_torch.bridge import state_dict_to_jax
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.pipeline import ASRPipeline

torch.set_num_threads(1)


def _write_wav(path, audio):
    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny fp32 checkpoint saved by the JAX package, and wav files:
    three of equal length (a batch is token-exact against solo decodes only
    at equal lengths) and a longer one."""
    root = tmp_path_factory.mktemp("cli")
    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 16
    JaxASRModel(cfg, seed=2).save_pretrained(str(root / "ckpt"))  # a draw that prints text
    rng = np.random.default_rng(0)
    wavs = [_write_wav(root / f"f{i}.wav", rng.standard_normal(8000) * 0.1) for i in range(3)]
    t = np.arange(24000) / 16000
    tone = 0.3 * np.sin(2 * np.pi * 180 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)
    wavs.append(_write_wav(root / "long.wav", tone + 0.01 * rng.standard_normal(t.shape)))
    return str(root / "ckpt"), wavs


@pytest.fixture()
def pinned_towers(monkeypatch):
    """Both packages without aligner weights (uniform word spread) and with
    the synthetic ECAPA tier, whatever another test file attached."""
    monkeypatch.setattr(jax_alignment.ForcedAligner, "_params", None)
    monkeypatch.setattr(alignment.ForcedAligner, "_tree", None)
    monkeypatch.setattr(jax_diarization.EcapaEmbedder, "_instance",
                        jax_diarization.EcapaEmbedder.from_synthetic())
    monkeypatch.setattr(diarization.EcapaEmbedder, "_instances", {})


def _run(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _close(got, want, rtol=1e-5):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (got, want)
        for k in want:
            _close(got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (got, want)
        for a, b in zip(got, want):
            _close(a, b, rtol)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=rtol, abs=1e-12), (got, want)
    else:
        assert got == want, (got, want)


_TRANSCRIBE = {
    "one": (["f0"], []),
    "bulk": (["f0", "f1", "f2"], []),
    "bulk_json": (["f0", "f1", "f2"], ["--json"]),
    "bulk_prompt": (["f0", "f1", "long"], ["--prompt", "Write it down"]),
    "json": (["f1"], ["--json", "--timestamps", "--confidence"]),
    "speakers": (["long"], ["--json", "--speakers"]),
    "srt": (["long"], ["--srt"]),
    "vtt": (["f0", "long"], ["--vtt", "--timestamps"]),
    "tsv_options": (["f0", "f2"], ["--confidence"]),
}


@pytest.mark.parametrize("case", sorted(_TRANSCRIBE))
def test_transcribe_prints_jaxs(checkpoint, pinned_towers, case):
    ckpt, wavs = checkpoint
    by_name = {"f0": wavs[0], "f1": wavs[1], "f2": wavs[2], "long": wavs[3]}
    names, flags = _TRANSCRIBE[case]
    argv = ["transcribe", "-m", ckpt, *[by_name[n] for n in names], *flags]
    rc, ours = _run(cli.main, [*argv, "--device", "cpu"])
    jax_rc, theirs = _run(jax_cli.main, argv)
    assert rc == jax_rc == 0
    if "--json" in flags:
        got = [json.loads(line) for line in ours.splitlines()]
        want = [json.loads(line) for line in theirs.splitlines()]
        _close(got, want)
        assert [r["file"] for r in got] == [by_name[n] for n in names]
    else:
        assert ours == theirs
    assert ours.strip()


def test_bulk_transcribe_is_transcribe_batch(checkpoint):
    ckpt, wavs = checkpoint
    rc, out = _run(cli.main, ["transcribe", "-m", ckpt, *wavs[:3], "--json", "--device", "cpu"])
    records = [json.loads(line) for line in out.splitlines()]
    pipe = ASRPipeline(ASRModel.from_pretrained(ckpt, device="cpu"))
    assert rc == 0 and [r["text"] for r in records] == pipe.transcribe_batch(wavs[:3])


# ------------------------------------------------------------------ debug


def _models(ckpt_dir, seed=3, **overrides):
    cfg = tiny_test_config(model_dtype="float32", **overrides)
    jm = JaxASRModel(cfg, seed=seed)
    jm.save_pretrained(str(ckpt_dir))
    return jm, ASRModel.from_pretrained(ckpt_dir, device="cpu")


@pytest.mark.parametrize("overrides", [
    {},
    {"use_lora": True, "lora_rank": 4, "lora_alpha": 8},
    {"freeze_language_model": False, "projector_type": "mosa"},
    {"freeze_projector": True, "use_lora": True, "lora_rank": 4, "lora_alpha": 8},
])
def test_gradient_flow_report_is_jaxs(tmp_path, overrides):
    jm, tm = _models(tmp_path / "ckpt", **overrides)
    flags = {n: p.requires_grad for n, p in tm.named_parameters()}
    got, want = debug.check_gradient_flow(tm), jax_debug.check_gradient_flow(jm)
    _close(got, want)
    assert set(got["module_grad_norms"]) == {"encoder", "decoder", "projector"}
    assert got["module_grad_norms"]["encoder"] == 0.0
    assert got["ok"] and got["module_grad_norms"]["projector"] > 0
    # the model's own flags come back, and no gradient is left behind
    assert {n: p.requires_grad for n, p in tm.named_parameters()} == flags
    assert all(p.grad is None for p in tm.parameters())


@pytest.mark.parametrize("ptype", ["moe", "mosa"])
def test_router_health_is_jaxs(tmp_path, ptype):
    jm, tm = _models(tmp_path / "ckpt", projector_type=ptype)
    got, want = debug.check_router_health(tm), jax_debug.check_router_health(jm)
    _close(got, want)
    with pytest.raises(ValueError, match="moe/mosa"):
        debug.check_router_health(_models(tmp_path / "mlp")[1])
    # the hook point changes no output
    x = torch.randn(1, 12, tm.config.encoder_dim)
    with torch.no_grad():
        before, _ = tm.projector(x)
        hook = tm.projector.router_probs.register_forward_hook(lambda *a: None)
        after, _ = tm.projector(x)
        hook.remove()
    assert torch.equal(before, after)


def test_weight_reports_are_jaxs(tmp_path):
    jm, tm = _models(tmp_path / "a", use_lora=True, lora_rank=4, lora_alpha=8)
    jm2, tm2 = _models(tmp_path / "b", use_lora=True, lora_rank=4, lora_alpha=8)
    # a trained-looking adapter: B no longer zero
    with torch.no_grad():
        for name, p in tm.decoder.named_parameters():
            if name.endswith("q_proj_lora_b"):
                p.add_(0.01)
    tree, tree2 = state_dict_to_jax(tm), state_dict_to_jax(tm2)
    jtree = jax.tree.map(np.asarray, jm.params)
    jtree = {**jtree, "decoder": {**jtree["decoder"]}}
    jtree["decoder"]["layers"] = {**jtree["decoder"]["layers"], "q_proj_lora_b": np.asarray(
        tree["decoder"]["layers"]["q_proj_lora_b"])}
    _close(debug.analyze_weights(tree), jax_debug.analyze_weights(jtree))
    _close(debug.analyze_lora(tree), jax_debug.analyze_lora(jtree))
    _close(debug.compare_to_base(tree2, tree), jax_debug.compare_to_base(
        jax.tree.map(np.asarray, jm2.params), jtree))
    assert debug.analyze_lora(tree)["layers/q_proj"]["b_is_zero"] is False


@pytest.mark.parametrize("command", ["check-gradient-flow", "analyze-weights", "analyze-lora",
                                     "compare-to-base", "check-moe"])
def test_debug_commands_run(tmp_path, command):
    lora = {"use_lora": True, "lora_rank": 4, "lora_alpha": 8}
    _models(tmp_path / "ckpt", projector_type="moe", **lora)
    argv = ["debug", command, "-m", str(tmp_path / "ckpt"), "--device", "cpu"]
    if command == "compare-to-base":
        _models(tmp_path / "base", seed=4, projector_type="moe", **lora)
        argv += ["-b", str(tmp_path / "base")]
    rc, out = _run(cli.main, argv)
    assert rc in (0, 1) and out.strip()
    if command == "check-gradient-flow":
        assert rc == 0 and "ok: True" in out
    if command == "check-moe":
        assert out.strip().splitlines()[-1] in ("HEALTHY", "UNHEALTHY")


# --------------------------------------------------------------- analysis


def test_analysis_commands_print_jaxs(tmp_path):
    rows = [("the cat sat", "the cat sat", 0.0), ("pay $5 at 8 am", "pay five", 60.0),
            ("ten percent", "", 100.0)]
    blocks = [f"Sample {i} - WER: {w:.2f}%\nGround Truth: {g}\nPrediction: {p}\n"
              for i, (g, p, w) in enumerate(rows)]
    results = tmp_path / "results.txt"
    results.write_text(("-" * 80 + "\n").join(blocks))
    for argv in (["high-wer", str(results), "--threshold", "50"],
                 ["entity-errors", str(results)], ["extract-entities", str(results)],
                 ["compare", str(results), str(results)]):
        ours, theirs = _run(cli.main, ["analysis", *argv]), _run(jax_cli.main, ["analysis", *argv])
        assert ours == theirs and ours[1].strip()


# ------------------------------------------------------- doctor and dev


def test_doctor_reports_the_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out = _run(cli.main, ["doctor", "--json", "--timeout", "300"])
    report = json.loads(out)
    assert rc == 2 and report["status"] == "unreachable"
    assert report["device"]["ok"] is False and "no CUDA device" in report["device"]["error"]
    assert set(report) == {"versions", "device", "nvcc", "kernels", "native_audio", "status"}
    assert report["kernels"]["dir"].split("/")[-2] == "kernels"
    rc, out = _run(cli.main, ["doctor", "--timeout", "300"])
    assert rc == 2 and "status   : unreachable" in out


@pytest.mark.parametrize("task,rc,tail", [("security-scan", 0, "0 security finding(s)"),
                                          ("docstrings", 0, "(fail-under 50)"),
                                          ("dead-code", 0, "verify before deleting")])
def test_dev_analyzers_scan_the_port(task, rc, tail):
    got_rc, out = _run(cli.main, ["dev", task])
    assert got_rc == rc and out.strip().splitlines()[-1].endswith(tail)
    if task != "security-scan":  # findings name the scanned files
        assert "tiny_audio_tpu_torch/" in out and "tiny_audio_tpu/" not in out


# -------------------------------------------------- the other entry points


def test_train_serve_and_realtime_reach_the_ports_entry_points(monkeypatch):
    from tiny_audio_tpu import realtime as jax_realtime
    from tiny_audio_tpu import serving as jax_serving
    from tiny_audio_tpu_torch import realtime, serving
    from tiny_audio_tpu_torch.train import __main__ as train_main

    seen = {"train": []}
    monkeypatch.setattr(train_main, "main", lambda argv: seen["train"].append(argv))
    assert cli.main(["train", "+experiments=smoke", "training.max_steps=2",
                     "--device", "cpu"]) == 0
    assert cli.main(["train", "+experiments=smoke"]) == 0
    assert seen["train"] == [["+experiments=smoke", "training.max_steps=2", "run.device=cpu"],
                             ["+experiments=smoke"]]

    for ours, theirs, name in ((serving, jax_serving, "serve"),
                               (realtime, jax_realtime, "serve_realtime")):
        monkeypatch.setattr(ours, name, lambda *a, _n=name, **k: seen.setdefault(_n, (a, k)))
        monkeypatch.setattr(theirs, name,
                            lambda *a, _n=name, **k: seen.setdefault("jax_" + _n, (a, k)))
    flags = ["-m", "ckpt", "--port", "9", "--no-warmup", "--max-batch", "4", "--engine",
             "continuous", "--w8a8-decode", "--realtime-port", "7"]
    assert cli.main(["serve", *flags, "--device", "cpu"]) == 0
    assert jax_cli.main(["serve", *flags]) == 0
    args, kwargs = seen["serve"]
    assert args == seen["jax_serve"][0] and kwargs == {**seen["jax_serve"][1], "device": "cpu"}
    flags = ["-m", "ckpt", "--port", "5", "--partial-every-s", "0.5"]
    assert cli.main(["realtime", *flags, "--device", "cpu"]) == 0
    assert jax_cli.main(["realtime", *flags]) == 0
    args, kwargs = seen["serve_realtime"]
    assert kwargs == {**seen["jax_serve_realtime"][1], "device": "cpu"}


def _help_texts(parser: argparse.ArgumentParser):
    yield parser.description or ""
    for action in parser._actions:
        yield action.help or ""
        if isinstance(action, argparse._SubParsersAction):
            for choice in action._choices_actions:
                yield choice.help or ""
            for sub in action.choices.values():
                yield from _help_texts(sub)


def test_commands_and_help_texts():
    """JAX's commands less ``tpu-vm``, ``demo`` and ``push``; ``--device``
    wherever a model is touched; no TPU figure in any help text."""
    def commands(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return sub.choices

    ours, theirs = commands(cli.build_parser()), commands(jax_cli.build_parser())
    assert set(ours) == set(theirs) - {"tpu-vm", "demo", "push"}
    for name in ("transcribe", "serve", "realtime", "eval", "train"):
        assert "--device" in ours[name]._option_string_actions, name
    for name, sub in commands(ours["debug"]).items():
        assert "--device" in sub._option_string_actions, name
    for name in ("serve", "realtime", "transcribe", "doctor"):
        assert set(theirs[name]._option_string_actions) <= \
            set(ours[name]._option_string_actions), name
    for text in _help_texts(cli.build_parser()):
        assert "TPU" not in text and "faster" not in text, text
        assert not re.search(r"\d\s*%|\bp50\b|\d\s*s vs", text), text
