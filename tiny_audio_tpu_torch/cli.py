"""The port's ``ta`` CLI: transcribe / train / serve / realtime / eval /
analysis / debug / doctor / dev.

Port of :mod:`tiny_audio_tpu.cli` on argparse.  Run as ``python -m
tiny_audio_tpu_torch.cli <command> ...`` or through the ``ta-torch``
console script.  Every command that touches a model takes ``--device``,
the card unless ``cpu`` is asked for.  The JAX CLI's ``tpu-vm``, ``demo``
and ``push`` (remote TPU operations, Gradio, an upload) are not part of
the port.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent
_DEVICE_HELP = "where the model runs: the card unless 'cpu' is asked for"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ta-torch",
        description="tiny-audio-tpu on PyTorch + CUDA: speech-LLM toolkit for one H100")
    sub = parser.add_subparsers(dest="command", required=True)

    from tiny_audio_tpu_torch.analysis import add_analysis_parser
    from tiny_audio_tpu_torch.debug import add_debug_parser
    from tiny_audio_tpu_torch.eval.cli import add_eval_parser

    add_eval_parser(sub)
    add_analysis_parser(sub)

    # one-shot transcription (the reference's `pipeline(...)(file)` usage)
    tx = sub.add_parser("transcribe", help="Transcribe audio file(s)")
    tx.add_argument("-m", "--model", required=True, help="checkpoint dir")
    tx.add_argument("files", nargs="+", help="wav file path(s)")
    tx.add_argument("--timestamps", action="store_true", help="word-level timestamps")
    tx.add_argument("--speakers", action="store_true", help="diarization")
    tx.add_argument("--confidence", action="store_true",
                    help="per-utterance confidence (mean token probability)")
    tx.add_argument("--srt", action="store_true",
                    help="print SubRip subtitles (implies --timestamps)")
    tx.add_argument("--vtt", action="store_true",
                    help="print WebVTT subtitles (implies --timestamps)")
    tx.add_argument("--prompt", default=None, help="custom user prompt")
    tx.add_argument("--json", action="store_true", dest="as_json",
                    help="print full result dicts as JSON lines")
    tx.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    tx.set_defaults(func=_cmd_transcribe)

    tr = sub.add_parser("train", help="Train (hydra-style overrides)")
    tr.add_argument("overrides", nargs="*",
                    help="e.g. +experiments=smoke training.max_steps=20")
    tr.add_argument("--device", default=None,
                    help="run.device for the run (default: the config's, the card)")
    tr.set_defaults(func=_cmd_train)

    add_debug_parser(sub)

    srv = sub.add_parser("serve", help="HTTP transcription server")
    srv.add_argument("-m", "--model", required=True)
    srv.add_argument("--host", default="0.0.0.0")
    srv.add_argument("--port", type=int, default=8000)
    srv.add_argument("--no-warmup", action="store_true")
    srv.add_argument("--no-batching", action="store_true",
                     help="disable dynamic request coalescing")
    srv.add_argument("--max-batch", type=int, default=16)
    srv.add_argument("--max-wait-ms", type=float, default=20.0)
    srv.add_argument("--engine", choices=("dynamic", "continuous", "none"), default="dynamic",
                     help="short-clip batching: coalesced uniform batches (dynamic) or "
                          "decode slots that requests join and leave between decode "
                          "chunks (continuous); PERF.md has both measured on the card")
    srv.add_argument("--tp", type=int, default=1,
                     help="tensor-parallel degree (multi-GPU is not ported: above 1 raises)")
    srv.add_argument("--dp", type=int, default=None,
                     help="data-parallel degree (multi-GPU is not ported: above 1 raises)")
    srv.add_argument("--realtime-port", type=int, default=None,
                     help="also serve realtime websocket transcription on this port "
                          "(shares the card with HTTP traffic)")
    srv.add_argument("--wq-decode", action="store_true",
                     help="weight-only int8 decode products (kernel #6): half the weight "
                          "bytes per decode step, a small quantization trade; prefill "
                          "stays bf16")
    srv.add_argument("--w8a8-head", action="store_true",
                     help="int8 x int8 LM head for decode logits (kernel #5; a W8A8 "
                          "numerics trade; times in PERF.md)")
    srv.add_argument("--w8a8-decode", action="store_true",
                     help="W8A8 for every decode-step product, layers and head "
                          "(kernel #5; supersedes --wq-decode/--w8a8-head; times in "
                          "PERF.md)")
    srv.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    srv.set_defaults(func=_cmd_serve)

    rt = sub.add_parser("realtime", help="Realtime websocket transcription server (PCM16 in, "
                                         "VAD-endpointed Turn events out)")
    rt.add_argument("-m", "--model", required=True)
    rt.add_argument("--host", default="0.0.0.0")
    rt.add_argument("--port", type=int, default=8765)
    rt.add_argument("--no-warmup", action="store_true")
    rt.add_argument("--partial-every-s", type=float, default=1.0,
                    help="min seconds between partial transcripts per turn")
    rt.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    rt.set_defaults(func=_cmd_realtime)

    doc = sub.add_parser("doctor", help="Environment diagnostics (card, nvcc, kernels, native)")
    doc.add_argument("--timeout", type=float, default=None,
                     help="device probe timeout seconds (default 300)")
    doc.add_argument("--json", action="store_true", dest="as_json")
    doc.set_defaults(func=_cmd_doctor)

    dev = sub.add_parser("dev", help="Developer tasks on the port's package")
    dev.add_argument("task", choices=["test", "test-all", "lint", "format", "type-check",
                                      "coverage", "build-native", "security-scan",
                                      "docstrings", "dead-code", "precommit"])
    dev.set_defaults(func=_cmd_dev)
    return parser


def _cmd_train(args) -> int:
    from tiny_audio_tpu_torch.train.__main__ import main as train_main

    overrides = list(args.overrides)
    if args.device is not None:
        overrides.append(f"run.device={args.device}")
    train_main(overrides)
    return 0


def _cmd_serve(args) -> int:
    from tiny_audio_tpu_torch.serving import serve

    serve(args.model, host=args.host, port=args.port, warmup=not args.no_warmup,
          dynamic_batching=not args.no_batching, max_batch=args.max_batch,
          max_wait_ms=args.max_wait_ms, engine=args.engine, tp=args.tp, dp=args.dp,
          realtime_port=args.realtime_port, wq_decode=args.wq_decode,
          w8a8_head=args.w8a8_head, w8a8_decode=args.w8a8_decode, device=args.device)
    return 0


def _cmd_realtime(args) -> int:
    from tiny_audio_tpu_torch.realtime import serve_realtime

    serve_realtime(args.model, host=args.host, port=args.port, warmup=not args.no_warmup,
                   partial_every_s=args.partial_every_s, device=args.device)
    return 0


def _cmd_transcribe(args) -> int:
    import json

    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    pipe = ASRPipeline(ASRModel.from_pretrained(args.model, device=args.device))
    kwargs = {}
    if args.timestamps or args.srt or args.vtt:
        kwargs["return_timestamps"] = True
    if args.speakers:
        kwargs["return_speakers"] = True
    if args.confidence:
        kwargs["return_confidence"] = True
    if args.prompt:
        kwargs["user_prompt"] = args.prompt

    # Bulk path: plain-text transcription of many files coalesces short clips
    # into batched generate calls (one pass over the decoder weights for N
    # files); any per-file option keeps the one-at-a-time path below.
    if len(args.files) > 1 and set(kwargs) <= {"user_prompt"}:
        loaded = [pipe.extract_audio(p) for p in args.files]
        limit = int(pipe.MAX_CHUNK_SECONDS * 16000)
        texts: list = [None] * len(loaded)
        short = [i for i, a in enumerate(loaded) if len(a["array"]) <= limit]
        if short:
            for i, t in zip(short, pipe.transcribe_batch([loaded[i] for i in short], **kwargs)):
                texts[i] = t
        for i, a in enumerate(loaded):  # long-form files go solo
            if texts[i] is None:
                texts[i] = pipe(a, **kwargs)["text"]
        for path, t in zip(args.files, texts):
            # TSV cells stay one line; --json keeps the exact text
            print(json.dumps({"file": path, "text": t}) if args.as_json
                  else f"{path}\t{' '.join(t.split())}")
        return 0

    for path in args.files:
        result = pipe(path, **kwargs)
        if args.srt or args.vtt:
            from tiny_audio_tpu_torch.utils.subtitles import to_srt, to_vtt

            render = to_srt if args.srt else to_vtt
            if len(args.files) > 1:
                print(f"# {path}")
            print(render(result.get("words") or []))
        elif args.as_json:
            print(json.dumps({"file": path, **result}))
        elif len(args.files) > 1:
            print(f"{path}\t{' '.join(result['text'].split())}")
        else:
            print(result["text"])
    return 0


def _cmd_doctor(args) -> int:
    from tiny_audio_tpu_torch.doctor import main as doctor_main

    return doctor_main(probe_timeout_s=args.timeout, as_json=args.as_json)


def _port_tests() -> list[str]:
    return sorted(f"tests/{p.name}" for p in (REPO / "tests").glob("test_torch_*.py"))


def _cmd_dev(args) -> int:
    if args.task == "test-all":
        # the port's test files in four shards, one pytest process each
        files = _port_tests()
        n_shards = 4
        for i in range(n_shards):
            shard = files[i::n_shards]
            print(f"[dev] test shard {i + 1}/{n_shards}: {len(shard)} files")
            rc = subprocess.call([sys.executable, "-m", "pytest", "-x", "-q", *shard], cwd=REPO)
            if rc != 0:
                return rc
        return 0
    if args.task == "build-native":
        from tiny_audio_tpu_torch import native

        try:
            print(f"built {native.build()}")
        except (OSError, subprocess.SubprocessError) as e:
            print(f"native build failed: {e}", file=sys.stderr)
            return 1
        return 0

    pkg = str(PACKAGE)
    if args.task == "security-scan":
        from tiny_audio_tpu_torch.devtools import security_scan

        findings = security_scan([pkg])
        for f in findings:
            print(f)
        print(f"{len(findings)} security finding(s)")
        return 1 if findings else 0
    if args.task == "docstrings":
        from tiny_audio_tpu_torch.devtools import docstring_coverage

        pct, missing = docstring_coverage([pkg])
        for f in missing[:40]:
            print(f)
        print(f"docstring coverage: {pct:.1f}% (fail-under 50)")
        return 1 if pct < 50.0 else 0
    if args.task == "dead-code":
        from tiny_audio_tpu_torch.devtools import dead_code

        findings = dead_code([pkg])
        for f in findings:
            print(f)
        print(f"{len(findings)} candidate(s) - heuristic, verify before deleting")
        return 0  # advisory
    cmds = {
        "test": [sys.executable, "-m", "pytest", *_port_tests(), "-x", "-q", "-m", "not slow"],
        "lint": [sys.executable, "-m", "ruff", "check", pkg],
        "format": [sys.executable, "-m", "ruff", "format", pkg],
        "type-check": [sys.executable, "-m", "mypy", pkg, "--ignore-missing-imports"],
        "coverage": [sys.executable, "-m", "pytest", *_port_tests(), "-q",
                     "--cov=tiny_audio_tpu_torch"],
    }
    if args.task == "precommit":
        # format -> lint -> security -> docstrings -> fast tests, stopping at
        # the first failure
        for task in ("format", "lint"):
            rc = subprocess.call(cmds[task], cwd=REPO)
            if rc != 0:
                return rc
        for task in ("security-scan", "docstrings", "test"):
            rc = _cmd_dev(argparse.Namespace(task=task))
            if rc != 0:
                return rc
        return 0
    try:
        return subprocess.call(cmds[args.task], cwd=REPO)
    except FileNotFoundError as e:
        print(f"tool unavailable: {e}", file=sys.stderr)
        return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
