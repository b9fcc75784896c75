"""Eval CLI: dispatch by dataset type x backend, timestamped result writers.

Port of :mod:`tiny_audio_tpu.eval.cli`::

    python -m tiny_audio_tpu_torch.eval.cli -m <checkpoint> -d <dataset> \\
        [-n N] [--backend local] [--device cuda]

dispatches by the dataset's type (ASR / diarization / alignment / MCQ /
classification) and the chosen backend, and writes ``results.txt`` (ASR) or
``results.jsonl`` and ``metrics.txt`` into a timestamped directory under
``--output-dir``, in the JAX package's format.  The local backends run on
``--device`` (the card unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

from tiny_audio_tpu_torch.eval.datasets import (
    DATASET_REGISTRY,
    load_eval_dataset,
    validate_datasets,
)


def _result_dir(
    output_dir: str, model_name: str, dataset_name: str, suffix: str = ""
) -> Path:
    ts = datetime.now(timezone.utc).strftime("%Y%m%d_%H%M%S")
    safe = model_name.replace("/", "_")
    d = Path(output_dir) / f"{ts}_{safe}_{dataset_name}{suffix}"
    d.mkdir(parents=True, exist_ok=True)
    return d


def save_asr_results(
    model_name: str, dataset_name: str, results, metrics: dict,
    output_dir: str = "outputs",
) -> Path:
    """results.txt + metrics.txt: per sample its WER, normalized ground
    truth and prediction."""
    from tiny_audio_tpu_torch.eval.normalizer import TextNormalizer

    normalizer = TextNormalizer()
    out = _result_dir(output_dir, model_name, dataset_name)
    with (out / "results.txt").open("w") as f:
        for i, r in enumerate(results, 1):
            f.write(f"Sample {i} - WER: {r.wer:.2f}%\n")
            f.write(f"Ground Truth: {normalizer.normalize(r.reference)}\n")
            f.write(f"Prediction: {normalizer.normalize(r.prediction)}\n")
            f.write("-" * 80 + "\n")
    _write_metrics(out, model_name, dataset_name, metrics)
    return out


def save_generic_results(
    model_name: str, dataset_name: str, rows: list, metrics: dict,
    output_dir: str = "outputs", suffix: str = "",
) -> Path:
    import json

    out = _result_dir(output_dir, model_name, dataset_name, suffix)
    with (out / "results.jsonl").open("w") as f:
        for row in rows:
            f.write(json.dumps(row, default=str) + "\n")
    _write_metrics(out, model_name, dataset_name, metrics)
    return out


def _write_metrics(out: Path, model_name: str, dataset_name: str, metrics: dict):
    with (out / "metrics.txt").open("w") as f:
        f.write(f"Model: {model_name}\n")
        f.write(f"Dataset: {dataset_name}\n")
        f.write(f"Timestamp: {out.name.split('_' + model_name.replace('/', '_'))[0]}\n")
        f.write("-" * 40 + "\n")
        for k, v in metrics.items():
            f.write(f"{k}: {v:.4f}\n" if isinstance(v, float) else f"{k}: {v}\n")
    print(f"Results saved to: {out}")


# ----------------------------------------------------------------- dispatch


def _build_pipeline(model_path: str, device="cuda"):
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    return ASRPipeline(ASRModel.from_pretrained(model_path, device=device))


def run_eval(
    model: str,
    dataset_name: str,
    num_samples: Optional[int] = None,
    backend: str = "local",
    output_dir: str = "outputs",
    num_workers: int = 1,
    endpoint_url: Optional[str] = None,
    device="cuda",
) -> dict:
    cfg = DATASET_REGISTRY[dataset_name]
    ds = load_eval_dataset(cfg, num_samples=num_samples)

    if cfg.dataset_type == "asr":
        from tiny_audio_tpu_torch.eval.evaluators.asr import BACKENDS, LOCAL_BACKENDS

        if backend in LOCAL_BACKENDS:
            evaluator = BACKENDS[backend](model, device=device)
        elif backend == "endpoint":
            evaluator = BACKENDS[backend](endpoint_url or model,
                                          num_workers=num_workers)
        else:
            evaluator = BACKENDS[backend](num_workers=num_workers)
        try:
            results, metrics = evaluator.evaluate(
                ds, num_samples=num_samples, text_column=cfg.text_column
            )
        finally:
            close = getattr(evaluator, "close", None)
            if close is not None:  # the realtime backend owns a WebSocket server
                close()
        save_asr_results(evaluator.model_name, dataset_name, results, metrics,
                         output_dir)
        return metrics

    if cfg.dataset_type == "diarization":
        from tiny_audio_tpu_torch.eval.evaluators.diarization import (
            make_diarization_evaluator,
        )

        kwargs = {"device": device} if backend == "local" else {}
        evaluator = make_diarization_evaluator(backend, **kwargs)
        rows, metrics = evaluator.evaluate(ds, num_samples=num_samples)
        save_generic_results(evaluator.model_name, dataset_name, rows, metrics,
                             output_dir, suffix="_diarization")
        return metrics

    if cfg.dataset_type == "alignment":
        from tiny_audio_tpu_torch.eval.evaluators.alignment import (
            make_alignment_evaluator,
        )

        if backend == "local":
            pipe = _build_pipeline(model, device)

            def align_fn(audio, sample):
                return pipe(audio, return_timestamps=True).get("words", [])

            evaluator = make_alignment_evaluator("local", align_fn,
                                                 model_name=model)
        else:
            evaluator = make_alignment_evaluator(backend)
        rows, metrics = evaluator.evaluate(ds, num_samples=num_samples)
        save_generic_results(evaluator.model_name, dataset_name, rows, metrics,
                             output_dir, suffix="_alignment")
        return metrics

    if cfg.dataset_type in ("mcq", "classification"):
        pipe = _build_pipeline(model, device)

        def transcribe_fn(audio, prompt):
            return pipe(audio, user_prompt=prompt)["text"]

        if cfg.dataset_type == "mcq":
            from tiny_audio_tpu_torch.eval.evaluators.mcq import MCQEvaluator

            evaluator = MCQEvaluator(transcribe_fn, model_name=model)
            rows, metrics = evaluator.evaluate(
                ds, num_samples=num_samples,
                question_column=cfg.text_column,
                choices_column=cfg.extra.get("choices_column", "choices"),
                answer_column=cfg.extra.get("answer_column", "answer"),
                category_column=cfg.extra.get("category_column", "task"),
            )
        else:
            from tiny_audio_tpu_torch.eval.evaluators.classification import (
                ClassificationEvaluator,
            )

            evaluator = ClassificationEvaluator(
                transcribe_fn, task=cfg.extra["task"], model_name=model
            )
            rows, metrics = evaluator.evaluate(
                ds, num_samples=num_samples,
                label_column=cfg.extra.get("label_column", "label"),
            )
        save_generic_results(model, dataset_name, rows, metrics, output_dir,
                             suffix=f"_{cfg.dataset_type}")
        return metrics

    raise ValueError(f"unknown dataset type {cfg.dataset_type!r}")


def add_eval_parser(subparsers) -> None:
    p = subparsers.add_parser("eval", help="Run evaluation")
    p.add_argument("-m", "--model", required=True,
                   help="checkpoint dir, or backend model id")
    p.add_argument("-d", "--datasets", nargs="+", required=True)
    p.add_argument("-n", "--num-samples", type=int, default=None)
    p.add_argument("--backend", default="local",
                   choices=["local", "local-streaming", "realtime",
                            "endpoint", "assemblyai",
                            "assemblyai-streaming", "deepgram", "elevenlabs"])
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--endpoint-url", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the local backends run (default: the card)")
    p.set_defaults(func=_main_from_args)


def _main_from_args(args) -> int:
    names = validate_datasets(args.datasets)
    for name in names:
        print(f"=== {name} ===")
        metrics = run_eval(
            args.model, name,
            num_samples=args.num_samples,
            backend=args.backend,
            output_dir=args.output_dir,
            num_workers=args.num_workers,
            endpoint_url=args.endpoint_url,
            device=args.device,
        )
        for k, v in metrics.items():
            print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    return 0


def main(argv=None) -> int:
    import sys

    parser = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.eval.cli")
    sub = parser.add_subparsers()
    add_eval_parser(sub)
    args_in = list(argv) if argv is not None else sys.argv[1:]
    args = parser.parse_args(["eval"] + args_in)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
