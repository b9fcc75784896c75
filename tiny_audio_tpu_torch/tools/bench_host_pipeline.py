"""Host input-pipeline throughput: augmentation + collation samples/s.

    python -m tiny_audio_tpu_torch.tools.bench_host_pipeline [--device-rate X] [--workers N]

Port of ``scripts/bench_host_pipeline.py``.  The host must feed at least
the samples per second that the card's training step consumes, or training
becomes input-bound (the reference's documented bottleneck, which it
answers with 24 dataloader workers).  This measures the chain (full RIR +
noise augmentation -> mel extraction -> chat-ML label masking)
single-threaded and through ``batch_iterator``'s ``transform_workers``
thread pool (numpy's FFT work releases the GIL), for 0, ``--workers``, 4
and 8 workers.

The rate to match is the card's own stage-1 ``samples_per_s``:
``--device-rate X`` if given, else the ``stage1_projector`` stage of
``tools/bench_train_stages`` run on ``--device`` first.  Each pipeline line
prints that rate and where it came from beside the verdict (``OK`` or
``INPUT-BOUND``).  The augmentation runs on the host in numpy; the
collator computes the mel features on ``--device`` (the card unless
``cpu`` is asked for), so each timed span that collates is closed by
``torch.cuda.synchronize()`` there, and one collation runs untimed before
the first timed one (on the card the first call pays for the CUDA context
and the mel's first launches, ~1 s, which the script's figure would bill to
the pipeline).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_rows(n: int, seconds: float = 15.0) -> list[dict]:
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        rows.append({
            "audio": {
                "array": (rng.standard_normal(int(seconds * 16000)) * 0.1)
                .astype(np.float32),
                "sampling_rate": 16000,
            },
            "text": "the quick brown fox jumps over the lazy dog " * 4,
        })
    return rows


def build_chain(device="cuda"):
    """(transform, collator) of the script: the worst-case augmentation
    (RIR always convolved, the noise chain, 5% silence injection) and the
    collator over a byte tokenizer and the flagship's projector."""
    from tiny_audio_tpu_torch.config import ASRConfig
    from tiny_audio_tpu_torch.models.projectors import create_projector
    from tiny_audio_tpu_torch.tokenization import ByteTokenizer
    from tiny_audio_tpu_torch.train.augmentation import (
        AugmentationPipeline,
        NoiseAugmentation,
        RIRAugmentation,
    )
    from tiny_audio_tpu_torch.train.collator import DataCollator

    cfg = ASRConfig()
    # byte tokenizer: same masking/collation code path, no HF download
    tokenizer = ByteTokenizer(cfg.decoder.vocab_size)
    projector = create_projector(cfg)
    transform = AugmentationPipeline(
        rir=RIRAugmentation(p=1.0),       # worst case: always convolve
        noise=NoiseAugmentation(),
        silence_injection_prob=0.05,
    )
    collator = DataCollator(
        tokenizer, projector, num_mel_bins=cfg.encoder.num_mel_bins,
        system_prompt=cfg.system_prompt, device=device,
    )
    return transform, collator


def device_rate(rate, device: str, log=print) -> tuple[float, str]:
    """(samples/s the host must match, where it came from)."""
    if rate is not None:
        return float(rate), "--device-rate"
    from tiny_audio_tpu_torch.tools import bench_train_stages

    (res,) = bench_train_stages.run_stages("stage1_projector", device, log=log)
    if "error" in res:
        raise SystemExit(f"the stage-1 run for the device rate failed: {res}")
    return float(res["samples_per_s"]), f"stage1_projector on {device} (bench_train_stages)"


def measure(rows: list, transform, collator, batch_size: int, workers: int, rate: float,
            source: str, log=print) -> dict:
    """The script's timings, each line logged as the script prints it:
    augmentation and collation alone, single-threaded, then
    ``batch_iterator`` at each worker count.  Returns the samples/s of
    each and the verdict of each worker count."""
    from tiny_audio_tpu_torch.train.trainer import batch_iterator

    device = collator.processor.device

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # stage timings, single-thread
    t0 = time.time()
    aug = [transform(r) for r in rows]
    t_aug = time.time() - t0
    collator(aug[:batch_size])  # untimed: the device's first launches are set-up
    sync()
    t0 = time.time()
    for i in range(0, len(aug), batch_size):
        collator(aug[i:i + batch_size])
    sync()
    t_col = time.time() - t0
    log(f"augment: {len(rows) / t_aug:7.1f} samples/s "
        f"({t_aug / len(rows) * 1e3:.1f} ms/sample)")
    log(f"collate: {len(rows) / t_col:7.1f} samples/s "
        f"({t_col / len(rows) * 1e3:.1f} ms/sample)")
    out = {"augment": len(rows) / t_aug, "collate": len(rows) / t_col, "pipeline": {}}

    # full pipeline through batch_iterator (what training actually runs)
    for n_workers in sorted({0, workers, 4, 8}):
        it = batch_iterator(
            rows, collator, batch_size, epochs=1, transform=transform,
            transform_workers=n_workers,
        )
        t0 = time.time()
        n_batches = sum(1 for _ in it)
        sync()
        dt = time.time() - t0
        got = n_batches * batch_size / dt
        verdict = "OK" if got >= rate else "INPUT-BOUND"
        log(f"pipeline workers={n_workers}: {got:7.1f} samples/s "
            f"(device needs {rate} from {source}) {verdict}")
        out["pipeline"][n_workers] = {"samples_per_s": got, "verdict": verdict}
    return out


def main(argv=None) -> None:
    from tiny_audio_tpu_torch.device import require_device

    ap = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.tools.bench_host_pipeline")
    ap.add_argument("--rows", type=int, default=96)
    ap.add_argument("--batch-size", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--workers", type=int, default=0,
                    help="transform worker threads (0 = inline)")
    ap.add_argument("--device", default="cuda", help="where the collator computes the mel")
    ap.add_argument("--device-rate", type=float, default=None,
                    help="samples/s of the card's step (default: measure stage 1 on --device)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    def log(line: str) -> None:
        print(line, flush=True)

    rate, source = device_rate(args.device_rate, args.device, log=log)
    transform, collator = build_chain(device)
    rows = build_rows(args.rows, args.seconds)
    log(f"collator device: {device}")
    measure(rows, transform, collator, args.batch_size, args.workers, rate, source, log=log)


if __name__ == "__main__":
    main()
