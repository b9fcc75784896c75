"""Drive the port's multi-GPU paths on a tiny model over an n-rank grid.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
on the tiny fp32 MoE config (its expert math split over tp), over a
``(n / tp, tp)`` grid, at tp = 2 and then at tp = 4:

- ``generate`` token-exact against the single-device run;
- 3 batched transcripts through ``DynamicBatcher`` and 1 solo through
  ``EndpointHandler``, equal to the single-device pipeline's;
- one train step through the ``Trainer`` (finite loss);
- a checkpoint save -> load -> re-place on a second model: the gathered
  parameters and optimizer state bitwise those written.

Run: ``python -m tiny_audio_tpu_torch.parallel.dryrun 4 --device cpu`` (CPU
ranks over gloo); ``--device cuda`` puts the ranks on the first n cards over
NCCL, or all on the one card over gloo when there are fewer.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch


class _Records(list):
    """A Trainer callback keeping its logged records."""

    def on_log(self, trainer, record: dict) -> None:
        self.append(record)


def mesh_devices(n: int, device: str) -> tuple[list[str], str]:
    """(devices, backend) of an n-rank grid on ``device``: CPU ranks over
    gloo, the first n cards over NCCL, or n ranks sharing card 0 over gloo
    on a host with fewer cards."""
    if device == "cpu":
        return ["cpu"] * n, "gloo"
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)], "nccl"
    return ["cuda:0"] * n, "gloo"


def run(n: int, tp: int, device: str = "cuda", log=print) -> dict:
    """One pass at ``(n / tp, tp)`` on the card (``device="cpu"``: CPU ranks
    over gloo); returns the step's metrics."""
    from tiny_audio_tpu_torch.batching import DynamicBatcher
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.handler import EndpointHandler
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.parallel.mesh import make_mesh
    from tiny_audio_tpu_torch.pipeline import ASRPipeline
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.train.data import synthetic_dataset
    from tiny_audio_tpu_torch.train.optim import OptimizerConfig
    from tiny_audio_tpu_torch.train.trainer import Trainer, TrainingConfig

    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n}")
    dp = n // tp
    dev = "cpu" if device == "cpu" else "cuda:0"
    cfg = tiny_test_config(projector_type="moe", model_dtype="float32")
    model = ASRModel(cfg, seed=0, device=dev)

    # single-device baselines before sharding: the grid changes layout, not math
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((1, cfg.encoder.num_mel_bins, 50)).astype(np.float32)
    mask = np.ones((1, 50), np.int32)
    baseline_tokens = model.generate(feats, mask, max_new_tokens=6)
    pipe = ASRPipeline(model)
    audio = [(rng.standard_normal(8000) * 0.1).astype(np.float32) for _ in range(3)]
    baseline_texts = pipe.transcribe_batch(audio)

    devices, backend = mesh_devices(n, device)
    with make_mesh(dp=dp, tp=tp, devices=devices, backend=backend, timeout=120) as mesh, \
            tempfile.TemporaryDirectory(prefix="ta-dryrun-") as tmp:
        model.place_on(mesh)
        tokens = model.generate(feats, mask, max_new_tokens=6)
        np.testing.assert_array_equal(baseline_tokens, tokens)
        log(f"generate OK: tokens={tokens[0].tolist()}")

        handler = EndpointHandler(pipeline=pipe, device=dev)  # the model is placed
        batcher = DynamicBatcher(handler.pipe, max_batch=4, max_wait_ms=200.0)
        try:
            futures = [batcher.submit(a) for a in audio]
            served = [f.result(timeout=120) for f in futures]
        finally:
            batcher.close()
        assert served == baseline_texts, f"batched transcripts {served!r} vs {baseline_texts!r}"
        solo = handler({"inputs": audio[0]})
        assert solo["text"] == baseline_texts[0], f"solo {solo['text']!r} vs {baseline_texts[0]!r}"
        log(f"serve OK: {len(served)} batched + 1 solo transcripts equal to one device's")

        out = Path(tmp)
        rows = synthetic_dataset(4 * dp, seed=0, min_s=0.3, max_s=0.8)
        collator = DataCollator(model.tokenizer, model.projector,
                                num_mel_bins=cfg.encoder.num_mel_bins, device=dev)
        train_cfg = TrainingConfig(
            output_dir=str(out), max_steps=1, per_device_batch_size=2, logging_steps=1,
            save_steps=1, eval_steps=0, dataloader_workers=0, dp=dp, tp=tp,
            optimizer=OptimizerConfig(total_steps=10))
        records = _Records()
        Trainer(model, train_cfg, rows, collator, callbacks=[records]).train()
        loss = records[0]["loss"]
        assert np.isfinite(loss), f"non-finite loss {loss}"
        log(f"train OK: loss={loss:.4f}, ce={records[0]['ce_loss']:.4f}, "
            f"aux={records[0]['aux_loss']:.6f}, grad_norm={records[0]['grad_norm']:.4f}")

        # save -> load -> re-place: a second model on the grid resumes from
        # the checkpoint; what it gathers is bitwise what was written
        written = torch.load(out / "checkpoints" / "1" / "state.pt", weights_only=True)
        again = Trainer(ASRModel(cfg, seed=1, device=dev).place_on(mesh),
                        dataclasses.replace(train_cfg, resume_from_checkpoint=True),
                        rows, collator)
        assert again._maybe_resume() == 1
        state = again._rank.checkpoint_state()
        for name, value in written["params"].items():
            assert torch.equal(state["params"][name], value), name
        for key in ("mu", "nu"):
            for name, value in written["opt_state"][key].items():
                assert torch.equal(state["opt_state"][key][name].cpu(), value.cpu()), name
        log(f"ckpt OK: {len(written['params'])} trainable leaves and their moments "
            "save/load/re-place exact")
    log(f"dryrun OK: mesh=(dp={dp}, tp={tp}) on {backend} {sorted(set(devices))}")
    return records[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, help="ranks in the grid")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the ranks on the CPU")
    tps = [2] if args.n % 2 == 0 else [1]
    if args.n % 4 == 0:
        tps.append(4)  # >2-way splits: a head-count bug is invisible at tp=2
    for tp in tps:
        run(args.n, tp, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
