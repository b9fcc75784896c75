"""Training loop on one device: accumulation, NaN watchdog, checkpoints.

Port of :mod:`tiny_audio_tpu.train.trainer` to PyTorch on one card:

- the same host loop: a shuffled ``batch_iterator`` (numpy
  ``default_rng(seed)``, so the batch order equals the JAX package's) run by
  a background ``_Prefetcher``; each host batch padded to the fixed global
  batch by duplicating real rows with ``labels = -100``; the
  accumulate/update alternation of :func:`~.optim.make_accum_steps`; the
  watchdog that reads the previous micro-step's loss and aborts a sustained
  non-finite run; ``logging_steps`` records to ``metrics.jsonl`` (and W&B
  when installed and asked for); ``evaluate`` under ``no_grad``; early
  stopping on eval loss;
- one device only: ``dp``/``tp`` other than None/1 raise
  ``NotImplementedError`` (multi-GPU is queued in ROADMAP.md);
- resume checkpoints are the port's own format, not Orbax's:
  ``checkpoints/<step>/state.pt`` holds the trainable parameters by name,
  the optimizer state and the step (``torch.save``), at most
  ``save_total_limit`` of them; ``model/`` beside them is
  ``save_pretrained(save_towers=False)`` in the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import shutil
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from tiny_audio_tpu_torch.train.optim import (
    OptimizerConfig,
    build_optimizer,
    init_grad_accum,
    make_accum_steps,
    make_train_step,
)


@dataclass
class TrainingConfig:
    """HF ``TrainingArguments`` analogue (the JAX package's fields)."""

    output_dir: str = "outputs/run"
    max_steps: int = 1000
    per_device_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    logging_steps: int = 25
    save_steps: int = 500
    save_total_limit: int = 5
    eval_steps: int = 500
    eval_batches: int = 16
    early_stopping_patience: int = 0  # 0 = disabled
    resume_from_checkpoint: bool = False
    group_by_length: bool = False
    seed: int = 0
    # mesh: one device only in the port
    dp: Optional[int] = None
    tp: int = 1
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    prefetch_depth: int = 2
    # augmentation thread-pool width (the reference's dataloader_num_workers)
    dataloader_workers: int = 4
    log_to_wandb: bool = False
    wandb_project: str = "tiny-audio-tpu"


class _Prefetcher:
    """Background thread running the collator ahead of the device step.

    ``close()`` must be called when the consumer stops early (max_steps,
    early stopping): without it the producer blocks in ``q.put`` forever and
    the generator's ``finally`` (transform-pool shutdown) never runs."""

    _STOP = object()

    def __init__(self, batch_iter: Iterable, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, args=(iter(batch_iter),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop:
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it):
        try:
            for item in it:
                if not self._put(item):
                    break
        except BaseException as e:  # surface worker errors on the main thread
            self.error = e
        finally:
            if hasattr(it, "close"):  # run the generator's finally now
                it.close()
            self._put(self._STOP)

    def close(self) -> None:
        self._stop = True
        while True:  # unblock a producer waiting on a full queue
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._STOP:
                if self.error is not None:
                    raise self.error
                return
            yield item


def _audio_len(row: dict) -> int:
    audio = row.get("audio")
    arr = audio.get("array") if isinstance(audio, dict) else audio
    return 0 if arr is None else int(np.asarray(arr).shape[-1])


def batch_iterator(
    dataset,
    collator,
    batch_size: int,
    seed: int = 0,
    epochs: Optional[int] = None,
    transform: Optional[Callable[[dict], dict]] = None,
    drop_last: bool = True,
    group_by_length: bool = False,
    length_window: int = 50,
    transform_workers: int = 0,
):
    """Shuffled epoch loop -> collated batches (the JAX package's order).

    ``transform``: per-sample augmentation on the host, its random stream
    pinned to (epoch, dataset index) whatever the pool's scheduling.
    ``group_by_length``: sort by audio length inside shuffled windows of
    ``length_window * batch_size`` rows and shuffle the batch order.
    """
    from tiny_audio_tpu_torch.train.augmentation import set_sample_key

    pool = None
    if transform is not None and transform_workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(transform_workers)
    rng = np.random.default_rng(seed)
    n = len(dataset)
    epoch = 0

    def run_transform(epoch, j, row):
        set_sample_key((epoch, int(j)))
        try:
            return transform(row)
        finally:
            set_sample_key(None)

    try:
        while epochs is None or epoch < epochs:
            order = rng.permutation(n)
            if group_by_length:
                window = max(length_window * batch_size, batch_size)
                reordered = []
                for w in range(0, n, window):
                    idx = order[w : w + window]
                    lengths = np.array([
                        dataset.audio_len(int(j)) if hasattr(dataset, "audio_len")
                        else _audio_len(dataset[int(j)])
                        for j in idx
                    ])
                    reordered.append(idx[np.argsort(lengths, kind="stable")])
                order = np.concatenate(reordered)
                starts = np.arange(0, n - (batch_size - 1 if drop_last else 0), batch_size)
                rng.shuffle(starts)
            else:
                starts = range(0, n - (batch_size - 1 if drop_last else 0), batch_size)
            yielded = 0
            for i in starts:
                js = [int(j) for j in order[i : i + batch_size]]
                rows = [dataset[j] for j in js]
                if transform is not None:
                    if pool is not None:
                        rows = list(pool.map(run_transform, [epoch] * len(js), js, rows))
                    else:
                        rows = [run_transform(epoch, j, r) for j, r in zip(js, rows)]
                try:
                    yield collator(rows)
                    yielded += 1
                except ValueError:
                    continue  # all rows in the batch were filtered out
            if yielded == 0:
                raise ValueError(
                    f"batch_iterator produced no batches in an epoch "
                    f"({n} rows, batch_size={batch_size}, drop_last={drop_last})")
            epoch += 1
    finally:
        if pool is not None:  # generator close/exhaustion must not leak threads
            pool.shutdown(wait=False)


class Trainer:
    """Training loop over a port :class:`ASRModel` on its device."""

    CHECKPOINT_FILE = "state.pt"

    def __init__(
        self,
        model,
        config: TrainingConfig,
        train_dataset,
        collator,
        eval_dataset=None,
        transform: Optional[Callable[[dict], dict]] = None,
        callbacks: Optional[list] = None,
    ):
        if config.dp not in (None, 1) or config.tp != 1:
            raise NotImplementedError(
                f"dp={config.dp} tp={config.tp}: the port trains on one device "
                "(multi-GPU is queued in ROADMAP.md)")
        self.model = model
        self.config = config
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.collator = collator
        self.transform = transform
        self.callbacks = callbacks or []
        self.out_dir = Path(config.output_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.device = model.device

        opt_cfg = dataclasses.replace(config.optimizer, total_steps=config.max_steps)
        self.optimizer, self.param_labels = build_optimizer(model.config, opt_cfg, model)
        self._accum = max(config.gradient_accumulation_steps, 1)
        if self._accum > 1:
            self.grad_accum = init_grad_accum(self.optimizer)
            self._accumulate_step, self._update_step = make_accum_steps(
                model, self.optimizer, self._accum)
        else:
            self.grad_accum = None
            self._train_step = make_train_step(model, self.optimizer)

        self._ckpt_dir = (self.out_dir / "checkpoints").absolute()
        self._metrics_file = self.out_dir / "metrics.jsonl"
        self._last_saved_step = -1
        self._wandb = None
        if config.log_to_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=config.wandb_project,
                                         config=dataclasses.asdict(config))
            except Exception:
                self._wandb = None

    # ------------------------------------------------------------ checkpoints

    def _checkpoint_steps(self) -> list[int]:
        if not self._ckpt_dir.is_dir():
            return []
        return sorted(int(p.name) for p in self._ckpt_dir.iterdir()
                      if p.name.isdigit() and (p / self.CHECKPOINT_FILE).exists())

    def _save_checkpoint(self, step: int) -> None:
        trainable = {n: p.detach().cpu() for n, p in self.optimizer.params.items()}
        state = {"params": trainable, "opt_state": self.optimizer.state_dict(), "step": step}
        ckpt = self._ckpt_dir / str(step)
        ckpt.mkdir(parents=True, exist_ok=True)
        tmp = ckpt / (self.CHECKPOINT_FILE + ".tmp")
        torch.save(state, tmp)
        tmp.replace(ckpt / self.CHECKPOINT_FILE)
        for old in self._checkpoint_steps()[:-max(self.config.save_total_limit, 1)]:
            shutil.rmtree(self._ckpt_dir / str(old))
        self._last_saved_step = step
        # model-level artifact (config + trainable weights) next to it
        self.model.save_pretrained(self.out_dir / "model", save_towers=False)
        for cb in self.callbacks:
            if hasattr(cb, "on_save"):
                cb.on_save(self, step)

    def _maybe_resume(self) -> int:
        if not self.config.resume_from_checkpoint:
            return 0
        steps = self._checkpoint_steps()
        if not steps:
            return 0
        state = torch.load(self._ckpt_dir / str(steps[-1]) / self.CHECKPOINT_FILE,
                           map_location=self.device, weights_only=True)
        with torch.no_grad():
            for name, value in state["params"].items():
                self.optimizer.params[name].copy_(value)
        self.optimizer.load_state_dict(state["opt_state"])
        print(f"[trainer] resumed from step {steps[-1]}")
        self._last_saved_step = int(state["step"])  # already on disk
        return int(state["step"])

    # --------------------------------------------------------------- logging

    def _log(self, record: dict) -> None:
        record = {k: (float(v) if isinstance(v, (torch.Tensor, np.floating)) else v)
                  for k, v in record.items()}
        with self._metrics_file.open("a") as f:
            f.write(json.dumps(record) + "\n")
        msg = "  ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in record.items())
        print(f"[trainer] {msg}", flush=True)
        if self._wandb is not None:
            self._wandb.log(record, step=record.get("step"))
        for cb in self.callbacks:
            if hasattr(cb, "on_log"):
                cb.on_log(self, record)

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def evaluate(self) -> dict:
        if self.eval_dataset is None:
            return {}
        losses, aux = [], []
        global_bs = self.config.per_device_batch_size
        it = batch_iterator(self.eval_dataset, self.collator, global_bs,
                            seed=0, epochs=1, drop_last=False)
        for i, batch in enumerate(it):
            if i >= self.config.eval_batches:
                break
            _, metrics = self.model.compute_loss(self._put_batch(batch, global_bs), train=False)
            losses.append(float(metrics["ce_loss"]))
            aux.append(float(metrics["aux_loss"]))
        if not losses:
            return {}
        return {"eval_loss": float(np.mean(losses)), "eval_aux_loss": float(np.mean(aux))}

    def _put_batch(self, batch: dict, target_rows: Optional[int] = None) -> dict:
        """The host batch as tensors on the device, its leading axis padded
        to ``target_rows`` (the fixed global batch: a collator-filtered row
        must not change the step's shapes) by duplicating real rows, whose
        labels become -100 (ballast, never gradient signal)."""
        out = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        n = out["input_ids"].shape[0]
        if target_rows is not None and target_rows != n:
            idx = torch.as_tensor(
                np.concatenate([np.arange(n), np.arange(target_rows - n) % n]),
                device=self.device)
            out = {k: v[idx] for k, v in out.items()}
            out["labels"][n:] = -100
        return out

    # ------------------------------------------------------------------ train

    def train(self) -> dict:
        cfg = self.config
        start_step = self._maybe_resume()
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        global_bs = cfg.per_device_batch_size

        it = _Prefetcher(
            batch_iterator(self.train_dataset, self.collator, global_bs, seed=cfg.seed,
                           transform=self.transform, group_by_length=cfg.group_by_length,
                           transform_workers=cfg.dataloader_workers),
            depth=cfg.prefetch_depth,
        )
        best_eval = float("inf")
        patience_left = cfg.early_stopping_patience
        step = start_step  # optimizer updates (HF max_steps semantics)
        accum = self._accum
        micro = start_step * accum
        window_losses: list[float] = []
        nonfinite_streak = 0
        t_window = time.time()
        prev_loss = None  # the previous micro-step's loss, still on the device

        def check_loss(loss: torch.Tensor) -> None:
            # the non-finite skip only skips; a sustained run means the data
            # or the learning rate is broken: abort before its budget runs out
            nonlocal nonfinite_streak
            loss_f = float(loss)
            nonfinite_streak = 0 if np.isfinite(loss_f) else nonfinite_streak + 1
            if nonfinite_streak >= 25:
                raise FloatingPointError(
                    f"loss non-finite for {nonfinite_streak} consecutive micro-batches "
                    f"around step {step} — aborting before optimizer-state poisoning")
            window_losses.append(loss_f)

        try:
            for batch in it:
                if step >= cfg.max_steps:
                    break
                batch = self._put_batch(batch, global_bs)
                if accum > 1:
                    is_update = (micro + 1) % accum == 0
                    fn = self._update_step if is_update else self._accumulate_step
                    loss, metrics = fn(self.grad_accum, batch, generator)
                else:
                    loss, metrics = self._train_step(batch, generator)
                micro += 1
                # the watchdog reads the previous micro-step's loss, so the
                # host never waits on the step it just queued
                if prev_loss is not None:
                    check_loss(prev_loss)
                prev_loss = loss
                if micro % accum != 0:
                    continue  # mid-accumulation: no optimizer update happened
                step += 1

                if step % cfg.logging_steps == 0:
                    dt = time.time() - t_window
                    if not window_losses:
                        check_loss(loss)
                        prev_loss = None
                    self._log({
                        "step": step,
                        "loss": float(np.mean(window_losses)),
                        "ce_loss": metrics["ce_loss"],
                        "aux_loss": metrics["aux_loss"],
                        "grad_norm": metrics["grad_norm"],
                        "steps_per_s": (max(len(window_losses), 1) / accum) / max(dt, 1e-9),
                    })
                    window_losses, t_window = [], time.time()

                if cfg.eval_steps and step % cfg.eval_steps == 0:
                    eval_metrics = self.evaluate()
                    if eval_metrics:
                        self._log({"step": step, **eval_metrics})
                        if cfg.early_stopping_patience:
                            if eval_metrics["eval_loss"] < best_eval - 1e-5:
                                best_eval = eval_metrics["eval_loss"]
                                patience_left = cfg.early_stopping_patience
                            else:
                                patience_left -= 1
                                if patience_left <= 0:
                                    print("[trainer] early stopping")
                                    break

                if cfg.save_steps and step % cfg.save_steps == 0:
                    self._save_checkpoint(step)

            if prev_loss is not None:  # the lagged watchdog's final sample
                check_loss(prev_loss)
        finally:
            it.close()  # stop the prefetch thread and the transform pool
        if self._last_saved_step != step:
            self._save_checkpoint(step)
        final = {"final_step": step}
        final.update(self.evaluate())
        return final
