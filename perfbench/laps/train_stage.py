"""Training: whole optimizer steps of the port's gradient accumulation.

Set-up builds one model and one optimizer (``train.optim.build_optimizer``
with the workload's recipe), collates the workload's micro-batches with the
port's ``DataCollator`` (the processor's mel on the card), and drives the
first three steps through the window's own call (``make_accum_steps``: the
accumulating step, then the updating one) on micro-batches that all differ.
The window goes on with the same objects, cycling the micro-batches.

Correct: the plain reference follows those three steps in fp32 from the
same seed (its own mel, token ids, labels, loss, gradients, clipping and
AdamW).  Three numbers are held to the workload's limits: the largest
relative gap of a step's loss; the worst leaf's gap of the first gradient's
norm, the program's read from the optimizer's first moment after one step;
the worst leaf's gap of the norm of the parameters' change over the three
steps.  A leaf's gap is taken against the larger of its reference norm and
the median leaf's; leaves whose reference gradient is under a thousandth of
the median leaf's are left out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import flops, reference, traffic, weights
from perfbench.laps.serve_offline import SetupClock, asr_config, dtype_of

KIND = "train"
END_TO_END = {"train_step_ms": "ms", "setup_s": "s"}
CHECKED_STEPS = 3
#: a leaf whose reference gradient norm is under this share of the median
#: leaf's moves by round-off alone and is left out of the comparison
TINY_LEAF = 1e-3
#: reference rows a forward and backward at a time (memory, not results)
REF_ROWS = 2
#: the port's launch counters of the kernels the rooflines read: a traced
#: run logs them beside the trace's events (a cross-check)
WRAPPERS = {"prefill_attn_stats": ("tiny_audio_tpu_torch.ops.prefill_attention",
                                   "prefill_attention"),
            "prefill_attn_bwd_dkv": ("tiny_audio_tpu_torch.ops.prefill_attention",
                                     "prefill_attention_bwd_dkv"),
            "prefill_attn_bwd_dq": ("tiny_audio_tpu_torch.ops.prefill_attention",
                                    "prefill_attention_bwd_dq")}


class Lap:
    def __init__(self, spec: dict, cfg: dict, seed: int, device: torch.device):
        self.spec, self.cfg, self.seed, self.device = spec, cfg, seed, device
        self.rows = traffic.TrainRows(spec["traffic"], seed)
        self.accum_steps = self.rows.accum
        self.next_batch = 0
        self.unit_batches: list = []  # the micro-batch indices of each window step

    # ---------------------------------------------------------- program

    def setup(self) -> None:
        from tiny_audio_tpu_torch.models.asr import ASRModel
        from tiny_audio_tpu_torch.train.collator import DataCollator
        from tiny_audio_tpu_torch.train.optim import (
            OptimizerConfig, build_optimizer, init_grad_accum, make_accum_steps)

        dev = self.device
        clock = SetupClock(dev)
        acfg = asr_config(self.cfg)
        tree = weights.make_params(self.cfg, self.seed, dev, dtype_of(self.cfg))
        clock.mark("weights")
        self.model = ASRModel(acfg, params=tree, device=dev)
        del tree
        clock.mark("model")
        self.optimizer, _ = build_optimizer(acfg, OptimizerConfig(**self.spec["optimizer"]),
                                            self.model)
        self.accumulate, self.update = make_accum_steps(self.model, self.optimizer,
                                                        self.accum_steps)
        self.accum = init_grad_accum(self.optimizer)
        self.generator = torch.Generator(device=dev).manual_seed(
            int(traffic.rng(self.seed, 6).integers(2**62)))
        collator = DataCollator(self.model.tokenizer, self.model.projector,
                                num_mel_bins=self.cfg["encoder"]["num_mel_bins"],
                                system_prompt=self.cfg["system_prompt"], device=dev)
        self.batches = [collator([{"audio": self.rows.audio(p), "text": t}
                                  for p, t in zip(b["pcm"], b["texts"])])
                        for b in self.rows.batches]
        clock.mark("collate")
        params = self.optimizer.params
        self.p0 = {n: p.detach().clone() for n, p in params.items()}
        self.losses = []
        for step in range(CHECKED_STEPS):
            self.losses.append(self._step())
            if step == 0:
                self.mu1 = {n: m.detach().clone()
                            for n, m in self.optimizer.state["mu"].items()}
        self.p3 = {n: p.detach().clone() for n, p in params.items()}
        self.losses = [float(x) for x in self.losses]
        self.skipped0 = self.optimizer.state["total_notfinite"]
        clock.mark("three steps")

    def _step(self) -> torch.Tensor:
        """One optimizer step over the next ``accum`` micro-batches; its loss
        is the mean of theirs."""
        total = 0.0
        used = []
        for j in range(self.accum_steps):
            i = self.next_batch % len(self.batches)
            self.next_batch += 1
            used.append(i)
            call = self.update if j == self.accum_steps - 1 else self.accumulate
            loss, _ = call(self.accum, self.batches[i], self.generator)
            total = total + loss
        self.last_used = used
        return total / self.accum_steps

    def unit(self) -> None:
        self._step()
        self.unit_batches.append(self.last_used)

    def metrics(self, units: int, window_s: float) -> dict:
        return {"train_step_ms": 1e3 * window_s / units}

    def counts(self, units: int) -> tuple:
        """(optimizer steps attempted, skipped as non-finite) in the window."""
        return units, self.optimizer.state["total_notfinite"] - self.skipped0

    def release(self) -> None:
        host = lambda d: {n: t.float().cpu() for n, t in d.items()}  # noqa: E731
        self.p0, self.mu1, self.p3 = host(self.p0), host(self.mu1), host(self.p3)
        self.beta1 = self.optimizer.opt.adam_beta1
        del self.model, self.optimizer, self.accumulate, self.update, self.accum, self.batches

    # ---------------------------------------------------------- shapes

    def shapes(self, i: int) -> tuple:
        """(padded text length, valid lengths, real mel frames) of micro-batch
        ``i``, as the reference builds it."""
        b = self.rows.batches[i]
        mel = [int(math.ceil(n / 160)) for n in b["lengths"]]
        stride = self.cfg["projector_pool_stride"]
        lens = [len(sample_ids(self.cfg, reference.audio_tokens(reference.conv_len(m), stride),
                               t)[0]) for m, t in zip(mel, b["texts"])]
        return -(-max(lens) // 64) * 64, lens, mel

    def context(self, n_units: int) -> dict:
        d = self.cfg["decoder"]
        hq, hkv, hd, layers = d["num_heads"], d["num_kv_heads"], d["head_dim"], d["num_layers"]
        expected, model_flops = [], []
        for used in self.unit_batches[:n_units]:
            bwd, total = [], 0.0
            for i in used:
                t, lens, mel = self.shapes(i)
                least = flops.least_s(*flops.prefill_attention_backward(
                    len(lens), t, hq, hkv, hd, lens))
                bwd += [least] * layers
                total += sum(flops.train_row_flops(self.cfg, m, n) for m, n in zip(mel, lens))
            expected.append({"prefill_attn_bwd": bwd})
            model_flops.append(total)
        return {"expected": expected, "model_flops": model_flops}

    @staticmethod
    def phases(unit) -> list:
        return [(unit.start, "step")]

    # ---------------------------------------------------------- correct

    def check(self) -> dict:
        ref = reference_steps(self.cfg, self.spec, self.seed, self.device, self.rows)
        program = {"losses": self.losses, "grad1": {n: g / (1 - self.beta1)
                                                     for n, g in self.mu1.items()},
                   "change": {n: self.p3[n] - self.p0[n] for n in self.p0}}
        limits = self.spec["check"]["limits"]
        return {name: {"value": value, "limit": limits[name]}
                for name, value in compare(program, ref).items()}


def compare(program: dict, ref: dict) -> dict:
    """The three numbers held to their limits (see the module docstring)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(program["grad1"], ref["grad1"], ref["grad1"]),
            "change_gap": leaf_gap(program["change"], ref["change"], ref["grad1"])}


def leaf_gap(prog: dict, ref: dict, ref_grad: dict) -> float:
    """The worst leaf's ``| |prog| - |ref| | / max(|ref|, median leaf |ref|)``
    over leaves whose reference gradient is not nought to rounding."""
    gnorm = {n: float(g.norm()) for n, g in ref_grad.items()}
    gmed = float(np.median(list(gnorm.values())))
    kept = [n for n in ref if gnorm[n] >= TINY_LEAF * gmed]
    norms = {n: float(ref[n].norm()) for n in kept}
    median = float(np.median(list(norms.values())))
    return max(abs(float(prog[n].norm()) - norms[n]) / max(norms[n], median) for n in kept)


# --------------------------------------------------------------- reference

#: the model's projector leaves by the program's parameter names
PROJECTOR = {"projector.linear_1.weight": ("linear_1", True),
             "projector.norm.weight": ("norm", False),
             "projector.linear_2.weight": ("linear_2", True),
             "projector.norm_2.weight": ("norm_2", False)}


def sample_ids(cfg: dict, n_audio: int, text: str) -> tuple:
    """(ids, labels) of one training row: only the answer and its end are
    supervised."""
    prompt = reference.chat(cfg["system_prompt"], reference.user_turn(n_audio), None)
    full = reference.chat(cfg["system_prompt"], reference.user_turn(n_audio), text)
    return full, [-100] * len(prompt) + full[len(prompt):]


def schedule(opt: dict, count: int) -> float:
    """The learning rate at an update count: linear warmup from 0, then the
    recipe's decay over the remaining steps (optax's formulas)."""
    lr, total = opt["learning_rate"], opt["total_steps"]
    warm = opt.get("warmup_steps") or int(opt.get("warmup_ratio", 0.0) * total)
    if count < warm:
        return lr * count / warm
    steps, c = max(total - warm, 1), min(max(count - warm, 0), total - warm)
    kind = opt.get("lr_scheduler_type", "cosine")
    if kind == "constant":
        return lr
    if kind == "cosine":
        return lr * 0.5 * (1 + math.cos(math.pi * c / steps))
    power = 1.0 if kind == "linear" else opt.get("polynomial_power", 0.5)
    return lr * (1 - c / steps) ** power


def micro_batch(model: reference.Model, cfg: dict, batch: dict, device) -> dict:
    """The reference's inputs of one micro-batch: bucketed mel, ids, labels."""
    n = len(batch["pcm"])
    lengths = np.asarray(batch["lengths"])
    frames = reference.bucket_frames(int(math.ceil(lengths.max() / 160)))
    pcm = np.zeros((n, frames * 160), np.float32)
    for i, p in enumerate(batch["pcm"]):
        pcm[i, :len(p)] = traffic.TrainRows.audio(p)
    mel = np.minimum(np.ceil(lengths / 160).astype(np.int64), frames)
    stride = cfg["projector_pool_stride"]
    rows = [sample_ids(cfg, reference.audio_tokens(reference.conv_len(int(m)), stride), t)
            for m, t in zip(mel, batch["texts"])]
    width = -(-max(len(ids) for ids, _ in rows) // 64) * 64
    ids = np.full((n, width), reference.PAD_ID, np.int64)
    labels = np.full((n, width), -100, np.int64)
    for i, (a, lab) in enumerate(rows):
        ids[i, :len(a)], labels[i, :len(lab)] = a, lab
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return {"feats": reference.log_mel(t(pcm), cfg["encoder"]["num_mel_bins"]),
            "mel": t(mel), "ids": t(ids), "labels": t(labels),
            "valid": t(ids) != reference.PAD_ID}


def reference_steps(cfg: dict, spec: dict, seed: int, device, rows: traffic.TrainRows,
                    prec: reference.Precision = reference.FP32, keep_rows=None) -> dict:
    """The first three steps in the reference: each step's loss, the first
    clipped mean gradient and the projector's change.  ``keep_rows``: a
    planted fault, the rows of each micro-batch kept (the mean taken over
    them alone)."""
    reference.no_tf32()
    tree = weights.make_params(cfg, seed, device, dtype_of(cfg))
    model = reference.Model(cfg, tree, prec)
    proj = {name: tree["projector"][leaf]["kernel" if kernel else "weight"].float().clone()
            .requires_grad_(True) for name, (leaf, kernel) in PROJECTOR.items()}
    del tree
    opt = spec["optimizer"]
    b1, b2 = opt.get("adam_beta1", 0.9), opt.get("adam_beta2", 0.999)
    eps = opt.get("adam_epsilon", 1e-8)
    decay = {n: (0.0 if "norm" in n.split(".")[1] else opt.get("projector_weight_decay",
                                                            opt.get("weight_decay", 0.0)))
             for n in proj}
    p0 = {n: p.detach().clone() for n, p in proj.items()}
    mu = {n: torch.zeros_like(p) for n, p in proj.items()}
    nu = {n: torch.zeros_like(p) for n, p in proj.items()}
    accum = rows.accum
    losses, grad1 = [], None
    for step in range(CHECKED_STEPS):
        grads = {n: torch.zeros_like(p) for n, p in proj.items()}
        step_loss = 0.0
        for j in range(accum):
            mb = micro_batch(model, cfg, rows.batches[step * accum + j], device)
            keep = range(len(mb["ids"])) if keep_rows is None else keep_rows
            loss = micro_batch_loss(model, mb, proj, list(keep))
            step_loss += loss / accum
            for n, p in proj.items():
                grads[n] += p.grad / accum
                p.grad = None
        losses.append(step_loss)
        norm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
        if not norm < opt.get("max_grad_norm", 1.0):
            grads = {n: g / norm * opt.get("max_grad_norm", 1.0) for n, g in grads.items()}
        if step == 0:
            grad1 = {n: g.cpu() for n, g in grads.items()}
        lr = schedule(opt, step)
        with torch.no_grad():
            for n, p in proj.items():
                mu[n].mul_(b1).add_(grads[n], alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(grads[n], grads[n], value=1 - b2)
                upd = (mu[n] / (1 - b1 ** (step + 1))) / (
                    torch.sqrt(nu[n] / (1 - b2 ** (step + 1))) + eps)
                p.sub_(lr * (upd + decay[n] * p))
    return {"losses": losses, "grad1": grad1,
            "change": {n: (p.detach() - p0[n]).cpu() for n, p in proj.items()}}


def micro_batch_loss(model: reference.Model, mb: dict, proj: dict, keep: list) -> float:
    """Forward and backward of the mean token loss over the rows ``keep``,
    ``REF_ROWS`` rows at a time; the gradients accumulate in ``proj``."""
    labels = mb["labels"][keep]
    count = int((labels[:, 1:] != -100).sum())
    total = 0.0
    for s in range(0, len(keep), REF_ROWS):
        rows = keep[s:s + REF_ROWS]
        with torch.no_grad():
            hidden = model.encode(mb["feats"][rows], mb["mel"][rows])
        audio = model.project(hidden, {PROJECTOR[n][0]: p for n, p in proj.items()})
        ids = mb["ids"][rows]
        logits = model.decode(model.splice(ids, audio), mb["valid"][rows])
        lab = mb["labels"][rows][:, 1:]
        ll = torch.log_softmax(logits[:, :-1], dim=-1)
        picked = ll.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
        loss = -(picked * (lab != -100)).sum() / count
        loss.backward()
        total += float(loss.detach())
    return total
