"""Optimizer: four label groups with their own learning rate and weight decay.

Port of :mod:`tiny_audio_tpu.train.optim` in plain torch, with optax's
semantics written out (the JAX package builds ``apply_if_finite(chain(
clip_by_global_norm, multi_transform({label: adamw})))``):

1. a non-finite gradient skips the whole update and leaves the state as it
   was, up to ``MAX_CONSECUTIVE_ERRORS`` in a row (then, as optax does, the
   update is applied; the Trainer's watchdog aborts first);
2. the gradients are clipped to ``max_grad_norm`` by their global norm;
3. each label group runs AdamW with its own step count and learning-rate
   schedule: ``p -= lr(count) * (m_hat / (sqrt(v_hat) + eps) + wd * p)``,
   the schedule read at the count before the increment (so the first update
   of a warmed-up run has learning rate 0), the moments kept in the
   parameter's dtype;
4. frozen parameters (label ``frozen``) have no gradient, no update and no
   state.

Parameters are addressed by their names in the model (``named_parameters``);
:func:`param_labels` labels them as the JAX package labels its params tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from tiny_audio_tpu_torch.models.asr import is_frozen

MAX_CONSECUTIVE_ERRORS = 100  # optax.apply_if_finite's budget in the JAX package
GROUPS = ("other_decay", "other_nodecay", "decoder_decay", "decoder_nodecay")


@dataclass
class OptimizerConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    decoder_learning_rate: Optional[float] = None
    decoder_weight_decay: Optional[float] = None
    projector_weight_decay: Optional[float] = None
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "cosine"  # cosine | linear | polynomial | constant
    warmup_steps: int = 0
    warmup_ratio: float = 0.0
    total_steps: int = 10000
    polynomial_power: float = 0.5


def _is_no_decay(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "bias" or "norm" in name.lower()


def param_labels(model: torch.nn.Module, config) -> dict[str, str]:
    """Label each parameter of an ``ASRModel``: ``frozen`` where the model's
    rule (:func:`~tiny_audio_tpu_torch.models.asr.is_frozen`) says so, else
    ``{decoder,other}_{decay,nodecay}``."""
    labels = {}
    for name, _ in model.named_parameters():
        if is_frozen(name, config):
            labels[name] = "frozen"
            continue
        group = "decoder" if name.startswith("decoder.") else "other"
        labels[name] = f"{group}_{'nodecay' if _is_no_decay(name) else 'decay'}"
    return labels


def make_schedule(opt: OptimizerConfig, base_lr: float) -> Callable[[int], float]:
    """Learning rate at an update count, with optax's formulas: the main
    schedule over ``total_steps - warmup`` steps after a linear warmup from 0."""
    warmup = opt.warmup_steps or int(opt.warmup_ratio * opt.total_steps)
    decay_steps = max(opt.total_steps - warmup, 1)

    def polynomial(init: float, end: float, power: float, steps: int):
        def schedule(count: int) -> float:
            frac = 1 - min(max(count, 0), steps) / steps
            return (init - end) * frac**power + end
        return schedule

    if opt.lr_scheduler_type == "cosine":
        def main(count: int) -> float:
            return base_lr * 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
    elif opt.lr_scheduler_type == "linear":
        main = polynomial(base_lr, 0.0, 1.0, decay_steps)
    elif opt.lr_scheduler_type == "polynomial":
        main = polynomial(base_lr, 0.0, opt.polynomial_power, decay_steps)
    elif opt.lr_scheduler_type == "constant":
        def main(count: int) -> float:
            return base_lr
    else:
        raise ValueError(f"Unknown scheduler: {opt.lr_scheduler_type}")
    if warmup > 0:
        warm = polynomial(0.0, base_lr, 1.0, warmup)
        return lambda count: warm(count) if count < warmup else main(count - warmup)
    return main


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (fp32)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


class GroupedAdamW:
    """The JAX package's optimizer over named parameters (see the module
    docstring).  :meth:`step` takes the gradients of the trainable
    parameters by name and updates the parameters in place."""

    def __init__(self, params: dict[str, torch.nn.Parameter], labels: dict[str, str],
                 opt: OptimizerConfig):
        base_lr = opt.learning_rate
        dec_lr = opt.decoder_learning_rate if opt.decoder_learning_rate is not None else base_lr
        base_wd = opt.weight_decay
        dec_wd = opt.decoder_weight_decay if opt.decoder_weight_decay is not None else base_wd
        proj_wd = opt.projector_weight_decay if opt.projector_weight_decay is not None else base_wd
        self.opt = opt
        self.schedules = {"other_decay": make_schedule(opt, base_lr),
                          "other_nodecay": make_schedule(opt, base_lr),
                          "decoder_decay": make_schedule(opt, dec_lr),
                          "decoder_nodecay": make_schedule(opt, dec_lr)}
        self.weight_decay = {"other_decay": proj_wd, "other_nodecay": 0.0,
                             "decoder_decay": dec_wd, "decoder_nodecay": 0.0}
        self.params = {n: p for n, p in params.items() if labels[n] != "frozen"}
        self.labels = {n: labels[n] for n in self.params}
        self.state = {
            "count": {g: 0 for g in GROUPS},
            "mu": {n: torch.zeros_like(p) for n, p in self.params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in self.params.items()},
            "notfinite_count": 0,
            "total_notfinite": 0,
        }

    def step(self, grads: dict[str, torch.Tensor]) -> bool:
        """One update from ``grads`` (a tensor for every trainable
        parameter).  Returns False when a non-finite gradient skipped it."""
        grads = {n: grads[n] for n in self.params}
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
        st = self.state
        st["notfinite_count"] = 0 if finite else st["notfinite_count"] + 1
        if not finite:
            st["total_notfinite"] += 1
            if st["notfinite_count"] <= MAX_CONSECUTIVE_ERRORS:
                return False
        opt = self.opt
        norm = global_norm(grads.values())
        if not bool(norm < opt.max_grad_norm):
            grads = {n: g / norm.to(g.dtype) * opt.max_grad_norm for n, g in grads.items()}
        b1, b2 = opt.adam_beta1, opt.adam_beta2
        lrs = {g: self.schedules[g](c) for g, c in st["count"].items()}
        counts = {g: c + 1 for g, c in st["count"].items()}
        # bias corrections 1 - beta**count, in fp32 as optax computes them
        f32 = torch.float32
        c1 = {g: float(1 - torch.tensor(b1, dtype=f32) ** c) for g, c in counts.items()}
        c2 = {g: float(1 - torch.tensor(b2, dtype=f32) ** c) for g, c in counts.items()}
        with torch.no_grad():
            for name, p in self.params.items():
                group = self.labels[name]
                g = grads[name].to(p.dtype)
                mu = st["mu"][name].mul_(b1).add_(g, alpha=1 - b1)
                nu = st["nu"][name].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (mu / c1[group]) / (torch.sqrt(nu / c2[group]) + opt.adam_epsilon)
                update = update + self.weight_decay[group] * p
                p.sub_(lrs[group] * update)
        st["count"] = counts
        return True

    def state_dict(self) -> dict:
        return {"count": dict(self.state["count"]),
                "mu": {n: t.detach().clone() for n, t in self.state["mu"].items()},
                "nu": {n: t.detach().clone() for n, t in self.state["nu"].items()},
                "notfinite_count": self.state["notfinite_count"],
                "total_notfinite": self.state["total_notfinite"]}

    def load_state_dict(self, state: dict) -> None:
        for key in ("mu", "nu"):
            for name, t in self.state[key].items():
                t.copy_(state[key][name])
        self.state["count"] = dict(state["count"])
        self.state["notfinite_count"] = int(state["notfinite_count"])
        self.state["total_notfinite"] = int(state["total_notfinite"])


def build_optimizer(config, opt: OptimizerConfig, model: torch.nn.Module):
    """(optimizer, labels) for an ``ASRModel``: AdamW per label group,
    global-norm clipping, the non-finite skip; frozen parameters untouched."""
    labels = param_labels(model, config)
    return GroupedAdamW(dict(model.named_parameters()), labels, opt), labels


def _loss_and_grads(model, optimizer: GroupedAdamW, batch: dict, generator):
    """Loss, metrics and the trainable parameters' gradients of one batch
    (frozen parameters take no gradient at all: ``requires_grad`` is off)."""
    for p in optimizer.params.values():
        p.grad = None
    loss, metrics = model.compute_loss(batch, train=True, generator=generator)
    loss.backward()
    grads = {}
    for name, p in optimizer.params.items():
        grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, optimizer: GroupedAdamW):
    """``train_step(batch, generator) -> (loss, metrics)``: gradients of the
    trainable parameters only (the frozen ones are left out before the
    clip, as the JAX step zeroes them), ``grad_norm`` in the metrics, then
    one optimizer update."""

    def train_step(batch: dict, generator=None):
        loss, metrics, grads = _loss_and_grads(model, optimizer, batch, generator)
        metrics["grad_norm"] = global_norm(grads.values())
        optimizer.step(grads)
        return loss, metrics

    return train_step


def init_grad_accum(optimizer: GroupedAdamW) -> dict[str, torch.Tensor]:
    """Trainable-only fp32 gradient accumulator (no shadow of the frozen
    towers)."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in optimizer.params.items()}


def make_accum_steps(model, optimizer: GroupedAdamW, accum_steps: int):
    """(accumulate_step, update_step) for gradient accumulation, both
    ``(accum, batch, generator) -> (loss, metrics)``: the first adds the
    micro-batch gradient into ``accum``; the second also applies the
    optimizer to the accumulated MEAN (the clip acts on the mean) and zeroes
    ``accum``.  The caller alternates them."""
    inv = 1.0 / float(accum_steps)

    def accumulate_step(accum: dict, batch: dict, generator=None):
        loss, metrics, grads = _loss_and_grads(model, optimizer, batch, generator)
        for name, g in grads.items():
            accum[name].add_(g.float())
        return loss, metrics

    def update_step(accum: dict, batch: dict, generator=None):
        loss, metrics = accumulate_step(accum, batch, generator)
        mean = {n: (a * inv).to(optimizer.params[n].dtype) for n, a in accum.items()}
        metrics["grad_norm"] = global_norm(mean.values())
        optimizer.step(mean)
        for a in accum.values():
            a.zero_()
        return loss, metrics

    return accumulate_step, update_step
