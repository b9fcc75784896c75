"""Offline convergence benchmark: show that the training stack learns.

Port of :mod:`tiny_audio_tpu.train.convergence`.  The ladder runs the staged
recipe (a pretrained encoder and language model, then the projector-only
stage 1, then stage-2 LoRA) end to end through the port's
:class:`~tiny_audio_tpu_torch.train.trainer.Trainer` on formant-synthesized
labeled speech (:func:`~tiny_audio_tpu_torch.utils.speech_synth.labeled_speech_dataset`),
and measures held-out greedy-decode WER through
:class:`~tiny_audio_tpu_torch.pipeline.ASRPipeline` before and after each
stage.  Phases:

-1. encoder CTC pretrain (:func:`pretrain_encoder_ctc`): the encoder and a
    throwaway linear CTC head learn the word vocabulary, standing in for the
    pretrained encoder tower the recipe composes; the head is discarded;
0.  decoder warmup: decoder-only training (``freeze_language_model=False``,
    ``freeze_projector=True``) on labeled speech through the frozen random
    projector, standing in for a pretrained language model that uses its
    audio positions (warming up on noise teaches the decoder to ignore them,
    after which no projector training moves WER);
1.  stage 1: towers frozen, the projector trains;
2.  stage 2: projector frozen, LoRA adapters on the decoder train.

Held-out rows use another seed (unseen voices and word sequences), so a
WER drop is generalization, not memorization.  The model runs on the CUDA
device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

#: the CTC-pretrained tiny encoder (a byte-identical copy of the JAX
#: package's artifact)
ENCODER_ARTIFACT = Path(__file__).resolve().parents[1] / "data" / "convergence_encoder.msgpack"
#: the JAX package's seed-0 projector and decoder of the tiny fp32 towers
#: (``ASRModel(tiny_test_config(model_dtype="float32"), seed=0).params``),
#: written by flax: with ENCODER_ARTIFACT, the start of the JAX package's
#: convergence gate, whose WER threshold holds from that draw and not from
#: every draw of the same initializers
INIT_ARTIFACT = Path(__file__).resolve().parents[1] / "data" / "convergence_init.msgpack"

DEFAULT_VOCAB = [
    "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
    "hello", "world", "speech", "audio", "model", "test",
]


def ctc_loss(logits: torch.Tensor, logit_pad: torch.Tensor, labels: torch.Tensor,
             label_pad: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood [B] with ``optax.ctc_loss``'s
    arguments: ``logits`` [B, T, C], ``logit_pad`` [B, T] (1 = padding),
    ``labels`` [B, S] int and ``label_pad`` [B, S] (1 = padding)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    input_lengths = (1 - logit_pad).sum(dim=1).long()
    target_lengths = (1 - label_pad).sum(dim=1).long()
    return F.ctc_loss(log_probs, labels.long(), input_lengths, target_lengths, blank=blank,
                      reduction="none", zero_infinity=False)


class OptaxAdamW:
    """``optax.adamw(optax.cosine_decay_schedule(lr, steps, alpha))`` over a
    list of fp32 tensors: optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4 on every leaf), bias corrections at the incremented
    count, the schedule read at the count before the increment."""

    def __init__(self, params: list, lr: float, decay_steps: int, alpha: float = 0.1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.params = params
        self.lr, self.decay_steps, self.alpha = lr, decay_steps, alpha
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def schedule(self, count: int) -> float:
        frac = min(count, self.decay_steps) / self.decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return self.lr * ((1.0 - self.alpha) * cosine + self.alpha)

    @torch.no_grad()
    def step(self, grads: list) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        f32 = torch.float32
        c1 = float(1 - torch.tensor(self.b1, dtype=f32) ** self.count)
        c2 = float(1 - torch.tensor(self.b2, dtype=f32) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p
            p.sub_(lr * update)


def pretrain_encoder_ctc(
    model,
    train_rows: list[dict],
    eval_rows: list[dict],
    vocab: list[str],
    steps: int = 600,
    batch: int = 16,
    lr: float = 2e-3,
    seed: int = 0,
    verbose: bool = True,
) -> dict:
    """Pretrain ``model.encoder`` in place with a linear CTC head (blank 0,
    word ids from 1) on the synthetic vocabulary, then discard the head.
    The loss is the batch's summed CTC loss over its number of labels; the
    optimizer :class:`OptaxAdamW`; the batches ``default_rng(seed)``'s, as in
    the JAX package.  On the card the encoder attention's gradient is kernel
    #1's plain-recompute backward.  Returns the loss curve (ten points) and
    the held-out greedy-decode token error rate."""
    from tiny_audio_tpu_torch.config import compute_encoder_output_length
    from tiny_audio_tpu_torch.eval.wer import WerCounts, align_counts
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    proc = ASRPipeline(model).processor
    cfg = model.config.encoder
    dev = model.device
    word_index = {w: i for i, w in enumerate(vocab)}
    blank = 0

    def features(rows):
        feats = proc.extract_features([r["audio"]["array"] for r in rows])
        max_words = max(len(r["text"].split()) for r in rows)
        labels = np.zeros((len(rows), max_words), np.int64)
        label_pad = np.ones((len(rows), max_words), np.float32)
        for i, r in enumerate(rows):
            ids = [word_index[w] + 1 for w in r["text"].split()]
            labels[i, : len(ids)] = ids
            label_pad[i, : len(ids)] = 0.0
        return (feats["input_features"].float(), feats["audio_attention_mask"].long(),
                torch.from_numpy(labels).to(dev), torch.from_numpy(label_pad).to(dev))

    mel_tr, mask_tr, lab_tr, lpad_tr = features(train_rows)
    mel_ev, mask_ev, lab_ev, lpad_ev = features(eval_rows)
    if mel_tr.shape[-1] != mel_ev.shape[-1]:
        raise ValueError(f"train and eval landed in different mel buckets "
                         f"({mel_tr.shape[-1]} vs {mel_ev.shape[-1]})")

    gen = torch.Generator(device=dev).manual_seed(seed)
    head_w = torch.empty((cfg.d_model, len(vocab) + 1), dtype=torch.float32, device=dev)
    head_w = (0.02 * head_w.normal_(generator=gen)).requires_grad_(True)
    head_b = torch.zeros(len(vocab) + 1, dtype=torch.float32, device=dev, requires_grad=True)
    enc_params = list(model.encoder.parameters())
    trainable = [p for p in enc_params if p.dtype.is_floating_point] + [head_w, head_b]
    frozen_state = [p.requires_grad for p in enc_params]
    for p in enc_params:
        p.requires_grad_(True)

    def logits_fn(mel, mask):
        hidden = model.encoder(mel, mask)
        logits = hidden.float() @ head_w + head_b
        enc_len = compute_encoder_output_length(mask.sum(-1), cfg.conv_layers)
        logit_pad = (torch.arange(logits.shape[1], device=dev)[None]
                     >= enc_len[:, None]).float()
        return logits, logit_pad

    opt = OptaxAdamW(trainable, lr, steps)
    step_rng = np.random.default_rng(seed)
    curve = []
    try:
        for i in range(steps):
            idx = torch.from_numpy(step_rng.integers(0, len(train_rows), batch)).to(dev)
            logits, logit_pad = logits_fn(mel_tr[idx], mask_tr[idx])
            per = ctc_loss(logits, logit_pad, lab_tr[idx], lpad_tr[idx], blank)
            loss = per.sum() / torch.clamp((1.0 - lpad_tr[idx]).sum(), min=1.0)
            grads = torch.autograd.grad(loss, trainable)
            opt.step(grads)
            if (i + 1) % max(steps // 10, 1) == 0:
                curve.append((i + 1, loss.item()))
                if verbose:
                    print(f"[convergence] ctc step={i + 1} loss={curve[-1][1]:.3f}")
        with torch.no_grad():
            logits, logit_pad = logits_fn(mel_ev, mask_ev)
    finally:
        for p, requires in zip(enc_params, frozen_state):
            p.requires_grad_(requires)

    # held-out greedy CTC decode -> token error rate (are the features informative?)
    pred = logits.argmax(-1).cpu().numpy()
    valid = logit_pad.cpu().numpy() == 0.0
    lab_ev, lpad_ev = lab_ev.cpu().numpy(), lpad_ev.cpu().numpy()
    counts = WerCounts()
    for b in range(pred.shape[0]):
        seq, prev = [], -1
        for t, ok in zip(pred[b], valid[b]):
            if ok and t != prev and t != blank:
                seq.append(int(t))
            prev = int(t)
        ref = [int(x) for x, p in zip(lab_ev[b], lpad_ev[b]) if p == 0.0]
        counts = counts + align_counts(ref, seq)
    ter = counts.wer
    if verbose:
        print(f"[convergence] ctc held-out token error rate: {ter:.3f}")
    return {"curve": curve, "token_error_rate": ter}


def save_pretrained_encoder(model, path: str) -> None:
    """Write the encoder's params in flax's msgpack layout (the JAX params
    tree), which :func:`load_pretrained_encoder` and the JAX package's
    loader both read."""
    from tiny_audio_tpu_torch.bridge import state_dict_to_jax
    from tiny_audio_tpu_torch.utils import msgpack_io

    msgpack_io.save(path, state_dict_to_jax(model)["encoder"])


def load_pretrained_encoder(model, path: str) -> None:
    """Fill ``model.encoder`` from a file :func:`save_pretrained_encoder` (or
    the JAX package's) wrote; every encoder leaf must be present."""
    from tiny_audio_tpu_torch.bridge import load_jax_params
    from tiny_audio_tpu_torch.utils import msgpack_io

    load_jax_params(model, {"encoder": msgpack_io.load(path)}, require_all=False)


def load_gate_start(model) -> None:
    """Set a tiny fp32 ``model`` to the convergence gate's start: the JAX
    gate's seed-0 projector and decoder (INIT_ARTIFACT) and the
    CTC-pretrained encoder (ENCODER_ARTIFACT)."""
    from tiny_audio_tpu_torch.bridge import load_jax_params
    from tiny_audio_tpu_torch.utils import msgpack_io

    load_jax_params(model, msgpack_io.load(INIT_ARTIFACT), require_all=False)
    load_pretrained_encoder(model, str(ENCODER_ARTIFACT))


def _wer_eval(model, rows: list[dict], max_new_tokens: int = 48) -> float:
    """Held-out corpus WER through the pipeline's greedy decode."""
    from tiny_audio_tpu_torch.eval.normalizer import TextNormalizer
    from tiny_audio_tpu_torch.eval.wer import corpus_wer
    from tiny_audio_tpu_torch.pipeline import ASRPipeline

    pipe = ASRPipeline(model)
    norm = TextNormalizer()
    refs, hyps = [], []
    cap = pipe.BATCH_BUCKETS[-1]
    for i in range(0, len(rows), cap):
        chunk = rows[i : i + cap]
        texts = pipe.transcribe_batch([r["audio"] for r in chunk],
                                      max_new_tokens=max_new_tokens)
        refs.extend(norm(r["text"]) for r in chunk)
        hyps.extend(norm(t) for t in texts)
    return corpus_wer(refs, hyps)


def train_stage(
    model,
    collator,
    train_rows: list[dict],
    eval_rows: list[dict],
    out_dir: str,
    steps: int,
    lr: float,
    batch: int = 8,
    seed: int = 0,
    verbose: bool = True,
) -> dict:
    """One phase of the ladder through the Trainer, which trains what
    ``model.config`` leaves unfrozen (``requires_grad`` is set from it here);
    returns the Trainer's result with the logged loss curve and the wall
    seconds."""
    from tiny_audio_tpu_torch.train.optim import OptimizerConfig
    from tiny_audio_tpu_torch.train.trainer import Trainer, TrainingConfig

    run_dir = Path(out_dir)
    cfg = TrainingConfig(
        output_dir=str(run_dir),
        max_steps=steps,
        per_device_batch_size=batch,
        logging_steps=max(steps // 10, 1),
        save_steps=steps,
        save_total_limit=1,
        eval_steps=0,
        dataloader_workers=0,
        optimizer=OptimizerConfig(
            learning_rate=lr, decoder_learning_rate=lr,
            warmup_steps=min(20, steps // 5),
            lr_scheduler_type="cosine", total_steps=steps,
        ),
        seed=seed,
    )
    t0 = time.time()
    model.freeze()
    result = Trainer(model, cfg, train_rows, collator, eval_dataset=eval_rows).train()
    curve = [
        (rec["step"], rec["loss"])
        for rec in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
        if "loss" in rec
    ]
    result["seconds"] = time.time() - t0
    result["curve"] = curve
    if verbose:
        print(f"[convergence] {run_dir.name}: {steps} steps in {result['seconds']:.0f}s, "
              f"loss {curve[0][1]:.3f} -> {curve[-1][1]:.3f}, "
              f"eval_loss {result.get('eval_loss', float('nan')):.3f}")
    return result


def run_convergence_ladder(
    out_dir: str,
    vocab: "list[str] | None" = None,
    n_train: int = 384,
    n_eval: int = 32,
    batch: int = 8,
    ctc_steps: int = 600,
    warmup_steps: int = 400,
    s1_steps: int = 500,
    s2_steps: int = 200,
    ctc_lr: float = 2e-3,
    warmup_lr: float = 3e-3,
    s1_lr: float = 1e-3,
    s2_lr: float = 1e-3,
    lora_rank: int = 4,
    words_per_utt: tuple[int, int] = (2, 4),
    seed: int = 0,
    verbose: bool = True,
    save_encoder_path: "str | None" = None,
    device="cuda",
) -> dict:
    """Run the four phases on the tiny fp32 towers; returns (and writes
    ``convergence.json`` in ``out_dir``) the JAX package's record::

        {"wer_init", "wer_warmup", "wer_s1", "wer_s2", "eval_loss_warmup",
         "eval_loss_s1", "eval_loss_s2", "ctc_token_error_rate",
         "phase_seconds": {...}, "curves": {phase: [(step, loss), ...]}, ...}
    """
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.utils.speech_synth import labeled_speech_dataset

    vocab = vocab or list(DEFAULT_VOCAB)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    speech_train = labeled_speech_dataset(n_train, vocab, seed=seed, words_per_utt=words_per_utt)
    # held out: another seed -> unseen word sequences and unseen voices
    speech_eval = labeled_speech_dataset(n_eval, vocab, seed=seed + 10_000,
                                         words_per_utt=words_per_utt)

    model = ASRModel(tiny_test_config(model_dtype="float32"), seed=seed, device=device)
    # the system prompt must match inference's (the pipeline's prompt
    # uses config.system_prompt): a decoder trained prompt-free scores ~0
    # teacher-forced accuracy under the eval prompt
    collator = DataCollator(
        model.tokenizer, model.projector,
        num_mel_bins=model.config.encoder.num_mel_bins,
        system_prompt=model.config.system_prompt,
        encoder_conv_layers=model.config.encoder_conv_layers,
        device=model.device,
    )

    def phase(name: str, steps: int, lr: float) -> dict:
        return train_stage(model, collator, speech_train, speech_eval[:16], str(out / name),
                           steps, lr, batch=batch, seed=seed, verbose=verbose)

    # ---- phase -1: encoder CTC pretrain (the pretrained tower)
    t0 = time.time()
    ctc = pretrain_encoder_ctc(model, speech_train, speech_eval, vocab, steps=ctc_steps,
                               batch=16, lr=ctc_lr, seed=seed, verbose=verbose)
    ctc["seconds"] = time.time() - t0
    if save_encoder_path:
        save_pretrained_encoder(model, save_encoder_path)

    wer_init = _wer_eval(model, speech_eval)
    if verbose:
        print(f"[convergence] held-out WER at init: {wer_init:.3f}")

    # ---- phase 0: decoder warmup through the frozen random projector
    model.config.freeze_language_model = False
    model.config.freeze_projector = True
    warm = phase("decoder_warmup", warmup_steps, warmup_lr)
    wer_warmup = _wer_eval(model, speech_eval)
    if verbose:
        print(f"[convergence] held-out WER after decoder warmup: {wer_warmup:.3f}")

    # ---- phase 1: stage 1, projector only
    model.config.freeze_language_model = True
    model.config.freeze_projector = False
    s1 = phase("stage1_projector", s1_steps, s1_lr)
    wer_s1 = _wer_eval(model, speech_eval)
    if verbose:
        print(f"[convergence] held-out WER after stage 1: {wer_s1:.3f}")

    # ---- phase 2: stage 2, LoRA (projector frozen, adapters train): fresh
    # adapters over the trained base weights
    model.config.use_lora = True
    model.config.lora_rank = lora_rank
    model.config.lora_alpha = 2 * lora_rank
    model.config.freeze_projector = True
    model.config.freeze_language_model = True  # LoRA leaves are exempt
    rebuilt = ASRModel(model.config, tokenizer=model.tokenizer, seed=seed, device=device)
    params = dict(rebuilt.named_parameters())
    with torch.no_grad():
        for name, value in model.named_parameters():
            params[name].copy_(value)
    model = rebuilt
    s2 = phase("stage2_lora", s2_steps, s2_lr)
    wer_s2 = _wer_eval(model, speech_eval)
    if verbose:
        print(f"[convergence] held-out WER after stage 2: {wer_s2:.3f}")

    record = {
        "vocab_size": len(vocab),
        "n_train": n_train,
        "n_eval": n_eval,
        "steps": {"ctc": ctc_steps, "warmup": warmup_steps, "s1": s1_steps, "s2": s2_steps},
        "ctc_token_error_rate": ctc["token_error_rate"],
        "wer_init": wer_init,
        "wer_warmup": wer_warmup,
        "wer_s1": wer_s1,
        "wer_s2": wer_s2,
        "eval_loss_warmup": warm.get("eval_loss"),
        "eval_loss_s1": s1.get("eval_loss"),
        "eval_loss_s2": s2.get("eval_loss"),
        "phase_seconds": {"ctc": ctc["seconds"], "warmup": warm["seconds"],
                          "s1": s1["seconds"], "s2": s2["seconds"]},
        "curves": {"ctc": ctc["curve"], "warmup": warm["curve"],
                   "s1": s1["curve"], "s2": s2["curve"]},
    }
    (out / "convergence.json").write_text(json.dumps(record, indent=2))
    return record
