"""Train the compact ECAPA-TDNN speaker embedder on synthetic voices.

    python -m tiny_audio_tpu_torch.tools.train_speaker_embedder [--device cuda] [--out PATH]
    python -m tiny_audio_tpu_torch.tools.train_speaker_embedder --device cpu --steps 10 \\
        --speakers 8 --out /tmp/ecapa.msgpack --no-der
    python -m tiny_audio_tpu_torch.tools.train_speaker_embedder --eval-only   # the shipped file

Port of ``scripts/train_speaker_embedder.py``: a small-channel ECAPA
(``CHANNELS = (256, 256, 256, 256, 768)``, ~2 M parameters) trained with an
AAM-softmax head (margin 0.2, scale 30) over 192 synthetic voices, each a
(f0, vocal-tract scale) of the formant synthesizer, 4 utterances a voice,
through the VAD trainer's noise, reverb and level augmentation
(:mod:`.train_vad`'s primitives); features are the diarizer's
``_speaker_fbank`` on the host, the network and the head run on
``--device``.  AdamW (``OptaxAdamW``, weight decay 1e-5 on every leaf) on
``cosine_decay_schedule(1e-3, steps, alpha=0.05)``.

The JAX package keeps each BatchNorm's ``mean`` and ``var`` as parameters,
so its trainer moves them by gradient like any weight; the port's
``BatchNorm1dEval`` holds them as buffers for inference, and this tool
trains them as JAX does (the buffers are made leaf tensors that take a
gradient, the module's code unchanged).  The result is written in fp16 in
flax's layout (``utils/msgpack_io.py``), which both packages'
``EcapaEmbedder`` read; the default output is the port's
``data/ecapa_synthetic.msgpack``.  Unless ``--no-der``, the DER of
``tools/bench_quality``'s synthetic conversations is printed with the
initial and the trained weights.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tiny_audio_tpu_torch.tools import train_vad

SR = 16000
WINDOW_S = 0.75          # the diarizer's embedding window
WIN_SAMPLES = int(WINDOW_S * SR)
#: the JAX script's defaults
N_SPEAKERS = 192
UTTS_PER_SPEAKER = 4
UTT_S = 3.0
N_STEPS = 3500
BATCH = 64
LR = 1e-3
SEED = 0
MARGIN = 0.2             # AAM-softmax margin
SCALE = 30.0             # AAM-softmax scale
ALPHA = 0.05
WEIGHT_DECAY = 1e-5
CHANNELS = (256, 256, 256, 256, 768)
OUT_PATH = Path(__file__).resolve().parents[1] / "data" / "ecapa_synthetic.msgpack"


def _speaker_voice(rng) -> dict:
    return {
        "f0": float(np.exp(rng.uniform(np.log(85.0), np.log(280.0)))),
        "scale": float(rng.uniform(0.88, 1.32)),
    }


class SpeakerData:
    """Windows of ``n_speakers`` synthetic voices and their labels, drawn
    from ``rng`` in the JAX script's order."""

    def __init__(self, rng, n_speakers: int = N_SPEAKERS,
                 utts_per_speaker: int = UTTS_PER_SPEAKER, log=print):
        from tiny_audio_tpu_torch.utils.speech_synth import synth_utterance

        self.rng = rng
        self.n_speakers, self.utts_per_speaker = n_speakers, utts_per_speaker
        log(f"[data] synthesizing {n_speakers} voices x {utts_per_speaker} utts...")
        t0 = time.time()
        self.voices = [_speaker_voice(rng) for _ in range(n_speakers)]
        self.utts: list[list[np.ndarray]] = []
        for spk, v in enumerate(self.voices):
            clips = []
            for u in range(utts_per_speaker):
                audio, _ = synth_utterance(
                    UTT_S, SR, seed=spk * 101 + u,
                    f0=v["f0"] * float(rng.uniform(0.96, 1.04)),
                    vocal_tract_scale=v["scale"],
                    speech_fraction=0.85,
                )
                clips.append(audio)
            self.utts.append(clips)
        log(f"[data] done in {time.time() - t0:.1f}s")

    def _augment(self, w: np.ndarray) -> np.ndarray:
        rng = self.rng
        m = train_vad
        if rng.random() < 0.45:
            rir = m.synth_rir(rng, rt60=float(rng.uniform(0.15, 0.9)),
                              drr_db=float(rng.uniform(-6.0, 12.0)))
            w = m.apply_rir(w, rir)
        if rng.random() < 0.7:
            kind = rng.integers(3)
            n = len(w)
            noise = (rng.standard_normal(n).astype(np.float32) if kind == 0
                     else m.pink_noise(n, rng) if kind == 1
                     else m.hum_noise(n, rng))
            rms = float(np.sqrt(np.mean(w**2))) + 1e-9
            snr = float(rng.uniform(0.0, 25.0))
            w = w + noise * rms / (10 ** (snr / 20))
        peak = float(np.max(np.abs(w))) + 1e-9
        return (w * 10 ** (float(self.rng.uniform(-30.0, -6.0)) / 20) / peak
                ).astype(np.float32)

    def batch(self, size: int):
        rng = self.rng
        xs, ys = [], []
        for _ in range(size):
            spk = int(rng.integers(self.n_speakers))
            clip = self.utts[spk][int(rng.integers(self.utts_per_speaker))]
            start = int(rng.integers(0, len(clip) - WIN_SAMPLES))
            w = clip[start: start + WIN_SAMPLES].copy()
            xs.append(self._augment(w))
            ys.append(spk)
        return np.stack(xs), np.asarray(ys, np.int32)


def aam_softmax(emb: torch.Tensor, head: torch.Tensor, labels: torch.Tensor):
    """The JAX script's loss and accuracy: additive angular margin on the
    target class over cosine logits scaled by SCALE."""
    emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-8)
    w = head / (torch.linalg.norm(head, dim=0, keepdim=True) + 1e-8)
    cos = emb @ w  # [B, speakers]
    onehot = F.one_hot(labels.long(), head.shape[1]).to(cos.dtype)
    theta = torch.arccos(torch.clamp(cos, -1 + 1e-6, 1 - 1e-6))
    logits = SCALE * (onehot * torch.cos(theta + MARGIN) + (1 - onehot) * cos)
    loss = -(onehot * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
    acc = (cos.argmax(dim=-1) == labels.long()).float().mean()
    return loss, acc


def trainable_statistics(net) -> list:
    """Each ``BatchNorm1dEval``'s ``running_mean`` and ``running_var``, made
    leaf tensors that take a gradient (the JAX package's ``mean``/``var``
    params); the module reads them as before."""
    from tiny_audio_tpu_torch.models.ecapa import BatchNorm1dEval

    stats = []
    for module in net.modules():
        if isinstance(module, BatchNorm1dEval):
            for name in ("running_mean", "running_var"):
                t = module._buffers[name].detach().clone().requires_grad_(True)
                module._buffers[name] = t
                stats.append(t)
    return stats


class EmbedderTrainer:
    """The JAX script's step on ``device``: the ECAPA (its BN statistics
    trained), the AAM head, AdamW on every leaf."""

    def __init__(self, net, head: torch.Tensor, steps: int = N_STEPS, lr: float = LR):
        from tiny_audio_tpu_torch.train.convergence import OptaxAdamW

        self.net = net
        self.head = head.requires_grad_(True)
        self.params = [*net.parameters(), *trainable_statistics(net), self.head]
        self.opt = OptaxAdamW(self.params, lr, steps, alpha=ALPHA, weight_decay=WEIGHT_DECAY)

    def step(self, feats: np.ndarray, labels: np.ndarray) -> tuple[float, float]:
        device = self.head.device
        loss, acc = aam_softmax(self.net(torch.from_numpy(feats).to(device)), self.head,
                                torch.from_numpy(labels).to(device))
        self.opt.step(list(torch.autograd.grad(loss, self.params)))
        return float(loss.detach()), float(acc)


def init_ecapa(seed: int = SEED):
    """The compact ECAPA with flax's initializers from ``seed`` (lecun-normal
    conv and Dense kernels, zero biases, BN scale 1, bias 0, mean 0, var 1)
    and the AAM head, N(0, 0.05^2) ``[embed_dim, N_SPEAKERS]``."""
    from torch import nn

    from tiny_audio_tpu_torch.models.ecapa import EcapaTDNN

    g = torch.Generator().manual_seed(seed)
    net = EcapaTDNN(channels=CHANNELS)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, (nn.Conv1d, nn.Linear)):
                train_vad.lecun_normal_(module.weight, module.weight[0].numel(), g)
                module.bias.zero_()
    head = torch.randn((net.embed_dim, N_SPEAKERS), generator=g) * 0.05
    return net, head


def train(steps: int = N_STEPS, n_speakers: int = N_SPEAKERS,
          utts_per_speaker: int = UTTS_PER_SPEAKER, batch: int = BATCH, seed: int = SEED,
          device="cuda", init: Optional[tuple] = None, log=print) -> dict:
    """Train the embedder; returns ``{"tree": flax params tree (CPU fp32),
    "losses", "accs", "step_ms"}``.  ``init``: ``(flax params tree, head)``
    to start from (the JAX script's init), else :func:`init_ecapa`."""
    from tiny_audio_tpu_torch.bridge import load_flax_tower, tower_flax_tree
    from tiny_audio_tpu_torch.device import require_device
    from tiny_audio_tpu_torch.diarization import _speaker_fbank

    device = require_device(device)
    rng = np.random.default_rng(seed)
    data = SpeakerData(rng, n_speakers, utts_per_speaker, log=log)
    net, head = init_ecapa(seed)
    if init is not None:
        load_flax_tower(net, init[0])
        head = torch.as_tensor(np.asarray(init[1], np.float32))
    head = head[:, :n_speakers].contiguous()
    net = net.to(device).train()
    log(f"[train] EcapaTDNN{CHANNELS} params: {sum(p.numel() for p in net.parameters()):,}")
    trainer = EmbedderTrainer(net, head.to(device), steps)
    losses, accs, step_ms = [], [], []
    t0 = time.time()
    for i in range(1, steps + 1):
        audio, labels = data.batch(batch)
        feats = _speaker_fbank(audio)
        t_step = time.perf_counter()
        loss, acc = trainer.step(feats, labels)  # float(): the step has ended
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        losses.append(loss)
        accs.append(acc)
        if i % 100 == 0 or i == 1:
            log(f"[train] step {i}/{steps} loss={loss:.4f} acc={acc:.3f} "
                f"({time.time() - t0:.0f}s)")
    return {"tree": tower_flax_tree(net), "losses": losses, "accs": accs, "step_ms": step_ms}


def fp16_tree(tree: dict) -> dict:
    """The tree in fp16, as the JAX script stores it."""
    return {k: fp16_tree(v) if isinstance(v, dict) else v.to(torch.float16)
            for k, v in tree.items()}


def der_with(embedder, conversations: int = 10, device="cuda") -> float:
    """Corpus DER (%) of ``tools/bench_quality``'s synthetic conversations
    with ``embedder`` as the diarizer's speaker tower on ``device``."""
    from tiny_audio_tpu_torch.diarization import EcapaEmbedder
    from tiny_audio_tpu_torch.tools.bench_quality import bench_diarization

    key = str(embedder.device)
    saved = EcapaEmbedder._instances.get(key)
    EcapaEmbedder._instances[key] = embedder
    try:
        return float(bench_diarization(conversations, device=device)["corpus_der"])
    finally:
        if saved is None:
            EcapaEmbedder._instances.pop(key, None)
        else:
            EcapaEmbedder._instances[key] = saved


def main(argv=None) -> dict:
    from tiny_audio_tpu_torch.diarization import EcapaEmbedder
    from tiny_audio_tpu_torch.models.ecapa import EcapaTDNN
    from tiny_audio_tpu_torch.utils import msgpack_io

    parser = argparse.ArgumentParser(
        prog="python -m tiny_audio_tpu_torch.tools.train_speaker_embedder")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=N_STEPS)
    parser.add_argument("--speakers", type=int, default=N_SPEAKERS)
    parser.add_argument("--utts", type=int, default=UTTS_PER_SPEAKER,
                        help="utterances a speaker")
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--out", type=Path, default=OUT_PATH)
    parser.add_argument("--no-der", action="store_true", help="skip the DER before and after")
    parser.add_argument("--eval-only", action="store_true",
                        help="train nothing: the DER with the weights at --out")
    args = parser.parse_args(argv)
    if args.eval_only:
        der = der_with(EcapaEmbedder.from_synthetic(args.out, args.device), device=args.device)
        print(f"[eval] synthetic-conversation DER with {args.out}: {der:.1f}%")
        return {"der": der}
    t0 = time.time()
    out = train(args.steps, args.speakers, args.utts, args.batch, args.seed, args.device)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    # fp16 halves the file; embeddings are compared by cosine
    msgpack_io.save(args.out, fp16_tree(out["tree"]))
    print(f"[train] wrote {args.out} ({args.out.stat().st_size / 1e6:.1f} MB) "
          f"in {time.time() - t0:.1f}s")
    if not args.no_der:
        before = EcapaEmbedder(module=init_ecapa(args.seed)[0], params=None, device=args.device)
        after = EcapaEmbedder(module=EcapaTDNN(channels=CHANNELS),
                              params=msgpack_io.load(args.out), tier="synthetic",
                              device=args.device)
        out["der_before"] = der_with(before, device=args.device)
        out["der_after"] = der_with(after, device=args.device)
        print(f"[eval] synthetic-conversation DER: init {out['der_before']:.1f}% -> "
              f"trained {out['der_after']:.1f}%")
    return out


if __name__ == "__main__":
    main()
