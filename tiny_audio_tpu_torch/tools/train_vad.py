"""Train the neural VAD (:mod:`tiny_audio_tpu_torch.vad`) on synthesized speech.

    python -m tiny_audio_tpu_torch.tools.train_vad [--device cuda] [--out PATH]
    python -m tiny_audio_tpu_torch.tools.train_vad --device cpu --steps 20 --utts 24 \\
        --out /tmp/vad.msgpack
    python -m tiny_audio_tpu_torch.tools.train_vad --eval-only   # the shipped weights

Port of ``scripts/train_vad.py``: formant-synthesized utterances
(:mod:`tiny_audio_tpu_torch.utils.speech_synth`) mixed through an
augmentation grid (white, pink, babble, music and hum noise at -5..30 dB
SNR, synthetic-RIR reverb near and far, level roving, clipping, a second
speaker, noise-only negatives), and the causal conv + GRU frame classifier
fit with masked BCE (+-2 frames around speech edges are don't-care) by
AdamW (``OptaxAdamW``: optax's ``adamw`` with weight decay 1e-5 on every
leaf) on ``cosine_decay_schedule(2e-3, steps, alpha=0.02)``.  The batches
are the JAX script's for the same seed, byte for byte; the features and the
network run on ``--device`` (the card unless ``--device cpu``).

``nn.GRU`` carries hidden biases for the r and z gates that flax's GRUCell
has not: they are held at zero (no gradient, so AdamW leaves them at 0), and
the written file is flax's tree (:func:`~tiny_audio_tpu_torch.bridge.
tower_flax_tree`), which both packages' ``NeuralVAD`` read.  The default
output is the port's ``data/vad_weights.msgpack``; ends with the heuristic-
vs-neural F1 table over held-out conditions (:func:`evaluate`).
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000
CLIP_S = 4.0
N_FRAMES = int(CLIP_S * SR) // 256  # 250
N_SAMPLES = N_FRAMES * 256

#: the JAX script's defaults
N_UTTS = 600
N_STEPS = 1500
BATCH = 32
LR = 2e-3
SEED = 0
ALPHA = 0.02
WEIGHT_DECAY = 1e-5
OUT_PATH = Path(__file__).resolve().parents[1] / "data" / "vad_weights.msgpack"


# ----------------------------------------------------------------- noise bank


def pink_noise(n: int, rng) -> np.ndarray:
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.maximum(np.fft.rfftfreq(n, 1 / SR), 1.0)
    out = np.fft.irfft(spec / np.sqrt(freqs), n)
    return (out / (np.std(out) + 1e-9)).astype(np.float32)


def music_noise(n: int, rng) -> np.ndarray:
    """Chord of harmonics with onsets: tonal interference (low spectral
    flatness, the heuristic's blind spot)."""
    t = np.arange(n) / SR
    root = rng.uniform(80, 400)
    out = np.zeros(n, np.float32)
    for mult in rng.choice([1.0, 1.25, 1.5, 2.0, 2.5, 3.0], 4, replace=False):
        phase = rng.uniform(0, 2 * np.pi)
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
        out += rng.uniform(0.3, 1.0) * np.sin(
            2 * np.pi * root * mult * vib * t + phase
        ).astype(np.float32)
    # note onsets every 0.3-0.8 s
    env = np.ones(n, np.float32)
    pos = 0
    while pos < n:
        dur = int(rng.uniform(0.3, 0.8) * SR)
        seg = min(dur, n - pos)
        env[pos: pos + seg] = np.exp(-2.0 * np.linspace(0, 1, seg))
        pos += dur
    out *= env
    return (out / (np.std(out) + 1e-9)).astype(np.float32)


def hum_noise(n: int, rng) -> np.ndarray:
    t = np.arange(n) / SR
    base = rng.choice([50.0, 60.0])
    out = sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * base * k * t) for k in (1, 2, 3))
    out = out + 0.1 * rng.standard_normal(n)
    return (out / (np.std(out) + 1e-9)).astype(np.float32)


def synth_rir(rng, rt60: float, drr_db: float) -> np.ndarray:
    """Exponentially decaying noise RIR; ``drr_db`` sets the direct-path
    level over the reverb tail (low = far-field)."""
    n = int(rt60 * SR)
    t = np.arange(n) / SR
    tail = rng.standard_normal(n).astype(np.float32) * np.exp(-6.9 * t / rt60)
    tail[: int(0.003 * SR)] *= 0.1  # pre-delay
    tail /= np.sqrt(np.sum(tail**2)) + 1e-9
    rir = tail * 10 ** (-drr_db / 20)
    rir[0] += 1.0  # direct path
    return rir


def apply_rir(x: np.ndarray, rir: np.ndarray) -> np.ndarray:
    n = len(x)
    nfft = 1 << int(np.ceil(np.log2(n + len(rir))))
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(rir, nfft), nfft)[:n]
    return y.astype(np.float32)


# ------------------------------------------------------------------- examples


class ExampleFactory:
    """Labeled 4 s examples from a pool of ``n_utts`` dry utterances, drawn
    from ``rng`` in the JAX script's order."""

    def __init__(self, rng, n_utts: int = N_UTTS, log=print):
        from tiny_audio_tpu_torch.utils.speech_synth import synth_utterance

        self.rng = rng
        log(f"[data] synthesizing {n_utts} dry utterances...")
        t0 = time.time()
        self.utts = []
        for i in range(n_utts):
            f0 = rng.uniform(90, 260)
            scale = rng.uniform(0.95, 1.25)
            audio, mask = synth_utterance(
                CLIP_S, SR, seed=i, f0=f0, vocal_tract_scale=scale,
                speech_fraction=rng.uniform(0.35, 0.85),
            )
            self.utts.append((audio[:N_SAMPLES], mask[:N_SAMPLES]))
        log(f"[data] done in {time.time() - t0:.1f}s")

    def babble(self, n: int) -> np.ndarray:
        """Sums of utterances from the pool, mixed only as noise."""
        rng = self.rng
        out = np.zeros(n, np.float32)
        for _ in range(6):
            a, _ = self.utts[rng.integers(len(self.utts))]
            out += np.roll(a, rng.integers(n))[:n]
        return (out / (np.std(out) + 1e-9)).astype(np.float32)

    def noise(self, n: int) -> np.ndarray:
        rng = self.rng
        kind = rng.integers(5)
        if kind == 0:
            return rng.standard_normal(n).astype(np.float32)
        if kind == 1:
            return pink_noise(n, rng)
        if kind == 2:
            return self.babble(n)
        if kind == 3:
            return music_noise(n, rng)
        return hum_noise(n, rng)

    def example(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (audio [N_SAMPLES], labels [N_FRAMES], weight [N_FRAMES])."""
        from tiny_audio_tpu_torch.utils.speech_synth import mask_to_frames

        rng = self.rng
        roll = rng.random()
        if roll < 0.15:  # noise-only negative
            audio = np.zeros(N_SAMPLES, np.float32)
            mask = np.zeros(N_SAMPLES, bool)
        else:
            a, m = self.utts[rng.integers(len(self.utts))]
            audio, mask = a.copy(), m.copy()
            if roll < 0.30:  # overlapping second speaker
                b, mb = self.utts[rng.integers(len(self.utts))]
                shift = rng.integers(N_SAMPLES)
                audio = audio + 0.8 * np.roll(b, shift)
                mask = mask | np.roll(mb, shift)

        # reverb before noise (the room acts on the source); labels stay dry
        if rng.random() < 0.4 and mask.any():
            rir = synth_rir(rng, rt60=rng.uniform(0.15, 1.0),
                            drr_db=rng.uniform(-6.0, 12.0))  # low DRR = far-field
            audio = apply_rir(audio, rir)

        speech_rms = np.sqrt(np.mean(audio[mask] ** 2)) if mask.any() else 0.0
        noise = self.noise(N_SAMPLES)
        if speech_rms > 0:
            snr_db = rng.uniform(-5.0, 30.0)
            noise_rms = speech_rms / (10 ** (snr_db / 20))
        else:
            noise_rms = rng.uniform(0.003, 0.1)
        audio = audio + noise * noise_rms

        # level roving + occasional clipping
        peak = np.max(np.abs(audio)) + 1e-9
        audio = audio * (10 ** (rng.uniform(-45.0, -6.0) / 20) / peak)
        if rng.random() < 0.1:
            audio = np.clip(audio * rng.uniform(2.0, 5.0), -1.0, 1.0)

        labels = mask_to_frames(mask, 256).astype(np.float32)[:N_FRAMES]
        # boundary don't-care: +-2 frames around every speech edge
        edges = np.flatnonzero(np.diff(labels) != 0)
        weight = np.ones(N_FRAMES, np.float32)
        for e in edges:
            weight[max(e - 1, 0): e + 3] = 0.0
        return audio.astype(np.float32), labels, weight

    def batch(self, size: int):
        xs, ys, ws = zip(*(self.example() for _ in range(size)))
        return np.stack(xs), np.stack(ys), np.stack(ws)


# ------------------------------------------------------------------- training


def init_vadnet(seed: int = SEED, device="cuda"):
    """A ``VADNet`` with flax's initializers, drawn from ``seed``: lecun-normal
    (truncated) conv, Dense and GRU input kernels, orthogonal GRU recurrent
    kernels, zero biases (the r and z hidden biases among them).  The draws
    are made on the CPU; the net is returned on ``device`` (the card unless
    the caller asks for ``"cpu"``)."""
    from torch import nn

    from tiny_audio_tpu_torch.device import require_device
    from tiny_audio_tpu_torch.vad import VADNet

    g = torch.Generator().manual_seed(seed)
    net = VADNet()
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, (nn.Conv1d, nn.Linear)):
                fan_in = module.weight[0].numel()
                lecun_normal_(module.weight, fan_in, g)
                module.bias.zero_()
            elif isinstance(module, nn.GRU):
                h = module.hidden_size
                for i in range(3):
                    rows = slice(i * h, (i + 1) * h)
                    lecun_normal_(module.weight_ih_l0[rows], module.input_size, g)
                    q, r = torch.linalg.qr(torch.randn((h, h), generator=g))
                    module.weight_hh_l0[rows] = q * torch.sign(torch.diagonal(r))
                module.bias_ih_l0.zero_()
                module.bias_hh_l0.zero_()
    return net.to(require_device(device))


def lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two deviations, scaled
    to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w.copy_(torch.nn.init.trunc_normal_(torch.empty(w.shape), 0.0, 1.0, -2.0, 2.0,
                                        generator=g) * std)


class VadTrainer:
    """The JAX script's training step on ``device``: features by
    ``vad_logmel``, masked BCE, AdamW on every leaf; the GRU's r and z
    hidden biases get no gradient."""

    def __init__(self, net, steps: int = N_STEPS, lr: float = LR):
        from tiny_audio_tpu_torch.train.convergence import OptaxAdamW

        self.net = net.train()
        self.params = list(net.parameters())
        self.opt = OptaxAdamW(self.params, lr, steps, alpha=ALPHA, weight_decay=WEIGHT_DECAY)
        gru = net.GRUCell_0
        self._bias_hh = next(i for i, p in enumerate(self.params) if p is gru.bias_hh_l0)
        self._rz = 2 * gru.hidden_size

    def step(self, audio: np.ndarray, labels: np.ndarray, weight: np.ndarray) -> float:
        from tiny_audio_tpu_torch.vad import vad_logmel

        device = self.params[0].device
        audio, labels, weight = (torch.from_numpy(x).to(device) for x in (audio, labels, weight))
        feats = vad_logmel(audio, n_frames=N_FRAMES)
        logits = self.net(feats)
        per = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
        loss = (per * weight).sum() / torch.clamp(weight.sum(), min=1.0)
        grads = list(torch.autograd.grad(loss, self.params))
        grads[self._bias_hh][: self._rz] = 0.0  # flax's GRUCell has no such bias
        self.opt.step(grads)
        return float(loss.detach())


def train(steps: int = N_STEPS, n_utts: int = N_UTTS, batch: int = BATCH, seed: int = SEED,
          device="cuda", init: Optional[dict] = None, log=print) -> dict:
    """Train a VAD; returns ``{"tree": flax params tree (CPU tensors),
    "losses": [...], "step_ms": [...]}``.  ``init``: a flax params tree to
    start from (the JAX script's ``VADNet.init``), else :func:`init_vadnet`."""
    from tiny_audio_tpu_torch.bridge import load_flax_tower, tower_flax_tree
    from tiny_audio_tpu_torch.device import require_device

    device = require_device(device)
    rng = np.random.default_rng(seed)
    factory = ExampleFactory(rng, n_utts, log=log)
    net = init_vadnet(seed, device)
    if init is not None:
        load_flax_tower(net, init)
    log(f"[train] VADNet params: {sum(p.numel() for p in net.parameters()):,}")
    trainer = VadTrainer(net, steps)
    losses, step_ms = [], []
    t0 = time.time()
    for i in range(1, steps + 1):
        audio, labels, weight = factory.batch(batch)
        t_step = time.perf_counter()
        losses.append(trainer.step(audio, labels, weight))  # float(): the step has ended
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        if i % 100 == 0 or i == 1:
            log(f"[train] step {i}/{steps} loss={losses[-1]:.4f} ({time.time() - t0:.0f}s)")
    return {"tree": tower_flax_tree(net), "losses": losses, "step_ms": step_ms}


# ----------------------------------------------------------------- evaluation


def _f1(pred: np.ndarray, truth: np.ndarray) -> float:
    tp = float(np.sum(pred & truth))
    p = tp / max(float(np.sum(pred)), 1.0)
    r = tp / max(float(np.sum(truth)), 1.0)
    return 2 * p * r / max(p + r, 1e-9)


def evaluate(tree: Optional[dict] = None, device="cuda", log=print) -> dict:
    """Heuristic-vs-neural F1 over held-out conditions (fresh seeds): the
    weights ``tree``, else the shipped ones."""
    from tiny_audio_tpu_torch.diarization import frame_vad
    from tiny_audio_tpu_torch.utils.speech_synth import mask_to_frames, synth_utterance
    from tiny_audio_tpu_torch.vad import HOP, NeuralVAD

    neural = NeuralVAD(tree, device) if tree is not None else NeuralVAD.get(device)
    assert neural is not None, "no trained weights found"

    rng = np.random.default_rng(12345)
    dur = 8.0
    conditions = {}

    def add(name, audio, mask):
        truth = mask_to_frames(mask, HOP)
        n = len(truth)
        conditions[name] = (_f1(frame_vad(audio)[:n], truth), _f1(neural(audio)[:n], truth))

    for seed in (1001, 1002):
        audio, mask = synth_utterance(dur, seed=seed, f0=rng.uniform(100, 230))
        peak = np.max(np.abs(audio))

        add(f"clean#{seed % 10}", audio, mask)
        add(f"quiet -40dBFS#{seed % 10}", audio * (10 ** (-40 / 20) / peak), mask)
        sp_rms = np.sqrt(np.mean(audio[mask] ** 2))
        for snr in (0, 10):
            noise = rng.standard_normal(len(audio)).astype(np.float32)
            noise *= sp_rms / (10 ** (snr / 20))
            add(f"white {snr}dB#{seed % 10}", audio + noise, mask)
        music = music_noise(len(audio), rng) * sp_rms / (10 ** (10 / 20))
        add(f"music 10dB#{seed % 10}", audio + music, mask)
        # far-field: strong reverb, weak direct path, moderate noise
        rir = synth_rir(rng, rt60=0.8, drr_db=-4.0)
        far = apply_rir(audio, rir)
        far += rng.standard_normal(len(far)).astype(np.float32) * (
            np.sqrt(np.mean(far**2)) / (10 ** (15 / 20)))
        add(f"far-field#{seed % 10}", far, mask)
        # overlap: second speaker at half amplitude
        b, mb = synth_utterance(dur, seed=seed + 50, f0=210.0, vocal_tract_scale=1.15)
        add(f"overlap#{seed % 10}", audio + 0.6 * b, mask | mb)

    log(f"\n{'condition':<22}{'heuristic':>10}{'neural':>10}")
    for name, (h, n) in sorted(conditions.items()):
        log(f"{name:<22}{h:>10.3f}{n:>10.3f}")
    hs = np.mean([h for h, _ in conditions.values()])
    ns = np.mean([n for _, n in conditions.values()])
    log(f"{'MEAN':<22}{hs:>10.3f}{ns:>10.3f}")
    return conditions


def main(argv=None) -> dict:
    from tiny_audio_tpu_torch.utils import msgpack_io

    parser = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.tools.train_vad")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=N_STEPS)
    parser.add_argument("--utts", type=int, default=N_UTTS)
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--out", type=Path, default=OUT_PATH)
    parser.add_argument("--no-eval", action="store_true", help="skip the F1 table")
    parser.add_argument("--eval-only", action="store_true",
                        help="train nothing: the F1 table of the weights at --out")
    args = parser.parse_args(argv)
    if args.eval_only:
        return {"f1": evaluate(msgpack_io.load(args.out), args.device)}
    t0 = time.time()
    out = train(args.steps, args.utts, args.batch, args.seed, args.device)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    msgpack_io.save(args.out, out["tree"])
    print(f"[train] wrote {args.out} ({args.out.stat().st_size / 1024:.0f} KB) "
          f"in {time.time() - t0:.1f}s")
    if not args.no_eval:
        out["f1"] = evaluate(out["tree"], args.device)
    return out


if __name__ == "__main__":
    main()
