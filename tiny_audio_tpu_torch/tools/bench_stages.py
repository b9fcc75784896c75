"""Time each stage of the serving path on its own at the serving batch.

    python -m tiny_audio_tpu_torch.tools.bench_stages [--device cuda]

Port of ``scripts/bench_stages.py``.  Each stage of ``generate`` runs as its
own call at the serving batch, beside the full ``generate``, so that the
residual (full minus parts) is explicit instead of silently billed to a
stage:

  frontend    mel spectrogram + frame mask (``ops/mel.py``)
  enc+splice  encoder -> projector -> prompt embed -> splice
              (``ASRModel._splice_embeds``)
  prefill     decoder forward over the spliced prompt, cache write, one
              logit (``generation.prefill_prompt_cache``)
  e2e         ``ASRModel.generate`` (all of the above + the decode loop)
  decode      e2e - (frontend + enc+splice + prefill)   [residual]

The workload is the JAX script's: the flagship ``ASRConfig()`` with an int8
KV cache and random weights from seed 0; ``TA_BENCH_BATCH`` (default 48)
rows of 30 s float32 audio from ``default_rng(0)``; the prompt built as
``generate`` builds it; one warm call, then ``REPS`` timed calls.  Each
timed call is a :class:`~tiny_audio_tpu_torch.utils.profiling.StageTimer`
stage closed by ``torch.cuda.synchronize()``.  The model runs on
``--device`` (the card unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

REPS = 5
CLIP_S = 30.0
SAMPLE_RATE = 16000


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_inputs(model, batch: int, clip_s: float = CLIP_S) -> dict:
    """The script's inputs on ``model``'s device: ``batch`` rows of
    ``clip_s`` seconds of clipped noise from ``default_rng(0)``, their
    lengths and frame count, and the prompt ids at the serving shape
    (identical to ``generate``'s build) padded to ``t_pad`` with the pad id."""
    from tiny_audio_tpu_torch.ops import mel

    device = model.device
    n_samples = int(clip_s * SAMPLE_RATE)
    rng = np.random.default_rng(0)
    audio = np.clip(rng.standard_normal((batch, n_samples)) * 0.1, -1, 1).astype(np.float32)
    n_frames = n_samples // mel.HOP_LENGTH
    n_audio = model._num_audio_tokens(n_frames)
    ids = model.build_prompt_ids(n_audio)
    t_real = len(ids)
    t_pad = model._bucket_prompt_len(t_real, n_audio)
    ids_np = np.full((batch, t_pad), model.gen_config.pad_token_id, np.int32)
    ids_np[:, :t_real] = ids
    return {
        "audio": torch.as_tensor(audio, device=device),
        "lengths": torch.full((batch,), n_samples, dtype=torch.int32, device=device),
        "n_frames": n_frames,
        "n_audio": n_audio,
        "t_real": t_real,
        "t_pad": t_pad,
        "input_ids": torch.as_tensor(ids_np, device=device),
    }


@torch.inference_mode()
def frontend(model, audio: torch.Tensor, lengths: torch.Tensor, n_frames: int):
    """Stage 1: log-mel features [B, mels, T] and the frame mask [B, T]."""
    from tiny_audio_tpu_torch.ops import mel

    feats = mel.log_mel_spectrogram(audio, num_mel_bins=model.config.encoder.num_mel_bins)
    return feats, mel.frame_attention_mask(lengths, n_frames)


@torch.inference_mode()
def splice(model, feats: torch.Tensor, mask: torch.Tensor, input_ids: torch.Tensor):
    """Stage 2: the prefill's input embeddings (encoder, projector, splice)."""
    return model._splice_embeds(feats, mask, input_ids)


@torch.inference_mode()
def prefill(model, embeds: torch.Tensor, prompt_len: int):
    """Stage 3: the greedy first token [B] and the prompt's cache."""
    from tiny_audio_tpu_torch.generation import prefill_prompt_cache

    return prefill_prompt_cache(model.decoder, embeds, prompt_len=prompt_len)


def measure_stages(model, batch: int, reps: int = REPS, clip_s: float = CLIP_S) -> dict:
    """Time the stages and the full ``generate`` of ``model`` at ``batch``
    rows: one warm call each, then ``reps`` calls, each a ``StageTimer``
    stage closed by a device sync.  Returns the prompt's shape, each
    stage's mean ms, the decode residual and its ms per step, the
    compute-only RTFx and the timer's summary."""
    from tiny_audio_tpu_torch.utils.profiling import StageTimer

    device = model.device
    inputs = stage_inputs(model, batch, clip_s)
    timer = StageTimer()

    def timed(name: str, fn, *args):
        out = fn(*args)
        _sync(device)
        for _ in range(reps):
            with timer.stage(name):
                out = fn(*args)
                _sync(device)
        return out

    feats, mask = timed("frontend", lambda: frontend(model, inputs["audio"], inputs["lengths"],
                                                     inputs["n_frames"]))
    embeds = timed("encoder+proj+splice", lambda: splice(model, feats, mask, inputs["input_ids"]))
    timed("prefill", lambda: prefill(model, embeds, inputs["t_real"]))
    timed("e2e generate", lambda: model.generate(feats, mask, mel_length=inputs["n_frames"]))

    summary = timer.summary()
    ms = {name: stats["mean_s"] * 1e3 for name, stats in summary.items()}
    residual = (ms["e2e generate"] - ms["frontend"] - ms["encoder+proj+splice"]
                - ms["prefill"])
    max_new = int(model.config.max_new_tokens)
    return {
        "batch": batch,
        "clip_s": clip_s,
        "t_real": inputs["t_real"],
        "t_pad": inputs["t_pad"],
        "n_audio": inputs["n_audio"],
        "frontend_ms": ms["frontend"],
        "splice_ms": ms["encoder+proj+splice"],
        "prefill_ms": ms["prefill"],
        "e2e_ms": ms["e2e generate"],
        "decode_ms": residual,
        "max_new_tokens": max_new,
        "decode_step_ms": residual / float(max_new),
        "rtfx": batch * clip_s / (ms["e2e generate"] / 1e3),
        "stages": summary,
    }


def report_lines(r: dict) -> list[str]:
    """The JAX script's printed lines for a :func:`measure_stages` result."""
    return [
        f"batch={r['batch']} prompt t_real={r['t_real']} t_pad={r['t_pad']} "
        f"n_audio={r['n_audio']}",
        f"frontend            {r['frontend_ms']:8.1f} ms",
        f"encoder+proj+splice {r['splice_ms']:8.1f} ms",
        f"prefill             {r['prefill_ms']:8.1f} ms",
        f"e2e generate        {r['e2e_ms']:8.1f} ms",
        f"decode (residual)   {r['decode_ms']:8.1f} ms "
        f"({r['decode_step_ms']:.2f} ms/step x {r['max_new_tokens']})",
        f"RTFx (compute-only) {r['rtfx']:8.1f}",
    ]


def main(argv=None) -> None:
    from tiny_audio_tpu_torch.config import ASRConfig
    from tiny_audio_tpu_torch.device import require_device
    from tiny_audio_tpu_torch.models.asr import ASRModel

    parser = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.tools.bench_stages")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = require_device(args.device)
    batch = int(os.environ.get("TA_BENCH_BATCH", "48"))
    cfg = ASRConfig()
    cfg.kv_cache_dtype = "int8"
    model = ASRModel(cfg, seed=0, device=device)
    for line in report_lines(measure_stages(model, batch)):
        print(line, flush=True)


if __name__ == "__main__":
    main()
