"""Measure the training ladder at flagship size on one card.

    python -m tiny_audio_tpu_torch.tools.bench_train_stages            # all three stages
    TA_STAGE=stage3 python -m tiny_audio_tpu_torch.tools.bench_train_stages   # just one

Port of ``scripts/bench_train_stages.py``.  Stage 1 trains the projector,
stage 2 LoRA adapters on the frozen decoder (projector frozen), stage 3 the
whole decoder under gradient checkpointing: the question is the step time
of each and whether stage 3's backward and optimizer state fit one card.

Each stage runs in a subprocess (a fresh CUDA context and caching
allocator, so its peak memory is its own) that builds the full-size model
with random weights from seed 0 (throughput does not depend on the weights'
values) on ``--device`` (the card unless ``cpu`` is asked for), one first
step, then ``STEPS`` timed steps on one synthetic batch.  Its last line is
``RESULT {json}`` with the script's keys: the median step ms, samples/s,
the first step's seconds under ``compile_s`` (here no compilation:
loading the kernel library, cuBLAS's handles and the caching allocator's
first blocks, and under gradient checkpointing the import of
``torch._dynamo`` that ``torch.utils.checkpoint``'s first call makes), the
trainable-parameter count, the last loss, the peak
device memory (``torch.cuda.max_memory_allocated``) and the card's memory
(``torch.cuda.mem_get_info``); both are 0 on the CPU.  Each timed step is a
:class:`~tiny_audio_tpu_torch.utils.profiling.StageTimer` stage closed by
``torch.cuda.synchronize()``.

The parent builds the kernels once (``kernels.build``) before the first
child, so the children load the library from ``build/kernels/<hash>/``
instead of running ``nvcc``; each child says which it did.  The parent
prints the JSON list of the results last, and exits 1 when a stage failed
(its entry is ``{"stage", "error": "rc=..."}``).  ``--tiny`` runs the tiny
test towers in fp32 on 5 s clips (a check of the tool, not a measurement).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

STAGES = {
    # (config overrides, batch size, grad checkpointing)
    "stage1_projector": {"overrides": {}, "batch": 6},
    "stage2_lora": {
        "overrides": {"use_lora": True, "lora_rank": 8, "lora_alpha": 32,
                      "freeze_projector": True},
        "batch": 6,
    },
    "stage3_full_decoder": {
        "overrides": {"freeze_language_model": False,
                      "gradient_checkpointing": True},
        "batch": 6,
    },
}
STEPS = 5
CLIP_S = 10.0
#: the tiny towers' clip: 500 frames, inside the tiny encoder's 512-frame window
TINY_CLIP_S = 5.0
SAMPLE_RATE = 16000
CHILD_TIMEOUT_S = 3600
TEXT = "the quick brown fox jumps over the dog"


def stage_config(overrides: dict, base=None):
    """``base`` (default the flagship ``ASRConfig()``) with a stage's
    overrides set and ``__post_init__`` run again, as the script does."""
    from tiny_audio_tpu_torch.config import ASRConfig

    cfg = copy.deepcopy(base) if base is not None else ASRConfig()
    for key, value in overrides.items():
        setattr(cfg, key, value)
    cfg.__post_init__()
    return cfg


def trainable_params(model, labels: dict) -> int:
    """Elements of the parameters whose optimizer label is not ``frozen``."""
    return sum(p.numel() for name, p in model.named_parameters() if labels[name] != "frozen")


def synthetic_batch(model, b: int, clip_s: float = CLIP_S) -> dict:
    """The script's synthetic production batch on ``model``'s device: ``b``
    clips of ``0.1 * standard_normal`` from ``default_rng(0)`` through the
    processor (bucketed mel), and one chat-templated row of ``TEXT`` holding
    the first clip's audio tokens, tiled ``b`` times; labels are the ids
    with ``-100`` at pad positions."""
    from tiny_audio_tpu_torch.processing import ASRProcessor

    device = model.device
    rng = np.random.default_rng(0)
    proc = ASRProcessor(model.tokenizer, projector=model.projector,
                        num_mel_bins=model.config.encoder.num_mel_bins, device=device)
    audio = [(0.1 * rng.standard_normal(int(clip_s * SAMPLE_RATE))).astype(np.float32)
             for _ in range(b)]
    feats = proc.extract_features(audio)
    n = int(proc.num_audio_tokens(int(feats["mel_lengths"][0])))
    row = np.asarray(
        proc.tokenizer.apply_chat_template(
            proc.build_messages(n, text=TEXT), tokenize=True, add_generation_prompt=False),
        np.int32)
    input_ids = np.tile(row, (b, 1))
    labels = np.where(input_ids == proc.tokenizer.pad_token_id, -100, input_ids)
    ids = torch.as_tensor(input_ids, device=device)
    return {
        "input_ids": ids,
        "attention_mask": torch.ones_like(ids),
        "labels": torch.as_tensor(labels, device=device),
        "input_features": feats["input_features"],
        "audio_attention_mask": feats["audio_attention_mask"],
    }


def stage_step(model):
    """(train_step, trainable count) of the script's optimizer
    (``total_steps=100``, decoder learning rate 1e-4) over ``model``."""
    from tiny_audio_tpu_torch.train.optim import OptimizerConfig, build_optimizer, make_train_step

    optimizer, labels = build_optimizer(
        model.config, OptimizerConfig(total_steps=100, decoder_learning_rate=1e-4), model)
    return make_train_step(model, optimizer), trainable_params(model, labels)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_stage(name: str, model, b: int, clip_s: float = CLIP_S) -> dict:
    """One first step and ``STEPS`` timed steps of ``model`` on the
    synthetic batch; returns the script's ``RESULT`` dict."""
    from tiny_audio_tpu_torch.utils.profiling import StageTimer

    device = model.device
    train_step, n_trainable = stage_step(model)
    batch = synthetic_batch(model, b, clip_s)
    generator = torch.Generator(device=device).manual_seed(0)
    timer = StageTimer()
    with timer.stage("first"):
        loss, _ = train_step(batch, generator)
        float(loss)
    for _ in range(STEPS):
        with timer.stage("step"):
            loss, _ = train_step(batch, generator)
            _sync(device)
    summary = timer.summary()
    step_s = summary["step"]["p50_s"]
    peak = limit = 0
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        limit = torch.cuda.mem_get_info(device)[1]
    return {
        "stage": name,
        "batch": b,
        "step_ms": round(step_s * 1000, 1),
        "samples_per_s": round(b / step_s, 2),
        "compile_s": round(summary["first"]["total_s"], 1),
        "trainable_params_m": round(n_trainable / 1e6, 2),
        "loss": round(float(loss), 3),
        "peak_hbm_gb": round(peak / 2**30, 2),
        "hbm_limit_gb": round(limit / 2**30, 2),
    }


def _kernels_origin() -> str:
    """Build or load the kernel library; says which, and its build key."""
    from tiny_audio_tpu_torch import kernels

    path, seconds, _ = kernels.build()
    return f"{f'built in {seconds:.1f} s' if seconds else 'loaded'} {path.parent.name}"


def _child() -> None:
    """A stage in this process, from ``TA_STAGE_SPEC``; prints its kernels'
    origin and the ``RESULT`` line."""
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.device import require_device
    from tiny_audio_tpu_torch.models.asr import ASRModel

    spec = json.loads(os.environ["TA_STAGE_SPEC"])
    device = require_device(spec["device"])
    print(f"KERNELS {_kernels_origin() if device.type == 'cuda' else 'none (cpu)'}", flush=True)
    base = tiny_test_config(model_dtype="float32") if spec["tiny"] else None
    cfg = stage_config(spec["overrides"], base)
    model = ASRModel(cfg, seed=0, device=device)
    clip_s = TINY_CLIP_S if spec["tiny"] else CLIP_S
    print("RESULT " + json.dumps(measure_stage(spec["name"], model, spec["batch"], clip_s)),
          flush=True)


def run_stages(only: str | None = None, device: str = "cuda", tiny: bool = False,
               log=print) -> list[dict]:
    """Each stage whose name contains ``only`` (all when None) in a child
    process; returns the results, a failed stage as its error entry."""
    from tiny_audio_tpu_torch.device import require_device

    if require_device(device).type == "cuda":
        log(f"[stages] kernels {_kernels_origin()}")
    root = str(Path(__file__).resolve().parents[2])
    results = []
    for name, spec in STAGES.items():
        if only and only not in name:
            continue
        env = dict(os.environ, TA_STAGE_SPEC=json.dumps(
            {"name": name, **spec, "device": device, "tiny": tiny}))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
        log(f"[stages] running {name}...")
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "tiny_audio_tpu_torch.tools.bench_train_stages", "--child"],
                env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
                stdin=subprocess.DEVNULL)
        except subprocess.TimeoutExpired:
            log(f"[stages] {name} FAILED: no result after {CHILD_TIMEOUT_S} s")
            results.append({"stage": name, "error": f"timeout={CHILD_TIMEOUT_S}s"})
            continue
        lines = proc.stdout.splitlines()
        kernels_line = next((ln for ln in lines if ln.startswith("KERNELS ")), None)
        line = next((ln for ln in lines if ln.startswith("RESULT ")), None)
        if line is None or proc.returncode != 0:
            tail = (proc.stdout + proc.stderr)[-2000:]
            log(f"[stages] {name} FAILED (rc={proc.returncode}):\n{tail}")
            results.append({"stage": name, "error": f"rc={proc.returncode}"})
            continue
        res = json.loads(line[len("RESULT "):])
        log(f"[stages] {name}: kernels {kernels_line[len('KERNELS '):]}; {res}")
        results.append(res)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m tiny_audio_tpu_torch.tools.bench_train_stages")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="the tiny test towers in fp32 on 5 s clips (a check, not a measurement)")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        _child()
        return
    results = run_stages(os.environ.get("TA_STAGE"), args.device, args.tiny,
                         log=lambda line: print(line, flush=True))
    print(json.dumps(results), flush=True)
    if any("error" in r for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
