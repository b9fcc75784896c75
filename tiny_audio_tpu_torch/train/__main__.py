"""Training entry point of the port: configs -> model -> data -> Trainer.

The port's counterpart of the JAX package's ``scripts/train.py``: composes
the repo's ``configs/`` with ``+experiments=`` overlays and dotted
overrides, builds the model on the card (fresh, or from a checkpoint of
either package), wires augmentation and silence injection, picks the
(multitask) collator and runs :class:`~tiny_audio_tpu_torch.train.trainer.Trainer`.

Usage::

    python -m tiny_audio_tpu_torch.train +experiments=smoke
    python -m tiny_audio_tpu_torch.train +experiments=mlp_lora \
        run.pretrained_model_path=outputs/stage1/model
    python -m tiny_audio_tpu_torch.train +experiments=smoke run.device=cpu

``run.device`` (default ``cuda``) names the device; without a card the
default raises.  Composing ``configs/`` needs PyYAML.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"

#: training-stage fields a new config sets over a loaded checkpoint's
STAGE_FIELDS = ("use_lora", "lora_rank", "lora_alpha", "lora_target_modules",
                "freeze_projector", "freeze_language_model", "audio_token_dropout",
                "gradient_checkpointing")


def build_model(cfg: dict, device="cuda"):
    """ASRModel from the composed tree (``run.tiny_model``: the tiny towers
    of ``tiny_test_config``)."""
    import torch

    from tiny_audio_tpu_torch.config import ASRConfig, tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.tokenization import HFTokenizerAdapter

    run = cfg.get("run", {}) or {}
    model_cfg = dict(cfg.get("model", {}) or {})
    model_cfg.pop("defaults_note", None)
    if run.get("tiny_model"):
        fields = {f.name for f in dataclasses.fields(ASRConfig)}
        asr_config = tiny_test_config(**{k: v for k, v in model_cfg.items()
                                         if k in fields and k not in ("encoder", "decoder")})
    else:
        asr_config = ASRConfig.from_dict(model_cfg)

    tokenizer = None
    if run.get("tokenizer_path"):
        tokenizer = HFTokenizerAdapter.from_pretrained(run["tokenizer_path"])

    pretrained = run.get("pretrained_model_path")
    if not pretrained:
        return ASRModel(asr_config, tokenizer=tokenizer, seed=int(run.get("seed", 0)),
                        device=device)
    model = ASRModel.from_pretrained(pretrained, tokenizer=tokenizer, device=device)
    config = model.config
    for key in STAGE_FIELDS:
        if key in model_cfg:
            setattr(config, key, model_cfg[key])
    if not (config.use_lora or config.gradient_checkpointing):
        model.freeze()  # requires_grad from the new stage's labels
        return model
    # rebuild with the new stage's fields (fresh LoRA adapters) over the
    # loaded base weights, as the JAX package's scripts/train.py does
    rebuilt = ASRModel(config, tokenizer=model.tokenizer, seed=0, device=device)
    params = dict(rebuilt.named_parameters())
    with torch.no_grad():
        for name, value in model.named_parameters():
            if "lora" not in name:
                params[name].copy_(value)
    return rebuilt


def build_augmentation(train_cfg: dict):
    from tiny_audio_tpu_torch.train.augmentation import (
        AugmentationPipeline,
        NoiseAugmentation,
        RIRAugmentation,
    )

    rir_cfg = train_cfg.get("rir_augmentation") or {}
    noise_cfg = train_cfg.get("noise_augmentation") or {}
    silence_p = float(train_cfg.get("silence_injection_prob") or 0.0)
    rir = (RIRAugmentation(rir_dir=rir_cfg.get("rir_dir"), p=float(rir_cfg.get("p", 0.5)))
           if rir_cfg.get("enabled") else None)
    noise = (NoiseAugmentation(noise_dir=noise_cfg.get("noise_dir"),
                               transient_dir=noise_cfg.get("transient_dir"))
             if noise_cfg.get("enabled") or silence_p > 0 else None)
    if rir is None and noise is None:
        return None
    return AugmentationPipeline(rir=rir, noise=noise, silence_injection_prob=silence_p)


def main(argv=None, config_dir=CONFIG_DIR) -> dict:
    from tiny_audio_tpu_torch.train.collator import DataCollator, MultiTaskDataCollator
    from tiny_audio_tpu_torch.train.config_loader import load_config
    from tiny_audio_tpu_torch.train.data import DatasetLoader
    from tiny_audio_tpu_torch.train.optim import OptimizerConfig
    from tiny_audio_tpu_torch.train.trainer import Trainer, TrainingConfig

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = load_config(config_dir, argv)
    run = cfg.get("run", {}) or {}
    train_cfg = dict(cfg.get("training", {}) or {})
    device = run.get("device", "cuda")

    model = build_model(cfg, device=device)
    print(f"[train] device={model.device} projector={model.config.projector_type} "
          f"lora={model.config.use_lora} freeze_lm={model.config.freeze_language_model}")
    train_rows, eval_rows = DatasetLoader(cfg.get("data"), seed=int(run.get("seed", 0))).load()
    print(f"[train] {len(train_rows)} train rows, {len(eval_rows) if eval_rows else 0} eval rows")

    data_cfg = cfg.get("data") or {}
    multitask = any(ds.get("task") for ds in data_cfg.get("datasets", [])
                    if isinstance(ds, dict)) or getattr(train_rows, "has_tasks", False)
    collator_cls = MultiTaskDataCollator if multitask else DataCollator
    collator = collator_cls(
        model.tokenizer, model.projector,
        num_mel_bins=model.config.encoder.num_mel_bins,
        system_prompt=model.config.system_prompt,
        encoder_conv_layers=model.config.encoder_conv_layers,
        device=model.device,
    )
    opt_fields = {f.name for f in dataclasses.fields(OptimizerConfig)}
    tc_fields = {f.name for f in dataclasses.fields(TrainingConfig)}
    training = TrainingConfig(
        output_dir=str(run.get("output_dir", "outputs/run")),
        optimizer=OptimizerConfig(**{k: v for k, v in train_cfg.items() if k in opt_fields}),
        seed=int(run.get("seed", 0)),
        **{k: v for k, v in train_cfg.items()
           if k in tc_fields and k not in ("optimizer", "seed", "output_dir")},
    )
    trainer = Trainer(model, training, train_rows, collator, eval_dataset=eval_rows,
                      transform=build_augmentation(train_cfg))
    result = trainer.train()
    model.save_pretrained(Path(training.output_dir) / "model")
    print(f"[train] done: {result}")
    return result


if __name__ == "__main__":
    main()
