"""Convergence gate of the port: the PyTorch training stack must learn.

The counterpart of ``tests/test_convergence_gate.py`` with the same data,
start, steps and thresholds: the tiny fp32 towers start where the JAX gate
starts (its seed-0 projector and decoder, ``tiny_audio_tpu_torch/data/
convergence_init.msgpack``, and the port's copy of the CTC-pretrained
encoder, ``convergence_encoder.msgpack``), the decoder warms up through the
frozen random projector, then stage 1 trains the projector alone, all
through the port's Trainer, collator and pipeline, and held-out
greedy-decode WER (unseen voices and word sequences) must drop below the
pinned gates.  The WER gate holds from that draw of the initializers, not
from every draw: the JAX gate itself misses it from seeds 1, 2 and 3.  A
zero-learning-rate stage 1 is the negative control: it must not pass the
strict marginal gate on the eval loss.  Runs on the CPU here; on the card,
``chip_smoke.py`` runs the same ladder.
"""

from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.slow


def test_staging_ladder_reduces_heldout_wer(tmp_path):
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.train.convergence import (
        DEFAULT_VOCAB,
        _wer_eval,
        load_gate_start,
        train_stage,
    )
    from tiny_audio_tpu_torch.utils.speech_synth import labeled_speech_dataset

    train_rows = labeled_speech_dataset(256, DEFAULT_VOCAB, seed=0)
    eval_rows = labeled_speech_dataset(24, DEFAULT_VOCAB, seed=10_000)

    model = ASRModel(tiny_test_config(model_dtype="float32"), seed=0, device="cpu")
    load_gate_start(model)
    collator = DataCollator(model.tokenizer, model.projector,
                            num_mel_bins=model.config.encoder.num_mel_bins,
                            system_prompt=model.config.system_prompt, device="cpu")

    wer_init = _wer_eval(model, eval_rows)
    assert wer_init > 0.6, f"untrained model scored WER {wer_init:.2f}: the task is degenerate"

    # decoder warmup: the decoder trains through the frozen random projector
    model.config.freeze_language_model = False
    model.config.freeze_projector = True
    warm = train_stage(model, collator, train_rows, eval_rows[:16], str(tmp_path / "warmup"),
                       steps=300, lr=3e-3, seed=0)
    assert warm["curve"][-1][1] < 0.5 * warm["curve"][0][1], warm["curve"]

    # stage 1: towers frozen, projector only; first the negative control
    # (lr 0 updates nothing), which must not pass the strict marginal gate
    model.config.freeze_language_model = True
    model.config.freeze_projector = False
    snapshot = {n: p.detach().clone() for n, p in model.named_parameters()}
    dead = train_stage(model, collator, train_rows, eval_rows[:16],
                       str(tmp_path / "stage1_dead"), steps=40, lr=0.0, seed=0)
    assert not (dead["eval_loss"] < warm["eval_loss"]), (warm["eval_loss"], dead["eval_loss"])
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(snapshot[name])

    s1 = train_stage(model, collator, train_rows, eval_rows[:16], str(tmp_path / "stage1"),
                     steps=300, lr=1e-3, seed=0)
    wer_s1 = _wer_eval(model, eval_rows)
    print(f"wer_init={wer_init!r} wer_s1={wer_s1!r} eval_loss_warmup={warm['eval_loss']!r} "
          f"eval_loss_dead={dead['eval_loss']!r} eval_loss_s1={s1['eval_loss']!r}")
    assert wer_s1 <= 0.85 * wer_init, f"WER init {wer_init:.3f} -> stage 1 {wer_s1:.3f}"
    assert s1["eval_loss"] < warm["eval_loss"], (warm, s1)


def _ladder(model, collator, tmp_path, train_stage, wer_eval, rows) -> dict:
    """The gate's warmup and stage 1 (no control) on ``model``; WER at init
    and after stage 1, eval losses after each stage, stage 1's first logged
    loss."""
    train_rows, eval_rows = rows
    wer_init = wer_eval(model, eval_rows)
    model.config.freeze_language_model, model.config.freeze_projector = False, True
    warm = train_stage(model, collator, train_rows, eval_rows[:16], str(tmp_path / "warmup"),
                       steps=300, lr=3e-3, seed=0, verbose=False)
    model.config.freeze_language_model, model.config.freeze_projector = True, False
    s1 = train_stage(model, collator, train_rows, eval_rows[:16], str(tmp_path / "stage1"),
                     steps=300, lr=1e-3, seed=0, verbose=False)
    wer_s1 = wer_eval(model, eval_rows)
    return {"wer_init": wer_init, "wer_s1": wer_s1, "ratio": wer_s1 / wer_init,
            "eval_loss_warmup": warm["eval_loss"], "eval_loss_s1": s1["eval_loss"],
            "s1_first_loss": s1["curve"][0][1]}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gate_margin_by_init_draw(tmp_path, seed):
    """The gate's WER threshold against the draw of the projector and
    decoder initializers: the JAX package's ladder from
    ``ASRModel(..., seed)``, the port's from that same draw, and the port's
    from its own seeded draw.  Prints each one's WER ratio (stage 1 / init;
    the gate asks <= 0.85), which is a property of the draw, not of either
    stack.  From JAX's draw the port must track JAX where the two fp32
    trajectories are still one: the warmup's eval loss and stage 1's first
    logged loss within 1e-5 (sums in other orders, ~5e-7 measured).  Later
    the sum-order noise can grow smoothly, as in any chaotic training run
    (seed 2: 2e-7 at stage 1's step 30, 3e-4 at 120, 5e-3 at 150), so the
    ends are printed, not compared."""
    import jax
    import numpy as np

    from tiny_audio_tpu.config import tiny_test_config as jax_tiny
    from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
    from tiny_audio_tpu.train import convergence as jconv
    from tiny_audio_tpu.train.collator import DataCollator as JaxCollator
    from tiny_audio_tpu_torch.bridge import load_jax_params
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.train import convergence as conv
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.utils.speech_synth import labeled_speech_dataset

    rows = (labeled_speech_dataset(256, conv.DEFAULT_VOCAB, seed=0),
            labeled_speech_dataset(24, conv.DEFAULT_VOCAB, seed=10_000))
    jm = JaxASRModel(jax_tiny(model_dtype="float32"), seed=seed)
    jconv.load_pretrained_encoder(jm, str(conv.ENCODER_ARTIFACT))
    start = jax.tree.map(np.asarray, jm.params)

    def port_model(params=None):
        model = ASRModel(tiny_test_config(model_dtype="float32"), seed=seed, device="cpu")
        if params is None:
            conv.load_pretrained_encoder(model, str(conv.ENCODER_ARTIFACT))
        else:
            load_jax_params(model, params)
        return model, DataCollator(model.tokenizer, model.projector, num_mel_bins=80,
                                   system_prompt=model.config.system_prompt, device="cpu")

    jcol = JaxCollator(jm.tokenizer, jm.projector, num_mel_bins=80,
                       system_prompt=jm.config.system_prompt)
    want = _ladder(jm, jcol, tmp_path / "jax", jconv.train_stage, jconv._wer_eval, rows)
    same = _ladder(*port_model(start), tmp_path / "same", conv.train_stage, conv._wer_eval, rows)
    own = _ladder(*port_model(), tmp_path / "own", conv.train_stage, conv._wer_eval, rows)
    print(f"seed={seed} jax={want} port_from_jax_draw={same} port_own_draw={own}")
    for key in ("eval_loss_warmup", "s1_first_loss"):
        assert abs(same[key] - want[key]) < 1e-5, (key, same, want)
