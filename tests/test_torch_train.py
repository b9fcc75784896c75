"""The training slice: the PyTorch port vs the JAX package, on the CPU, fp32.

Same inputs (made with numpy from a seed) go through both packages:
attention gradients, the LoRA decoder, ``compute_loss`` and its gradients,
the optimizer and its schedules, the collator, augmentation, config
composition, a few Trainer steps and stage-2 checkpoints.  Tolerances are
stated where they are used; fp32 sums run in other orders in XLA and torch.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu_torch.bridge import jax_to_state_dict, load_jax_params, state_dict_to_jax
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.models.asr import ASRModel, merge_lora, split_lora

torch.set_num_threads(1)
# fp32 tolerances: the same math summed in another order
ATOL, RTOL = 1e-5, 1e-4


def _port(jm, seed=1):
    """The port model of a JAX model's config, its params copied in."""
    tm = ASRModel(PortASRConfig.from_dict(jm.config.to_dict()), seed=seed, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return tm


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows(n, seed=0, min_s=0.3, max_s=0.8):
    from tiny_audio_tpu.train.data import synthetic_dataset

    return synthetic_dataset(n, seed=seed, min_s=min_s, max_s=max_s)


def _jax_batch(jm, rows):
    from tiny_audio_tpu.train.collator import DataCollator

    col = DataCollator(jm.tokenizer, jm.projector, num_mel_bins=jm.config.encoder.num_mel_bins)
    return {k: np.array(v) for k, v in col(rows).items()}


# ------------------------------------------------------------- attention


@pytest.mark.parametrize("t,hq,hkv,d", [
    (21, 6, 2, 16),
    # the widths of the Hopper backward kernels, GQA group 2, past one 64-row tile
    (70, 4, 2, 64),
    (70, 4, 2, 128),
])
def test_prefill_backward_plain_matches_jax_grad(t, hq, hkv, d):
    """Autograd through the plain prefill attention (the backward kernels'
    oracle) against jax.grad of the JAX causal_self_attention (the naive
    path on the CPU): GQA groups 3 and 2, a right-padded row and padding
    inside a row."""
    from tiny_audio_tpu.ops.attention import causal_self_attention
    from tiny_audio_tpu_torch.ops.prefill_attention import prefill_attention_backward_plain

    rng = np.random.default_rng(0)
    b = 2
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, hkv, d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, t * 5 // 7:] = 0  # from key 15 at T = 21
    mask[0, 3:6] = 0

    def loss(q, k, v):
        return jnp.sum(causal_self_attention(q, k, v, jnp.asarray(mask)) * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    got = prefill_attention_backward_plain(*map(torch.from_numpy, (q, k, v)),
                                           torch.from_numpy(mask), torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_encoder_backward_plain_matches_jax_custom_vjp():
    """Autograd through the port's encoder attention on CPU tensors against
    jax.grad of encoder_attention_tpu (its Pallas kernel in interpret mode,
    its custom VJP recomputing the naive formula)."""
    from tiny_audio_tpu.ops.encoder_attention import encoder_attention_tpu
    from tiny_audio_tpu_torch.ops.encoder_attention import encoder_attention

    rng = np.random.default_rng(1)
    b, t, h, d = 2, 24, 2, 16
    q, k, v, dout = (rng.standard_normal((b, t, h * d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, t), np.int32)
    mask[1, 17:] = 0

    def loss(q, k, v):
        return jnp.sum(encoder_attention_tpu(q, k, v, jnp.asarray(mask), h, True) * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (encoder_attention(*leaves, torch.from_numpy(mask), h) * torch.from_numpy(dout)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(_np(leaf.grad), np.asarray(w), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------- LoRA, compute_loss


@pytest.fixture(scope="module")
def stage1_pair():
    jm = JaxASRModel(tiny_test_config(model_dtype="float32"), seed=0)
    return jm, _port(jm)


@pytest.fixture(scope="module")
def stage2_pair():
    """LoRA on the frozen decoder, projector frozen, lora_b nonzero."""
    cfg = tiny_test_config(model_dtype="float32", use_lora=True, freeze_projector=True)
    jm = JaxASRModel(cfg, seed=0)
    rng = np.random.default_rng(2)
    layers = jm.params["decoder"]["layers"]
    for name in list(layers):
        if name.endswith("_lora_b"):
            layers[name] = jnp.asarray(rng.standard_normal(layers[name].shape) * 0.05,
                                       jnp.float32)
    return jm, _port(jm)


def _jax_loss_and_grads(jm, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jm.compute_loss(p, jb, train=True)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jm.params)
    return float(loss), metrics, jax_to_state_dict(jax.tree.map(np.asarray, grads))


def test_compute_loss_and_projector_grads_match_jax(stage1_pair):
    """Stage 1: the loss, its metrics and every projector gradient equal
    jax.value_and_grad of the JAX compute_loss (audio_token_dropout 0); the
    frozen towers get no gradient at all."""
    jm, tm = stage1_pair
    batch = _jax_batch(jm, _rows(3))
    want_loss, want_metrics, want_grads = _jax_loss_and_grads(jm, batch)
    loss, metrics = tm.compute_loss(batch, train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=RTOL)
    assert int(metrics["num_label_tokens"]) == int(want_metrics["num_label_tokens"])
    assert float(metrics["aux_loss"]) == 0.0
    for name, p in tm.named_parameters():
        if name.startswith("projector."):
            np.testing.assert_allclose(_np(p.grad), _np(want_grads[name]), atol=ATOL, rtol=RTOL,
                                       err_msg=name)
            p.grad = None
        else:
            assert p.grad is None and not p.requires_grad, name


def test_lora_decoder_loss_and_grads_match_jax(stage2_pair):
    """Stage 2: with nonzero lora_b the decoder's output differs from the
    base model's and the loss equals JAX's; gradients reach the LoRA leaves
    only, and equal JAX's there."""
    jm, tm = stage2_pair
    batch = _jax_batch(jm, _rows(2, seed=4))
    want_loss, _, want_grads = _jax_loss_and_grads(jm, batch)
    loss, _ = tm.compute_loss(batch, train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=RTOL)
    lora = [n for n, _ in tm.named_parameters() if "lora" in n]
    assert len(lora) == 2 * 7 * tm.config.decoder.num_layers
    for name, p in tm.named_parameters():
        if "lora" in name:
            np.testing.assert_allclose(_np(p.grad), _np(want_grads[name]), atol=ATOL, rtol=RTOL,
                                       err_msg=name)
            p.grad = None
        else:
            assert p.grad is None, name
    base = ASRModel(PortASRConfig.from_dict(tiny_test_config(model_dtype="float32").to_dict()),
                    device="cpu")
    base.load_state_dict({n: v for n, v in tm.state_dict().items() if "lora" not in n})
    with torch.no_grad():
        assert abs(float(base.compute_loss(batch)[0]) - float(loss)) > 1e-4


def test_lora_generate_token_exact(stage2_pair):
    """The LoRA delta on every decode-step product: greedy tokens equal JAX's."""
    from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
    from tiny_audio_tpu_torch.processing import ASRProcessor

    jm, tm = stage2_pair
    audio = [np.random.default_rng(5).standard_normal(8000).astype(np.float32) * 0.1]
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features(audio)
    tf = ASRProcessor(tm.projector, num_mel_bins=80, device="cpu").extract_features(audio)
    want = jm.generate(jf["input_features"], jf["audio_attention_mask"], max_new_tokens=8,
                       min_new_tokens=8)
    got = tm.generate(tf["input_features"], tf["audio_attention_mask"], max_new_tokens=8,
                      min_new_tokens=8)
    np.testing.assert_array_equal(got, want)


def test_audio_token_dropout_keeps_frames_at_rate(stage1_pair):
    """p > 0: a Bernoulli keep-mask over encoder frames from the generator
    (not JAX's bits; the rate is what is compared): about 1 - p of the
    frames reach the projector unchanged, the rest as zeros; the same seed
    gives the same loss, another seed another."""
    import dataclasses

    _, tm0 = stage1_pair
    tm = ASRModel(dataclasses.replace(tm0.config, audio_token_dropout=0.3), device="cpu")
    tm.load_state_dict(tm0.state_dict())
    seen = []
    hook = tm.projector.register_forward_hook(lambda mod, args, out: seen.append(args[0]))
    batch = _jax_batch(JaxASRModel(tiny_test_config(model_dtype="float32"), seed=0), _rows(4))
    with torch.no_grad():
        losses = [float(tm.compute_loss(batch, generator=torch.Generator().manual_seed(s))[0])
                  for s in (7, 7, 8)]
        eval_loss = float(tm.compute_loss(batch, train=False)[0])
    hook.remove()
    dropped = torch.cat([(x == 0).all(-1).flatten() for x in seen[:3]]).float().mean().item()
    assert abs(dropped - 0.3) < 0.05, dropped  # ~1500 frames: 3 sigma < 0.04
    assert losses[0] == losses[1] and losses[0] != losses[2]
    assert not (seen[3] == 0).all(-1).any()  # train=False: no dropout
    assert np.isfinite(eval_loss)


# -------------------------------------------------------------- optimizer


@pytest.mark.parametrize("kind", ["cosine", "linear", "polynomial", "constant"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_optax(kind, warmup):
    from tiny_audio_tpu.train.optim import OptimizerConfig as JaxOpt, make_schedule as jax_sched
    from tiny_audio_tpu_torch.train.optim import OptimizerConfig, make_schedule

    kw = dict(lr_scheduler_type=kind, warmup_steps=warmup, total_steps=12, polynomial_power=0.5)
    want = jax_sched(JaxOpt(**kw), 2e-3)
    got = make_schedule(OptimizerConfig(**kw), 2e-3)
    for count in range(16):  # optax evaluates in float32, the port in float64
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"count {count}")
    if warmup:
        assert got(0) == 0.0


def test_optimizer_matches_optax_over_steps():
    """Five updates of the port's optimizer and of the JAX package's optax
    chain on the same gradients: groups (projector decay and no-decay, LoRA
    at the decoder's own rate and decay), warmup, clipping (the gradients
    are large), a non-finite step skipped with the state untouched, frozen
    parameters unchanged."""
    from tiny_audio_tpu.train.optim import OptimizerConfig as JaxOpt, build_optimizer as jax_build
    from tiny_audio_tpu_torch.train.optim import OptimizerConfig, build_optimizer

    cfg = tiny_test_config(model_dtype="float32", use_lora=True)
    jm = JaxASRModel(cfg, seed=0)
    tm = _port(jm)
    kw = dict(learning_rate=3e-3, decoder_learning_rate=1e-3, weight_decay=0.1,
              projector_weight_decay=0.05, warmup_steps=2, total_steps=8, max_grad_norm=1.0)
    tx, labels = jax_build(cfg, JaxOpt(**kw), jm.params)
    opt, port_labels = build_optimizer(tm.config, OptimizerConfig(**kw), tm)
    assert {lab for lab in port_labels.values()} == set(jax.tree.leaves(labels))
    params, state = jm.params, tx.init(jm.params)
    update = jax.jit(tx.update)
    frozen_before = {n: p.clone() for n, p in tm.named_parameters() if not p.requires_grad}
    rng = np.random.default_rng(3)
    for step in range(5):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 2).astype(np.float32),
                             jax.tree.map(np.asarray, params))
        if step == 2:
            grads["projector"]["linear_1"]["kernel"][0, 0] = np.nan
        grads = jax.tree.map(lambda g, lab: np.zeros_like(g) if lab == "frozen" else g,
                             grads, labels)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        named = jax_to_state_dict(grads)
        applied = opt.step({n: named[n] for n in opt.params})
        assert applied == (step != 2)
    assert opt.state["count"]["other_decay"] == 4
    want = jax_to_state_dict(jax.tree.map(np.asarray, params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p), _np(want[name]), atol=ATOL, rtol=RTOL, err_msg=name)
    for name, before in frozen_before.items():
        assert torch.equal(dict(tm.named_parameters())[name], before), name


@pytest.mark.parametrize("overrides", [
    {}, {"freeze_language_model": False}, {"use_lora": True, "freeze_projector": True},
], ids=["stage1", "decoder_trained", "stage2_lora"])
def test_param_labels_and_requires_grad_match_jax(overrides):
    """Every parameter's label equals the JAX package's label of the same
    leaf, and ``requires_grad`` is off exactly where that label is frozen."""
    from tiny_audio_tpu.train.optim import param_labels as jax_param_labels
    from tiny_audio_tpu_torch.train.optim import GROUPS, param_labels

    jm = JaxASRModel(tiny_test_config(model_dtype="float32", **overrides), seed=0)
    tm = _port(jm)
    names = ("frozen",) + GROUPS
    # labels as integer leaves of the params' shapes, so the bridge names them
    codes = jax.tree.map(lambda lab, p: np.full(p.shape, names.index(lab), np.int8),
                         jax_param_labels(jm.params, jm.config), jm.params)
    want = {n: names[int(t.flatten()[0])] for n, t in jax_to_state_dict(codes).items()}
    got = param_labels(tm, tm.config)
    assert got == want
    assert {n for n, p in tm.named_parameters() if p.requires_grad} == {
        n for n, lab in got.items() if lab != "frozen"}


def test_accumulation_equals_one_big_step(stage1_pair):
    """Two accumulated micro-steps of one batch equal one step on it: the
    update applies the clip to the mean gradient."""
    from tiny_audio_tpu_torch.train.optim import (
        OptimizerConfig,
        build_optimizer,
        init_grad_accum,
        make_accum_steps,
        make_train_step,
    )

    _, tm0 = stage1_pair
    batch = _jax_batch(JaxASRModel(tiny_test_config(model_dtype="float32"), seed=0), _rows(2))
    results = []
    for accumulate in (False, True):
        tm = ASRModel(tm0.config, device="cpu")
        tm.load_state_dict(tm0.state_dict())
        opt, _ = build_optimizer(tm.config, OptimizerConfig(lr_scheduler_type="constant",
                                                            max_grad_norm=0.5), tm)
        if accumulate:
            acc_step, upd_step = make_accum_steps(tm, opt, 2)
            accum = init_grad_accum(opt)
            acc_step(accum, batch)
            _, metrics = upd_step(accum, batch)
            assert not any(a.any() for a in accum.values())
        else:
            _, metrics = make_train_step(tm, opt)(batch)
        assert float(metrics["grad_norm"]) > 0.5  # the clip is active
        results.append(dict(tm.named_parameters())["projector.linear_1.weight"].detach().clone())
    torch.testing.assert_close(results[1], results[0], atol=ATOL, rtol=RTOL)


# ------------------------------------------- collator, augmentation, configs


@pytest.mark.parametrize("multitask", [False, True])
def test_collator_matches_jax(multitask):
    """ids, labels, masks and token counts byte-equal; mel within the mel
    front end's tolerance (tests/test_torch_mel.py)."""
    from tiny_audio_tpu.train import collator as jcol
    from tiny_audio_tpu_torch.train import collator as pcol

    jm = JaxASRModel(tiny_test_config(model_dtype="float32"), seed=0)
    rows = _rows(5, seed=6)
    rows[1]["text"] = "<comma> Hello, World [noise] 50%"
    rows[2]["audio"] = {"array": np.full(100, np.nan, np.float32), "sampling_rate": 16000}
    if multitask:
        rows[3]["task"] = "sift"
        rows[3]["sift_response"] = "A calm voice."
    cls = "MultiTaskDataCollator" if multitask else "DataCollator"
    want = getattr(jcol, cls)(jm.tokenizer, jm.projector, num_mel_bins=80, seed=3)(rows)
    got = getattr(pcol, cls)(jm.tokenizer, jm.projector, num_mel_bins=80, seed=3,
                             device="cpu")(rows)
    assert got.keys() == want.keys()
    for key in ("input_ids", "attention_mask", "labels", "audio_token_counts",
                "audio_attention_mask"):
        w = np.asarray(want[key])
        g = _np(got[key]) if isinstance(got[key], torch.Tensor) else got[key]
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), key
    np.testing.assert_allclose(_np(got["input_features"]), np.asarray(want["input_features"]),
                               atol=2e-4)
    assert pcol.normalize_label("<comma> Hi  [x] 5%") == jcol.normalize_label("<comma> Hi  [x] 5%")


def test_augmentation_bit_equal(monkeypatch):
    """RIR, the noise chain and silence injection give the same float32
    bytes for the same seed and sample key (the JAX package's optional C++
    FFT is switched off: the port has only the numpy one, which is also the
    JAX package's fallback)."""
    from tiny_audio_tpu import native
    from tiny_audio_tpu.train import augmentation as jaug
    from tiny_audio_tpu_torch.train import augmentation as paug

    monkeypatch.setattr(native, "fft_convolve", lambda a, k: None)
    rows = _rows(4, seed=9)
    outs = []
    for mod in (jaug, paug):
        pipe = mod.AugmentationPipeline(
            rir=mod.RIRAugmentation(p=0.9, seed=1),
            noise=mod.NoiseAugmentation(p_eq=0.9, p_clip=0.9, p_filter=0.9, seed=2),
            silence_injection_prob=0.3, seed=4)
        got = []
        for j, row in enumerate(rows):
            mod.set_sample_key((0, j))
            try:
                got.append(pipe(row))
            finally:
                mod.set_sample_key(None)
        outs.append(got)
    for w, g in zip(*outs):
        assert w["text"] == g["text"] and w.get("silence") == g.get("silence")
        assert w["audio"]["array"].tobytes() == g["audio"]["array"].tobytes()


@pytest.mark.parametrize("argv", [[], ["+experiments=smoke"],
                                  ["+experiments=mlp_lora", "training.max_steps=7"],
                                  ["data=multitask", "model.lora_rank=4"]])
def test_config_composition_matches_jax(argv):
    from pathlib import Path

    from tiny_audio_tpu.train.config_loader import load_config as jax_load
    from tiny_audio_tpu_torch.train.__main__ import CONFIG_DIR
    from tiny_audio_tpu_torch.train.config_loader import load_config

    assert CONFIG_DIR == Path(__file__).resolve().parent.parent / "configs"
    assert load_config(CONFIG_DIR, argv) == jax_load(CONFIG_DIR, argv)


def test_synthetic_dataset_and_loader_match_jax():
    from tiny_audio_tpu.train.data import DatasetLoader as JaxLoader
    from tiny_audio_tpu_torch.train.data import DatasetLoader, synthetic_dataset

    for w, g in zip(_rows(3, seed=2), synthetic_dataset(3, seed=2, min_s=0.3, max_s=0.8)):
        assert w["text"] == g["text"] and w["audio"]["array"].tobytes() == g["audio"]["array"].tobytes()
    cfg = {"datasets": [{"path": "synthetic", "num_samples": 6, "target_samples": 9}],
           "eval_split_fraction": 0.25}
    (jt, je), (pt, pe) = JaxLoader(cfg, seed=1).load(), DatasetLoader(cfg, seed=1).load()
    assert [r["text"] for r in pt] == [r["text"] for r in jt]
    assert [r["text"] for r in pe] == [r["text"] for r in je]


def test_loader_without_hf_datasets_raises_clearly(monkeypatch, tmp_path):
    """A non-synthetic corpus needs HF ``datasets``; where the package is
    missing (as on the card) the loader says so (the import is blocked here,
    so nothing is fetched)."""
    import sys

    from tiny_audio_tpu_torch.train.data import DatasetLoader

    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="`datasets` package"):
        DatasetLoader({"datasets": [{"path": str(tmp_path)}]}).load()


# ----------------------------------------------------------------- Trainer


def _trainer_config(module, out_dir, per_device, **kw):
    return module.TrainingConfig(
        output_dir=str(out_dir), max_steps=3, per_device_batch_size=per_device,
        logging_steps=1, save_steps=0, eval_steps=0, dataloader_workers=0,
        optimizer=module.OptimizerConfig(learning_rate=1e-3, lr_scheduler_type="constant"),
        **kw)


def _ce_losses(out_dir):
    lines = (out_dir / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line)["ce_loss"] for line in lines if "ce_loss" in json.loads(line)]


def test_trainer_steps_match_jax_trainer(tmp_path):
    """Three steps of each Trainer from the same params and rows, with the
    same global batch of 8 (the JAX Trainer's dp is the 8 virtual CPU
    devices): the per-step losses and the final projector agree; the port
    then resumes from its checkpoint and continues to step 5."""
    from tiny_audio_tpu.train import trainer as jtrain
    from tiny_audio_tpu.train.collator import DataCollator as JaxCollator
    from tiny_audio_tpu_torch.train import trainer as ptrain
    from tiny_audio_tpu_torch.train.collator import DataCollator

    jm = JaxASRModel(tiny_test_config(model_dtype="float32"), seed=0)
    tm = _port(jm)
    rows = _rows(20, seed=0)
    jcfg = _trainer_config(jtrain, tmp_path / "jax", 1)
    assert jax.device_count() == 8
    jcol = JaxCollator(jm.tokenizer, jm.projector, num_mel_bins=80)
    jtrain.Trainer(jm, jcfg, rows, jcol).train()

    pcol = DataCollator(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    result = ptrain.Trainer(tm, _trainer_config(ptrain, tmp_path / "port", 8), rows, pcol).train()
    assert result["final_step"] == 3
    np.testing.assert_allclose(_ce_losses(tmp_path / "port"), _ce_losses(tmp_path / "jax"),
                               rtol=1e-4)
    want = jax_to_state_dict(jax.tree.map(np.asarray, jm.params))
    for name, p in tm.named_parameters():
        if name.startswith("projector."):
            np.testing.assert_allclose(_np(p), _np(want[name]), atol=1e-4, rtol=1e-3,
                                       err_msg=name)
    assert (tmp_path / "port" / "checkpoints" / "3" / "state.pt").exists()
    assert (tmp_path / "port" / "model" / "projector.msgpack").exists()

    resumed = ASRModel(tm.config, device="cpu")
    cfg = _trainer_config(ptrain, tmp_path / "port", 8, resume_from_checkpoint=True)
    cfg.max_steps = 5
    trainer = ptrain.Trainer(resumed, cfg, rows, pcol)
    assert trainer._maybe_resume() == 3
    for name, p in resumed.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(p, dict(tm.named_parameters())[name])
    assert trainer.optimizer.state["count"]["other_decay"] == 3
    assert trainer.train()["final_step"] == 5


def test_trainer_refuses_meshes(stage1_pair):
    from tiny_audio_tpu_torch.train.trainer import Trainer, TrainingConfig

    for kw in ({"dp": 2}, {"tp": 2}):
        with pytest.raises(NotImplementedError, match="one device"):
            Trainer(stage1_pair[1], TrainingConfig(output_dir="/nonexistent", **kw), [], None)


# ------------------------------------------------------------- checkpoints


def test_stage2_checkpoint_round_trip_with_jax(tmp_path, stage2_pair):
    """A stage-2 model/ (adapter.msgpack, no towers) from the port loads in
    the JAX package with equal LoRA and projector leaves, and JAX's save
    loads back in the port; split_lora/merge_lora partition the tree."""
    jm, tm = stage2_pair
    tm.save_pretrained(tmp_path / "port", save_towers=False)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["adapter.msgpack", "config.json", "projector.msgpack", "tpu_metadata.json"]
    loaded = JaxASRModel.from_pretrained(tmp_path / "port", seed=0)
    want = state_dict_to_jax(tm)
    for tower in ("projector",):
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(loaded.params[tower]),
                                jax.tree.leaves(want[tower])):
            np.testing.assert_array_equal(np.asarray(a), _np(b), err_msg=str(path))
    _, jax_lora = split_lora(jax.tree.map(np.asarray, loaded.params["decoder"]))
    _, port_lora = split_lora(want["decoder"])
    assert jax.tree.structure(jax_lora) == jax.tree.structure(jax.tree.map(_np, port_lora))
    for a, b in zip(jax.tree.leaves(jax_lora), jax.tree.leaves(jax.tree.map(_np, port_lora))):
        np.testing.assert_array_equal(a, b)

    jm.save_pretrained(tmp_path / "jax", save_towers=True)
    back = ASRModel.from_pretrained(tmp_path / "jax", device="cpu")
    for (name, a), (_, b) in zip(back.named_parameters(), tm.named_parameters()):
        assert torch.equal(a, b), name
    base, lora = split_lora(want["decoder"])
    assert lora and all("lora" in "/".join(p) for p, _ in _paths(lora))
    assert merge_lora(base, lora).keys() == want["decoder"].keys()


def _paths(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,), value
