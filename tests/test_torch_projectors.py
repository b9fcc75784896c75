"""The MOSA, MoE and QFormer projectors: the PyTorch port vs the JAX modules.

Each JAX model is built from ``tiny_test_config(projector_type=kind)``; its
random params are carried into the port by
:func:`tiny_audio_tpu_torch.bridge.load_jax_params`.  Forward passes agree
to fp32 sums in other orders (1e-4) and to a few bf16 ulps (5e-2, as the
MLP projector in ``tests/test_torch_models.py``); the output-length formulas
are equal over the JAX tests' lengths; MoE's aux loss (train mode, no
jitter) within 1e-6 and its gate matrix exactly, tied router logits
included; ``compute_loss`` and the projector's gradients within rtol 1e-4 of
``jax.value_and_grad``; checkpoints cross both ways bitwise; and fp32
greedy decoding is token-exact for both KV dtypes and both decode paths.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.models.projectors import create_projector as jax_create_projector
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch.bridge import jax_to_state_dict, load_jax_params, state_dict_to_jax
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.models.projectors import create_projector, moe_gate
from tiny_audio_tpu_torch.processing import ASRProcessor

torch.set_num_threads(1)
KINDS = ("mosa", "moe", "qformer")
# forward lengths: odd (MOSA's two stride-2 convolutions), a partial QFormer
# window, and the shortest each projector takes (MoE stacks 4 frames)
LENGTHS = {"mosa": (99, 5, 1), "moe": (99, 33, 4), "qformer": (99, 16, 1)}
FP32_ATOL = 1e-4
BF16_ATOL = 5e-2
RTOL = 1e-4


def _config(kind, **overrides):
    return tiny_test_config(projector_type=kind, **overrides)


def _port_model(jm, seed=1):
    tm = ASRModel(PortASRConfig.from_dict(jm.config.to_dict()), seed=seed, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return tm


_MODELS: dict = {}


def _pair(kind, model_dtype="float32", kv_cache_dtype="bfloat16", **overrides):
    key = (kind, model_dtype, kv_cache_dtype, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        cfg = _config(kind, model_dtype=model_dtype, kv_cache_dtype=kv_cache_dtype, **overrides)
        cfg.max_new_tokens = 12
        jm = JaxASRModel(cfg, seed=0)
        _MODELS[key] = (jm, _port_model(jm))
    return _MODELS[key]


def _hidden(cfg, t, seed=1, b=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, cfg.encoder.d_model)).astype(np.float32)


def _jax_project(jm, hidden, dtype=jnp.float32, train=False):
    # jitted: XLA's CPU runtime has no eager bf16 x bf16 -> fp32 dot
    apply = jax.jit(lambda p, x: jm.projector.apply({"params": p}, x, train=train))
    out, aux = apply(jm.params["projector"], jnp.asarray(hidden, dtype))
    return np.asarray(out.astype(jnp.float32)), float(aux)


@pytest.mark.parametrize("kind", KINDS)
def test_bridge_covers_every_projector_leaf(kind):
    jm, tm = _pair(kind)
    names = set(jax_to_state_dict(jax.tree.map(np.asarray, jm.params)))
    assert names == {n for n, _ in tm.named_parameters()}
    back = state_dict_to_jax(tm)["projector"]
    assert jax.tree.structure(back) == jax.tree.structure(jm.params["projector"])
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jm.params["projector"])):
        assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_projector_fp32(kind):
    jm, tm = _pair(kind)
    for t in LENGTHS[kind]:
        hidden = _hidden(jm.config, t)
        want, want_aux = _jax_project(jm, hidden)
        with torch.inference_mode():
            got, aux = tm.projector(torch.from_numpy(hidden))
        n_out = jm.projector.get_output_length(t)
        assert got.shape == want.shape == (2, n_out, jm.config.llm_dim), t
        assert got.dtype == torch.float32
        assert float(aux) == want_aux == 0.0
        np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, err_msg=f"T={t}")


def _einsum_upcasting_bf16(einsum):
    """``jnp.einsum`` whose bf16 x bf16 -> fp32 products (MoE's experts,
    the attention oracle) run on fp32 copies of the operands: the same exact
    products and fp32 sums, which XLA's CPU runtime cannot run as bf16 dots."""

    def wrapped(subscripts, *operands, **kwargs):
        if kwargs.get("preferred_element_type") == jnp.float32:
            operands = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o
                        for o in operands]
        return einsum(subscripts, *operands, **kwargs)

    return wrapped


@pytest.mark.parametrize("kind", KINDS)
def test_projector_bf16(kind, monkeypatch):
    jm, tm = _pair(kind, model_dtype="bfloat16")
    hidden = _hidden(jm.config, 45, seed=2)
    monkeypatch.setattr(jnp, "einsum", _einsum_upcasting_bf16(jnp.einsum))
    want, _ = _jax_project(jm, hidden, jnp.bfloat16)
    with torch.inference_mode():
        got, _ = tm.projector(torch.from_numpy(hidden).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.projector.parameters())
    # outputs of O(1) in bf16 (relative spacing 2**-7): a few ulps
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_output_length_matches_jax(kind):
    cfg = _config(kind)
    jp = jax_create_projector(cfg)
    tp = create_projector(PortASRConfig.from_dict(cfg.to_dict()), device="cpu")
    lengths = sorted({1500, 100, 99, 30, 16, 15, 14, 5, 4, 1})
    for n in lengths:
        assert tp.get_output_length(n) == jp.get_output_length(n), n
    arr = np.asarray(lengths)
    np.testing.assert_array_equal(tp.get_output_length(arr), jp.get_output_length(arr))
    if kind == "mosa":
        assert [tp.get_output_length(n) for n in (1500, 99, 5, 1)] == [375, 25, 2, 1]
    elif kind == "qformer":
        assert tp.num_queries == 3 and tp.get_output_length(1500) == 300


def test_moe_aux_loss_matches_jax():
    """Train mode without jitter is deterministic: output and aux equal JAX's."""
    jm, tm = _pair("moe", router_jitter_noise=0.0)
    hidden = _hidden(jm.config, 64, seed=3)
    want, want_aux = _jax_project(jm, hidden, train=True)
    got, aux = tm.projector(torch.from_numpy(hidden), train=True)
    assert want_aux > 0 and aux.dtype == torch.float32
    assert abs(aux.item() - want_aux) <= 1e-6
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FP32_ATOL)


def _jax_gate(probs, k):
    top_w, top_idx = jax.lax.top_k(jnp.asarray(probs), k)
    top_w = top_w / (top_w.sum(axis=-1, keepdims=True) + 1e-6)
    one_hot = jax.nn.one_hot(top_idx, probs.shape[-1], dtype=jnp.float32)
    return np.asarray(jnp.einsum("btk,btke->bte", top_w, one_hot))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_moe_gate_exact(k):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 4)).astype(np.float32)
    logits[0, :3] = 0.5  # all four tied
    logits[1, 2, 1] = logits[1, 2, 3]  # a pair tied
    logits[1, 4, :2] = logits[1, 4, 2]  # three tied
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    got = moe_gate(torch.from_numpy(probs), k).numpy()
    np.testing.assert_array_equal(got, _jax_gate(probs, k))
    assert ((got > 0).sum(-1) == k).all()


def test_moe_tied_router_rows_match_jax():
    """Duplicated router rows tie two experts' logits on every token: the
    lower index wins in both packages, so the outputs agree."""
    jm, _ = _pair("moe")
    params = jax.tree.map(np.asarray, jm.params)
    router = params["projector"]["router"]["kernel"].copy()
    router[:, 2] = router[:, 1]
    params["projector"]["router"]["kernel"] = router
    tm = ASRModel(PortASRConfig.from_dict(jm.config.to_dict()), device="cpu")
    load_jax_params(tm, params)
    hidden = _hidden(jm.config, 40, seed=5)
    want, _ = jm.projector.apply({"params": params["projector"]}, jnp.asarray(hidden))
    with torch.inference_mode():
        got, _ = tm.projector(torch.from_numpy(hidden))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_train_randomness_from_the_generator(kind):
    """Router jitter (MoE) and dropout (QFormer) only in train mode, drawn
    from the caller's generator: one seed repeats, another differs, eval
    ignores the generator, and a train-mode draw without one raises."""
    _, tm = _pair(kind)
    x = torch.from_numpy(_hidden(tm.config, 45, seed=6))

    def run(train, seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tm.projector(x, train=train, generator=gen)

    evaluated, eval_aux = run(False)
    assert torch.equal(run(False, 7)[0], evaluated) and float(eval_aux) == 0.0
    a, aux_a = run(True, 7)
    b, aux_b = run(True, 7)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    c, _ = run(True, 8)
    if kind == "mosa":  # no train-mode randomness
        assert torch.equal(a, evaluated) and torch.equal(c, a) and float(aux_a) == 0.0
        return
    assert not torch.equal(a, evaluated) and not torch.equal(a, c)
    if kind == "moe":
        assert float(aux_a) > 0.0
    with pytest.raises(ValueError, match="generator"):
        run(True)


@pytest.mark.parametrize("kind", KINDS)
def test_compute_loss_and_projector_grads_match_jax(kind):
    from tiny_audio_tpu.train.collator import DataCollator
    from tiny_audio_tpu.train.data import synthetic_dataset

    jm, tm = _pair(kind)
    col = DataCollator(jm.tokenizer, jm.projector, num_mel_bins=jm.config.encoder.num_mel_bins)
    batch = {k: np.array(v) for k, v in col(synthetic_dataset(3, seed=2, min_s=0.3,
                                                              max_s=0.8)).items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jm.compute_loss(p, jb, train=False)

    (want, want_metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jm.params)
    want_grads = jax_to_state_dict(jax.tree.map(np.asarray, grads))
    loss, metrics = tm.compute_loss(batch, train=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    assert float(metrics["aux_loss"]) == float(want_metrics["aux_loss"]) == 0.0
    # a self-attention key bias has a zero gradient in exact arithmetic (the
    # softmax ignores a shift shared by a row's scores), so both sides hold
    # rounding noise there: the absolute floor is RTOL of the projector's
    # largest gradient
    scale = max(float(np.abs(g.numpy()).max()) for n, g in want_grads.items()
                if n.startswith("projector."))
    for name, p in tm.named_parameters():
        if name.startswith("projector."):
            np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=RTOL,
                                       atol=RTOL * scale, err_msg=name)
            p.grad = None
        else:
            assert p.grad is None, name


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_both_ways(tmp_path, kind):
    from test_torch_checkpoint import _assert_same_params

    jm, _ = _pair(kind, model_dtype="bfloat16")
    jm.save_pretrained(tmp_path / "jax")
    tm = ASRModel.from_pretrained(tmp_path / "jax", device="cpu")
    assert tm.config.to_dict() == jm.config.to_dict()
    _assert_same_params(state_dict_to_jax(tm), jm.params)
    tm.save_pretrained(tmp_path / "port")
    _assert_same_params(JaxASRModel.from_pretrained(tmp_path / "port").params, jm.params)


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(int(s * 16000)).astype(np.float32) * 0.1 for s in seconds]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kv_cache_dtype", ["bfloat16", "int8"])
def test_generate_token_exact(kind, kv_cache_dtype):
    jm, tm = _pair(kind, kv_cache_dtype=kv_cache_dtype)
    audio = _audio((1.0, 0.55, 0.3))
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features(audio)
    tproc = ASRProcessor(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    tf = tproc.extract_features(audio)
    want = jm.generate(jf["input_features"], jf["audio_attention_mask"], min_new_tokens=8)
    for fused in (True, False):
        got = tm.generate(tf["input_features"], tf["audio_attention_mask"], min_new_tokens=8,
                          fused_decode=fused)
        assert got.shape == (3, 12)
        np.testing.assert_array_equal(got, want, err_msg=f"fused={fused}")


@pytest.mark.parametrize("kind", KINDS)
def test_random_init_follows_jax_initializers(kind):
    """The port's seeded init draws each new leaf from the JAX package's
    initializer: the same bounds, spreads and constants as a JAX init."""
    cfg = _config(kind, model_dtype="float32")
    jp = jax.tree.map(np.asarray, JaxASRModel(cfg, seed=0).params["projector"])
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=0, device="cpu")
    again = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=0, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(tm.parameters(), again.parameters()))
    got = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in
           jax.tree_util.tree_leaves_with_path(jax.tree.map(
               lambda t: t.numpy(), state_dict_to_jax(tm)["projector"]))}
    want = {"/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if np.all(w == w.flat[0]):  # zeros and ones: biases, norm scales
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        assert abs(g.std() - w.std()) < 0.1 * w.std(), name
        assert abs(np.abs(g).max() - np.abs(w).max()) < 0.35 * np.abs(w).max(), name


def test_moe_compute_loss_adds_the_router_loss():
    """Train mode: loss = ce + aux, aux > 0 and equal to the projector's own
    on the same generator draws; eval mode: aux 0."""
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.train.data import synthetic_dataset

    _, tm = _pair("moe")
    collator = DataCollator(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    batch = collator(synthetic_dataset(2, seed=3, min_s=0.3, max_s=0.6))
    with torch.no_grad():
        loss, metrics = tm.compute_loss(batch, train=True, generator=torch.Generator().manual_seed(0))
        again, _ = tm.compute_loss(batch, train=True, generator=torch.Generator().manual_seed(0))
        _, eval_metrics = tm.compute_loss(batch, train=False)
    assert float(metrics["aux_loss"]) > 0.0 and float(eval_metrics["aux_loss"]) == 0.0
    assert torch.equal(loss, again)
    torch.testing.assert_close(loss, metrics["ce_loss"] + metrics["aux_loss"])


@pytest.mark.parametrize("kind", KINDS)
def test_trainer_logs_the_aux_loss(tmp_path, kind):
    """Two stage-1 Trainer steps on the CPU: the projector moves, the towers
    do not, and ``metrics.jsonl`` carries MoE's nonzero aux loss (0 for the
    other kinds; the eval loss's aux is 0 for all)."""
    import json

    from tiny_audio_tpu_torch.config import tiny_test_config as port_tiny
    from tiny_audio_tpu_torch.train.collator import DataCollator
    from tiny_audio_tpu_torch.train.data import synthetic_dataset
    from tiny_audio_tpu_torch.train.trainer import Trainer, TrainingConfig

    tm = ASRModel(port_tiny(projector_type=kind, model_dtype="float32"), seed=0, device="cpu")
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    collator = DataCollator(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    rows = synthetic_dataset(4, seed=0, min_s=0.3, max_s=0.6)
    config = TrainingConfig(output_dir=str(tmp_path), max_steps=2, per_device_batch_size=2,
                            logging_steps=1, save_steps=0, eval_steps=2, dataloader_workers=0)
    result = Trainer(tm, config, rows, collator, eval_dataset=rows[:2]).train()
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    aux = [r["aux_loss"] for r in records if "aux_loss" in r]
    assert len(aux) == 2 and all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    assert all(a > 0 for a in aux) if kind == "moe" else aux == [0.0, 0.0]
    assert result["eval_aux_loss"] == 0.0
    for name, p in tm.named_parameters():
        assert torch.equal(p, before[name]) != name.startswith("projector."), name


@pytest.mark.parametrize("kind", KINDS)
def test_experiment_preset_trains_through_the_cli(tmp_path, kind):
    """``python -m tiny_audio_tpu_torch.train +experiments=<kind>`` composes
    the preset's fields into the model (here on the tiny towers, on the
    CPU), trains and saves a ``model/`` that loads back with the preset."""
    from tiny_audio_tpu_torch.train.__main__ import main as train_main

    out = tmp_path / kind
    result = train_main([f"+experiments={kind}", "run.tiny_model=true", "run.device=cpu",
                         "model.model_dtype=float32", f"run.output_dir={out}",
                         "training.max_steps=2", "training.per_device_batch_size=2",
                         "training.logging_steps=1", "training.eval_steps=2",
                         "training.eval_batches=1", "training.save_steps=2",
                         "training.dataloader_workers=0",
                         "training.rir_augmentation.enabled=false",
                         "training.noise_augmentation.enabled=false",
                         "training.silence_injection_prob=0.0"])
    assert result["final_step"] == 2 and np.isfinite(result["eval_loss"])
    back = ASRModel.from_pretrained(out / "model", device="cpu")
    assert back.config.projector_type == kind
    if kind == "moe":
        assert (back.config.num_experts, back.config.num_experts_per_tok) == (4, 2)
        assert back.config.router_jitter_noise == 0.01
    if kind == "qformer":
        assert back.config.qformer_window_size == 15 and back.config.downsample_rate == 5


@pytest.mark.parametrize("kind", ("mlp",) + KINDS)
def test_projector_output_ignores_requires_grad(kind):
    """A frozen and a trainable projector with the same weights give the
    same bits: every activation reaching a product folds into rows
    (contiguous), so ``torch.matmul`` takes one path whatever the weights'
    ``requires_grad`` (on CUDA the two paths round differently; the card's
    check is in ``tests/test_torch_kernels.py``)."""
    from tiny_audio_tpu_torch.models.projectors import frame_stack

    cfg = PortASRConfig.from_dict(_config(kind, model_dtype="float32").to_dict())
    proj = create_projector(cfg, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(_hidden(cfg, 47, seed=9))
    assert frame_stack(x, 4).is_contiguous()
    outs = []
    for flag in (True, False):
        proj.requires_grad_(flag)
        with torch.no_grad():
            outs.append(proj(x)[0])
    assert torch.equal(*outs)
