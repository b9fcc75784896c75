"""The convergence ladder of the port vs the JAX package's, on the CPU.

The labeled synthetic speech is bitwise the JAX package's; the CTC loss and
the CTC pretrain's gradient through the encoder agree with ``optax.ctc_loss``
and ``jax.value_and_grad`` (1e-5, fp32 sums in other orders), its AdamW
update with optax's (1e-5); the encoder artifact is the JAX package's bytes
and loads to the JAX params, as does the gate's start (the JAX gate's
seed-0 projector and decoder); the held-out WER evaluation gives JAX's
number on the same bridged params; and a toy run of the whole ladder writes
``convergence.json`` with JAX's keys.  The full gate is
``tests/test_torch_convergence_gate.py`` (slow).
"""

from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.train import convergence as jax_convergence
from tiny_audio_tpu.utils import speech_synth as jax_synth
from tiny_audio_tpu_torch.bridge import jax_to_state_dict, load_jax_params, state_dict_to_jax
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.train import convergence
from tiny_audio_tpu_torch.utils import speech_synth

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
JAX_ARTIFACT = REPO / "tiny_audio_tpu" / "data" / "convergence_encoder.msgpack"
PORT_ARTIFACT = convergence.ENCODER_ARTIFACT
VOCAB = convergence.DEFAULT_VOCAB
ATOL = 1e-5


def test_default_vocab_is_jax():
    import inspect

    src = inspect.getsource(jax_convergence.run_convergence_ladder)
    assert all(f'"{w}"' in src for w in VOCAB) and len(VOCAB) == 14


@pytest.mark.parametrize("seed,words", [(0, (2, 4)), (10_000, (2, 4)), (3, (1, 6))])
def test_labeled_speech_dataset_bitwise_jax(seed, words):
    got = speech_synth.labeled_speech_dataset(5, VOCAB, seed=seed, words_per_utt=words)
    want = jax_synth.labeled_speech_dataset(5, VOCAB, seed=seed, words_per_utt=words)
    assert [r["text"] for r in got] == [r["text"] for r in want]
    for g, w in zip(got, want):
        assert g["audio"]["sampling_rate"] == w["audio"]["sampling_rate"]
        assert g["audio"]["array"].dtype == w["audio"]["array"].dtype
        assert g["audio"]["array"].tobytes() == w["audio"]["array"].tobytes()
    with pytest.raises(ValueError):
        speech_synth.labeled_speech_dataset(1, [str(i) for i in range(26)])


def test_other_synth_functions_bitwise_jax():
    a, segs, mask = speech_synth.synth_conversation(6.0, overlap_prob=0.5, seed=2)
    b, segs_j, mask_j = jax_synth.synth_conversation(6.0, overlap_prob=0.5, seed=2)
    assert a.tobytes() == b.tobytes() and segs == segs_j and np.array_equal(mask, mask_j)
    np.testing.assert_array_equal(speech_synth.mask_to_frames(mask, 160),
                                  jax_synth.mask_to_frames(mask, 160))


def _ctc_inputs(seed=0, b=4, t=24, c=7, s=6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, c)).astype(np.float32) * 2
    logit_len = np.array([t, t - 3, 17, 12])[:b]
    label_len = np.array([s, 3, 4, 1])[:b]
    labels = rng.integers(1, c, (b, s)).astype(np.int32)
    labels[0, 1] = labels[0, 0]  # a repeat needs a blank between
    labels[labels == 0] = 1
    logit_pad = (np.arange(t)[None] >= logit_len[:, None]).astype(np.float32)
    label_pad = (np.arange(s)[None] >= label_len[:, None]).astype(np.float32)
    labels = np.where(label_pad == 0, labels, 0).astype(np.int32)
    return logits, logit_pad, labels, label_pad


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_matches_optax(seed):
    logits, logit_pad, labels, label_pad = _ctc_inputs(seed)
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.asarray(logit_pad),
                                     jnp.asarray(labels), jnp.asarray(label_pad), blank_id=0))
    got = convergence.ctc_loss(torch.from_numpy(logits), torch.from_numpy(logit_pad),
                               torch.from_numpy(labels), torch.from_numpy(label_pad))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)


def test_adamw_updates_match_optax():
    """Five updates of OptaxAdamW and of optax.adamw on the cosine schedule
    with alpha 0.1 (weight decay 1e-4 on every leaf) from the same params
    and gradients."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    steps, lr = 4, 2e-3
    tx = optax.adamw(optax.cosine_decay_schedule(lr, steps, alpha=0.1))
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    opt = convergence.OptaxAdamW(tparams, lr, steps)
    for count in range(steps + 1):
        assert opt.schedule(count) == pytest.approx(
            float(optax.cosine_decay_schedule(lr, steps, alpha=0.1)(count)), rel=1e-6)
    for _ in range(steps + 1):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(g) for g in grads])
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)


def test_ctc_encoder_gradient_matches_jax():
    """The CTC pretrain's loss and its gradient through the fp32 encoder and
    the head, on the same params, features and labels, against JAX's."""
    from tiny_audio_tpu.models.encoder import AudioEncoder, compute_encoder_output_length
    from tiny_audio_tpu.pipeline import ASRPipeline as JaxASRPipeline

    cfg = tiny_test_config(model_dtype="float32")
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    rows = speech_synth.labeled_speech_dataset(3, VOCAB, seed=1)
    feats = JaxASRPipeline(jm).processor.extract_features([r["audio"]["array"] for r in rows])
    mel = np.array(feats["input_features"], np.float32)
    mask = np.array(feats["audio_attention_mask"], np.int32)
    index = {w: i + 1 for i, w in enumerate(VOCAB)}
    n = max(len(r["text"].split()) for r in rows)
    labels = np.zeros((3, n), np.int32)
    label_pad = np.ones((3, n), np.float32)
    for i, r in enumerate(rows):
        ids = [index[w] for w in r["text"].split()]
        labels[i, :len(ids)], label_pad[i, :len(ids)] = ids, 0.0
    rng = np.random.default_rng(0)
    head_w = (0.02 * rng.standard_normal((cfg.encoder.d_model, len(VOCAB) + 1))).astype(np.float32)

    module = AudioEncoder(cfg.encoder, dtype=jnp.float32, param_dtype=jnp.float32)

    def jax_loss(p):
        hidden = module.apply({"params": p["encoder"]}, jnp.asarray(mel), jnp.asarray(mask))
        logits = hidden @ p["w"]
        enc_len = compute_encoder_output_length(jnp.asarray(mask).sum(-1), cfg.encoder.conv_layers)
        logit_pad = (jnp.arange(logits.shape[1])[None] >= enc_len[:, None]).astype(jnp.float32)
        per = optax.ctc_loss(logits, logit_pad, jnp.asarray(labels), jnp.asarray(label_pad))
        return per.sum() / jnp.maximum((1.0 - label_pad).sum(), 1.0)

    want, grads = jax.value_and_grad(jax_loss)({"encoder": jm.params["encoder"],
                                                "w": jnp.asarray(head_w)})
    enc = list(tm.encoder.parameters())
    for p in enc:
        p.requires_grad_(True)
    w = torch.from_numpy(head_w).requires_grad_(True)
    hidden = tm.encoder(torch.from_numpy(mel), torch.from_numpy(mask))
    logits = hidden @ w
    enc_len = torch.from_numpy(np.asarray(compute_encoder_output_length(mask.sum(-1),
                                                                        cfg.encoder.conv_layers)))
    logit_pad = (torch.arange(logits.shape[1])[None] >= enc_len[:, None]).float()
    per = convergence.ctc_loss(logits, logit_pad, torch.from_numpy(labels),
                               torch.from_numpy(label_pad))
    loss = per.sum() / float((1.0 - label_pad).sum())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=ATOL)
    want_enc = jax_to_state_dict({"encoder": jax.tree.map(np.asarray, grads["encoder"])})
    scale = max(float(np.abs(g.numpy()).max()) for g in want_enc.values())
    for name, p in tm.named_parameters():
        if name in want_enc:
            np.testing.assert_allclose(p.grad.numpy(), want_enc[name].numpy(), rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(grads["w"]), rtol=1e-4,
                               atol=1e-4 * scale)


def test_encoder_artifact_is_jax_bytes_and_params(tmp_path):
    assert PORT_ARTIFACT.read_bytes() == JAX_ARTIFACT.read_bytes()
    cfg = tiny_test_config(model_dtype="float32")
    jm = JaxASRModel(cfg, seed=0)
    jax_convergence.load_pretrained_encoder(jm, str(JAX_ARTIFACT))
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=0, device="cpu")
    convergence.load_pretrained_encoder(tm, str(PORT_ARTIFACT))
    want = jax_to_state_dict({"encoder": jax.tree.map(np.asarray, jm.params["encoder"])})
    for name, value in want.items():
        assert torch.equal(tm.get_parameter(name), value), name
    # and back: the port's file loads into the JAX model to the same params
    convergence.save_pretrained_encoder(tm, str(tmp_path / "enc.msgpack"))
    jm2 = JaxASRModel(cfg, seed=1)
    jax_convergence.load_pretrained_encoder(jm2, str(tmp_path / "enc.msgpack"))
    for a, b in zip(jax.tree.leaves(jm2.params["encoder"]), jax.tree.leaves(jm.params["encoder"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert state_dict_to_jax(tm)["encoder"].keys() == jm.params["encoder"].keys()


def test_gate_start_is_jax_seed0(tmp_path):
    """``convergence_init.msgpack`` holds the JAX package's seed-0 projector
    and decoder of the tiny fp32 towers, bitwise (flax wrote it), and
    ``load_gate_start`` gives the JAX gate's starting model.  Regenerate::

        JAX_PLATFORMS=cpu python -c "import flax.serialization as s, jax; \\
        from pathlib import Path; from tiny_audio_tpu.config import tiny_test_config; \\
        from tiny_audio_tpu.models.asr import ASRModel; \\
        p = ASRModel(tiny_test_config(model_dtype='float32'), seed=0).params; \\
        Path('tiny_audio_tpu_torch/data/convergence_init.msgpack').write_bytes( \\
        s.msgpack_serialize(jax.device_get({k: p[k] for k in ('projector', 'decoder')})))"
    """
    from flax import serialization

    cfg = tiny_test_config(model_dtype="float32")
    jm = JaxASRModel(cfg, seed=0)
    want = jax.device_get({k: jm.params[k] for k in ("projector", "decoder")})
    assert convergence.INIT_ARTIFACT.read_bytes() == serialization.msgpack_serialize(want)
    jax_convergence.load_pretrained_encoder(jm, str(JAX_ARTIFACT))
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    convergence.load_gate_start(tm)
    for name, value in jax_to_state_dict(jax.tree.map(np.asarray, jm.params)).items():
        assert torch.equal(tm.get_parameter(name), value), name


def test_wer_eval_matches_jax():
    cfg = tiny_test_config(model_dtype="float32")
    jm = JaxASRModel(cfg, seed=0)
    jax_convergence.load_pretrained_encoder(jm, str(JAX_ARTIFACT))
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    rows = speech_synth.labeled_speech_dataset(5, VOCAB, seed=10_000)
    got = convergence._wer_eval(tm, rows, max_new_tokens=10)
    want = jax_convergence._wer_eval(jm, rows, max_new_tokens=10)
    assert got == want and got > 0


def test_toy_ladder_writes_jax_keys(tmp_path, monkeypatch):
    """The port's whole ladder at a few rows and steps writes
    ``convergence.json``; the JAX ladder, its phases stubbed, gives the key
    set it writes."""
    import json

    rec = convergence.run_convergence_ladder(
        str(tmp_path / "port"), n_train=16, n_eval=4, ctc_steps=2, warmup_steps=2,
        s1_steps=2, s2_steps=2, verbose=False, device="cpu",
        save_encoder_path=str(tmp_path / "enc.msgpack"))
    written = json.loads((tmp_path / "port" / "convergence.json").read_text())
    assert written == json.loads(json.dumps(rec))
    assert (tmp_path / "enc.msgpack").exists()
    assert all(np.isfinite(loss) for phase in rec["curves"].values() for _, loss in phase)

    monkeypatch.setattr(jax_convergence, "pretrain_encoder_ctc",
                        lambda *a, **k: {"curve": [(1, 1.0)], "token_error_rate": 1.0})
    monkeypatch.setattr(jax_convergence, "train_stage",
                        lambda *a, **k: {"eval_loss": 1.0, "seconds": 0.0, "curve": [(1, 1.0)]})
    monkeypatch.setattr(jax_convergence, "_wer_eval", lambda *a, **k: 1.0)
    want = jax_convergence.run_convergence_ladder(str(tmp_path / "jax"), n_train=2, n_eval=2,
                                                  verbose=False)
    assert written.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, dict):
            assert written[key].keys() == value.keys(), key
