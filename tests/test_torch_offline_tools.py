"""The port's offline tools against the JAX scripts, on the CPU.

``tools/train_vad.py``, ``tools/train_speaker_embedder.py`` and
``tools/handler_local.py`` against ``scripts/train_vad.py``,
``scripts/train_speaker_embedder.py`` and ``scripts/handler_local.py``
(loaded by path, as ``tests/test_scripts.py`` loads scripts; their size
globals set with monkeypatch, the scripts untouched):

- the data: ``ExampleFactory`` and ``SpeakerData`` batches byte-equal to
  the scripts' from the same seed, with few utterances;
- three training steps from JAX's own init (``VADNet`` / ``EcapaTDNN``
  ``.init(PRNGKey(0))`` as the scripts take it, the AAM head from
  ``PRNGKey(1)``), the JAX step rebuilt here from the scripts' formulas:
  the losses within ``LOSS_RTOL``, the parameters within ``PARAM_ATOL``
  (Adam's first steps move a weight by about the learning rate whatever its
  gradient's size, so a gradient near 0 that the two frameworks round
  differently can move it by up to ``lr`` a step: the bound is in units of
  the learning rate; three leaves of the ECAPA's pooling whose gradient is
  at the rounding level, ``NOISY_LEAVES``, to ``STEPS`` learning rates); the
  GRU's r and z hidden biases stay 0 and the ECAPA BN ``mean``/``var`` are
  trained as JAX's are;
- the written files load in both packages (JAX's ``NeuralVAD`` /
  ``EcapaEmbedder.from_synthetic`` and the port's ``NeuralVAD.from_file`` /
  ``EcapaEmbedder.from_synthetic``) with equal outputs (``OUT_ATOL``);
- ``handler_local`` finds the newest checkpoint, exits without one, and
  answers one request on a tiny saved checkpoint on the CPU.
"""

import importlib.util
import io
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from tiny_audio_tpu_torch.tools import handler_local, train_speaker_embedder, train_vad
from tiny_audio_tpu_torch.utils import msgpack_io

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
#: a loss of the same step on the same batch, JAX against the port (fp32)
LOSS_RTOL = 1e-4
#: parameters after STEPS steps, in units of the learning rate
PARAM_ATOL_LRS = 0.5
#: the ECAPA's attentive pooling leaves whose gradient is 0 in exact
#: arithmetic (``asp_conv`` bias: the softmax over time ignores a shift per
#: channel) or, for some channels, within rounding of 0 (``asp_tdnn``'s BN
#: mean and bias, ~1e-3 at most against the fc bias's ~0.5): Adam turns
#: rounding into steps of up to lr, so these are held to STEPS lr, the most
#: STEPS steps move a weight
NOISY_LEAVES = {("asp_conv", "bias"), ("asp_tdnn", "norm", "mean"),
                ("asp_tdnn", "norm", "bias")}
#: a file's outputs through the two packages (probabilities, embeddings)
OUT_ATOL = 1e-5
STEPS = 3


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(*_):
    pass


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value, np.float32)


def _assert_trees_close(got: dict, want: dict, lr: float, noisy=frozenset()):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for path in want:
        atol = (STEPS if path in noisy else PARAM_ATOL_LRS) * lr
        np.testing.assert_allclose(got[path], want[path], atol=atol, rtol=0, err_msg=str(path))


# --------------------------------------------------------------------- data


def test_vad_examples_are_the_scripts_bytes(monkeypatch):
    script = _script("train_vad")
    monkeypatch.setattr(script, "N_UTTS", 6)
    with redirect_stdout(io.StringIO()):
        want = script.ExampleFactory(np.random.default_rng(0))
    got = train_vad.ExampleFactory(np.random.default_rng(0), 6, log=_quiet)
    for _ in range(3):
        for g, w in zip(got.batch(5), want.batch(5)):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_speaker_batches_are_the_scripts_bytes(monkeypatch):
    script = _script("train_speaker_embedder")
    monkeypatch.setattr(script, "N_SPEAKERS", 5)
    monkeypatch.setattr(script, "UTTS_PER_SPEAKER", 2)
    with redirect_stdout(io.StringIO()):
        want = script.SpeakerData(np.random.default_rng(0))
    got = train_speaker_embedder.SpeakerData(np.random.default_rng(0), 5, 2, log=_quiet)
    for _ in range(3):
        for g, w in zip(got.batch(6), want.batch(6)):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


# ------------------------------------------------------------- VAD training


@pytest.fixture(scope="module")
def vad_runs():
    """The JAX script's init and STEPS steps (its step rebuilt), and the
    port's trainer from that init on the same batches."""
    from tiny_audio_tpu.vad import N_MELS, build_vadnet, vad_logmel

    rng = np.random.default_rng(0)
    factory = train_vad.ExampleFactory(rng, 8, log=_quiet)
    batches = [factory.batch(4) for _ in range(STEPS)]
    net = build_vadnet()
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, N_MELS), jnp.float32))["params"]
    init = jax.tree.map(np.asarray, params)
    tx = optax.adamw(optax.cosine_decay_schedule(train_vad.LR, train_vad.N_STEPS, alpha=0.02),
                     weight_decay=1e-5)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, audio, labels, weight):
        feats = vad_logmel(audio, n_frames=train_vad.N_FRAMES)

        def loss_fn(p):
            logits = net.apply({"params": p}, feats)
            per = optax.sigmoid_binary_cross_entropy(logits, labels)
            return jnp.sum(per * weight) / jnp.maximum(jnp.sum(weight), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jax_losses = []
    for audio, labels, weight in batches:
        params, opt_state, loss = step(params, opt_state, *map(jnp.asarray,
                                                               (audio, labels, weight)))
        jax_losses.append(float(loss))

    from tiny_audio_tpu_torch.bridge import load_flax_tower, tower_flax_tree

    port = train_vad.init_vadnet(0, device="cpu")
    load_flax_tower(port, init)
    trainer = train_vad.VadTrainer(port)
    losses = [trainer.step(*b) for b in batches]
    return {"jax_losses": jax_losses, "jax_params": jax.tree.map(np.asarray, params),
            "losses": losses, "net": port, "tree": tower_flax_tree(port)}


def test_vad_steps_match_jax(vad_runs):
    np.testing.assert_allclose(vad_runs["losses"], vad_runs["jax_losses"], rtol=LOSS_RTOL)
    _assert_trees_close(vad_runs["tree"], vad_runs["jax_params"], train_vad.LR)
    gru = vad_runs["net"].GRUCell_0
    h = gru.hidden_size
    assert not gru.bias_hh_l0[: 2 * h].any()  # r and z: flax's cell has none
    assert gru.bias_hh_l0[2 * h:].any()  # n's trains


def test_vad_file_loads_in_both_packages(vad_runs, tmp_path):
    from tiny_audio_tpu import vad as jax_vad
    from tiny_audio_tpu_torch.utils.speech_synth import synth_utterance
    from tiny_audio_tpu_torch.vad import NeuralVAD

    path = tmp_path / "vad.msgpack"
    msgpack_io.save(path, vad_runs["tree"])
    audio = synth_utterance(3.0, seed=4)[0]
    want = jax_vad.NeuralVAD(serialization.msgpack_restore(path.read_bytes())).frame_probs(audio)
    got = NeuralVAD.from_file(path, "cpu").frame_probs(audio)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)


def test_train_vad_entry_point_writes_a_file(tmp_path):
    out = tmp_path / "vad.msgpack"
    with redirect_stdout(io.StringIO()) as log:
        result = train_vad.main(["--device", "cpu", "--steps", "2", "--utts", "4",
                                 "--batch", "2", "--out", str(out)])
    assert out.is_file() and "MEAN" in log.getvalue()
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert set(result["f1"]) and all(0 <= n <= 1 for _, n in result["f1"].values())


# ------------------------------------------------------------ ECAPA training


@pytest.fixture(scope="module")
def ecapa_runs():
    from tiny_audio_tpu.diarization import _speaker_fbank as jax_fbank
    from tiny_audio_tpu.models.ecapa import EcapaTDNN as JaxEcapa
    from tiny_audio_tpu_torch.diarization import _speaker_fbank

    n_spk = 5
    data = train_speaker_embedder.SpeakerData(np.random.default_rng(0), n_spk, 2, log=_quiet)
    batches = []
    for _ in range(STEPS):
        audio, labels = data.batch(8)
        feats = _speaker_fbank(audio)
        assert np.array_equal(feats, jax_fbank(audio))
        batches.append((feats, labels))
    net = JaxEcapa(channels=train_speaker_embedder.CHANNELS)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(batches[0][0][:1]))["params"]
    head = jax.random.normal(jax.random.PRNGKey(1), (net.embed_dim, n_spk)) * 0.05
    init = (jax.tree.map(np.asarray, params), np.asarray(head))
    tx = optax.adamw(optax.cosine_decay_schedule(train_speaker_embedder.LR,
                                                 train_speaker_embedder.N_STEPS, alpha=0.05),
                     weight_decay=1e-5)
    state = {"net": params, "head": head}
    opt_state = tx.init(state)
    margin, scale = train_speaker_embedder.MARGIN, train_speaker_embedder.SCALE

    @jax.jit
    def step(state, opt_state, feats, labels):
        def loss_fn(s):
            emb = net.apply({"params": s["net"]}, feats)
            emb = emb / (jnp.linalg.norm(emb, axis=-1, keepdims=True) + 1e-8)
            w = s["head"] / (jnp.linalg.norm(s["head"], axis=0, keepdims=True) + 1e-8)
            cos = emb @ w
            onehot = jax.nn.one_hot(labels, n_spk)
            theta = jnp.arccos(jnp.clip(cos, -1 + 1e-6, 1 - 1e-6))
            logits = scale * (onehot * jnp.cos(theta + margin) + (1 - onehot) * cos)
            return optax.softmax_cross_entropy(logits, onehot).mean()

        loss, grads = jax.value_and_grad(loss_fn)(state)
        updates, opt_state = tx.update(grads, opt_state, state)
        return optax.apply_updates(state, updates), opt_state, loss

    jax_losses = []
    for feats, labels in batches:
        state, opt_state, loss = step(state, opt_state, jnp.asarray(feats), jnp.asarray(labels))
        jax_losses.append(float(loss))

    from tiny_audio_tpu_torch.bridge import load_flax_tower, tower_flax_tree

    port, _ = train_speaker_embedder.init_ecapa(0)
    load_flax_tower(port, init[0])
    trainer = train_speaker_embedder.EmbedderTrainer(port, torch.from_numpy(init[1].copy()))
    losses = [trainer.step(*b)[0] for b in batches]
    return {"jax_losses": jax_losses, "jax_params": jax.tree.map(np.asarray, state["net"]),
            "jax_head": np.asarray(state["head"]), "losses": losses, "net": port,
            "head": trainer.head.detach().numpy(), "tree": tower_flax_tree(port)}


def test_ecapa_steps_match_jax(ecapa_runs):
    lr = train_speaker_embedder.LR
    np.testing.assert_allclose(ecapa_runs["losses"], ecapa_runs["jax_losses"], rtol=LOSS_RTOL)
    _assert_trees_close(ecapa_runs["tree"], ecapa_runs["jax_params"], lr, NOISY_LEAVES)
    np.testing.assert_allclose(ecapa_runs["head"], ecapa_runs["jax_head"],
                               atol=PARAM_ATOL_LRS * lr)
    # the BN statistics trained as JAX's params: moved off 0 / 1, to JAX's values
    bn = ecapa_runs["net"].blocks_0.norm
    assert bn.running_mean.abs().max() > 0.5 * STEPS * lr
    assert (bn.running_var - 1).abs().max() > 0.5 * STEPS * lr
    want = ecapa_runs["jax_params"]["blocks_0"]["norm"]
    np.testing.assert_allclose(bn.running_mean.detach().numpy(), want["mean"],
                               atol=PARAM_ATOL_LRS * lr)
    np.testing.assert_allclose(bn.running_var.detach().numpy(), want["var"],
                               atol=PARAM_ATOL_LRS * lr)


def test_ecapa_file_loads_in_both_packages(ecapa_runs, tmp_path):
    from tiny_audio_tpu.diarization import EcapaEmbedder as JaxEmbedder
    from tiny_audio_tpu_torch.diarization import EcapaEmbedder

    path = tmp_path / "ecapa.msgpack"
    msgpack_io.save(path, train_speaker_embedder.fp16_tree(ecapa_runs["tree"]))
    windows = np.random.default_rng(3).standard_normal((4, 12000)).astype(np.float32) * 0.1
    want = JaxEmbedder.from_synthetic(path).embed_windows(windows)
    got = EcapaEmbedder.from_synthetic(path, device="cpu").embed_windows(windows)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)


def test_train_speaker_embedder_entry_point_writes_a_file(tmp_path):
    out = tmp_path / "ecapa.msgpack"
    with redirect_stdout(io.StringIO()):
        result = train_speaker_embedder.main(
            ["--device", "cpu", "--steps", "2", "--speakers", "4", "--utts", "2",
             "--batch", "4", "--out", str(out), "--no-der"])
    assert out.is_file() and len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    tree = msgpack_io.load(out)
    assert all(np.asarray(x).dtype == np.float16 for _, x in _raw_leaves(tree))


def _raw_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _raw_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


# ------------------------------------------------------------ handler_local


def test_find_latest_checkpoint(tmp_path):
    import os

    for i, name in enumerate(("old", "new")):
        (tmp_path / name / "model").mkdir(parents=True)
        (tmp_path / name / "model" / "config.json").write_text("{}")
        os.utime(tmp_path / name / "model", (1000 + i, 1000 + i))
    (tmp_path / "bare" / "model").mkdir(parents=True)  # no config.json
    got = handler_local.find_latest_checkpoint(tmp_path)
    assert got == tmp_path / "new" / "model"
    assert got == _script("handler_local").find_latest_checkpoint(tmp_path)
    with pytest.raises(SystemExit, match="no checkpoints"):
        handler_local.find_latest_checkpoint(tmp_path / "empty")


def test_handler_local_answers_on_a_tiny_checkpoint(tmp_path):
    from tiny_audio_tpu_torch.config import tiny_test_config
    from tiny_audio_tpu_torch.models.asr import ASRModel
    from tiny_audio_tpu_torch.utils.speech_synth import synth_utterance

    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 4
    ASRModel(cfg, seed=0, device="cpu").save_pretrained(tmp_path / "model")
    from tiny_audio_tpu_torch.utils.audio_io import write_wav

    wav = tmp_path / "clip.wav"
    write_wav(wav, synth_utterance(2.0, seed=1)[0], 16000)
    with redirect_stdout(io.StringIO()) as out:
        rc = handler_local.main(["-m", str(tmp_path / "model"), "--wav", str(wav),
                                 "--timestamps", "--speakers", "--device", "cpu"])
    text = out.getvalue()
    assert rc == 0, text
    assert "text: " in text and "words: " in text and "speaker_segments: " in text
    with redirect_stdout(io.StringIO()):  # the synthesized tone when no wav is given
        assert handler_local.main(["-m", str(tmp_path / "model"), "--device", "cpu"]) == 0
