"""HF and reference checkpoints converted into the port's model.

Port of :mod:`tiny_audio_tpu.convert`: the reference's published checkpoint
family (a Whisper/GLM-style encoder, a Qwen3-class LM, and the trained
projector's safetensors) read into :class:`~tiny_audio_tpu_torch.models.asr.
ASRModel`.  The tower converters sit beside their modules
(:func:`~tiny_audio_tpu_torch.models.encoder.convert_hf_audio_encoder`,
:func:`~tiny_audio_tpu_torch.models.decoder.convert_hf_qwen3`,
:func:`~tiny_audio_tpu_torch.models.wav2vec2.convert_hf_wav2vec2`,
:func:`~tiny_audio_tpu_torch.models.ecapa.convert_speechbrain_ecapa`); each
builds the JAX package's params tree, and
:func:`tiny_audio_tpu_torch.bridge.load_jax_params` fills the model from it.
This module adds state-dict loading (safetensors through the port's own
:mod:`~tiny_audio_tpu_torch.utils.safetensors_io`, ``.bin`` through
``torch.load``), the projector converter, and the one-call
:func:`convert_checkpoint` / :func:`convert_reference_checkpoint`.

The JAX package also calibrates an imported encoder's attention scores
against its TPU kernel's constant-shift softmax window at import
(``TA_SKIP_ATTN_CALIBRATION``).  The port's encoder kernel computes an
exact softmax (``ops/encoder_attention.py``), so no checkpoint can fall
outside it and that step is left out.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path

import torch

from tiny_audio_tpu_torch.bridge import (
    cast_leaf,
    host_array,
    jax_to_state_dict,
    load_jax_params,
    state_dict_to_jax,
    tower_flax_tree,
)
from tiny_audio_tpu_torch.utils import msgpack_io, safetensors_io

logger = logging.getLogger(__name__)


def load_state_dict(path) -> dict:
    """A state dict from a ``.safetensors`` or torch ``.bin``/``.ckpt`` file,
    or from an HF checkpoint directory (every ``*.safetensors``, else every
    ``pytorch_model*.bin``): CPU tensors by name."""
    path = Path(path)
    if path.is_dir():
        files = sorted(path.glob("*.safetensors")) or sorted(path.glob("pytorch_model*.bin"))
        if not files:
            raise FileNotFoundError(f"no weight files in {path}")
        sd: dict = {}
        for f in files:
            sd.update(load_state_dict(f))
        return sd
    if path.suffix == ".safetensors":
        return safetensors_io.load_file(path)
    return dict(torch.load(str(path), map_location="cpu", weights_only=True))


# ------------------------------------------------------------------ projector

#: a QFormer layer's leaves and their HF Blip2QFormerModel names under
#: ``qformer.encoder.layer.{i}`` (the model-level embeddings norm is
#: ``qformer.layernorm``)
QFORMER_LAYER_NAMES = {
    "self_q": "attention.attention.query",
    "self_k": "attention.attention.key",
    "self_v": "attention.attention.value",
    "self_out": "attention.output.dense",
    "ln_self": "attention.output.LayerNorm",
    "cross_q": "crossattention.attention.query",
    "cross_k": "crossattention.attention.key",
    "cross_v": "crossattention.attention.value",
    "cross_out": "crossattention.output.dense",
    "ln_cross": "crossattention.output.LayerNorm",
    "ffn_in": "intermediate_query.dense",
    "ffn_out": "output_query.dense",
    "ln_ffn": "output_query.LayerNorm",
}


def convert_reference_projector(state_dict: dict, projector_type: str,
                                dtype: torch.dtype = torch.float32) -> dict:
    """The reference's trained projector state dict as the JAX package's
    projector params tree (CPU tensors of ``dtype``).  Keys with or without
    the ``projector.`` prefix (the reference's trainable-only state dict
    carries it)."""
    sd = {k.removeprefix("projector."): host_array(v) for k, v in state_dict.items()}

    def lin(name, transpose=True):
        w = sd[name]
        return cast_leaf(w.T if transpose else w, dtype)

    def dense(name):
        return {"kernel": lin(f"{name}.weight"), "bias": lin(f"{name}.bias", transpose=False)}

    if projector_type == "mlp":
        return {
            "linear_1": {"kernel": lin("linear_1.weight")},
            "norm": {"weight": lin("norm.weight", transpose=False)},
            "linear_2": {"kernel": lin("linear_2.weight")},
            "norm_2": {"weight": lin("norm_2.weight", transpose=False)},
        }

    if projector_type == "mosa":
        params: dict = {}
        for i in range(2):
            params[f"downsample_{i}"] = {
                # torch Conv1d [out, in, k] -> flax [k, in, out]
                "kernel": cast_leaf(sd[f"downsample.{i * 2}.weight"].transpose(2, 1, 0), dtype),
                "bias": lin(f"downsample.{i * 2}.bias", transpose=False),
            }
        params["router_fc1"] = dense("router.0")
        params["router_fc2"] = dense("router.2")
        e = 0
        while f"experts.{e}.fc1.weight" in sd:
            params[f"expert_{e}"] = {"fc1": dense(f"experts.{e}.fc1"),
                                     "fc2": dense(f"experts.{e}.fc2")}
            e += 1
        return params

    if projector_type == "moe":
        n = 0
        while f"experts.{n}.fc1.weight" in sd:
            n += 1

        def stacked(fmt, transpose):
            return torch.stack([lin(fmt.format(e), transpose) for e in range(n)])

        return {
            "norm": {"weight": lin("norm.weight", transpose=False)},
            "router": {"kernel": lin("router.weight")},
            "shared_expert": {"fc1": dense("shared_expert.fc1"),
                              "fc2": dense("shared_expert.fc2")},
            "experts_fc1_kernel": stacked("experts.{}.fc1.weight", True),
            "experts_fc1_bias": stacked("experts.{}.fc1.bias", False),
            "experts_fc2_kernel": stacked("experts.{}.fc2.weight", True),
            "experts_fc2_bias": stacked("experts.{}.fc2.bias", False),
        }

    if projector_type == "qformer":
        def ln(name):
            return {"scale": lin(f"{name}.weight", transpose=False),
                    "bias": lin(f"{name}.bias", transpose=False)}

        params = {
            "query": cast_leaf(sd["query"], dtype),
            "ln_embed": ln("qformer.layernorm"),
            "linear": dense("linear"),
        }
        if "encoder_proj.weight" in sd:
            params["encoder_proj"] = {"kernel": lin("encoder_proj.weight")}
        i = 0
        while f"qformer.encoder.layer.{i}.attention.attention.query.weight" in sd:
            base = f"qformer.encoder.layer.{i}"
            params[f"layer_{i}"] = {
                ours: (ln if ours.startswith("ln_") else dense)(f"{base}.{theirs}")
                for ours, theirs in QFORMER_LAYER_NAMES.items()}
            i += 1
        if i == 0:
            raise KeyError(
                "no Blip2QFormer layers found in qformer projector state dict; "
                f"sample keys: {sorted(sd)[:10]}"
            )
        return params

    raise ValueError(f"no reference converter for projector_type={projector_type!r}")


# ------------------------------------------------- reference checkpoint dirs


def config_from_reference_dir(ckpt_dir):
    """The port's :class:`~tiny_audio_tpu_torch.config.ASRConfig` from a
    reference checkpoint directory's ``config.json``: top-level projector
    and generation fields (and any other ``ASRConfig`` field the file
    carries), tower dims overlaid from the nested HF ``audio_config`` /
    ``text_config``; HF machinery keys (``auto_map``, ...) are ignored."""
    from tiny_audio_tpu_torch.config import (
        ASRConfig,
        decoder_kwargs_from_hf,
        encoder_kwargs_from_hf,
    )

    raw = dict(json.loads((Path(ckpt_dir) / "config.json").read_text()))
    # The reference aliases ``encoder`` to ``audio_config``, so a serialized
    # config carries an HF tower dict under ``encoder``, not an
    # EncoderConfig: detect it by HF's ``model_type`` and reroute it.
    enc_raw = raw.get("encoder")
    if isinstance(enc_raw, dict) and "model_type" in enc_raw:
        raw.pop("encoder")
        raw.setdefault("audio_config", enc_raw)
    config = ASRConfig.from_dict(raw)
    audio_cfg = raw.get("audio_config")
    if isinstance(audio_cfg, dict):
        config.encoder = dataclasses.replace(config.encoder, **encoder_kwargs_from_hf(audio_cfg))
    text_cfg = raw.get("text_config")
    if isinstance(text_cfg, dict):
        config.decoder = dataclasses.replace(config.decoder, **decoder_kwargs_from_hf(text_cfg))
    config.__post_init__()  # re-derive encoder_dim / llm_dim from the new towers
    return config


def convert_reference_checkpoint(
    ckpt_dir,
    encoder_path=None,
    decoder_path=None,
    output_dir=None,
    tokenizer=None,
    seed: int = 0,
    device="cuda",
):
    """One-call conversion of a reference-format checkpoint directory onto
    ``device``.

    The published layout: ``config.json`` (composite config with nested
    tower configs), ``model.safetensors`` with the trainable weights under
    ``projector.``, tokenizer and feature-extractor files.  Tower weights are
    not in it (the reference downloads them by ``audio_model_id`` /
    ``text_model_id``): pass ``encoder_path`` / ``decoder_path``, which
    default to those ids when they are local directories."""
    ckpt_dir = Path(ckpt_dir)
    config = config_from_reference_dir(ckpt_dir)
    if encoder_path is None and Path(config.audio_model_id).is_dir():
        encoder_path = config.audio_model_id
    if decoder_path is None and Path(config.text_model_id).is_dir():
        decoder_path = config.text_model_id
    model = convert_checkpoint(config, encoder_path=encoder_path, decoder_path=decoder_path,
                               projector_path=ckpt_dir, output_dir=output_dir, seed=seed,
                               device=device)
    if tokenizer is not None:
        model.tokenizer = tokenizer
        model.gen_config = model.gen_config.__class__.from_asr_config(
            model.config, tokenizer.eos_token_ids, tokenizer.pad_token_id)
    return model


# ----------------------------------------------------------------- full model


def _overlay_tower_config(config, tower: str, path) -> None:
    """Overlay the tower dims a checkpoint's own ``config.json`` carries
    (only those keys: a sparse file must not reset the caller's other
    fields to defaults), with the JAX package's warning."""
    from tiny_audio_tpu_torch.config import decoder_kwargs_from_hf, encoder_kwargs_from_hf

    cfg_json = Path(path) / "config.json"
    if not cfg_json.is_file():
        return
    read = encoder_kwargs_from_hf if tower == "encoder" else decoder_kwargs_from_hf
    current = getattr(config, tower)
    found = read(json.loads(cfg_json.read_text()))
    changed = {k: v for k, v in found.items() if getattr(current, k) != v}
    if changed:
        logger.warning("%s config overridden by %s/config.json: %s", tower, path, changed)
        setattr(config, tower, dataclasses.replace(current, **changed))


def _load_tower(model, tower: str, tree: dict) -> None:
    """Fill ``model``'s tower (``encoder``, ``decoder`` or ``projector``)
    from its JAX params tree; raises when the tree leaves one of the
    tower's parameters unset."""
    names = set(jax_to_state_dict({tower: tree}))
    unset = sorted(n for n, _ in model.named_parameters()
                   if n.startswith(tower + ".") and n not in names)
    if unset:
        raise KeyError(f"converted {tower} leaves parameters unset: {unset[:8]}")
    load_jax_params(model, {tower: tree}, require_all=False)


def convert_checkpoint(
    config,
    encoder_path=None,
    decoder_path=None,
    projector_path=None,
    aligner_path=None,
    ecapa_path=None,
    output_dir=None,
    seed: int = 0,
    device="cuda",
):
    """An :class:`~tiny_audio_tpu_torch.models.asr.ASRModel` on ``device``
    from HF / reference torch checkpoints.

    A tower without a path keeps its seeded random init.  ``aligner_path``
    (an HF ``Wav2Vec2ForCTC``) attaches the process's
    :class:`~tiny_audio_tpu_torch.alignment.ForcedAligner` and
    ``ecapa_path`` (speechbrain's ``embedding_model.ckpt``) the speaker
    embedder for ``device``; with ``output_dir`` each is also written there
    as the JAX package's msgpack, and the model with ``save_pretrained``."""
    from tiny_audio_tpu_torch.models.asr import ASRModel, merge_lora, split_lora
    from tiny_audio_tpu_torch.models.decoder import convert_hf_qwen3
    from tiny_audio_tpu_torch.models.encoder import convert_hf_audio_encoder

    if encoder_path:
        _overlay_tower_config(config, "encoder", encoder_path)
    if decoder_path:
        _overlay_tower_config(config, "decoder", decoder_path)
    dtype = torch.bfloat16 if config.model_dtype == "bfloat16" else torch.float32
    model = ASRModel(config, seed=seed, device=device)
    out = Path(output_dir) if output_dir else None

    if encoder_path:
        _load_tower(model, "encoder", convert_hf_audio_encoder(
            load_state_dict(encoder_path), config.encoder, dtype=dtype))
    if decoder_path:
        converted = convert_hf_qwen3(load_state_dict(decoder_path), config.decoder, dtype=dtype)
        if config.use_lora:
            # HF base checkpoints carry no adapters: keep the model's fresh
            # LoRA leaves
            _, lora_fresh = split_lora(state_dict_to_jax(model)["decoder"])
            converted = merge_lora(converted, lora_fresh)
        _load_tower(model, "decoder", converted)
    if projector_path:
        _load_tower(model, "projector", convert_reference_projector(
            load_state_dict(projector_path), config.projector_type))
    if aligner_path:
        from tiny_audio_tpu_torch.alignment import ForcedAligner
        from tiny_audio_tpu_torch.models.wav2vec2 import convert_hf_wav2vec2

        tree = convert_hf_wav2vec2(load_state_dict(aligner_path))
        ForcedAligner._model = ForcedAligner._build(tree, model.device)
        ForcedAligner._tree = tree
        if out:
            out.mkdir(parents=True, exist_ok=True)
            msgpack_io.save(out / "wav2vec2_aligner.msgpack", tree)
    if ecapa_path:
        from tiny_audio_tpu_torch.diarization import EcapaEmbedder

        embedder = EcapaEmbedder.from_speechbrain(load_state_dict(ecapa_path),
                                                  device=model.device)
        EcapaEmbedder._instances[str(model.device)] = embedder
        if out:
            out.mkdir(parents=True, exist_ok=True)
            msgpack_io.save(out / "ecapa_embedder.msgpack", tower_flax_tree(embedder.module))
    if out:
        model.save_pretrained(out)
    return model
