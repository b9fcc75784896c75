"""The port's model written back out as a reference HF artifact.

Port of :mod:`tiny_audio_tpu.export`, the inverse of
:mod:`tiny_audio_tpu_torch.convert`: a projector (and a fine-tuned decoder
or LoRA adapters) trained on the card, in the file layout the torch
reference writes and reloads:

- ``model.safetensors``: the trainable weights in torch naming,
  ``projector.*`` always and ``language_model.*`` (flattened HF names) when
  the decoder was fine-tuned;
- ``adapter_model.safetensors`` + ``adapter_config.json``: PEFT-layout LoRA
  adapters under ``use_lora``;
- ``config.json``: the reference ``ASRConfig`` serialization (top-level
  projector and generation fields, ``auto_map`` and ``custom_pipelines``,
  the nested ``audio_config`` / ``text_config`` HF tower dicts and the
  ``encoder`` alias of the first);
- ``preprocessor_config.json`` (and the tokenizer's files when the model
  wraps an HF tokenizer).

Every tensor is written as float32 through the port's own
:mod:`~tiny_audio_tpu_torch.utils.safetensors_io`; the model's tree comes
from :func:`tiny_audio_tpu_torch.bridge.state_dict_to_jax`.  The JSON files
equal the JAX package's for the same model.  :func:`export_encoder_state`
(the encoder in Whisper naming, the inverse of
``convert_hf_whisper_encoder``) is the port's own addition.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tiny_audio_tpu_torch.bridge import state_dict_to_jax
from tiny_audio_tpu_torch.convert import QFORMER_LAYER_NAMES
from tiny_audio_tpu_torch.models.encoder import WHISPER_PROJECTIONS
from tiny_audio_tpu_torch.utils import safetensors_io


def _w(x) -> np.ndarray:
    """A params-tree leaf (tensor or array) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


# ------------------------------------------------------------------ projector


def export_projector_state(params: dict, projector_type: str) -> dict:
    """A projector params tree in the reference's torch naming (without the
    ``projector.`` prefix): the inverse of
    :func:`tiny_audio_tpu_torch.convert.convert_reference_projector`."""
    p = params

    def linear(prefix, tree, bias=True):
        out = {f"{prefix}.weight": _w(tree["kernel"]).T}
        if bias:
            out[f"{prefix}.bias"] = _w(tree["bias"])
        return out

    if projector_type == "mlp":
        return {
            "linear_1.weight": _w(p["linear_1"]["kernel"]).T,
            "norm.weight": _w(p["norm"]["weight"]),
            "linear_2.weight": _w(p["linear_2"]["kernel"]).T,
            "norm_2.weight": _w(p["norm_2"]["weight"]),
        }

    if projector_type == "mosa":
        sd: dict = {}
        for i in range(2):
            # flax Conv [k, in, out] -> torch Conv1d [out, in, k]
            kernel = _w(p[f"downsample_{i}"]["kernel"])
            sd[f"downsample.{i * 2}.weight"] = kernel.transpose(2, 1, 0)
            sd[f"downsample.{i * 2}.bias"] = _w(p[f"downsample_{i}"]["bias"])
        sd.update(linear("router.0", p["router_fc1"]))
        sd.update(linear("router.2", p["router_fc2"]))
        e = 0
        while f"expert_{e}" in p:
            for fc in ("fc1", "fc2"):
                sd.update(linear(f"experts.{e}.{fc}", p[f"expert_{e}"][fc]))
            e += 1
        return sd

    if projector_type == "moe":
        sd = {"norm.weight": _w(p["norm"]["weight"]),
              "router.weight": _w(p["router"]["kernel"]).T}
        sd.update(linear("shared_expert.fc1", p["shared_expert"]["fc1"]))
        sd.update(linear("shared_expert.fc2", p["shared_expert"]["fc2"]))
        for e in range(int(p["experts_fc1_kernel"].shape[0])):
            for fc in ("fc1", "fc2"):
                sd[f"experts.{e}.{fc}.weight"] = _w(p[f"experts_{fc}_kernel"][e]).T
                sd[f"experts.{e}.{fc}.bias"] = _w(p[f"experts_{fc}_bias"][e])
        return sd

    if projector_type == "qformer":
        sd = {
            "query": _w(p["query"]),
            "qformer.layernorm.weight": _w(p["ln_embed"]["scale"]),
            "qformer.layernorm.bias": _w(p["ln_embed"]["bias"]),
        }
        sd.update(linear("linear", p["linear"]))
        if "encoder_proj" in p:
            sd.update(linear("encoder_proj", p["encoder_proj"], bias=False))
        i = 0
        while f"layer_{i}" in p:
            layer = p[f"layer_{i}"]
            base = f"qformer.encoder.layer.{i}"
            for ours, theirs in QFORMER_LAYER_NAMES.items():
                if ours.startswith("ln_"):
                    sd[f"{base}.{theirs}.weight"] = _w(layer[ours]["scale"])
                    sd[f"{base}.{theirs}.bias"] = _w(layer[ours]["bias"])
                else:
                    sd.update(linear(f"{base}.{theirs}", layer[ours]))
            i += 1
        return sd

    raise ValueError(f"no reference exporter for projector_type={projector_type!r}")


# ------------------------------------------------------------- the towers


def export_decoder_state(params: dict, cfg) -> dict:
    """A decoder params tree (layers stacked) in flattened HF causal-LM
    naming: the inverse of ``convert_hf_qwen3`` for the Qwen3, Llama and
    Gemma-v1 families (one key layout; the family decides which norms
    exist).  LoRA leaves are skipped: they go out as PEFT adapters."""
    layers = params["layers"]
    sd: dict = {"model.embed_tokens.weight": _w(params["embed_tokens"]["embedding"])}
    for i in range(cfg.num_layers):
        base = f"model.layers.{i}"
        sd[f"{base}.input_layernorm.weight"] = _w(layers["input_layernorm"]["weight"][i])
        sd[f"{base}.post_attention_layernorm.weight"] = _w(
            layers["post_attention_layernorm"]["weight"][i])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{base}.self_attn.{name}.weight"] = _w(layers[name]["kernel"][i]).T
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{base}.mlp.{name}.weight"] = _w(layers[name]["kernel"][i]).T
        if cfg.qk_norm:
            sd[f"{base}.self_attn.q_norm.weight"] = _w(layers["q_norm"][i])
            sd[f"{base}.self_attn.k_norm.weight"] = _w(layers["k_norm"][i])
    sd["model.norm.weight"] = _w(params["norm"]["weight"])
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = _w(params["lm_head"]["kernel"]).T
    return sd


def export_encoder_state(params: dict, cfg, prefix: str = "") -> dict:
    """An encoder params tree in the HF WhisperEncoder naming, each key
    under ``prefix`` (``"audio_tower."`` for a GLM-style full checkpoint):
    the inverse of ``convert_hf_whisper_encoder``."""
    layers = params["layers"]
    sd: dict = {}
    for i in range(cfg.num_layers):
        base = f"layers.{i}"
        for ours, theirs, bias in WHISPER_PROJECTIONS:
            sd[f"{base}.{theirs}.weight"] = _w(layers[ours]["kernel"][i]).T
            if bias:
                sd[f"{base}.{theirs}.bias"] = _w(layers[ours]["bias"][i])
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{base}.{name}.weight"] = _w(layers[name]["weight"][i])
            sd[f"{base}.{name}.bias"] = _w(layers[name]["bias"][i])
    for i in range(len(cfg.conv_layers)):
        sd[f"conv{i + 1}.weight"] = _w(params[f"conv{i + 1}"]["kernel"]).transpose(2, 1, 0)
        sd[f"conv{i + 1}.bias"] = _w(params[f"conv{i + 1}"]["bias"])
    sd["embed_positions.weight"] = _w(params["embed_positions"])
    sd["layer_norm.weight"] = _w(params["layer_norm"]["weight"])
    sd["layer_norm.bias"] = _w(params["layer_norm"]["bias"])
    return {prefix + k: v for k, v in sd.items()}


def export_lora_adapter(params: dict, config, base_model=None) -> tuple[dict, dict]:
    """The decoder's LoRA leaves (``layers/{target}_lora_a|b``, stacked) in
    PEFT's ``adapter_model.safetensors`` naming, and its
    ``adapter_config.json``.  Torch Linear convention: ``lora_A`` is
    ``[r, in]`` (the tree's ``a`` is ``[in, r]``), ``lora_B`` ``[out, r]``.
    ``base_model`` (default: the config's ``text_model_id``) lands in
    ``base_model_name_or_path``."""
    layers = params["layers"]
    targets = [t for t in config.lora_target_modules if f"{t}_lora_a" in layers]
    sd: dict = {}
    for i in range(config.decoder.num_layers):
        for t in targets:
            sub = "self_attn" if t.endswith(("q_proj", "k_proj", "v_proj", "o_proj")) else "mlp"
            base = f"base_model.model.model.layers.{i}.{sub}.{t}"
            sd[f"{base}.lora_A.weight"] = _w(layers[f"{t}_lora_a"][i]).T
            sd[f"{base}.lora_B.weight"] = _w(layers[f"{t}_lora_b"][i]).T
    adapter_config = {
        "peft_type": "LORA",
        "task_type": "CAUSAL_LM",
        "r": int(config.lora_rank),
        "lora_alpha": int(config.lora_alpha),
        "lora_dropout": float(config.lora_dropout),
        "target_modules": list(targets),
        "bias": "none",
        "base_model_name_or_path": base_model if base_model is not None else config.text_model_id,
        "fan_in_fan_out": False,
        "inference_mode": True,
    }
    return sd, adapter_config


# --------------------------------------------------------------------- config


def _model_type(dec_cfg) -> str:
    if dec_cfg.qk_norm:
        return "qwen3"
    if getattr(dec_cfg, "rms_norm_offset", False):
        return "gemma"
    return "llama"


def tower_config_dicts(config) -> tuple[dict, dict]:
    """(audio_config, text_config) HF dicts: a tower id that names a local
    HF checkpoint directory gives its ``config.json`` as it is, else a
    minimal dict from the dataclass (every dimension
    ``config_from_reference_dir`` reads back)."""
    audio_cfg = text_cfg = None
    enc_json = Path(config.audio_model_id) / "config.json"
    if enc_json.is_file():
        audio_cfg = json.loads(enc_json.read_text())
    dec_json = Path(config.text_model_id) / "config.json"
    if dec_json.is_file():
        text_cfg = json.loads(dec_json.read_text())
    enc = config.encoder
    if audio_cfg is None:
        audio_cfg = {
            "model_type": "whisper",
            "num_mel_bins": enc.num_mel_bins,
            "d_model": enc.d_model,
            "encoder_layers": enc.num_layers,
            "encoder_attention_heads": enc.num_heads,
            "encoder_ffn_dim": enc.ffn_dim,
            "max_source_positions": enc.max_source_positions,
        }
    dec = config.decoder
    if text_cfg is None:
        text_cfg = {
            "model_type": _model_type(dec),
            "vocab_size": dec.vocab_size,
            "hidden_size": dec.hidden_size,
            "num_hidden_layers": dec.num_layers,
            "num_attention_heads": dec.num_heads,
            "num_key_value_heads": dec.num_kv_heads,
            "head_dim": dec.head_dim,
            "intermediate_size": dec.intermediate_size,
            "rope_theta": dec.rope_theta,
            "rms_norm_eps": dec.rms_norm_eps,
            "tie_word_embeddings": dec.tie_word_embeddings,
            "max_position_embeddings": dec.max_position_embeddings,
        }
    return audio_cfg, text_cfg


def export_reference_config(config, audio_model_id=None, text_model_id=None) -> dict:
    """The reference ``ASRConfig`` serialization dict, HF auto-loading keys
    included.  ``audio_model_id`` / ``text_model_id`` replace the config's
    tower ids (pass hub ids to make an artifact portable); the nested tower
    dicts carry the dimensions either way."""
    audio_cfg, text_cfg = tower_config_dicts(config)
    return {
        "model_type": "asr_model",
        "architectures": ["ASRModel"],
        "auto_map": {
            "AutoConfig": "asr_config.ASRConfig",
            "AutoModel": "asr_modeling.ASRModel",
        },
        "custom_pipelines": {
            "automatic-speech-recognition": {
                "impl": "asr_pipeline.ASRPipeline",
                "pt": ["AutoModel"],
                "tf": [],
            }
        },
        "audio_model_id": audio_model_id or config.audio_model_id,
        "text_model_id": text_model_id or config.text_model_id,
        "attn_implementation": "sdpa",
        "model_dtype": config.model_dtype,
        "encoder_dim": config.encoder_dim,
        "llm_dim": config.llm_dim,
        "encoder_conv_layers": [list(t) for t in config.encoder_conv_layers],
        "audio_sample_rate": config.audio_sample_rate,
        "system_prompt": config.system_prompt,
        "projector_type": config.projector_type,
        "projector_pool_stride": config.projector_pool_stride,
        "downsample_rate": config.downsample_rate,
        "projector_hidden_dim": config.projector_hidden_dim,
        "audio_token_dropout": config.audio_token_dropout,
        "num_experts": config.num_experts,
        "num_experts_per_tok": config.num_experts_per_tok,
        "qformer_window_size": config.qformer_window_size,
        "qformer_num_layers": config.qformer_num_layers,
        "qformer_num_heads": config.qformer_num_heads,
        "use_lora": config.use_lora,
        "lora_rank": config.lora_rank,
        "lora_alpha": config.lora_alpha,
        "lora_dropout": config.lora_dropout,
        "lora_target_modules": list(config.lora_target_modules),
        "freeze_language_model": config.freeze_language_model,
        "max_new_tokens": config.max_new_tokens,
        "min_new_tokens": config.min_new_tokens,
        "num_beams": config.num_beams,
        "repetition_penalty": config.repetition_penalty,
        "length_penalty": config.length_penalty,
        "no_repeat_ngram_size": config.no_repeat_ngram_size,
        "do_sample": config.do_sample,
        "temperature": config.temperature,
        "top_p": config.top_p,
        "top_k": config.top_k,
        "audio_config": audio_cfg,
        "text_config": text_cfg,
        # the reference aliases encoder = audio_config, so an artifact
        # carries both keys
        "encoder": audio_cfg,
    }


# ------------------------------------------------------------------- artifact


def export_reference_artifact(model, output_dir, audio_model_id=None,
                              text_model_id=None) -> Path:
    """Write the port's ``model`` as a reference-layout HF artifact
    directory: ``projector.*`` always, ``language_model.*`` when
    ``freeze_language_model`` is off, PEFT adapter files under ``use_lora``;
    the tower ids as in :func:`export_reference_config`."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    config = model.config
    params = state_dict_to_jax(model)

    sd = {f"projector.{k}": v
          for k, v in export_projector_state(params["projector"], config.projector_type).items()}
    if not config.freeze_language_model:
        sd.update({f"language_model.{k}": v
                   for k, v in export_decoder_state(params["decoder"], config.decoder).items()})
    safetensors_io.save_file(sd, out / "model.safetensors")

    if config.use_lora:
        adapter_sd, adapter_cfg = export_lora_adapter(params["decoder"], config,
                                                      base_model=text_model_id)
        if adapter_sd:
            safetensors_io.save_file(adapter_sd, out / "adapter_model.safetensors")
            (out / "adapter_config.json").write_text(json.dumps(adapter_cfg, indent=2))

    (out / "config.json").write_text(json.dumps(
        export_reference_config(config, audio_model_id=audio_model_id,
                                text_model_id=text_model_id), indent=2))
    (out / "preprocessor_config.json").write_text(json.dumps({
        "processor_class": "ASRProcessor",
        "auto_map": {"AutoProcessor": "asr_processing.ASRProcessor"},
        "feature_size": config.encoder.num_mel_bins,
        "sampling_rate": config.audio_sample_rate,
    }, indent=2))

    # an HF tokenizer ships with the artifact; the byte tokenizer has no
    # HF serialization
    hf_tok = getattr(model.tokenizer, "tok", None)
    if hf_tok is not None and hasattr(hf_tok, "save_pretrained"):
        hf_tok.save_pretrained(out)
    return out
