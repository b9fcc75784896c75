"""Reverse export: the port's model written as a reference HF artifact.

For the same model (the JAX package's params loaded into the port), the
port's ``export_reference_artifact`` writes JAX's files: ``config.json``,
``preprocessor_config.json`` and ``adapter_config.json`` equal as dicts,
``model.safetensors`` and ``adapter_model.safetensors`` holding the same
tensors, read back through ``safetensors.torch``.  Each exporter is the
inverse of its converter (export -> convert gives the model's own tree,
bitwise), and the LoRA adapters are in PEFT's layout.
"""

import json

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file

from tiny_audio_tpu import export as jax_export
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu_torch import convert, export
from tiny_audio_tpu_torch.bridge import load_jax_params, state_dict_to_jax
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.models.decoder import convert_hf_qwen3
from tiny_audio_tpu_torch.models.encoder import convert_hf_whisper_encoder

torch.set_num_threads(1)


def _pair(**overrides):
    cfg = tiny_test_config(model_dtype="float32", **overrides)
    jm = JaxASRModel(cfg, seed=5)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


def _bits(x: torch.Tensor):
    x = x.contiguous()
    return str(x.dtype), tuple(x.shape), x.reshape(-1).view(torch.uint8).numpy().tobytes()


def _assert_same_tree(ours: dict, theirs: dict, path="") -> None:
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            _assert_same_tree(ours[k], theirs[k], f"{path}/{k}")
    else:
        assert _bits(ours) == _bits(theirs), path


@pytest.mark.parametrize("overrides", [
    {},
    {"projector_type": "moe", "freeze_language_model": False},
    {"projector_type": "qformer", "use_lora": True, "lora_rank": 4, "lora_alpha": 8},
    {"projector_type": "mosa", "use_lora": True, "lora_rank": 4, "lora_alpha": 8,
     "freeze_language_model": False},
])
def test_artifact_files_are_jaxs(tmp_path, overrides):
    jm, tm = _pair(**overrides)
    ours = export.export_reference_artifact(tm, tmp_path / "ours", text_model_id="hub/lm")
    theirs = jax_export.export_reference_artifact(jm, tmp_path / "theirs",
                                                  text_model_id="hub/lm")
    names = sorted(p.name for p in theirs.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == names
    for name in names:
        if name.endswith(".json"):
            assert json.loads((ours / name).read_text()) == json.loads((theirs / name).read_text())
        else:
            got, want = load_file(str(ours / name)), load_file(str(theirs / name))
            assert got.keys() == want.keys()
            for key in want:
                assert want[key].dtype == torch.float32
                assert _bits(got[key]) == _bits(want[key]), key
    assert ("adapter_model.safetensors" in names) == bool(overrides.get("use_lora"))
    has_lm = any(k.startswith("language_model.")
                 for k in load_file(str(ours / "model.safetensors")))
    assert has_lm == (not tm.config.freeze_language_model)


@pytest.mark.parametrize("ptype", ["mlp", "mosa", "moe", "qformer"])
def test_projector_export_then_convert_is_the_tree(ptype):
    _, tm = _pair(projector_type=ptype)
    tree = state_dict_to_jax(tm)["projector"]
    sd = {f"projector.{k}": v for k, v in export.export_projector_state(tree, ptype).items()}
    _assert_same_tree(convert.convert_reference_projector(sd, ptype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_exports_then_convert_are_the_trees(dtype):
    """bf16 -> fp32 on disk -> bf16 is exact: the decoder and the encoder
    (under the GLM ``audio_tower.`` prefix) come back bitwise."""
    from tiny_audio_tpu_torch.config import tiny_test_config as port_tiny

    cfg = port_tiny(model_dtype=dtype)
    tm = ASRModel(cfg, seed=4, device="cpu")
    tree = state_dict_to_jax(tm)
    torch_dtype = getattr(torch, dtype)
    dec_sd = export.export_decoder_state(tree["decoder"], cfg.decoder)
    _assert_same_tree(convert_hf_qwen3(dec_sd, cfg.decoder, dtype=torch_dtype), tree["decoder"])
    enc_sd = export.export_encoder_state(tree["encoder"], cfg.encoder, prefix="audio_tower.")
    assert all(k.startswith("audio_tower.") for k in enc_sd)
    _assert_same_tree(convert_hf_whisper_encoder(enc_sd, cfg.encoder, dtype=torch_dtype),
                      tree["encoder"])


def test_decoder_state_is_jaxs():
    jm, tm = _pair()
    ours = export.export_decoder_state(state_dict_to_jax(tm)["decoder"], tm.config.decoder)
    theirs = jax_export.export_decoder_state(jax.device_get(jm.params["decoder"]),
                                             jm.config.decoder)
    assert ours.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_lora_adapter_peft_layout():
    jm, tm = _pair(use_lora=True, lora_rank=4, lora_alpha=8)
    sd, adapter_cfg = export.export_lora_adapter(state_dict_to_jax(tm)["decoder"], tm.config)
    want_sd, want_cfg = jax_export.export_lora_adapter(jm.params["decoder"], jm.config)
    assert adapter_cfg == want_cfg
    assert adapter_cfg["peft_type"] == "LORA" and adapter_cfg["r"] == 4
    assert sd.keys() == want_sd.keys()
    assert len(sd) == 2 * tm.config.decoder.num_layers * len(adapter_cfg["target_modules"])
    a = sd["base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight"]
    b = sd["base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight"]
    dec = tm.config.decoder
    assert a.shape == (4, dec.hidden_size)  # torch Linear: A [r, in], B [out, r]
    assert b.shape == (dec.num_heads * dec.head_dim, 4)


def test_reference_config_reads_back(tmp_path):
    from tiny_audio_tpu_torch.config import tiny_test_config as port_tiny

    cfg = port_tiny(model_dtype="float32", projector_type="moe")
    (tmp_path / "config.json").write_text(json.dumps(export.export_reference_config(cfg)))
    back = convert.config_from_reference_dir(tmp_path)
    assert back.projector_type == "moe"
    assert back.encoder == cfg.encoder and back.encoder_conv_layers == cfg.encoder_conv_layers
    for field in ("vocab_size", "num_kv_heads", "qk_norm", "head_dim", "num_layers"):
        assert getattr(back.decoder, field) == getattr(cfg.decoder, field)
    assert back.projector_pool_stride == cfg.projector_pool_stride


def test_local_tower_configs_are_reproduced(tmp_path):
    """Tower ids naming local HF directories: their config.json goes into
    the artifact's config as it is, in both packages."""
    (tmp_path / "enc").mkdir()
    (tmp_path / "dec").mkdir()
    enc = {"model_type": "whisper", "d_model": 64, "custom": [1, 2]}
    dec = {"model_type": "qwen3", "hidden_size": 64, "extra": "x"}
    (tmp_path / "enc" / "config.json").write_text(json.dumps(enc))
    (tmp_path / "dec" / "config.json").write_text(json.dumps(dec))
    cfg = tiny_test_config(audio_model_id=str(tmp_path / "enc"),
                           text_model_id=str(tmp_path / "dec"))
    ours = export.export_reference_config(PortASRConfig.from_dict(cfg.to_dict()))
    assert ours == jax_export.export_reference_config(cfg)
    assert ours["audio_config"] == enc == ours["encoder"] and ours["text_config"] == dec
