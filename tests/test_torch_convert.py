"""HF and reference checkpoint conversion: the port against the JAX package.

Each tower converter of the port (``convert_hf_audio_encoder`` /
``convert_hf_whisper_encoder``, ``convert_hf_qwen3``, ``convert_hf_wav2vec2``,
``convert_speechbrain_ecapa``) and ``convert_reference_projector`` must give
the JAX converter's params tree leaf for leaf, bitwise (the same names,
dtypes and bytes: fp32 -> bf16 rounds to nearest even in both), on state
dicts of tiny random ``transformers`` towers (fp32 and bf16 tensors), a
speechbrain-layout ECAPA dict at the 512 and 1024 widths, and every
projector kind.  ``convert_reference_checkpoint`` on a reference-layout
directory (the layout of ``tests/test_checkpoint_dress_rehearsal.py`` at
tier-1 size) gives JAX's parameters and greedy tokens.  The processor's
text half and ``whisper_mode`` give JAX's ids and features.
"""

import json

import jax
import numpy as np
import pytest
import torch

from tiny_audio_tpu import convert as jax_convert
from tiny_audio_tpu.config import DecoderConfig as JaxDecoderConfig
from tiny_audio_tpu.config import EncoderConfig as JaxEncoderConfig
from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.export import export_projector_state as jax_export_projector
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch import convert
from tiny_audio_tpu_torch.bridge import state_dict_to_jax
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.config import DecoderConfig, EncoderConfig
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.processing import ASRProcessor
from tiny_audio_tpu_torch.tokenization import ByteTokenizer

torch.set_num_threads(1)
transformers = pytest.importorskip("transformers")

DTYPES = {"bfloat16": (torch.bfloat16, jax.numpy.bfloat16),
          "float32": (torch.float32, jax.numpy.float32)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _bits(x) -> tuple[str, tuple, bytes]:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        name = str(x.dtype).removeprefix("torch.")
        return name, tuple(x.shape), x.reshape(-1).view(torch.uint8).numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.shape, np.ascontiguousarray(x).tobytes()


def assert_same_tree(ours: dict, theirs: dict) -> None:
    ours, theirs = _leaves(ours), _leaves(theirs)
    assert ours.keys() == theirs.keys()
    for key in theirs:
        assert _bits(ours[key]) == _bits(theirs[key]), key


# ---------------------------------------------------------------- encoder


@pytest.fixture(scope="module")
def whisper():
    from transformers import WhisperConfig, WhisperModel

    torch.manual_seed(0)
    hf_cfg = WhisperConfig(
        num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_layers=1, decoder_attention_heads=4,
        decoder_ffn_dim=128, max_source_positions=256, vocab_size=100, pad_token_id=0,
        bos_token_id=1, eos_token_id=2, decoder_start_token_id=1)
    encoder = WhisperModel(hf_cfg).encoder.eval()
    kw = dict(num_mel_bins=80, d_model=64, num_layers=2, num_heads=4, ffn_dim=128,
              max_source_positions=256)
    return encoder.state_dict(), EncoderConfig(**kw), JaxEncoderConfig(**kw), encoder


def _renamed(sd: dict, renames, prefix: str = "") -> dict:
    out = {}
    for k, v in sd.items():
        for new, old in renames:
            k = k.replace(new, old)
        out[prefix + k] = v
    return out


_ALIASES = [(".self_attn.out_proj.", ".self_attn.o_proj."),
            (".self_attn_layer_norm.", ".input_layernorm."),
            (".final_layer_norm.", ".post_attention_layernorm."),
            (".fc1.", ".mlp.fc1."), (".fc2.", ".mlp.fc2.")]


def _encoder_layout(sd: dict, layout: str) -> dict:
    if layout == "whisper":
        return dict(sd)
    if layout == "whisper_prefixed":
        return {f"model.encoder.{k}": v for k, v in sd.items()}
    if layout == "glm":
        out = {f"audio_tower.{k}": v for k, v in sd.items()}
        out["language_model.model.embed_tokens.weight"] = torch.zeros(4, 4)
        out["multi_modal_projector.linear.weight"] = torch.zeros(4, 4)
        return out
    if layout == "glm_aliases":
        return _renamed(sd, _ALIASES, "audio_tower.")
    if layout == "conv_lists":
        out = {}
        for k, v in sd.items():
            for i, stem in ((0, "conv1."), (1, "conv2.")):
                if k.startswith(stem):
                    k = f"conv_layers.{i}." + k[len(stem):]
            out[f"audio_tower.{k}"] = v
        return out
    if layout == "openai_ln_post":
        return {k.replace("layer_norm.", "ln_post.") if k.startswith("layer_norm.") else k: v
                for k, v in sd.items()}
    raise ValueError(layout)


@pytest.mark.parametrize("layout", ["whisper", "whisper_prefixed", "glm", "glm_aliases",
                                    "conv_lists", "openai_ln_post"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("stored", ["float32", "bfloat16"])
def test_encoder_converter_is_jaxs(whisper, layout, dtype, stored):
    from tiny_audio_tpu.models.encoder import convert_hf_audio_encoder as jax_conv
    from tiny_audio_tpu.models.encoder import detect_encoder_flavor as jax_flavor
    from tiny_audio_tpu_torch.models.encoder import (
        convert_hf_audio_encoder,
        detect_encoder_flavor,
        normalize_encoder_state_dict,
    )
    from tiny_audio_tpu.models.encoder import normalize_encoder_state_dict as jax_normalize

    sd, cfg, jcfg, _ = whisper
    sd = _encoder_layout({k: v.to(DTYPES[stored][0]) for k, v in sd.items()}, layout)
    assert detect_encoder_flavor(sd) == jax_flavor(sd)
    assert list(normalize_encoder_state_dict(sd)) == list(jax_normalize(sd))
    ours = convert_hf_audio_encoder(sd, cfg, dtype=DTYPES[dtype][0])
    theirs = jax_conv(sd, jcfg, dtype=DTYPES[dtype][1])
    assert_same_tree(ours, theirs)


def test_encoder_converter_refuses_an_unknown_layout(whisper):
    from tiny_audio_tpu_torch.models.encoder import convert_hf_whisper_encoder

    with pytest.raises(KeyError, match="unrecognized"):
        convert_hf_whisper_encoder({"audio_tower.something.weird": np.zeros((2, 2))},
                                   whisper[1])


def test_converted_encoder_runs_like_hf(whisper):
    """The converted fp32 tree in the port's encoder gives HF's output."""
    from tiny_audio_tpu_torch.bridge import load_jax_params
    from tiny_audio_tpu_torch.models.encoder import AudioEncoder, convert_hf_audio_encoder

    sd, cfg, _, hf = whisper
    holder = torch.nn.Module()
    holder.encoder = AudioEncoder(cfg, dtype=torch.float32, device="cpu")
    load_jax_params(holder, {"encoder": convert_hf_audio_encoder(sd, cfg, torch.float32)})
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 80, 512))
                           .astype(np.float32))
    with torch.no_grad():
        want = hf(mel).last_hidden_state
        got = holder.encoder(mel)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------- decoder


def _decoder_model(family: str, tie: bool):
    from transformers import (GemmaConfig, GemmaForCausalLM, LlamaConfig, LlamaForCausalLM,
                              Qwen3Config, Qwen3ForCausalLM)

    torch.manual_seed(0)
    common = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=96, max_position_embeddings=512)
    if family == "qwen3":
        model = Qwen3ForCausalLM(Qwen3Config(**common, head_dim=16, rope_theta=1e6,
                                             tie_word_embeddings=tie))
    elif family == "llama":
        model = LlamaForCausalLM(LlamaConfig(**common, rope_theta=1e4, tie_word_embeddings=tie,
                                             attention_bias=False, mlp_bias=False))
    else:
        model = GemmaForCausalLM(GemmaConfig(**common, head_dim=32, rope_theta=1e4,
                                             attention_bias=False))
        with torch.no_grad():  # zero-centered norms: make them non-trivial
            for name, p in model.named_parameters():
                if "norm" in name:
                    p.normal_(0.0, 0.5)
    return model


@pytest.mark.parametrize("family,tie", [("qwen3", True), ("qwen3", False), ("llama", True),
                                        ("llama", False), ("gemma", True)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decoder_converter_is_jaxs(family, tie, dtype):
    from tiny_audio_tpu.models.decoder import convert_hf_qwen3 as jax_conv
    from tiny_audio_tpu_torch.models.decoder import convert_hf_qwen3

    model = _decoder_model(family, tie)
    hf = model.config.to_dict()
    cfg, jcfg = DecoderConfig.from_hf_config(hf), JaxDecoderConfig.from_hf_config(hf)
    assert dataclass_dict(cfg) == dataclass_dict(jcfg)
    for sd in (model.state_dict(), {k: v.bfloat16() for k, v in model.state_dict().items()}):
        ours = convert_hf_qwen3(sd, cfg, dtype=DTYPES[dtype][0])
        theirs = jax_conv(sd, jcfg, dtype=DTYPES[dtype][1])
        assert_same_tree(ours, theirs)
        assert ("q_norm" in ours["layers"]) == (family == "qwen3")
        assert ("lm_head" in ours) == (not cfg.tie_word_embeddings)


def dataclass_dict(cfg) -> dict:
    import dataclasses

    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------- wav2vec2


def _w2v_state_dict(vocab: int, fold: str) -> dict:
    """A 12-layer, 7-conv HF Wav2Vec2ForCTC at narrow widths (the converter
    maps names; the widths are the checkpoint's), its position conv stored
    as parametrizations, as weight_g / weight_v, or fused."""
    from transformers import Wav2Vec2Config, Wav2Vec2ForCTC

    torch.manual_seed(1)
    cfg = Wav2Vec2Config(vocab_size=vocab, hidden_size=32, num_hidden_layers=12,
                         num_attention_heads=4, intermediate_size=64,
                         conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=4, do_stable_layer_norm=False,
                         feat_extract_norm="group")
    sd = dict(Wav2Vec2ForCTC(cfg).eval().state_dict())
    base = "wav2vec2.encoder.pos_conv_embed.conv"
    g = sd.pop(f"{base}.parametrizations.weight.original0")
    v = sd.pop(f"{base}.parametrizations.weight.original1")
    if fold == "parametrizations":
        sd[f"{base}.parametrizations.weight.original0"] = g
        sd[f"{base}.parametrizations.weight.original1"] = v
    elif fold == "weight_norm":
        sd[f"{base}.weight_g"], sd[f"{base}.weight_v"] = g, v
    else:
        sd[f"{base}.weight"] = torch._weight_norm(v, g, dim=2)
    return sd


@pytest.mark.parametrize("vocab", [29, 32])
@pytest.mark.parametrize("fold", ["parametrizations", "weight_norm", "fused"])
def test_wav2vec2_converter_is_jaxs(vocab, fold):
    from tiny_audio_tpu.models.wav2vec2 import convert_hf_wav2vec2 as jax_conv
    from tiny_audio_tpu_torch.models.wav2vec2 import convert_hf_wav2vec2

    sd = _w2v_state_dict(vocab, fold)
    assert_same_tree(convert_hf_wav2vec2(sd), jax_conv(sd))


def test_wav2vec2_full_width_converts_into_the_ports_aligner():
    """The base 960h geometry, converted and loaded into the port's module,
    gives HF's log-probabilities."""
    from transformers import Wav2Vec2Config, Wav2Vec2ForCTC

    from tiny_audio_tpu_torch.bridge import load_flax_tower
    from tiny_audio_tpu_torch.models.wav2vec2 import Wav2Vec2CTC, convert_hf_wav2vec2

    torch.manual_seed(0)
    hf = Wav2Vec2ForCTC(Wav2Vec2Config(vocab_size=29, do_stable_layer_norm=False,
                                       feat_extract_norm="group")).eval()
    model = Wav2Vec2CTC(device="cpu").eval()
    load_flax_tower(model, convert_hf_wav2vec2(hf.state_dict()))
    wav = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal((1, 3200)))
                           .astype(np.float32))
    with torch.no_grad():
        want = torch.log_softmax(hf(wav).logits, dim=-1)
        got = model(wav)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)


# ------------------------------------------------------------------ ECAPA


def speechbrain_state_dict(channels: int, last: int, embed: int, scale: int, se: int,
                           attn: int, n_mels: int = 80, seed: int = 0) -> dict:
    """Random weights under speechbrain's ``ECAPA_TDNN`` checkpoint names
    (``embedding_model.`` prefix, BatchNorm running statistics and
    ``num_batches_tracked``), at the given widths."""
    rng = np.random.default_rng(seed)
    sd: dict = {}

    def conv(name, out, cin, k, bias=True):
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.standard_normal((out, cin, k)).astype(np.float32) / np.sqrt(cin * k))
        if bias:
            sd[f"{name}.bias"] = torch.from_numpy(rng.standard_normal(out).astype(np.float32))

    def bn(name, c):
        sd[f"{name}.weight"] = torch.from_numpy(1 + 0.2 * rng.standard_normal(c).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(0.2 * rng.standard_normal(c).astype(np.float32))
        sd[f"{name}.running_mean"] = torch.from_numpy(0.5 * rng.standard_normal(c)
                                                      .astype(np.float32))
        sd[f"{name}.running_var"] = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    def tdnn(name, out, cin, k):
        conv(f"{name}.conv.conv", out, cin, k)
        bn(f"{name}.norm.norm", out)

    tdnn("blocks.0", channels, n_mels, 5)
    for i in (1, 2, 3):
        tdnn(f"blocks.{i}.tdnn1", channels, channels, 1)
        for j in range(scale - 1):
            tdnn(f"blocks.{i}.res2net_block.blocks.{j}", channels // scale, channels // scale, 3)
        tdnn(f"blocks.{i}.tdnn2", channels, channels, 1)
        conv(f"blocks.{i}.se_block.conv1.conv", se, channels, 1)
        conv(f"blocks.{i}.se_block.conv2.conv", channels, se, 1)
    tdnn("mfa", last, 3 * channels, 1)
    tdnn("asp.tdnn", attn, 3 * last, 1)
    conv("asp.conv.conv", last, attn, 1)
    bn("asp_bn.norm", 2 * last)
    conv("fc.conv", embed, 2 * last, 1)
    return {f"embedding_model.{k}": v for k, v in sd.items()}


@pytest.mark.parametrize("channels,last", [(512, 1536), (1024, 3072)])
def test_speechbrain_ecapa_converter_is_jaxs(channels, last):
    from tiny_audio_tpu.models.ecapa import convert_speechbrain_ecapa as jax_conv
    from tiny_audio_tpu_torch.diarization import EcapaEmbedder
    from tiny_audio_tpu_torch.models.ecapa import convert_speechbrain_ecapa

    sd = speechbrain_state_dict(channels, last, embed=192, scale=8, se=128, attn=128)
    ours, module = convert_speechbrain_ecapa(sd)
    theirs, jax_module = jax_conv(sd)
    assert_same_tree(ours, theirs)
    assert module.embed_dim == jax_module.embed_dim == 192
    emb = EcapaEmbedder.from_speechbrain(sd, device="cpu")
    assert emb.tier == "speechbrain"
    # the running statistics land in the BatchNorm buffers
    norm = emb.module.blocks_0.norm
    torch.testing.assert_close(norm.running_mean, sd["embedding_model.blocks.0.norm.norm"
                                                     ".running_mean"], rtol=0, atol=0)
    torch.testing.assert_close(norm.running_var, sd["embedding_model.blocks.0.norm.norm"
                                                    ".running_var"], rtol=0, atol=0)


# -------------------------------------------------------------- projectors


@pytest.mark.parametrize("ptype", ["mlp", "mosa", "moe", "qformer"])
@pytest.mark.parametrize("stored", ["float32", "bfloat16"])
def test_projector_converter_is_jaxs(ptype, stored):
    jm = JaxASRModel(tiny_test_config(projector_type=ptype, model_dtype="float32"), seed=2)
    sd = jax_export_projector(jax.device_get(jm.params["projector"]), ptype)
    sd = {f"projector.{k}": torch.from_numpy(np.array(v)).to(DTYPES[stored][0])
          for k, v in sd.items()}
    assert_same_tree(convert.convert_reference_projector(sd, ptype),
                     jax_convert.convert_reference_projector(sd, ptype))


def test_projector_converter_refuses_unknown_kinds():
    with pytest.raises(ValueError):
        convert.convert_reference_projector({}, "bogus")
    with pytest.raises(KeyError, match="Blip2QFormer"):
        convert.convert_reference_projector({"query": np.zeros((1, 2, 4)),
                                             "qformer.layernorm.weight": np.ones(4),
                                             "qformer.layernorm.bias": np.zeros(4),
                                             "linear.weight": np.zeros((4, 4)),
                                             "linear.bias": np.zeros(4)}, "qformer")


def test_load_state_dict_reads_dirs_safetensors_and_bin(tmp_path):
    from safetensors.torch import save_file

    save_file({"a": torch.ones(2, 2).bfloat16()}, str(tmp_path / "m.safetensors"))
    assert convert.load_state_dict(tmp_path)["a"].dtype == torch.bfloat16
    (tmp_path / "bin").mkdir()
    torch.save({"b": torch.arange(3)}, tmp_path / "bin" / "pytorch_model.bin")
    assert convert.load_state_dict(tmp_path / "bin")["b"].tolist() == [0, 1, 2]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        convert.load_state_dict(tmp_path / "empty")


# ------------------------------------------- a reference checkpoint directory


def _make_wav(seconds: float = 5.0, rate: int = 16000) -> np.ndarray:
    rng = np.random.default_rng(42)
    t = np.arange(int(seconds * rate)) / rate
    wav = 0.3 * np.sin(2 * np.pi * (200 + 300 * t) * t) + 0.02 * rng.standard_normal(t.shape)
    return wav.astype(np.float32)


@pytest.fixture(scope="module")
def reference_artifact(tmp_path_factory):
    """A checkpoint directory in the reference's published layout, with its
    two tiny HF towers saved beside it."""
    from safetensors.torch import save_file
    from transformers import Qwen3Config, Qwen3ForCausalLM, WhisperConfig, WhisperModel

    root = tmp_path_factory.mktemp("ref_artifact")
    torch.manual_seed(0)
    whisper = WhisperModel(WhisperConfig(
        num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_layers=1, decoder_attention_heads=4,
        decoder_ffn_dim=128, max_source_positions=250, vocab_size=100, pad_token_id=0,
        bos_token_id=1, eos_token_id=2, decoder_start_token_id=1)).eval()
    enc_dir = root / "towers" / "whisper"
    whisper.save_pretrained(enc_dir, safe_serialization=True)
    lm = Qwen3ForCausalLM(Qwen3Config(
        vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, intermediate_size=128, rope_theta=1e6,
        tie_word_embeddings=True, max_position_embeddings=1024)).eval()
    dec_dir = root / "towers" / "qwen3"
    lm.save_pretrained(dec_dir, safe_serialization=True)

    k, enc_dim, llm_dim = 4, 64, 64
    gen = torch.Generator().manual_seed(1)
    projector = {"linear_1.weight": torch.randn(llm_dim, enc_dim * k, generator=gen) / 16,
                 "norm.weight": 1.2 + 0.1 * torch.randn(llm_dim, generator=gen),
                 "linear_2.weight": torch.randn(llm_dim, llm_dim, generator=gen) / 8,
                 "norm_2.weight": 0.1 + torch.ones(llm_dim)}
    ckpt = root / "checkpoint"
    ckpt.mkdir()
    save_file({f"projector.{n}": w.contiguous() for n, w in projector.items()},
              str(ckpt / "model.safetensors"))
    config = {
        "model_type": "asr_model", "architectures": ["ASRModel"],
        "auto_map": {"AutoConfig": "asr_config.ASRConfig", "AutoModel": "asr_modeling.ASRModel"},
        "audio_model_id": str(enc_dir), "text_model_id": str(dec_dir),
        "attn_implementation": "sdpa", "model_dtype": "float32", "encoder_dim": enc_dim,
        "llm_dim": llm_dim, "encoder_conv_layers": [[1, 3, 1], [1, 3, 2]],
        "audio_sample_rate": 16000, "projector_type": "mlp", "projector_pool_stride": k,
        "audio_token_dropout": 0.0, "use_lora": False, "freeze_language_model": True,
        "max_new_tokens": 16, "num_beams": 1, "repetition_penalty": 1.0, "do_sample": False,
        "audio_config": json.loads(whisper.config.to_json_string()),
        "text_config": json.loads(lm.config.to_json_string()),
        "encoder": json.loads(whisper.config.to_json_string()),
    }
    (ckpt / "config.json").write_text(json.dumps(config, indent=2))
    return ckpt


def test_reference_checkpoint_converts_to_jaxs_model(reference_artifact, tmp_path,
                                                      monkeypatch):
    """The port's conversion of the directory equals JAX's parameter for
    parameter, its saved checkpoint reloads the same, and the greedy tokens
    on a 5 s clip equal JAX's."""
    monkeypatch.setenv("TA_SKIP_ATTN_CALIBRATION", "1")  # JAX's TPU-kernel check only
    jm = jax_convert.convert_reference_checkpoint(reference_artifact)
    tm = convert.convert_reference_checkpoint(reference_artifact, output_dir=tmp_path / "out",
                                              device="cpu")
    assert tm.config.to_dict() == jm.config.to_dict()
    assert_same_tree(state_dict_to_jax(tm), jax.device_get(jm.params))
    reloaded = ASRModel.from_pretrained(tmp_path / "out", device="cpu")
    assert_same_tree(state_dict_to_jax(reloaded), jax.device_get(jm.params))

    wav = _make_wav()
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features([wav])
    tf = ASRProcessor(tm.tokenizer, tm.projector, num_mel_bins=80,
                      device="cpu").extract_features([wav])
    want = jm.generate(jf["input_features"], jf["audio_attention_mask"], mel_length=500)
    got = tm.generate(tf["input_features"], tf["audio_attention_mask"], mel_length=500)
    np.testing.assert_array_equal(got, want)


def test_config_from_reference_dir_is_jaxs(reference_artifact):
    ours = convert.config_from_reference_dir(reference_artifact)
    theirs = jax_convert.config_from_reference_dir(reference_artifact)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.encoder.num_layers == 2 and ours.decoder.vocab_size == 512


def test_tower_config_overlay_warns_and_keeps_other_fields(reference_artifact, caplog):
    """A tower's own config.json overrides only the keys it carries, with
    JAX's warning; the LoRA leaves of a converted decoder stay fresh."""
    cfg = convert.config_from_reference_dir(reference_artifact)
    cfg.encoder = type(cfg.encoder)(**{**dataclass_dict(cfg.encoder), "d_model": 32,
                                       "conv_layers": ((1, 3, 1), (1, 3, 2))})
    cfg.use_lora, cfg.lora_rank = True, 4
    with caplog.at_level("WARNING"):
        model = convert.convert_checkpoint(cfg, encoder_path=cfg.audio_model_id,
                                           decoder_path=cfg.text_model_id, device="cpu")
    assert "encoder config overridden" in caplog.text and "'d_model': 64" in caplog.text
    assert model.config.encoder.d_model == 64
    lora_b = [p for n, p in model.decoder.named_parameters() if n.endswith("_lora_b")]
    assert lora_b and all(float(p.detach().abs().max()) == 0.0 for p in lora_b)


# ---------------------------------------------------------- the text half


@pytest.mark.parametrize("text", [None, "hello world"])
@pytest.mark.parametrize("prompts", [(None, None), ("be brief", ""), ("", "say it")])
def test_processor_call_is_jaxs(text, prompts):
    from tiny_audio_tpu.tokenization import ByteTokenizer as JaxByteTokenizer

    cfg = tiny_test_config(model_dtype="float32")
    jm = JaxASRModel(cfg, seed=0)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), device="cpu")
    jproc = JaxASRProcessor(JaxByteTokenizer(512), jm.projector, num_mel_bins=80)
    tproc = ASRProcessor(ByteTokenizer(512), tm.projector, num_mel_bins=80, device="cpu")
    audio = [np.random.default_rng(0).standard_normal(n).astype(np.float32) * 0.1
             for n in (16000, 7000)]
    system_prompt, user_prompt = prompts
    for clip in (audio, None):
        want = jproc(clip, text=text, system_prompt=system_prompt, user_prompt=user_prompt)
        got = tproc(clip, text=text, system_prompt=system_prompt, user_prompt=user_prompt)
        assert got.keys() == want.keys()
        for key in ("input_ids", "attention_mask"):
            assert got[key].dtype == np.int32 and got[key].shape[0] == 1
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        if clip is not None:
            assert isinstance(got["input_features"], torch.Tensor)
            np.testing.assert_allclose(got["input_features"].numpy(),
                                       np.asarray(want["input_features"]), atol=1e-4)
        assert tproc.build_messages(3, text, system_prompt, user_prompt) == \
            jproc.build_messages(3, text, system_prompt, user_prompt)


def test_whisper_mode_features_are_jaxs():
    """Every clip padded to the 3,000-frame window; the mask carries each
    clip's real length."""
    rng = np.random.default_rng(3)
    clips = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (16000, 4000, 9000)]
    from tiny_audio_tpu.tokenization import ByteTokenizer as JaxByteTokenizer

    jproc = JaxASRProcessor(JaxByteTokenizer(512), num_mel_bins=80, whisper_mode=True)
    tproc = ASRProcessor(ByteTokenizer(512), num_mel_bins=80, whisper_mode=True, device="cpu")
    want, got = jproc.extract_features(clips), tproc.extract_features(clips)
    assert got["input_features"].shape == (3, 80, 3000)
    np.testing.assert_allclose(got["input_features"].numpy(),
                               np.asarray(want["input_features"]), atol=1e-4)
    np.testing.assert_array_equal(got["audio_attention_mask"].numpy(),
                                  np.asarray(want["audio_attention_mask"]))
    assert got["audio_attention_mask"].sum(-1).tolist() == [100, 25, 57]
    np.testing.assert_array_equal(got["mel_lengths"], want["mel_lengths"])
