"""Configuration of the PyTorch port: the port's own copy of
:mod:`tiny_audio_tpu.config` (the port imports nothing of the JAX package).

Re-designed equivalent of the reference's ``ASRConfig``
(``tiny_audio/asr_config.py:22-220``): a plain dataclass with the
same field names and JSON serialization contract (``config.json`` in a checkpoint
directory), minus the HF ``PretrainedConfig`` machinery.  Tower architectures are
described by explicit ``EncoderConfig`` / ``DecoderConfig`` dataclasses instead of
HF Hub ``AutoConfig`` downloads, so a checkpoint is fully self-describing and the
model can be built offline.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Union

# Default conv layers for Whisper/GLM-ASR-style audio encoders:
# [(padding, kernel, stride), ...]  (reference: asr_config.py:6)
DEFAULT_ENCODER_CONV_LAYERS = [(1, 3, 1), (1, 3, 2)]


def compute_encoder_output_length(mel_length, conv_layers=None):
    """Apply encoder conv-layer formulas to compute output length.

    Works with Python ints and integer numpy/torch arrays; the per-layer formula
    ``(L + 2*p - (k-1) - 1) // s + 1`` is identical for both.
    (reference: asr_config.py:9-19)
    """
    layers = conv_layers if conv_layers is not None else DEFAULT_ENCODER_CONV_LAYERS
    length = mel_length
    for padding, kernel_size, stride in layers:
        length = (length + 2 * padding - (kernel_size - 1) - 1) // stride + 1
    return length


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper/GLM-ASR-style audio encoder architecture.

    Conv subsampling stack (from ``conv_layers``) followed by a pre-LN
    transformer with sinusoidal positions.  ``GLM-ASR-Nano``-class defaults
    (~600M params, 128 mel bins) — the reference loads this tower from the HF
    Hub (asr_modeling.py:203-237); here it is an explicit architecture.

    Frozen + tuple fields: hashable, so modules built from it can be jit
    static arguments.
    """

    num_mel_bins: int = 128
    d_model: int = 1280
    num_layers: int = 32
    num_heads: int = 20
    ffn_dim: int = 5120
    max_source_positions: int = 1500  # post-conv frames for 30 s of audio
    conv_layers: tuple = tuple(
        tuple(t) for t in DEFAULT_ENCODER_CONV_LAYERS
    )
    activation: str = "gelu"
    layer_norm_eps: float = 1e-5

    def __post_init__(self):
        object.__setattr__(
            self, "conv_layers", tuple(tuple(t) for t in self.conv_layers)
        )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @staticmethod
    def from_hf_config(hf: dict) -> "EncoderConfig":
        """Derive encoder dims from a checkpoint's HF ``config.json`` dict.

        Handles bare Whisper-encoder configs and GLM-ASR-style composite
        configs where the tower config is nested (``audio_config``) — the
        offline analogue of the reference's AutoConfig-driven dim
        auto-detection (``tiny_audio/asr_modeling.py:258-274``).
        Use this when converting a real checkpoint so the dims are
        provenance-checked instead of assumed.
        """
        return EncoderConfig(**encoder_kwargs_from_hf(hf))


def encoder_kwargs_from_hf(hf: dict) -> dict:
    """The EncoderConfig fields a HF ``config.json`` dict actually carries.

    Returns ONLY keys present in the checkpoint config — callers that need
    to reconcile against a user-supplied EncoderConfig must overlay these
    rather than build a fresh config (absent keys would otherwise be
    silently filled with dataclass defaults, clobbering the user's values).
    """
    enc = hf.get("audio_config") or hf.get("encoder_config") or hf
    kw: dict = {}
    for ours, theirs in [
        ("num_mel_bins", ("num_mel_bins",)),
        ("d_model", ("d_model", "hidden_size")),
        ("num_layers", ("encoder_layers", "num_hidden_layers")),
        ("num_heads", ("encoder_attention_heads", "num_attention_heads")),
        ("ffn_dim", ("encoder_ffn_dim", "intermediate_size")),
        ("max_source_positions", ("max_source_positions",)),
    ]:
        for name in theirs:
            if name in enc:
                kw[ours] = int(enc[name])
                break
    if "conv_layers" in enc or "encoder_conv_layers" in enc:
        kw["conv_layers"] = tuple(
            tuple(t) for t in (enc.get("conv_layers") or enc["encoder_conv_layers"])
        )
    return kw


@dataclass(frozen=True)
class DecoderConfig:
    """Qwen3-style causal LM architecture (GQA + QK-norm + RoPE + SwiGLU).

    Defaults match Qwen3-0.6B, the reference's frozen text tower
    (asr_config.py:39, asr_modeling.py:239-254).
    """

    vocab_size: int = 151936
    hidden_size: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 40960

    # Per-head QK RMSNorm — the Qwen3 signature feature.  False selects the
    # Llama-family variant (Llama/SmolLM2/Mistral layouts: identical block
    # otherwise), mirroring the reference's "any AutoModelForCausalLM text
    # tower" contract (tiny_audio/asr_modeling.py:239-254).
    qk_norm: bool = True

    # Gemma-family (v1) knobs — all default to the Qwen3/Llama behavior.
    # rms_norm_offset: weights stored zero-centered, applied as (1 + w)
    # (GemmaRMSNorm).  hidden_activation: MLP gate activation — "silu"
    # (SwiGLU) or "gelu_tanh" (Gemma GeGLU, torch's gelu_pytorch_tanh).
    # embedding_normalizer: multiply inputs_embeds by sqrt(hidden_size)
    # (cast to the compute dtype first, matching HF GemmaModel.forward).
    rms_norm_offset: bool = False
    hidden_activation: str = "silu"
    embedding_normalizer: bool = False

    # KV-cache storage: "bfloat16" (default) or "int8" (per-entry-scaled
    # symmetric quantization — halves decode-time cache bandwidth/memory;
    # serving-mode opt-in via ASRConfig.kv_cache_dtype)
    kv_cache_dtype: str = "bfloat16"

    # Rematerialize each block in the backward pass (trade FLOPs for
    # activation memory in stage-3 full fine-tunes; the reference's
    # gradient_checkpointing, asr_modeling.py:359-370)
    gradient_checkpointing: bool = False

    # LoRA (0 = disabled). Populated from ASRConfig.use_lora/lora_* by
    # ASRModel (stage-2 fine-tuning, reference asr_modeling.py:96-131).
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lora_targets: tuple = (
        "q_proj", "k_proj", "v_proj", "o_proj",
        "gate_proj", "up_proj", "down_proj",
    )

    def __post_init__(self):
        object.__setattr__(self, "lora_targets", tuple(self.lora_targets))

    @staticmethod
    def from_hf_config(hf: dict) -> "DecoderConfig":
        """Derive decoder dims from an HF causal-LM ``config.json`` dict
        (qwen3 / llama / smollm2 / mistral / gemma v1) — the offline
        analogue of the reference's AutoConfig-driven text-tower loading
        (``tiny_audio/asr_modeling.py:239-254``)."""
        return DecoderConfig(**decoder_kwargs_from_hf(hf))


def decoder_kwargs_from_hf(hf: dict) -> dict:
    """The DecoderConfig fields an HF causal-LM ``config.json`` actually
    carries (plus the derivable ``head_dim``/``num_kv_heads``/``qk_norm``).

    Returns ONLY determinable keys — callers reconciling against a
    user-supplied DecoderConfig must overlay these so runtime-only knobs
    (kv_cache_dtype, LoRA, gradient checkpointing) survive.
    """
    kw: dict = {}
    for ours, theirs, conv in [
        ("vocab_size", ("vocab_size",), int),
        ("hidden_size", ("hidden_size",), int),
        ("num_layers", ("num_hidden_layers",), int),
        ("num_heads", ("num_attention_heads",), int),
        ("num_kv_heads", ("num_key_value_heads",), int),
        ("head_dim", ("head_dim",), int),
        ("intermediate_size", ("intermediate_size",), int),
        ("rope_theta", ("rope_theta",), float),
        ("rms_norm_eps", ("rms_norm_eps",), float),
        ("tie_word_embeddings", ("tie_word_embeddings",), bool),
        ("max_position_embeddings", ("max_position_embeddings",), int),
    ]:
        for name in theirs:
            if hf.get(name) is not None:
                kw[ours] = conv(hf[name])
                break
    if "head_dim" not in kw and {"hidden_size", "num_heads"} <= kw.keys():
        kw["head_dim"] = kw["hidden_size"] // kw["num_heads"]
    if "num_kv_heads" not in kw and "num_heads" in kw:
        kw["num_kv_heads"] = kw["num_heads"]  # MHA checkpoints omit it
    if "model_type" in hf:
        mt = hf["model_type"]
        if mt in ("gemma2", "gemma3", "gemma3_text"):
            # these add attention/logit soft-capping, sliding-window layers
            # and (v3) dual rope bases — silently running them through the
            # v1 block would be numerically wrong, so refuse loudly
            raise ValueError(
                f"model_type '{mt}' is not supported as a text tower "
                "(soft-capping / sliding-window attention not implemented); "
                "supported families: qwen3, llama/smollm2/mistral, gemma (v1)"
            )
        # QK-norm is the qwen3 family signature; llama/gemma-v1 configs
        # have no such weights
        kw["qk_norm"] = mt in ("qwen3", "qwen3_moe")
        if mt == "gemma":
            kw["rms_norm_offset"] = True      # (1+w) zero-centered norms
            kw["hidden_activation"] = "gelu_tanh"  # GeGLU
            kw["embedding_normalizer"] = True      # embeds x sqrt(hidden)
    return kw


@dataclass
class ASRConfig:
    """Composite configuration: encoder + decoder + projector + generation.

    Field names mirror the reference ``ASRConfig`` (asr_config.py:36-169) so
    configs translate 1:1; tower ids are kept for provenance but the tower
    architectures are explicit dataclasses.
    """

    # Tower provenance (HF ids kept for weight conversion / parity bookkeeping)
    audio_model_id: str = "zai-org/GLM-ASR-Nano-2512"
    text_model_id: str = "Qwen/Qwen3-0.6B"
    model_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # "int8" = quantized serving cache
    gradient_checkpointing: bool = False  # remat decoder blocks (stage-3 memory)
    system_prompt: str = "You are a helpful assistant."

    # Tower architectures
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)

    # Dimensions (auto-filled from towers when None, asr_modeling.py:256-274)
    encoder_dim: Optional[int] = None
    llm_dim: Optional[int] = None
    encoder_conv_layers: list = field(
        default_factory=lambda: list(DEFAULT_ENCODER_CONV_LAYERS)
    )
    audio_sample_rate: int = 16000

    # Projector
    projector_type: str = "mlp"  # "mlp" | "mosa" | "moe" | "qformer"
    projector_pool_stride: int = 4
    downsample_rate: int = 5  # Granite default (qformer)
    projector_hidden_dim: Optional[int] = None
    audio_token_dropout: float = 0.0

    # MoE projector
    num_experts: int = 4
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.01
    router_z_loss_coef: float = 1e-4
    router_jitter_noise: float = 0.01

    # QFormer projector (Granite defaults)
    qformer_window_size: int = 15
    qformer_hidden_size: Optional[int] = None
    qformer_num_layers: int = 2
    qformer_num_heads: int = 16
    qformer_intermediate_size: Optional[int] = None

    # LoRA (stage-2 fine-tuning)
    use_lora: bool = False
    lora_rank: int = 8
    lora_alpha: int = 32
    lora_dropout: float = 0.0
    lora_target_modules: list = field(
        default_factory=lambda: [
            "q_proj",
            "k_proj",
            "v_proj",
            "o_proj",
            "gate_proj",
            "up_proj",
            "down_proj",
        ]
    )
    freeze_projector: bool = False
    freeze_language_model: bool = True

    # Generation defaults: greedy decoding (asr_config.py:100-111)
    num_beams: int = 1
    max_new_tokens: int = 128
    min_new_tokens: int = 0
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    use_cache: bool = True
    do_sample: bool = False
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.encoder, dict):
            self.encoder = EncoderConfig(**self.encoder)
        if isinstance(self.decoder, dict):
            self.decoder = DecoderConfig(**self.decoder)
        self.encoder_conv_layers = [tuple(t) for t in self.encoder_conv_layers]
        # encoder_conv_layers (token-count formula) and encoder.conv_layers
        # (the actual conv stack) MUST agree or the <audio> splice silently
        # mismatches the projector's output length.  A customized encoder
        # stack wins over the untouched default; conflicting customizations
        # are an error.
        enc_layers = [tuple(t) for t in self.encoder.conv_layers]
        default = [tuple(t) for t in DEFAULT_ENCODER_CONV_LAYERS]
        if self.encoder_conv_layers != enc_layers:
            if self.encoder_conv_layers == default:
                self.encoder_conv_layers = enc_layers
            elif enc_layers == default:
                object.__setattr__(
                    self.encoder, "conv_layers",
                    tuple(tuple(t) for t in self.encoder_conv_layers),
                )
            else:
                raise ValueError(
                    "encoder_conv_layers and encoder.conv_layers disagree: "
                    f"{self.encoder_conv_layers} vs {enc_layers}"
                )
        if self.encoder_dim is None:
            self.encoder_dim = self.encoder.d_model
        if self.llm_dim is None:
            self.llm_dim = self.decoder.hidden_size

    # -- serialization (config.json contract, asr_modeling.py:769-794) --------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["model_type"] = "asr_model"
        return d

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def save_pretrained(self, save_directory: Union[str, Path]) -> None:
        save_dir = Path(save_directory)
        save_dir.mkdir(parents=True, exist_ok=True)
        (save_dir / "config.json").write_text(self.to_json_string())

    @classmethod
    def from_dict(cls, d: dict) -> "ASRConfig":
        d = dict(d)
        d.pop("model_type", None)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_pretrained(cls, path: Union[str, Path]) -> "ASRConfig":
        p = Path(path)
        if p.is_dir():
            p = p / "config.json"
        return cls.from_dict(json.loads(p.read_text()))


def tiny_test_config(**overrides: Any) -> ASRConfig:
    """Small random-weight config for CPU tests (the reference uses
    whisper-tiny + SmolLM2-135M the same way, tests/conftest.py:148-193)."""
    cfg = ASRConfig(
        encoder=EncoderConfig(
            num_mel_bins=80,
            d_model=64,
            num_layers=2,
            num_heads=4,
            ffn_dim=128,
            max_source_positions=256,
        ),
        decoder=DecoderConfig(
            vocab_size=512,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            intermediate_size=128,
            max_position_embeddings=1024,
        ),
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    cfg.__post_init__()
    return cfg
