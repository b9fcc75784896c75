"""tiny-audio-tpu on PyTorch + CUDA: the serving path for one NVIDIA H100.

A port of :mod:`tiny_audio_tpu` (the JAX reference, which stays beside it):
mel -> audio encoder -> MLP projector -> ``<audio>`` splice -> Qwen3 prefill
-> KV-cached greedy decode -> text.  Plain tensor code is PyTorch; the two
attention kernels the JAX package ran in Pallas on the TPU (encoder attention
and causal prefill attention) are CUDA C++ written for Hopper
(``csrc/attention.cu``), each with a plain PyTorch version that serves CPU
tensors and the tests.

The package imports nothing of the JAX package: the configuration classes,
the tokenizer and the pipeline are its own copies.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""

from tiny_audio_tpu_torch.config import (  # noqa: F401
    ASRConfig,
    DecoderConfig,
    EncoderConfig,
    compute_encoder_output_length,
)
