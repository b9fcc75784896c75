"""tiny-audio-tpu on PyTorch + CUDA: the serving path for one NVIDIA H100.

A port of :mod:`tiny_audio_tpu` (the JAX reference, which stays beside it):
mel -> audio encoder -> MLP projector -> ``<audio>`` splice -> Qwen3 prefill
-> KV-cached greedy decode -> text, batched, streamed or behind the HTTP
server (:mod:`.serving`), with opt-in int8 decode modes and checkpoints in
the JAX package's layout.  Plain tensor code is PyTorch; the kernels the JAX
package ran in Pallas on the TPU along these paths (encoder and prefill
attention, decode attention with and without the cache append, the W8A8 and
weight-only int8 products) are CUDA C++ written for Hopper (``csrc/``), each
with a plain PyTorch version that serves CPU tensors and the tests.

The package imports nothing of the JAX package, nor jax, flax or msgpack:
the configuration classes, the tokenizer, the pipeline, the server and the
checkpoint reader are its own.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""

from tiny_audio_tpu_torch.config import (  # noqa: F401
    ASRConfig,
    DecoderConfig,
    EncoderConfig,
    compute_encoder_output_length,
)
