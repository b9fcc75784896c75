"""tiny-audio-tpu on PyTorch + CUDA: serving and training on one NVIDIA H100.

A port of :mod:`tiny_audio_tpu` (the JAX reference, which stays beside it):
mel -> audio encoder -> projector (MLP, MOSA, MoE or QFormer) -> ``<audio>``
splice -> Qwen3 prefill -> KV-cached decode (greedy, sampling, beam search)
-> text, batched, streamed or behind the HTTP server (:mod:`.serving`), with
opt-in int8 decode modes, word timestamps (:mod:`.alignment`) and speaker
diarization (:mod:`.diarization`, :mod:`.vad`), and checkpoints in the JAX
package's layout; training
(:mod:`.train`: stages 1-3, LoRA, the offline convergence ladder).  Plain tensor code is PyTorch; the kernels the JAX
package ran in Pallas on the TPU along these paths (encoder and prefill
attention, decode attention with and without the cache append, the W8A8 and
weight-only int8 products) are CUDA C++ written for Hopper (``csrc/``), each
with a plain PyTorch version that serves CPU tensors and the tests.

The package imports nothing of the JAX package, nor jax, flax or msgpack,
and ``transformers`` only to read an HF tokenizer: the configuration
classes, the tokenizer, the pipeline, the server, the checkpoint reader
and the WER normalizer are its own.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""

from tiny_audio_tpu_torch.config import (  # noqa: F401
    ASRConfig,
    DecoderConfig,
    EncoderConfig,
    compute_encoder_output_length,
)
