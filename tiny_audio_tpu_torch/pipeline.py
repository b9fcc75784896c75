"""ASRPipeline over the PyTorch model.

The JAX package's :class:`tiny_audio_tpu.pipeline.ASRPipeline` imports no
jax and takes the model as a duck type (``generate``, ``tokenizer``,
``projector``, ``config``), so the port reuses it whole: input normalization,
long-form chunking, batch buckets, ``postprocess_tokens`` and repetition
truncation.  Only the default processor differs: it runs the port's mel on
the model's device.
"""

from __future__ import annotations

from tiny_audio_tpu import pipeline as _jax_free_pipeline
from tiny_audio_tpu_torch.processing import ASRProcessor


class ASRPipeline(_jax_free_pipeline.ASRPipeline):
    """End-to-end transcription over a
    :class:`tiny_audio_tpu_torch.models.asr.ASRModel`."""

    def __init__(self, model, processor=None):
        # Sets what the base __init__ sets, without calling it: that one
        # imports the JAX package's processor, and with it jax.
        self.model = model
        self.processor = processor or ASRProcessor(
            projector=model.projector,
            num_mel_bins=model.config.encoder.num_mel_bins,
            encoder_conv_layers=model.config.encoder_conv_layers,
            device=model.device,
        )
        self.tokenizer = model.tokenizer
