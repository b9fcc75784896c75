"""pipecat STT service adapter for voice agents.

Port of :mod:`tiny_audio_tpu.integrations.pipecat_stt`: a
``SegmentedSTTService`` that loads the model on first use (on ``device``: the
card unless the caller asks for the CPU), converts int16 PCM to float32, and
yields an interim transcription frame per streamed token (or one final frame
in non-streaming mode).  pipecat-ai is an optional dependency: without it
this module imports, and constructing the service raises.
"""

from __future__ import annotations

from typing import AsyncGenerator

import numpy as np

try:  # optional dependency
    from pipecat.frames.frames import (
        ErrorFrame,
        Frame,
        InterimTranscriptionFrame,
        TranscriptionFrame,
    )
    from pipecat.services.stt_service import SegmentedSTTService
    from pipecat.utils.time import time_now_iso8601

    _HAVE_PIPECAT = True
except ImportError:
    _HAVE_PIPECAT = False
    SegmentedSTTService = object  # type: ignore[misc,assignment]


def pcm16_to_float32(audio_bytes: bytes) -> np.ndarray:
    """int16 little-endian PCM -> float32 in [-1, 1]."""
    pcm = np.frombuffer(audio_bytes, dtype=np.int16)
    return (pcm.astype(np.float32) / 32768.0).copy()


class TinyAudioSTTService(SegmentedSTTService):  # type: ignore[misc]
    """Segmented STT over a checkpoint of the JAX package's layout."""

    def __init__(
        self,
        *,
        model_path: str,
        streaming: bool = True,
        sample_rate: int = 16000,
        device="cuda",
        **kwargs,
    ):
        if not _HAVE_PIPECAT:
            raise ImportError(
                "pipecat-ai is required for TinyAudioSTTService "
                "(pip install pipecat-ai)"
            )
        super().__init__(sample_rate=sample_rate, **kwargs)
        self._model_path = model_path
        self._streaming = streaming
        self._device = device
        self._pipe = None

    def _ensure_model(self):
        if self._pipe is None:
            from tiny_audio_tpu_torch.models.asr import ASRModel
            from tiny_audio_tpu_torch.pipeline import ASRPipeline

            self._pipe = ASRPipeline(
                ASRModel.from_pretrained(self._model_path, device=self._device))
        return self._pipe

    async def run_stt(self, audio: bytes) -> "AsyncGenerator[Frame, None]":
        # All blocking work (the model's load, the kernels' build, decoding)
        # runs off the event loop; streaming runs the generator on a thread
        # feeding an asyncio queue, so interim frames arrive in real time.
        import asyncio
        import threading

        try:
            pipe = await asyncio.to_thread(self._ensure_model)
            waveform = pcm16_to_float32(audio)
            if self._streaming:
                loop = asyncio.get_running_loop()
                q: asyncio.Queue = asyncio.Queue()
                done = object()

                def produce():
                    try:
                        feats = pipe.processor.extract_features(waveform)
                        for fragment in pipe.model.generate_streaming(
                            feats["input_features"],
                            feats["audio_attention_mask"],
                        ):
                            loop.call_soon_threadsafe(q.put_nowait, fragment)
                    except BaseException as e:
                        loop.call_soon_threadsafe(q.put_nowait, e)
                    finally:
                        loop.call_soon_threadsafe(q.put_nowait, done)

                threading.Thread(target=produce, daemon=True).start()
                parts: list[str] = []
                while True:
                    item = await q.get()
                    if item is done:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    parts.append(item)
                    yield InterimTranscriptionFrame(
                        "".join(parts).strip(), "", time_now_iso8601()
                    )
                text = "".join(parts).strip()
            else:
                result = await asyncio.to_thread(pipe, waveform)
                text = result["text"]
            if text:
                yield TranscriptionFrame(text, "", time_now_iso8601())
        except Exception as e:
            yield ErrorFrame(f"tiny_audio_tpu_torch STT error: {e}")
