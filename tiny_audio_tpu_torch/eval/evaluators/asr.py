"""ASR evaluators: local pipeline, streaming TTFB, realtime server, HTTP
endpoint, API backends.

Port of :mod:`tiny_audio_tpu.eval.evaluators.asr`.  The local backends run
the port's :class:`~tiny_audio_tpu_torch.pipeline.ASRPipeline` on ``device``
(the card unless the caller asks for the CPU); the realtime backend and the
AssemblyAI streaming client speak WebSocket through the port's own transport
(:mod:`tiny_audio_tpu_torch.utils.websocket`).  The external API backends
(AssemblyAI, Deepgram, ElevenLabs) need their key and the network;
``requests`` is imported only when they are called.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from tiny_audio_tpu_torch.eval.evaluators.api import audio_to_wav_bytes as _to_wav_bytes
from tiny_audio_tpu_torch.eval.evaluators.base import Evaluator


class LocalEvaluator(Evaluator):
    """Evaluate a local checkpoint through the full ASRPipeline."""

    def __init__(self, model_path: str, num_workers: int = 1, pipeline=None,
                 device="cuda"):
        super().__init__(model_name=model_path, num_workers=1)  # one device
        if pipeline is not None:
            self.pipe = pipeline
        else:
            from tiny_audio_tpu_torch.models.asr import ASRModel
            from tiny_audio_tpu_torch.pipeline import ASRPipeline

            self.pipe = ASRPipeline(ASRModel.from_pretrained(model_path, device=device))

    def transcribe(self, audio: dict, sample: dict) -> str:
        kwargs = {}
        if "prompt" in sample:
            kwargs["user_prompt"] = sample["prompt"]
        return self.pipe(audio, **kwargs)["text"]


class LocalStreamingEvaluator(LocalEvaluator):
    """Streaming decode with time-to-first-fragment and processing-time
    metrics."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ttfbs: list[float] = []
        self.proc_times: list[float] = []

    def transcribe(self, audio: dict, sample: dict) -> str:
        from tiny_audio_tpu_torch.pipeline import ASRPipeline

        norm = ASRPipeline.extract_audio(audio)
        feats = self.pipe.processor.extract_features(norm["array"])
        t0 = time.time()
        first = None
        parts: list[str] = []
        for fragment in self.pipe.model.generate_streaming(
            feats["input_features"], feats["audio_attention_mask"]
        ):
            if first is None:
                first = time.time() - t0
            parts.append(fragment)
        self.ttfbs.append(first if first is not None else time.time() - t0)
        self.proc_times.append(time.time() - t0)
        return "".join(parts).strip()

    def compute_metrics(self, results) -> dict:
        metrics = super().compute_metrics(results)
        if self.ttfbs:
            metrics.update(
                ttfb_avg_s=float(np.mean(self.ttfbs)),
                ttfb_min_s=float(np.min(self.ttfbs)),
                ttfb_max_s=float(np.max(self.ttfbs)),
                processing_avg_s=float(np.mean(self.proc_times)),
            )
        return metrics


class LocalRealtimeEvaluator(LocalEvaluator):
    """WER through the realtime WebSocket path: a
    :class:`~tiny_audio_tpu_torch.realtime.RealtimeServer` around the local
    pipeline, each clip streamed as PCM16 chunks, the endpointed turns'
    transcripts joined.  This measures what online segmentation costs
    against the offline pipeline on the same audio.  Chunks stream without
    pacing (the server is pull-based)."""

    CHUNK_BYTES = 3200  # 100 ms of 16 kHz PCM16, the AAI client's cadence

    def __init__(self, model_path: str, num_workers: int = 1, pipeline=None,
                 device="cuda"):
        super().__init__(model_path, pipeline=pipeline, device=device)
        from tiny_audio_tpu_torch.realtime import RealtimeServer

        self.model_name = f"{model_path}-realtime"
        self.server = RealtimeServer(
            self.pipe, host="127.0.0.1", port=0,
            partial_every_s=None,  # finals only: partials would double decodes
        ).start()
        self.turn_counts: list[int] = []

    def transcribe(self, audio: dict, sample: dict) -> str:
        from tiny_audio_tpu_torch.pipeline import ASRPipeline
        from tiny_audio_tpu_torch.utils.websocket import connect

        norm = ASRPipeline.extract_audio(audio)
        pcm = (np.clip(norm["array"], -1.0, 1.0) * 32767).astype("<i2").tobytes()
        transcripts: dict[int, str] = {}
        with connect(f"ws://127.0.0.1:{self.server.port}/?sample_rate=16000") as ws:
            for i in range(0, len(pcm), self.CHUNK_BYTES):
                ws.send(pcm[i: i + self.CHUNK_BYTES])
            ws.send(json.dumps({"type": "Terminate"}))
            while True:
                msg = json.loads(ws.recv(timeout=600))
                if msg.get("type") == "Turn" and msg.get("end_of_turn"):
                    transcripts[msg.get("turn_order", 0)] = msg.get("transcript", "")
                if msg.get("type") == "Termination":
                    break
        self.turn_counts.append(len(transcripts))
        return " ".join(t for _, t in sorted(transcripts.items()) if t).strip()

    def compute_metrics(self, results) -> dict:
        metrics = super().compute_metrics(results)
        if self.turn_counts:
            metrics["turns_avg"] = float(np.mean(self.turn_counts))
        return metrics

    def close(self) -> None:
        self.server.shutdown()


class EndpointEvaluator(Evaluator):
    """POST audio bytes to a serving endpoint (a plain HTTP contract)."""

    def __init__(self, url: str, token: Optional[str] = None, num_workers: int = 4):
        super().__init__(model_name=url, num_workers=num_workers)
        self.url = url
        self.token = token or os.environ.get("HF_TOKEN")

    def transcribe(self, audio: dict, sample: dict) -> str:
        import requests

        headers = {"Content-Type": "audio/wav"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        resp = requests.post(
            self.url, data=_to_wav_bytes(audio), headers=headers, timeout=120
        )
        resp.raise_for_status()
        body = resp.json()
        if isinstance(body, str):  # endpoints may return a bare JSON string
            return body
        return body.get("text", "") if isinstance(body, dict) else ""


class AssemblyAIEvaluator(Evaluator):
    """AssemblyAI batch API."""

    def __init__(self, base_url: Optional[str] = None, num_workers: int = 4):
        super().__init__(model_name="assemblyai", num_workers=num_workers)
        self.api_key = os.environ.get("ASSEMBLYAI_API_KEY")
        if not self.api_key:
            raise RuntimeError("ASSEMBLYAI_API_KEY not set")
        self.base_url = (base_url or "https://api.assemblyai.com").rstrip("/")

    def transcribe(self, audio: dict, sample: dict) -> str:
        import requests

        headers = {"authorization": self.api_key}
        up = requests.post(
            f"{self.base_url}/v2/upload",
            data=_to_wav_bytes(audio), headers=headers, timeout=120,
        )
        up.raise_for_status()
        job = requests.post(
            f"{self.base_url}/v2/transcript",
            json={"audio_url": up.json()["upload_url"], "speech_model": "universal"},
            headers=headers, timeout=30,
        ).json()
        while True:
            st = requests.get(
                f"{self.base_url}/v2/transcript/{job['id']}",
                headers=headers, timeout=30,
            ).json()
            if st["status"] in ("completed", "error"):
                break
            time.sleep(1.0)
        if st["status"] == "error":
            raise RuntimeError(st.get("error", "assemblyai error"))
        return st.get("text") or ""


class AssemblyAIStreamingEvaluator(Evaluator):
    """AssemblyAI's realtime v3 WebSocket protocol, 100 ms PCM chunks; with
    ``base_url="ws://host:port/ws"`` it evaluates the port's own
    :class:`~tiny_audio_tpu_torch.realtime.RealtimeServer`."""

    CHUNK_BYTES = 3200  # 100 ms of 16 kHz 16-bit mono

    def __init__(self, base_url: Optional[str] = None, num_workers: int = 1):
        super().__init__(model_name="assemblyai-streaming", num_workers=num_workers)
        self.api_key = os.environ.get("ASSEMBLYAI_API_KEY")
        if not self.api_key:
            raise RuntimeError("ASSEMBLYAI_API_KEY not set")
        self.url = (
            base_url
            or "wss://streaming.assemblyai.com/v3/ws"
        ) + "?sample_rate=16000&format_turns=true"
        self.ttfbs: list[float] = []

    def transcribe(self, audio: dict, sample: dict) -> str:
        from tiny_audio_tpu_torch.utils.websocket import connect

        arr = np.asarray(audio["array"], np.float32)
        peak = np.abs(arr).max()
        if peak > 1.0:
            arr = arr / peak
        pcm = (arr * 32767).astype(np.int16).tobytes()

        ws = connect(self.url, additional_headers={"Authorization": self.api_key},
                     open_timeout=30)
        transcripts: dict[int, str] = {}
        first = None
        t0 = time.time()
        try:
            for i in range(0, len(pcm), self.CHUNK_BYTES):
                ws.send(pcm[i : i + self.CHUNK_BYTES])
                try:
                    msg = json.loads(ws.recv(timeout=0.01))
                    if msg.get("type") == "Turn":
                        if first is None:
                            first = time.time() - t0
                        transcripts[msg.get("turn_order", 0)] = msg.get(
                            "transcript", ""
                        )
                except Exception:
                    pass
                time.sleep(0.02)
            ws.send(json.dumps({"type": "Terminate"}))
            while True:
                try:
                    msg = json.loads(ws.recv(timeout=5.0))
                except Exception:
                    break
                if msg.get("type") == "Turn":
                    if first is None:  # short clips: the first Turn lands here
                        first = time.time() - t0
                    transcripts[msg.get("turn_order", 0)] = msg.get("transcript", "")
                if msg.get("type") == "Termination":
                    break
        finally:
            ws.close()
        if first is not None:
            self.ttfbs.append(first)
        return " ".join(t for _, t in sorted(transcripts.items()) if t)

    def compute_metrics(self, results) -> dict:
        metrics = super().compute_metrics(results)
        if self.ttfbs:
            metrics["ttfb_avg_s"] = float(np.mean(self.ttfbs))
        return metrics


class DeepgramEvaluator(Evaluator):
    """Deepgram nova-3 batch API."""

    def __init__(self, num_workers: int = 4, model: str = "nova-3"):
        super().__init__(model_name=f"deepgram-{model}", num_workers=num_workers)
        self.api_key = os.environ.get("DEEPGRAM_API_KEY")
        if not self.api_key:
            raise RuntimeError("DEEPGRAM_API_KEY not set")
        self.model = model

    def transcribe(self, audio: dict, sample: dict) -> str:
        import requests

        resp = requests.post(
            f"https://api.deepgram.com/v1/listen?model={self.model}&smart_format=true",
            data=_to_wav_bytes(audio),
            headers={
                "Authorization": f"Token {self.api_key}",
                "Content-Type": "audio/wav",
            },
            timeout=120,
        )
        resp.raise_for_status()
        alts = resp.json()["results"]["channels"][0]["alternatives"]
        return alts[0]["transcript"] if alts else ""


class ElevenLabsEvaluator(Evaluator):
    """ElevenLabs scribe batch API."""

    def __init__(self, num_workers: int = 4):
        super().__init__(model_name="elevenlabs-scribe", num_workers=num_workers)
        self.api_key = os.environ.get("ELEVENLABS_API_KEY")
        if not self.api_key:
            raise RuntimeError("ELEVENLABS_API_KEY not set")

    def transcribe(self, audio: dict, sample: dict) -> str:
        import requests

        resp = requests.post(
            "https://api.elevenlabs.io/v1/speech-to-text",
            headers={"xi-api-key": self.api_key},
            files={"file": ("a.wav", _to_wav_bytes(audio), "audio/wav")},
            data={"model_id": "scribe_v1"},
            timeout=120,
        )
        resp.raise_for_status()
        return resp.json().get("text", "")


BACKENDS = {
    "local": LocalEvaluator,
    "local-streaming": LocalStreamingEvaluator,
    "realtime": LocalRealtimeEvaluator,
    "endpoint": EndpointEvaluator,
    "assemblyai": AssemblyAIEvaluator,
    "assemblyai-streaming": AssemblyAIStreamingEvaluator,
    "deepgram": DeepgramEvaluator,
    "elevenlabs": ElevenLabsEvaluator,
}

#: the backends that run the local pipeline (and take ``device``)
LOCAL_BACKENDS = ("local", "local-streaming", "realtime")
