"""Raw-HTTP clients for the external STT APIs the harness evaluates against.

Port of :mod:`tiny_audio_tpu.eval.evaluators.api`: AssemblyAI, Deepgram and
ElevenLabs through their REST contracts directly (no vendor SDK), returning
the raw response JSON; the diarization and alignment evaluators extract
segments and words from it with the pure functions beside them.  ``requests``
is imported only when a client is called, which needs the vendor's key (the
same environment variables as the JAX package) and the network.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Optional


def require_key(env_var: str) -> str:
    key = os.environ.get(env_var)
    if not key:
        raise RuntimeError(f"{env_var} not set")
    return key


def assemblyai_transcribe(
    wav_bytes: bytes,
    api_key: str,
    base_url: str = "https://api.assemblyai.com",
    poll_s: float = 1.0,
    poll_timeout_s: float = 600.0,
    **params,
) -> dict:
    """Upload + submit + poll the AssemblyAI batch API; returns the completed
    transcript JSON (``utterances``/``words`` present per request params).

    The submit POST is status-checked (a 4xx body has no ``id`` — without
    the check it surfaced as a bare KeyError), and the poll loop is bounded
    by ``poll_timeout_s`` so a job stuck in ``processing`` can't hang an
    eval run forever."""
    import requests

    base_url = base_url.rstrip("/")
    headers = {"authorization": api_key}
    up = requests.post(f"{base_url}/v2/upload", data=wav_bytes,
                       headers=headers, timeout=120)
    up.raise_for_status()
    body = {"audio_url": up.json()["upload_url"], "speech_model": "universal"}
    body.update(params)
    submit = requests.post(f"{base_url}/v2/transcript", json=body,
                           headers=headers, timeout=30)
    submit.raise_for_status()
    job = submit.json()
    deadline = time.monotonic() + poll_timeout_s
    while True:
        st = requests.get(f"{base_url}/v2/transcript/{job['id']}",
                          headers=headers, timeout=30).json()
        if st["status"] in ("completed", "error"):
            break
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"assemblyai job {job['id']} still {st['status']!r} after "
                f"{poll_timeout_s:.0f}s"
            )
        time.sleep(poll_s)
    if st["status"] == "error":
        raise RuntimeError(st.get("error", "assemblyai error"))
    return st


def deepgram_transcribe(
    wav_bytes: bytes,
    api_key: str,
    model: str = "nova-3",
    base_url: str = "https://api.deepgram.com",
    **params,
) -> dict:
    """Deepgram synchronous batch API; returns the response JSON."""
    import requests

    query = "&".join([f"model={model}"] +
                     [f"{k}={str(v).lower()}" for k, v in params.items()])
    resp = requests.post(
        f"{base_url.rstrip('/')}/v1/listen?{query}",
        data=wav_bytes,
        headers={"Authorization": f"Token {api_key}",
                 "Content-Type": "audio/wav"},
        timeout=120,
    )
    resp.raise_for_status()
    return resp.json()


def elevenlabs_transcribe(
    wav_bytes: bytes,
    api_key: str,
    model_id: str = "scribe_v1",
    base_url: str = "https://api.elevenlabs.io",
    **params,
) -> dict:
    """ElevenLabs scribe speech-to-text API; returns the response JSON."""
    import requests

    data = {"model_id": model_id}
    data.update({k: json.dumps(v) if isinstance(v, bool) else v
                 for k, v in params.items()})
    resp = requests.post(
        f"{base_url.rstrip('/')}/v1/speech-to-text",
        headers={"xi-api-key": api_key},
        files={"file": ("a.wav", io.BytesIO(wav_bytes), "audio/wav")},
        data=data,
        timeout=120,
    )
    resp.raise_for_status()
    return resp.json()


def audio_to_wav_bytes(audio: dict) -> bytes:
    import tempfile
    from pathlib import Path

    import numpy as np

    from tiny_audio_tpu_torch.utils.audio_io import write_wav

    with tempfile.TemporaryDirectory() as td:
        p = Path(td) / "a.wav"
        write_wav(p, np.asarray(audio["array"], np.float32),
                  int(audio.get("sampling_rate", 16000)))
        return p.read_bytes()
