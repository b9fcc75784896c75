"""Evaluation dataset registry.

Port of :mod:`tiny_audio_tpu.eval.datasets`: 25+ :class:`DatasetConfig`
entries spanning ASR, diarization, alignment, MCQ and classification
benchmarks, loaded streaming with 16 kHz audio casting.  The ``synthetic``
sources (rows made from a seed) and local ``load_from_disk`` directories
run offline; a hub name needs HF ``datasets`` and the network.  ``datasets``
is imported only for those two.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

SAMPLE_RATE = 16000


@dataclass(frozen=True)
class DatasetConfig:
    name: str
    path: str
    config: Optional[str] = None
    split: str = "test"
    audio_column: str = "audio"
    text_column: str = "text"
    dataset_type: str = "asr"  # asr | diarization | alignment | mcq | classification
    extra: dict = field(default_factory=dict)


_ASR = [
    DatasetConfig("loquacious", "speechbrain/LoquaciousSet", "small", "test"),
    DatasetConfig("loquacious-small", "speechbrain/LoquaciousSet", "small", "test"),
    DatasetConfig("earnings22", "distil-whisper/earnings22", "chunked", "test",
                  text_column="transcription"),
    DatasetConfig("ami", "edinburghcstr/ami", "ihm", "test"),
    DatasetConfig("ami-sdm", "edinburghcstr/ami", "sdm", "test"),
    DatasetConfig("gigaspeech", "speechcolab/gigaspeech", "test", "test"),
    DatasetConfig("spgispeech", "kensho/spgispeech", "test", "test",
                  text_column="transcript"),
    DatasetConfig("tedlium", "LIUM/tedlium", "release3", "test"),
    DatasetConfig("commonvoice", "mozilla-foundation/common_voice_17_0", "en",
                  "test", text_column="sentence"),
    DatasetConfig("peoples", "MLCommons/peoples_speech", "clean", "test"),
    DatasetConfig("voxpopuli", "facebook/voxpopuli", "en", "test",
                  text_column="normalized_text"),
    DatasetConfig("switchboard", "hf-internal/switchboard", None, "test"),
    DatasetConfig("librispeech", "openslr/librispeech_asr", "clean", "test"),
    DatasetConfig("librispeech-other", "openslr/librispeech_asr", "other", "test"),
    DatasetConfig("expresso", "ylacombe/expresso", None, "train"),
    DatasetConfig("synthetic", "synthetic", None, "test"),
]

_DIARIZATION = [
    DatasetConfig(
        "callhome", "talkbank/callhome", "eng", "data",
        dataset_type="diarization",
        extra={"speakers_column": "speakers", "timestamps_column": "timestamps"},
    ),
    DatasetConfig("synthetic-diarization", "synthetic", None, "test",
                  dataset_type="diarization"),
]

_ALIGNMENT = [
    DatasetConfig(
        "librispeech-alignments", "gilkeyio/librispeech-alignments", None,
        "test_clean", dataset_type="alignment",
        extra={"words_column": "words"},
    ),
    DatasetConfig("synthetic-alignment", "synthetic", None, "test",
                  dataset_type="alignment"),
]

_MCQ = [
    DatasetConfig(
        "mmau", "apple/mmau", "test-mini", "test", dataset_type="mcq",
        text_column="question",
        extra={"choices_column": "choices", "answer_column": "answer",
               "category_column": "task"},
    ),
]

_CLASSIFICATION = [
    DatasetConfig("iemocap-emotion", "Zahra99/IEMOCAP_Audio", None, "train",
                  dataset_type="classification",
                  extra={"task": "emotion", "label_column": "label"}),
    DatasetConfig("voxceleb-gender", "ProgramComputer/voxceleb", None, "test",
                  dataset_type="classification",
                  extra={"task": "gender", "label_column": "gender"}),
    DatasetConfig("commonvoice-gender", "mozilla-foundation/common_voice_17_0",
                  "en", "test", dataset_type="classification",
                  extra={"task": "gender", "label_column": "gender"}),
    DatasetConfig("commonvoice-age", "mozilla-foundation/common_voice_17_0",
                  "en", "test", dataset_type="classification",
                  extra={"task": "age", "label_column": "age"}),
    DatasetConfig("commonvoice-accent", "mozilla-foundation/common_voice_17_0",
                  "en", "test", dataset_type="classification",
                  extra={"task": "accent", "label_column": "accents"}),
    DatasetConfig("sift-rate", "mazesmazes/sift-audio", None, "train",
                  dataset_type="classification",
                  extra={"task": "rate", "label_column": "speaking_rate"}),
    DatasetConfig("expresso-style", "ylacombe/expresso", None, "train",
                  dataset_type="classification",
                  extra={"task": "style", "label_column": "style"}),
]

DATASET_REGISTRY: dict[str, DatasetConfig] = {
    d.name: d for d in (_ASR + _DIARIZATION + _ALIGNMENT + _MCQ + _CLASSIFICATION)
}

# "all" expansion groups
ALL_GROUPS = {
    "all": ["loquacious-small", "librispeech", "ami", "tedlium"],
    # dedup by source: 'loquacious' and 'loquacious-small' alias the same
    # (path, config, split) — listing both evaluated that corpus twice and
    # double-weighted it in aggregates
    "all-full": [
        d.name
        for i, d in enumerate(_ASR)
        if d.path != "synthetic"
        and all(
            (d.path, d.config, d.split) != (p.path, p.config, p.split)
            for p in _ASR[:i]
        )
    ],
}


def _synthetic_conversation_rows(n: int, seed: int) -> list[dict]:
    """Formant-synthesized multi-speaker conversations with EXACT reference
    segments, cycling a condition grid: clean 2/3-speaker turn-taking,
    white-noise SNR 15 dB, reverberant far-field, and overlapped turns —
    plus a hard tier (the easy grid alone saturates near 0% DER, below the
    level where regressions are visible): close-voice pairs with
    small f0/vocal-tract deltas, 40% overlap, sub-second turns, 6 speakers,
    and far-field + 8 dB noise, targeting a 5–20% DER operating range —
    the offline DER benchmark."""
    import numpy as np

    from tiny_audio_tpu_torch.utils.speech_synth import synth_conversation

    conditions = [
        {"label": "clean-2spk", "n_speakers": 2},
        {"label": "clean-3spk", "n_speakers": 3},
        {"label": "noisy-2spk", "n_speakers": 2, "snr_db": 15.0},
        {"label": "reverb-2spk", "n_speakers": 2, "reverb": True},
        {"label": "overlap-2spk", "n_speakers": 2, "overlap_prob": 0.35},
        # ---- hard tier
        {"label": "hard-close-2spk", "n_speakers": 2,
         "voices": [(118.0, 1.0), (126.0, 1.03)]},
        {"label": "hard-overlap40-2spk", "n_speakers": 2,
         "overlap_prob": 0.8, "overlap_s": (0.5, 1.5)},
        {"label": "hard-short-turns-3spk", "n_speakers": 3,
         "turn_s": (0.4, 1.0), "gap_s": (0.1, 0.3)},
        {"label": "hard-6spk", "n_speakers": 6, "duration_s": 36.0},
        {"label": "hard-farfield-3spk", "n_speakers": 3, "reverb": True,
         "rt60": 0.9, "snr_db": 8.0},
    ]
    rows = []
    for i in range(n):
        cond = conditions[i % len(conditions)]
        rng = np.random.default_rng(seed * 1000 + i)
        audio, segments, _ = synth_conversation(
            duration_s=cond.get("duration_s", 24.0),
            n_speakers=cond["n_speakers"],
            seed=seed * 1000 + i,
            overlap_prob=cond.get("overlap_prob", 0.0),
            overlap_s=cond.get("overlap_s", (0.2, 0.8)),
            turn_s=cond.get("turn_s", (1.5, 4.0)),
            gap_s=cond.get("gap_s", (0.3, 1.0)),
            voices=cond.get("voices"),
        )
        if cond.get("reverb"):
            rt60, drr_db = cond.get("rt60", 0.6), 0.0
            t = np.arange(int(rt60 * SAMPLE_RATE)) / SAMPLE_RATE
            tail = rng.standard_normal(len(t)).astype(np.float32) * np.exp(
                -6.9 * t / rt60
            )
            tail /= np.sqrt(np.sum(tail**2)) + 1e-9
            rir = tail * 10 ** (-drr_db / 20)
            rir[0] += 1.0
            nfft = 1 << int(np.ceil(np.log2(len(audio) + len(rir))))
            audio = np.fft.irfft(
                np.fft.rfft(audio, nfft) * np.fft.rfft(rir, nfft), nfft
            )[: len(audio)].astype(np.float32)
        if "snr_db" in cond:
            rms = float(np.sqrt(np.mean(audio**2))) + 1e-9
            noise = rng.standard_normal(len(audio)).astype(np.float32)
            audio = audio + noise * rms / (10 ** (cond["snr_db"] / 20))
        peak = float(np.max(np.abs(audio))) + 1e-9
        audio = (0.5 * audio / peak).astype(np.float32)
        rows.append({
            "audio": {"array": audio, "sampling_rate": SAMPLE_RATE},
            "condition": cond["label"],
            "speakers": [
                {"speaker": f"S{s['speaker']}", "start": s["start"],
                 "end": s["end"]}
                for s in segments
            ],
        })
    return rows


def _synthetic_eval_rows(cfg: DatasetConfig, n: int = 16, seed: int = 0):
    from tiny_audio_tpu_torch.train.data import synthetic_dataset

    if cfg.dataset_type == "diarization":
        return _synthetic_conversation_rows(n, seed)

    rows = synthetic_dataset(n, seed=seed)
    if cfg.dataset_type == "alignment":
        for r in rows:
            dur = len(r["audio"]["array"]) / SAMPLE_RATE
            words = r["text"].split()
            edges = [dur * i / len(words) for i in range(len(words) + 1)]
            r["words"] = [
                {"word": w, "start": edges[i], "end": edges[i + 1]}
                for i, w in enumerate(words)
            ]
    return rows


def load_eval_dataset(
    name_or_cfg, num_samples: Optional[int] = None, streaming: bool = True,
    seed: int = 0,
) -> Any:
    """Resolve a registry name (or DatasetConfig) to an iterable of rows."""
    cfg = (
        name_or_cfg
        if isinstance(name_or_cfg, DatasetConfig)
        else DATASET_REGISTRY[name_or_cfg]
    )
    if cfg.path == "synthetic":
        rows = _synthetic_eval_rows(cfg, n=num_samples or 16, seed=seed)
        return rows

    import datasets as hfd
    from pathlib import Path

    if Path(cfg.path).is_dir():
        ds = hfd.load_from_disk(cfg.path)
        if isinstance(ds, hfd.DatasetDict):
            ds = ds[cfg.split]
    else:
        ds = hfd.load_dataset(
            cfg.path, cfg.config, split=cfg.split, streaming=streaming
        )
    try:
        ds = ds.cast_column(cfg.audio_column, hfd.Audio(sampling_rate=SAMPLE_RATE))
    except Exception:
        pass
    if num_samples:
        ds = ds.take(num_samples) if hasattr(ds, "take") else ds.select(
            range(min(num_samples, len(ds)))
        )
    return ds


def validate_datasets(names: list[str]) -> list[str]:
    """Expand "all" groups and fail on unknown names."""
    out: list[str] = []
    for name in names:
        if name in ALL_GROUPS:
            out.extend(ALL_GROUPS[name])
        elif name in DATASET_REGISTRY:
            out.append(name)
        else:
            known = ", ".join(sorted(DATASET_REGISTRY))
            raise ValueError(f"unknown dataset {name!r}; known: {known}")
    return out
