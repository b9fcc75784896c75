"""Dataset loading: multi-corpus mixing, resampling caps, synthetic smoke data.

Re-designed equivalent of the reference ``DatasetLoader``
(the reference's ``scripts/train.py:100-237``): per-dataset column renaming,
16 kHz audio casting, ``target_samples`` cap/repeat resampling, the
TEDLIUM/EdAcc ``ignore_time_segment_in_scoring`` filter, concat + shuffle,
and an eval-sample cap.  HF ``datasets`` does the heavy lifting; everything
degrades gracefully offline (this environment has zero egress), and
:func:`synthetic_dataset` provides the hermetic smoke corpus (the
reference's ``librispeech_dummy`` analogue, configs/data/librispeech_dummy).

Port of :mod:`tiny_audio_tpu.train.data` (the port's own copy): the same
seed gives the same rows.  HF ``datasets`` is imported only to load a
non-synthetic corpus, and its absence raises a clear error there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

SAMPLE_RATE = 16000


@dataclass
class DatasetSpec:
    """One entry of a data-mix config (reference configs/data/*.yaml)."""

    path: str  # HF hub id, local dataset dir, or "synthetic"
    name: Optional[str] = None  # HF config name
    split: str = "train"
    audio_column: str = "audio"
    text_column: str = "text"
    task: Optional[str] = None  # None/"asr" | "sift"
    target_samples: Optional[int] = None
    num_samples: int = 128  # synthetic only

    @classmethod
    def from_dict(cls, d: dict) -> "DatasetSpec":
        known = {f.name for f in cls.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in known})


def synthetic_dataset(
    n: int = 128,
    seed: int = 0,
    min_s: float = 0.5,
    max_s: float = 3.0,
    vocab: Optional[list[str]] = None,
) -> list[dict]:
    """Hermetic smoke corpus: harmonic "speech-like" clips + word labels."""
    rng = np.random.default_rng(seed)
    vocab = vocab or [
        "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
        "hello", "world", "speech", "audio", "model", "test",
    ]
    rows = []
    for _ in range(n):
        dur = rng.uniform(min_s, max_s)
        t = np.arange(int(dur * SAMPLE_RATE)) / SAMPLE_RATE
        f0 = rng.uniform(90, 250)
        audio = sum(
            rng.uniform(0.1, 0.3) / (h + 1) * np.sin(2 * np.pi * f0 * (h + 1) * t)
            for h in range(4)
        )
        audio = (audio * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t))).astype(np.float32)
        audio += 0.005 * rng.standard_normal(len(t)).astype(np.float32)
        words = rng.choice(vocab, size=rng.integers(2, 8))
        rows.append(
            {
                "audio": {"array": audio, "sampling_rate": SAMPLE_RATE},
                "text": " ".join(words),
            }
        )
    return rows


def _is_tedlium_ignored(text: str) -> bool:
    return "ignore_time_segment_in_scoring" in (text or "")


def _resample_to_target(rows: list, target: int, seed: int) -> list:
    """Cap or repeat-pad a corpus to ``target`` samples
    (reference train.py:154-176)."""
    rng = np.random.default_rng(seed)
    n = len(rows)
    if n == 0 or target is None or n == target:
        return list(rows)
    if n > target:
        idx = rng.choice(n, size=target, replace=False)
    else:
        idx = np.concatenate([np.tile(np.arange(n), target // n),
                              rng.choice(n, size=target % n, replace=False)])
    return [rows[int(i)] for i in idx]


class LazyRows:
    """Map-style sequence over mixed corpora that decodes audio ON ACCESS.

    The round-1 loader materialized every row (decoding each Audio cell to
    float32) into a Python list before training — ~64 GB for a 100k-clip
    corpus, where the eval harness deliberately stays lazy for the same
    reason.  Items are either in-memory dicts (synthetic) or
    ``(hf_dataset, index, spec)`` references resolved per ``__getitem__``;
    filtering and target_samples resampling operate on indices + the text
    column only (HF column access does not decode audio).
    """

    #: HF metadata columns that carry the clip length without an audio
    #: decode, in preference order; the NAME decides the unit (seconds vs
    #: samples).  An ambiguous "length" column is deliberately excluded:
    #: the common group_by_length convention stores token/char counts
    #: there, and a magnitude guess misreads both long durations (150 s
    #: clips) and token counts — silently wrecking the length buckets.
    _DURATION_COLUMNS = {"duration": "s", "duration_s": "s",
                         "num_samples": "samples"}

    def __init__(self, items: list, len_cache: Optional[dict] = None):
        self._items = items
        self._len_cache: dict[int, int] = len_cache or {}
        # per-underlying-dataset no-audio column view for metadata reads
        self._meta_views: dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self._items)

    def _len_from_metadata(self, i: int) -> Optional[int]:
        """Clip length from an HF duration/num_samples column — no decode.

        Uses a cached audio-column-free view of the source dataset so the
        metadata read never touches the Audio feature decoder.
        """
        kind, payload = self._items[i]
        if kind == "row":
            return None
        ds, idx, spec = payload
        key = id(ds)
        if key not in self._meta_views:
            view = None
            cols = getattr(ds, "column_names", None) or []
            col = next((c for c in self._DURATION_COLUMNS if c in cols), None)
            if col is not None:
                try:
                    view = (ds.select_columns([col]), col)
                except Exception:
                    view = None
            self._meta_views[key] = view
        view = self._meta_views[key]
        if view is None:
            return None
        try:
            value = float(view[0][int(idx)][view[1]])
        except Exception:
            return None
        if self._DURATION_COLUMNS[view[1]] == "s":
            return int(value * SAMPLE_RATE)
        return int(value)

    def audio_len(self, i: int) -> int:
        """Sample length in samples, memoized as an int — group_by_length's
        sort probe would otherwise decode every clip a second time per
        epoch just to read its length.  Prefers an HF metadata column
        (duration/num_samples) so the first epoch avoids the decode too."""
        if i not in self._len_cache:
            n = self._len_from_metadata(i)
            if n is None:
                row = self[int(i)]
                audio = row.get("audio")
                arr = audio.get("array") if isinstance(audio, dict) else audio
                n = 0 if arr is None else int(np.asarray(arr).shape[-1])
            self._len_cache[i] = n
        return self._len_cache[i]

    def __getitem__(self, i):
        if isinstance(i, slice):
            # Carry memoized lengths through the slice (eval max_samples
            # capping must not throw away first-epoch decode work):
            # remap old indices to the slice's coordinate space.
            idxs = range(*i.indices(len(self._items)))
            remapped = {
                new: self._len_cache[old]
                for new, old in enumerate(idxs)
                if old in self._len_cache
            }
            return LazyRows(self._items[i], len_cache=remapped)
        kind, payload = self._items[i]
        if kind == "row":
            return payload
        ds, idx, spec = payload
        r = ds[int(idx)]
        text = r.get(spec.text_column)
        row = {"audio": r.get(spec.audio_column), "text": text}
        if spec.task:
            row["task"] = spec.task
            if spec.task == "sift":
                row["sift_response"] = r.get("sift_response", text)
        return row

    @property
    def has_tasks(self) -> bool:
        """Any row carries a task tag — WITHOUT decoding audio (the
        multitask-collator check in scripts/train.py must not walk rows)."""
        for kind, payload in self._items:
            if kind == "row":
                if payload.get("task"):
                    return True
            elif payload[2].task:
                return True
        return False


class DatasetLoader:
    """Load + mix the corpora described by a data config dict."""

    def __init__(self, data_cfg: dict, seed: int = 0):
        self.cfg = data_cfg or {}
        self.seed = seed

    def _load_one(self, spec: DatasetSpec) -> list:
        """Returns LazyRows ITEMS (not rows — see LazyRows)."""
        if spec.path == "synthetic":
            rows = synthetic_dataset(spec.num_samples, seed=self.seed)
            if spec.task:
                for r in rows:
                    r["task"] = spec.task
                    if spec.task == "sift":
                        r.setdefault("sift_response", r.get("text"))
            items = [("row", r) for r in rows
                     if not _is_tedlium_ignored(r.get("text"))]
        else:
            ds = self._load_hf(spec)
            try:  # text-only column read: no audio decode
                texts = ds[spec.text_column]
            except Exception:
                try:  # list-like sources (tests, adapters): per-row dicts
                    texts = [r.get(spec.text_column) for r in ds]
                except Exception:
                    texts = [None] * len(ds)
            items = [
                ("hf", (ds, i, spec)) for i, t in enumerate(texts)
                if not _is_tedlium_ignored(t)
            ]
        if spec.target_samples:
            items = _resample_to_target(items, int(spec.target_samples),
                                        self.seed)
        return items

    def _load_hf(self, spec: DatasetSpec) -> Any:
        try:
            import datasets as hfd
        except ImportError as e:
            raise RuntimeError(
                f"dataset {spec.path!r} needs the HF `datasets` package, which is not "
                "installed (use path: synthetic for smoke runs)") from e

        try:
            from pathlib import Path

            if Path(spec.path).is_dir():
                ds = hfd.load_from_disk(spec.path)
                if isinstance(ds, hfd.DatasetDict):
                    ds = ds[spec.split]
            else:
                ds = hfd.load_dataset(spec.path, spec.name, split=spec.split)
        except Exception as e:
            raise RuntimeError(
                f"could not load dataset {spec.path!r} "
                f"(offline? use path: synthetic for smoke runs): {e}"
            ) from e
        try:
            ds = ds.cast_column(spec.audio_column, hfd.Audio(sampling_rate=SAMPLE_RATE))
        except Exception:
            pass
        return ds

    def load(self) -> tuple[LazyRows, Optional[LazyRows]]:
        """Returns (train_rows, eval_rows-or-None) as lazy sequences."""
        rng = np.random.default_rng(self.seed)
        specs = [DatasetSpec.from_dict(d) for d in self.cfg.get("datasets", [])]
        if not specs:
            specs = [DatasetSpec(path="synthetic")]
        items: list = []
        for spec in specs:
            items.extend(self._load_one(spec))
        order = rng.permutation(len(items))
        train = LazyRows([items[int(i)] for i in order])

        eval_rows: Optional[LazyRows] = None
        eval_cfg = self.cfg.get("eval")
        if eval_cfg:
            spec = DatasetSpec.from_dict(eval_cfg)
            eval_rows = LazyRows(self._load_one(spec))
            cap = eval_cfg.get("max_samples")
            if cap:
                eval_rows = eval_rows[: int(cap)]
        elif self.cfg.get("eval_split_fraction"):
            frac = float(self.cfg["eval_split_fraction"])
            n_eval = max(int(len(train) * frac), 1)
            eval_rows, train = train[:n_eval], train[n_eval:]
        return train, eval_rows
