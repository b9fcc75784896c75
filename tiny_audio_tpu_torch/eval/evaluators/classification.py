"""Audio classification evaluator: keyword spotting with synonym canon.

Port of :mod:`tiny_audio_tpu.eval.evaluators.classification`: the model
answers a task instruction in free text; predicted classes are extracted by
keyword spotting with per-task synonym canonicalization; a sample is correct
iff the reference class is in the predicted class set.
"""

from __future__ import annotations

import re
import time
from typing import Iterable, Optional

import numpy as np

# task -> {canonical: [synonyms...]}
TASK_CLASSES: dict[str, dict[str, list[str]]] = {
    "emotion": {
        "angry": ["anger", "mad", "furious", "annoyed", "irritated"],
        "happy": ["happiness", "joy", "joyful", "excited", "cheerful"],
        "sad": ["sadness", "unhappy", "sorrow", "melancholy", "down"],
        "neutral": ["calm", "normal", "flat", "plain"],
        "fear": ["afraid", "scared", "fearful", "anxious"],
        "disgust": ["disgusted", "revulsion"],
        "surprise": ["surprised", "astonished", "amazed"],
        "frustrated": ["frustration"],
    },
    "gender": {
        "male": ["man", "masculine", "boy", "he"],
        "female": ["woman", "feminine", "girl", "she"],
    },
    "age": {
        "teens": ["teenager", "teen", "adolescent"],
        "twenties": ["20s", "young adult"],
        "thirties": ["30s"],
        "forties": ["40s", "middle-aged", "middle aged"],
        "fifties": ["50s"],
        "sixties": ["60s", "senior"],
        "seventies": ["70s", "elderly"],
        "eighties": ["80s"],
    },
    "accent": {
        "american": ["united states", "us accent", "usa"],
        "british": ["england", "uk accent", "english accent"],
        "australian": ["australia"],
        "indian": ["india"],
        "scottish": ["scotland"],
        "irish": ["ireland"],
        "canadian": ["canada"],
    },
    "rate": {
        "slow": ["slowly", "slow pace", "leisurely"],
        "measured": ["moderate", "normal pace", "average pace", "steady"],
        "brisk": ["fast", "quick", "rapid", "fast pace", "quickly", "hurried"],
    },
    "style": {
        "default": ["neutral", "normal"],
        "happy": ["cheerful", "joyful"],
        "sad": ["sorrowful"],
        "whisper": ["whispering", "whispered"],
        "laughing": ["laughter", "laugh"],
        "confused": ["confusion", "puzzled"],
        "enunciated": ["clear", "articulate"],
    },
}

TASK_INSTRUCTIONS = {
    "emotion": "What emotion does the speaker express? Answer with one word.",
    "gender": "Is the speaker male or female? Answer with one word.",
    "age": "What is the approximate age group of the speaker?",
    "accent": "What accent does the speaker have? Answer with one word.",
    "rate": "Is the speaking pace slow, measured, or brisk?",
    "style": "What speaking style is used? Answer with one word.",
}


def _contains_word(text: str, needle: str) -> bool:
    """Whole-word/phrase containment — raw substring matching scored 'male'
    inside 'female' and 'he' inside 'the' as hits, silently inflating
    accuracy."""
    return re.search(rf"\b{re.escape(needle)}\b", text) is not None


def canonicalize(label: str, task: str) -> Optional[str]:
    """Map a dataset label to its canonical class.

    Labels are matched by word-boundary CONTAINMENT, not equality: Common
    Voice stores 'United States English' / 'male_masculine', which never
    equal any canonical name — exact matching pinned those tasks' accuracy
    at 0.  Separators normalize to spaces first so '_'-joined labels match.
    """
    lab = re.sub(r"[_\-/]+", " ", (label or "").strip().lower())
    classes = TASK_CLASSES.get(task, {})
    for canon, syns in classes.items():
        if lab == canon or lab in syns:
            return canon
    for canon, syns in classes.items():
        for needle in [canon] + syns:
            if _contains_word(lab, needle):
                return canon
    return lab or None


def extract_classes(prediction: str, task: str) -> set[str]:
    """All canonical classes whose name or any synonym appears in the text
    (whole-word matches only)."""
    text = (prediction or "").lower()
    found = set()
    for canon, syns in TASK_CLASSES.get(task, {}).items():
        for needle in [canon] + syns:
            if _contains_word(text, needle):
                found.add(canon)
                break
    return found


class ClassificationEvaluator:
    def __init__(self, transcribe_fn, task: str, model_name: str = "local"):
        """``transcribe_fn(audio_dict, prompt) -> str``."""
        self.transcribe_fn = transcribe_fn
        self.task = task
        self.model_name = model_name

    def evaluate(
        self, dataset: Iterable[dict], num_samples: Optional[int] = None,
        label_column: str = "label", instruction_column: str = "instruction",
        verbose: bool = True,
    ) -> tuple[list[dict], dict]:
        results = []
        for i, sample in enumerate(dataset):
            if num_samples and i >= num_samples:
                break
            reference = canonicalize(str(sample.get(label_column, "")), self.task)
            if reference is None:
                continue
            prompt = sample.get(instruction_column) or TASK_INSTRUCTIONS.get(
                self.task, f"Identify the {self.task} of the speaker."
            )
            t0 = time.time()
            try:
                prediction = self.transcribe_fn(sample["audio"], prompt)
                error = None
            except Exception as e:
                prediction, error = "", str(e)
            predicted = extract_classes(prediction, self.task)
            row = {
                "reference": reference,
                "prediction": prediction,
                "predicted_classes": sorted(predicted),
                "correct": reference in predicted,
                "time_s": time.time() - t0,
            }
            if error:
                row["error"] = error
            results.append(row)
            if verbose and (i + 1) % 50 == 0:
                print(f"[eval] {i + 1} samples", flush=True)
        return results, self.compute_metrics(results)

    @staticmethod
    def compute_metrics(results: list[dict]) -> dict:
        if not results:
            return {"accuracy": 0.0, "num_samples": 0}
        return {
            "accuracy": 100.0 * float(np.mean([r["correct"] for r in results])),
            "num_samples": len(results),
            "no_prediction": sum(1 for r in results if not r["predicted_classes"]),
            "errors": sum(1 for r in results if "error" in r),
        }
