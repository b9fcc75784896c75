"""The port's WER scoring vs the JAX package's, on the CPU.

``eval/wer.py`` (alignment counts, corpus WER), ``eval/spelling.py`` (the
British->American map), ``eval/normalizer.py`` and the port's copy of
Whisper's English normalizer (``eval/english_normalizer.py``, so the card
needs no ``transformers``): equal counts and equal strings on seeded inputs.
"""

import numpy as np
import pytest

from tiny_audio_tpu.eval import normalizer as jax_normalizer
from tiny_audio_tpu.eval import spelling as jax_spelling
from tiny_audio_tpu.eval import wer as jax_wer
from tiny_audio_tpu_torch.eval import english_normalizer, normalizer, spelling, wer

CORPUS = [
    "Hello, World!  It's twenty-five past 3 -- okay?",
    "The colour of the theatre's centre was grey; she apologised.",
    "I paid $1,234.56 for 2 1/2 kilograms (roughly) of aluminium.",
    "Mr. Smith, Dr. Jones & Mrs. O'Brien travelled 100 km in 1999.",
    "One hundred and twenty three thousand four hundred and five.",
    "We'll analyse the programme's behaviour, all right? It's kinda odd.",
    "uh, um, hmm... the first, second and 21st of May",
    "Ça va? Naïve café-goers drank 3.5% beer at 10:30pm.",
    "   ",
    "",
    "[inaudible] (laughs) <noise> the fox jumps over the lazy dog",
    "He won't've done it; they'd've been realising it's 1st-rate.",
]


def _words(rng, n):
    vocab = ["a", "b", "c", "d", "e", "f"]
    return [vocab[i] for i in rng.integers(0, len(vocab), n)]


@pytest.mark.parametrize("seed", range(6))
def test_align_counts_and_corpus_wer_match_jax(seed):
    rng = np.random.default_rng(seed)
    refs, hyps = [], []
    for _ in range(20):
        ref, hyp = _words(rng, int(rng.integers(0, 9))), _words(rng, int(rng.integers(0, 9)))
        got, want = wer.align_counts(ref, hyp), jax_wer.align_counts(ref, hyp)
        assert (got.substitutions, got.deletions, got.insertions, got.hits) == \
            (want.substitutions, want.deletions, want.insertions, want.hits)
        assert got.wer == want.wer and got.errors == want.errors
        assert wer.wer(" ".join(ref), " ".join(hyp)) == jax_wer.wer(" ".join(ref), " ".join(hyp))
        refs.append(" ".join(ref))
        hyps.append(" ".join(hyp))
    assert wer.corpus_wer(refs, hyps) == jax_wer.corpus_wer(refs, hyps)
    with pytest.raises(ValueError):
        wer.corpus_wer(refs, hyps[:-1])


def test_wer_counts_sum_and_edge_cases():
    total = wer.WerCounts(1, 2, 3, 4) + wer.WerCounts(4, 3, 2, 1)
    assert (total.substitutions, total.deletions, total.insertions, total.hits) == (5, 5, 5, 5)
    assert wer.WerCounts().wer == 0.0 and wer.WerCounts(insertions=1).wer == float("inf")
    assert wer.wer("a b c", "a b c") == 0.0 and wer.wer("a b", "") == 1.0


def test_spelling_map_matches_jax():
    assert spelling._build_default_map() == jax_spelling._build_default_map()
    assert spelling.load_spelling_map() == jax_spelling.load_spelling_map()


def test_spelling_map_from_a_file(tmp_path):
    path = tmp_path / "english.json"
    path.write_text('{"colour": "color"}')
    assert spelling.load_spelling_map(str(path)) == {"colour": "color"}


def test_text_normalizer_matches_jax():
    got, want = normalizer.TextNormalizer(), jax_normalizer.TextNormalizer()
    for text in CORPUS:
        assert got(text) == want(text), text
    assert got("colour okay") == "color ok"


def test_english_normalizer_copy_matches_transformers():
    """The copy behaves as the installed transformers module does."""
    from transformers.models.whisper import english_normalizer as upstream

    spellings = spelling.load_spelling_map()
    ours = english_normalizer.EnglishTextNormalizer(spellings)
    theirs = upstream.EnglishTextNormalizer(spellings)
    numbers = (english_normalizer.EnglishNumberNormalizer(),
               upstream.EnglishNumberNormalizer())
    for text in CORPUS:
        assert ours(text) == theirs(text), text
        assert numbers[0](text) == numbers[1](text), text
    for kwargs in ({}, {"remove_diacritics": True}, {"split_letters": True}):
        basic = (english_normalizer.BasicTextNormalizer(**kwargs),
                 upstream.BasicTextNormalizer(**kwargs))
        for text in CORPUS:
            assert basic[0](text) == basic[1](text), (kwargs, text)
