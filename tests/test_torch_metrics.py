# coding: utf-8
"""The port's corpus BLEU and chrF against the JAX package's (sacrebleu
2.x, with the options of ``sacrebleu_cfg`` its constructors take) on the
CPU, to 1e-9: a corpus of mixed case, punctuation, numbers, HTML entities,
empty hypotheses and hypotheses shorter than 4 tokens, under the 13a and
none tokenizers, lowercasing on and off, every smoothing method, and chrF
at word order 0 and 2."""
import random

import pytest

from joeys2t_torch.metrics import bleu, chrf
from joeys2t_tpu.metrics import bleu as jax_bleu
from joeys2t_tpu.metrics import chrf as jax_chrf

WORDS = ["The", "cat", "sat", "on", "the", "mat.", "Hello,", "world!", "it's", "3.5",
         "1,000", "-x", "A-b", "9-5", '"q"', "&amp;", "&quot;", "dog", "(ok)", "x", "é",
         "U.S.A.", "co-op", "naïve", "x/y", "--", "end."]


def corpus(seed=0):
    rng = random.Random(seed)

    def sent(n):
        return " ".join(rng.choice(WORDS) for _ in range(n))

    hyps = [sent(rng.randint(0, 12)) for _ in range(60)] + ["", "a", "The cat", "", "x y z "]
    refs = [sent(rng.randint(1, 12)) for _ in range(60)] + ["x y", "a", "the cat", "b",
                                                             "x y z"]
    return hyps, refs


SUBSETS = {"all": slice(None), "three": slice(0, 3), "short": slice(60, None)}


@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("cfg", [
    {}, {"lowercase": True}, {"tokenize": "none"}, {"tokenize": "13a", "lowercase": True},
    {"tokenize": "none", "lowercase": True}, {"smooth_method": "floor"},
    {"smooth_method": "add-k", "smooth_value": 2}, {"smooth_method": "none"},
    {"effective_order": True}, {"max_ngram_order": 2},
    {"word_order": 2}, {"word_order": 2, "lowercase": True},
    {"char_order": 3, "beta": 1}, {"whitespace": True}, {"eps_smoothing": True},
])
def test_bleu_and_chrf_match_sacrebleu(cfg, subset):
    hyps, refs = corpus()
    hyps, refs = hyps[SUBSETS[subset]], refs[SUBSETS[subset]]
    assert abs(bleu(hyps, refs, **cfg) - jax_bleu(hyps, refs, **cfg)) <= 1e-9
    assert abs(chrf(hyps, refs, **cfg) - jax_chrf(hyps, refs, **cfg)) <= 1e-9


def test_perfect_and_empty_corpora():
    hyps, refs = corpus(1)
    assert abs(bleu(refs, refs) - 100.0) <= 1e-9 and abs(chrf(refs, refs) - 1.0) <= 1e-9
    assert bleu([""] * 3, refs[:3]) == jax_bleu([""] * 3, refs[:3]) == 0.0
    assert chrf([""] * 3, refs[:3]) == jax_chrf([""] * 3, refs[:3]) == 0.0


@pytest.mark.parametrize("cfg", [{"tokenize": "intl"}, {"tokenize": "zh"},
                                 {"trg_lang": "zh"}])
def test_unported_options_raise(cfg):
    """The intl and zh tokenizers are ported (tests/test_torch_tooling.py holds
    them on mixed script); BLEU with them equals sacrebleu's, and chrF
    ignores an option of the other metric."""
    hyps, refs = corpus(1)
    assert bleu(hyps, refs, **cfg) == pytest.approx(jax_bleu(hyps, refs, **cfg), abs=1e-9)
    chrf(["a b"], ["a b"], **cfg)  # an option of the other metric is ignored
