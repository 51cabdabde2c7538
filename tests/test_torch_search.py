# coding: utf-8
"""The port's beam search against the JAX package's on the CPU.

One set of seeded weights goes from the port to the JAX model through
``torch_state_dict_to_flax`` (model as in test_torch_model.py: 2 + 2 layers,
hidden 128, head dim 64); the same encoder output goes through JAX ``beam_search`` (with its
``beam_reorder`` ``physical`` and its default ``auto``, the ancestry map)
and the port's, at float32. Hypotheses must be token-identical and scores
agree to 1e-5 relative. The eos logit is rescaled in both models to steer
when beams finish. A 6-id vocabulary (4 specials, 2 words) with unk and,
early on, eos banned leaves fewer finite candidates than beams: the rest
tie at NEG_INF, which exercises the tie rule, and n-best slots stay
unfilled."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.models import build_model
from joeys2t_torch.search import beam_search, transformer_greedy
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.config import SpecialSymbols as JaxSpecialSymbols
from joeys2t_tpu.convert import torch_state_dict_to_flax
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.search import beam_search as jax_beam_search
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
from test_torch_model import CFG, LENGTHS, TOKENS, features

EOS = 3
NEG_INF = -1e9
VOCABS = {"full": TOKENS, "tiny": ["t0", "t1"]}


def models(tokens, seed=0):
    """The port model on the CPU and the JAX model with the same seeded,
    perturbed float32 weights (``torch_state_dict_to_flax``), and the port's
    encoder output for ``features()``, which both searches take."""
    tmodel, tspec = build_model(CFG, trg_vocab=Vocabulary(tokens, SpecialSymbols()),
                                device="cpu", generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in tmodel.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        enc, _, mask = tmodel.encode(torch.tensor(features()), torch.tensor(LENGTHS))
    params = torch_state_dict_to_flax({k: v.numpy() for k, v in tmodel.state_dict().items()})
    jmodel, jspec = jax_build_model(CFG, trg_vocab=JaxVocabulary(tokens, JaxSpecialSymbols()))
    return dict(jmodel=jmodel, jspec=jspec, params=params, tmodel=tmodel, tspec=tspec,
                enc=enc.numpy(), mask=mask.numpy())


@pytest.fixture(scope="module")
def pairs():
    return {name: models(tokens) for name, tokens in VOCABS.items()}


def with_eos_scale(pair, eos_scale, fn):
    """``fn(jax params, port model)`` with the eos row of the output layer
    scaled by ``eos_scale`` in both models."""
    params = jax.tree.map(np.array, pair["params"])
    params["decoder"]["output_layer"]["kernel"][:, EOS] *= eos_scale
    w = pair["tmodel"].decoder.output_layer.weight
    saved = w.detach().clone()
    try:
        with torch.no_grad():
            w[EOS] *= eos_scale
        return fn(params, pair["tmodel"])
    finally:
        with torch.no_grad():
            w.copy_(saved)


CASES = [  # (vocabulary, beam size, n_best, alpha, eos scale, max length, options)
    ("full", 5, 1, 1.0, 1.0, 12, {}),
    ("full", 5, 2, 1.0, 1.2, 12, {}),
    ("full", 2, 2, -1.0, 1.4, 12, {"return_prob": "hyp"}),
    ("full", 5, 5, 1.0, 1.2, 12, {"return_prob": "hyp", "min_output_length": 3,
                                   "generate_unk": False}),
    ("full", 5, 5, -1.0, 3.0, 12, {"return_prob": "hyp"}),
    ("tiny", 5, 5, 1.0, 1.0, 6, {"return_prob": "hyp", "min_output_length": 3,
                                  "generate_unk": False}),
    ("tiny", 5, 2, -1.0, -2.0, 6, {"return_prob": "hyp", "generate_unk": False}),
    # two steps with two finite tokens a beam: 4 real hypotheses; the fifth
    # is a beam that the tie rule filled with banned tokens (alpha 1: its
    # score is NEG_INF over the penalty) or an unfilled slot (alpha -1)
    ("tiny", 5, 5, 1.0, 1.0, 2, {"return_prob": "hyp", "min_output_length": 3,
                                  "generate_unk": False}),
    ("tiny", 5, 5, -1.0, 1.0, 2, {"return_prob": "hyp", "min_output_length": 3,
                                   "generate_unk": False}),
]


@pytest.mark.parametrize("reorder", ["physical", "auto"])
@pytest.mark.parametrize("vocab,k,n_best,alpha,eos_scale,max_len,kwargs", CASES)
def test_beam_search_matches_jax(pairs, vocab, k, n_best, alpha, eos_scale, max_len,
                                 kwargs, reorder):
    pair = pairs[vocab]
    enc, mask = pair["enc"], pair["mask"]
    stats = {}

    def run(params, tmodel):
        ref = jax_beam_search(params, pair["jmodel"], pair["jspec"], jnp.asarray(enc),
                              None, jnp.asarray(mask), k, max_len, alpha, n_best=n_best,
                              beam_reorder=reorder, **kwargs)
        out = beam_search(tmodel, pair["tspec"], torch.tensor(enc), None,
                          torch.tensor(mask), k, max_len, alpha, n_best=n_best,
                          device="cpu", stats=stats, **kwargs)
        return ref, out

    (ids_j, scores_j, _), (ids_t, scores_t, att) = with_eos_scale(pair, eos_scale, run)
    assert att is None and ids_t.dtype == np.int64
    assert ids_t.shape[0] == len(LENGTHS) * n_best
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    if kwargs.get("return_prob") == "hyp":
        assert scores_t.shape == (len(LENGTHS) * n_best, 1)
        np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-5)
    else:
        assert scores_t is None and scores_j is None
    assert 1 <= stats["decode_steps"] <= max_len
    if eos_scale == 3.0:  # beams end early: the loop stops before the limit
        assert (ids_t[::n_best] == EOS).any(axis=1).all()
        assert stats["decode_steps"] < max_len
    if vocab == "tiny" and max_len == 2:
        fifth = (scores_t[:, 0] < NEG_INF / 10) if alpha > 0 else (scores_t[:, 0] == -1.0)
        assert fifth.reshape(-1, n_best).tolist() == [[False] * 4 + [True]] * len(LENGTHS)
        if alpha > 0:  # a beam that took a banned token, picked by the tie rule
            assert (ids_t[fifth, 1] == 0).all()
        else:  # an unfilled slot
            assert (ids_t[fifth] == [0, 1]).all()


@pytest.mark.parametrize("eos_scale", [1.0, 1.4])
def test_beam_size_one_is_greedy(pairs, eos_scale):
    pair = pairs["full"]
    enc, mask = torch.tensor(pair["enc"]), torch.tensor(pair["mask"])

    def run(_, tmodel):
        beam, _, _ = beam_search(tmodel, pair["tspec"], enc, None, mask, 1, 12, -1.0,
                                 device="cpu")
        greedy, _, _ = transformer_greedy(tmodel, pair["tspec"], enc, mask, 12,
                                          device="cpu")
        return beam, greedy

    beam, greedy = with_eos_scale(pair, eos_scale, run)
    for b_row, g_row in zip(beam, greedy):
        g = list(g_row)
        g = g[:g.index(EOS) + 1] if EOS in g else g
        assert list(b_row[:len(g)]) == g and (b_row[len(g):] == 1).all()


@pytest.mark.parametrize("option", [{"beam_reorder": "lazy"}, {"return_attention": True},
                                    {"beam_reorder": "lazy", "repetition_penalty": 1.2},
                                    {"return_attention": True, "no_repeat_ngram_size": 2}])
def test_unported_beam_options_raise(pairs, option):
    """The ancestry reorder and returned attention raise, also beside the
    repetition controls, which are ported (tests/test_torch_mt.py)."""
    pair = pairs["tiny"]
    with pytest.raises(NotImplementedError):
        beam_search(pair["tmodel"], pair["tspec"], torch.tensor(pair["enc"]), None,
                    torch.tensor(pair["mask"]), 2, 4, 1.0, device="cpu", **option)
