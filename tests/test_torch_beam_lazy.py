# coding: utf-8
"""The lazy beam reorder (``beam_reorder: lazy``, and ``auto`` for a
transformer decoder) against the JAX package's on the CPU.

The beam rows' self-attention buffers are never permuted; a (B, K, S)
ancestry map says which row holds each position of each beam's history.
Held here:

- ``MultiHeadedAttention.step_self_ancestry`` against JAX's over a few
  steps with random valid maps, float32, to 1e-5 (outputs and the written
  caches);
- the map's update after top-k against JAX's expression
  (joeys2t_tpu/search.py:547-558), exact;
- port lazy beam against JAX lazy beam, token-identical with scores to
  1e-5 relative at float32: an ASR model (2 + 2 layers, hidden 64, 4 heads
  of 16) and the MT model of test_torch_mt.py with prompts, the repetition
  penalty and n-gram blocking;
- port lazy against port physical, token-identical, in float32 and in
  bfloat16 compute with int8 caches;
- int8 caches: port lazy against JAX lazy, tokens identical, scores to
  1e-4 relative (test_torch_int8.py says why);
- ``auto`` resolving to lazy for transformer decoders and to the
  recurrent decoder's own loop, which has no cache to reorder."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch import search
from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.models import build_model
from joeys2t_torch.models.modules import NEG_INF, MultiHeadedAttention
from joeys2t_torch.search import beam_search
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.config import SpecialSymbols as JaxSpecialSymbols
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.models.initialization import initialize_model as jax_initialize
from joeys2t_tpu.models.modules import MultiHeadedAttention as JaxMHA
from joeys2t_tpu.search import beam_search as jax_beam_search
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
from test_torch_int8 import models as int8_models
from test_torch_mt import BEAM_CASES, jaxify, make_pair, search_inputs

TOKENS = [f"t{i}" for i in range(20)]  # + 4 specials = 24 ids
B, T = 3, 120
LENGTHS = np.array([120, 88, 61])
CFG = {
    "initializer": "xavier_uniform", "bias_initializer": "zeros",
    "encoder": {"type": "transformer", "num_layers": 2, "num_heads": 4,
                "embeddings": {"embedding_dim": 20}, "hidden_size": 64, "ff_size": 128,
                "dropout": 0.0, "subsample": True, "conv_kernel_sizes": [5, 5],
                "conv_channels": 64, "in_channels": 20, "layer_norm": "pre"},
    "decoder": {"type": "transformer", "num_layers": 2, "num_heads": 4,
                "embeddings": {"embedding_dim": 64, "scale": True}, "hidden_size": 64,
                "ff_size": 128, "dropout": 0.0, "layer_norm": "pre"},
}


def random_ancestry(rng, b, k, s, index):
    """A valid (B, K, S) map: entries in [0, K) up to ``index``, each row's
    own index beyond it."""
    anc = rng.randint(0, k, size=(b, k, s)).astype(np.int32)
    anc[:, :, index + 1:] = np.arange(k, dtype=np.int32)[None, :, None]
    return anc


def test_step_self_ancestry_matches_jax():
    """Five steps of one self-attention layer over (B*K, H, S, D) float32
    ring buffers with a fresh random map each step: the output and the
    slot written equal JAX's ``step_self_ancestry``."""
    rng = np.random.RandomState(0)
    b, k, heads, size, s_max = 2, 3, 4, 64, 8
    jmha = JaxMHA(num_heads=heads, size=size, dropout=0.0)
    x = rng.randn(b * k, 1, size).astype(np.float32)
    params = jax.tree.map(np.asarray, jmha.init({"params": jax.random.PRNGKey(1)},
                                                x, x, x, None)["params"])
    tmha = MultiHeadedAttention(heads, size, dropout=0.0).eval()
    tmha.load_state_dict({n[4:]: v for n, v in flax_params_to_state_dict(
        {"att": params}).items()})
    shape = (b * k, heads, s_max, size // heads)
    cache_kj = jnp.asarray(rng.randn(*shape).astype(np.float32))
    cache_vj = jnp.asarray(rng.randn(*shape).astype(np.float32))
    cache_kt, cache_vt = torch.tensor(np.array(cache_kj)), torch.tensor(np.array(cache_vj))
    for index in range(5):
        q = rng.randn(b * k, 1, size).astype(np.float32)
        anc = random_ancestry(rng, b, k, s_max, index)
        out_j, cache_kj, cache_vj, _, _ = jmha.apply(
            {"params": params}, jnp.asarray(q), cache_kj, cache_vj, index,
            jnp.asarray(anc), method="step_self_ancestry")
        bias = torch.full((b * k, s_max), NEG_INF)
        bias[:, :index + 1] = 0.0
        with torch.no_grad():
            out_t = tmha.step_self_ancestry(torch.tensor(q), cache_kt, cache_vt, index,
                                            bias, torch.tensor(anc))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {index}")
        np.testing.assert_allclose(cache_kt.numpy(), np.asarray(cache_kj), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(cache_vt.numpy(), np.asarray(cache_vj), rtol=1e-5,
                                   atol=1e-6)


def test_ancestry_update_matches_jax(monkeypatch):
    """Every step's map after top-k, as a lazy beam over the ASR model
    composes it, equals JAX's expression (``take_along_axis`` of the
    parents' rows, own rows past the step) on the same parents, step and
    previous map: exact. The first map holds each row's own index."""
    maps, parents = [], []
    real_step, real_topk = search.Seq2SeqModel.decode_step, search._stable_topk

    def step_spy(self, *args, ancestry=None, **kwargs):
        maps.append(ancestry.clone())
        return real_step(self, *args, ancestry=ancestry, **kwargs)

    def topk_spy(x, k):
        values, indices = real_topk(x, k)
        if x.shape[-1] == k * vocab:  # the beam selection, not the store merge
            parents.append(indices // vocab)
        return values, indices

    monkeypatch.setattr(search.Seq2SeqModel, "decode_step", step_spy)
    monkeypatch.setattr(search, "_stable_topk", topk_spy)
    p = asr_pair()
    vocab, k, max_len = p["tspec"].trg_vocab_size, 4, 10
    beam_search(p["tmodel"], p["tspec"], torch.tensor(p["enc"]), None,
                torch.tensor(p["mask"]), k, max_len, 1.0, device="cpu",
                beam_reorder="lazy")
    l1 = max_len + 1
    first = maps[0].numpy()
    assert first.dtype == np.int32 and first.shape == (B, k, l1)
    assert (first == np.arange(k)[None, :, None]).all()
    assert len(maps) >= 3 and len(parents) == len(maps)
    for step, (before, parent, after) in enumerate(zip(maps, parents, maps[1:])):
        s_grid = jnp.arange(l1)[None, None, :]
        ref = jnp.where(s_grid > step, jnp.arange(k, dtype=jnp.int32)[None, :, None],
                        jnp.take_along_axis(jnp.asarray(before.numpy()),
                                            jnp.asarray(parent.numpy())[:, :, None],
                                            axis=1))
        np.testing.assert_array_equal(after.numpy(), np.asarray(ref), err_msg=f"step {step}")


def jax_asr(seed=0, cfg=CFG):
    vocab = JaxVocabulary(TOKENS, JaxSpecialSymbols())
    model, spec = jax_build_model(cfg, trg_vocab=vocab)
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((B, 40, 20)),
                        jnp.zeros((B, 4), jnp.int32), jnp.full((B,), 40), None,
                        jnp.ones((B, 1, 4), bool))["params"]
    params = jax_initialize(params, cfg, 1, 1, jax.random.PRNGKey(seed + 1))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32), params)
    return model, spec, params


def asr_pair(cfg=CFG, compute_dtype=torch.float32):
    """The JAX and the port ASR model with the same perturbed float32
    weights, and the JAX encoder output of seeded features."""
    jmodel, jspec, params = jax_asr(cfg=cfg)
    tmodel, tspec = build_model(cfg, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()),
                                compute_dtype=compute_dtype, device="cpu")
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    feats = np.random.RandomState(3).randn(B, T, 20).astype(np.float32)
    enc, _, mask = jmodel.apply({"params": params}, jnp.asarray(feats),
                                jnp.asarray(LENGTHS), None, method="encode")
    return dict(jmodel=jmodel, jspec=jspec, params=params, tmodel=tmodel, tspec=tspec,
                enc=np.asarray(enc), mask=np.asarray(mask))


@pytest.fixture(scope="module")
def asr():
    return asr_pair()


ASR_CASES = [  # (beam size, n_best, alpha, max length, options)
    (5, 1, 1.0, 12, {}),
    (5, 3, 1.0, 12, {"return_prob": "hyp"}),
    (3, 3, -1.0, 10, {"return_prob": "hyp", "min_output_length": 4,
                      "generate_unk": False}),
    (2, 2, 1.0, 16, {"return_prob": "hyp"}),
]


@pytest.mark.parametrize("k,n_best,alpha,max_len,options", ASR_CASES)
def test_lazy_beam_matches_jax_asr(asr, k, n_best, alpha, max_len, options):
    ids_j, scores_j, _ = jax_beam_search(
        asr["params"], asr["jmodel"], asr["jspec"], jnp.asarray(asr["enc"]), None,
        jnp.asarray(asr["mask"]), k, max_len, alpha, n_best=n_best, beam_reorder="lazy",
        **options)
    ids_t, scores_t, _ = beam_search(
        asr["tmodel"], asr["tspec"], torch.tensor(asr["enc"]), None,
        torch.tensor(asr["mask"]), k, max_len, alpha, n_best=n_best, device="cpu",
        beam_reorder="lazy", **options)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    if options.get("return_prob") == "hyp":
        np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-5)


@pytest.fixture(scope="module")
def mt():
    return make_pair("untied")


@pytest.mark.parametrize("k,n_best,alpha,max_len,options,prompt_rows",
                         [case for case in BEAM_CASES if case[0] > 1])
def test_lazy_beam_matches_jax_mt(mt, k, n_best, alpha, max_len, options, prompt_rows):
    """The MT model with forced prompts, the repetition penalty and n-gram
    blocking over the history and the source."""
    enc, mask, options = search_inputs(mt, options, prompt_rows)
    ids_j, scores_j, _ = jax_beam_search(mt.params, mt.jmodel, mt.jspec, jnp.asarray(enc),
                                         None, jnp.asarray(mask), k, max_len, alpha,
                                         n_best=n_best, beam_reorder="lazy",
                                         **jaxify(options))
    ids_t, scores_t, _ = beam_search(mt.tmodel, mt.tspec, torch.tensor(enc), None,
                                     torch.tensor(mask), k, max_len, alpha, n_best=n_best,
                                     device="cpu", beam_reorder="lazy", **options)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    if options.get("return_prob") == "hyp":
        np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-5)


def int8_cfg():
    cfg = copy.deepcopy(CFG)
    cfg["cache_cross_int8"] = cfg["cache_self_int8"] = True
    return cfg


@pytest.mark.parametrize("compute", ["float32", "bfloat16 int8"])
def test_lazy_equals_physical(compute):
    """The same model, encoder output and options through both reorders:
    identical tokens and scores (the lazy plain version gathers the rows
    the physical reorder would have moved)."""
    p = (asr_pair() if compute == "float32"
         else asr_pair(int8_cfg(), compute_dtype=torch.bfloat16))
    enc = torch.tensor(p["enc"]).to(p["tmodel"].decoder.dtype)
    out = {}
    for reorder in ("physical", "lazy"):
        out[reorder] = beam_search(p["tmodel"], p["tspec"], enc, None,
                                   torch.tensor(p["mask"]), 5, 14, 1.0, n_best=5,
                                   device="cpu", beam_reorder=reorder, return_prob="hyp")
    np.testing.assert_array_equal(out["lazy"][0], out["physical"][0])
    np.testing.assert_array_equal(out["lazy"][1], out["physical"][1])


@pytest.mark.parametrize("n_best,alpha,eos_scale", [(1, 1.0, 1.0), (5, 1.0, 1.2),
                                                    (2, -1.0, 3.0)])
def test_int8_lazy_beam_matches_jax(n_best, alpha, eos_scale):
    """int8 self and cross caches: both lazy; the per-position scales are
    read through the map with their rows."""
    p = int8_models({"cache_cross_int8": True, "cache_self_int8": True})
    params = jax.tree.map(np.array, p["params"])
    params["decoder"]["output_layer"]["kernel"][:, 3] *= eos_scale
    with torch.no_grad():
        p["tmodel"].decoder.output_layer.weight[3] *= eos_scale
    ids_j, scores_j, _ = jax_beam_search(
        params, p["jmodel"], p["jspec"], jnp.asarray(p["enc"]), None,
        jnp.asarray(p["mask"]), 5, 12, alpha, n_best=n_best, beam_reorder="lazy",
        return_prob="hyp")
    ids_t, scores_t, _ = beam_search(p["tmodel"], p["tspec"], torch.tensor(p["enc"]), None,
                                     torch.tensor(p["mask"]), 5, 12, alpha, n_best=n_best,
                                     device="cpu", beam_reorder="lazy", return_prob="hyp")
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-4)


def test_auto_is_lazy_for_transformers(asr, monkeypatch):
    calls = []
    real = search._transformer_beam

    def spy(*args, lazy_reorder=False, **kwargs):
        calls.append(lazy_reorder)
        return real(*args, lazy_reorder=lazy_reorder, **kwargs)

    monkeypatch.setattr(search, "_transformer_beam", spy)
    for reorder in (None, "auto", "lazy", "physical"):
        options = {} if reorder is None else {"beam_reorder": reorder}
        beam_search(asr["tmodel"], asr["tspec"], torch.tensor(asr["enc"]), None,
                    torch.tensor(asr["mask"]), 3, 4, 1.0, device="cpu", **options)
    assert calls == [True, True, True, False]
    with pytest.raises(ValueError, match="beam_reorder"):
        beam_search(asr["tmodel"], asr["tspec"], torch.tensor(asr["enc"]), None,
                    torch.tensor(asr["mask"]), 3, 4, 1.0, device="cpu",
                    beam_reorder="sideways")


def test_auto_keeps_the_recurrent_loop(monkeypatch):
    """A recurrent decoder keeps no cache: every ``beam_reorder`` takes its
    own loop, with the same hypotheses, as JAX takes its recurrent search
    whatever the mode (joeys2t_tpu/search.py:715-719)."""
    from test_torch_rnn import make_pair as rnn_pair
    from test_torch_rnn import search_inputs as rnn_inputs

    calls = []
    monkeypatch.setattr(search, "_transformer_beam", lambda *a, **kw: calls.append(kw))
    p = rnn_pair("rnn_reverse")
    enc, hidden, mask, _ = rnn_inputs(p)
    outs = [beam_search(p.tmodel, p.tspec, enc, hidden, mask, 3, 12, 1.0, n_best=2,
                        device="cpu", beam_reorder=reorder, return_prob="hyp")
            for reorder in ("auto", "lazy", "physical")]
    assert not calls
    for out in outs[1:]:
        np.testing.assert_array_equal(out[0], outs[0][0])
        np.testing.assert_array_equal(out[1], outs[0][1])
