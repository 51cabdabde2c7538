# coding: utf-8
"""The recurrent text translation models (GRU/LSTM encoder-decoder with
Bahdanau or Luong attention) in the port against the JAX package on the
CPU.

Weights are JAX's tree (drawn and perturbed from a seed), carried to the
port by ``flax_params_to_state_dict``. Held to JAX: the encoder for GRU and
LSTM, one and two directions, one and two layers, with padded and
zero-length rows; both attentions; the decoder for each initial state with
input feeding on and off (all to 1e-5 in float32); the models of
``configs/rnn_reverse.yaml`` and ``configs/rnn_small.yaml`` (parameter
tree, forward, float32 under ``fp16``, one update, greedy and beam tokens
with ``return_prob: hyp`` scores to 1e-5 relative); the initializer's
per-gate fans; and both configs through the command line: a JAX checkpoint
after two CPU updates converted by ``jax_checkpoint_to_port``, and a
port-trained ``rnn_small`` model, each testing to the same hypotheses
through both packages' ``test``."""
import copy
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from joeys2t_torch.config import SpecialSymbols, dump_yaml, load_config, parse_train_args
from joeys2t_torch.convert import flax_params_to_state_dict, jax_checkpoint_to_port
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.hub_interface import load_model_dir
from joeys2t_torch.losses import build_loss_function
from joeys2t_torch.models import build_model
from joeys2t_torch.models.modules import Dropout, set_dropout_generator
from joeys2t_torch.models.rnn import (BahdanauAttention, LuongAttention, RecurrentDecoder,
                                      RecurrentEncoder)
from joeys2t_torch.search import (_cast_params_to_compute_dtype, _stable_topk, beam_search,
                                  greedy)
from joeys2t_torch.training import TrainManager
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.checkpoints import save_checkpoint as jax_save_checkpoint
from joeys2t_tpu.config import SpecialSymbols as JaxSymbols
from joeys2t_tpu.convert import torch_state_dict_to_flax
from joeys2t_tpu.data.batch import Batch as JaxBatch
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.models import rnn as jax_rnn
from joeys2t_tpu.models.initialization import initialize_model as jax_initialize
from joeys2t_tpu.search import beam_search as jax_beam_search
from joeys2t_tpu.search import greedy as jax_greedy
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
from test_torch_data import REPO, few_threads  # noqa: F401
from test_torch_mt import cli, write_reverse_cut

pytestmark = pytest.mark.usefixtures("few_threads")

TOKENS = [f"t{i}" for i in range(20)]  # 24 ids
PAD, BOS, EOS = 1, 2, 3
CONFIGS = ["rnn_reverse", "rnn_small"]


def perturbed(tree, seed: int, noise: float = 0.3):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + noise * rng.randn(*x.shape).astype(
        np.float32), tree)


def port_state(tree, prefix: str):
    """The port state dict of a JAX module's parameters ``tree``, as the
    module ``prefix`` of a model holds them, without the prefix."""
    return {k[len(prefix) + 1:]: v
            for k, v in flax_params_to_state_dict({prefix: tree}).items()}


def leaves(carry):
    """The tensors of a state tuple (per layer: h, or (c, h)) in order."""
    return [np.asarray(x) for x in jax.tree.leaves(
        jax.tree.map(np.asarray, carry, is_leaf=torch.is_tensor))]


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_recurrent_encoder_matches_jax(rnn_type, bidirectional, num_layers):
    """Outputs and last states to 1e-5; zeros at padded positions and in a
    zero-length row (which torch's packing refuses and JAX's scan leaves at
    zero); the last states are the last valid position's."""
    lengths = np.array([7, 4, 0, 1])
    x = np.random.RandomState(1).randn(4, 7, 5).astype(np.float32)
    jenc = jax_rnn.RecurrentEncoder(rnn_type=rnn_type, hidden_size=6, emb_size=5,
                                    num_layers=num_layers, bidirectional=bidirectional)
    params = perturbed(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(lengths))["params"], 2)
    out_j, hid_j, _ = jenc.apply({"params": params}, jnp.asarray(x), jnp.asarray(lengths))
    enc = RecurrentEncoder(rnn_type, 6, 5, num_layers, bidirectional=bidirectional)
    enc.load_state_dict(port_state(params, "encoder"), strict=True)
    with torch.no_grad():
        out, hid, mask = enc(torch.tensor(x), torch.tensor(lengths))
    out, hid = out.numpy(), hid.numpy()
    np.testing.assert_allclose(out, np.asarray(out_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(hid, np.asarray(hid_j), rtol=0, atol=1e-5)
    valid = np.arange(7)[None] < lengths[:, None]
    np.testing.assert_array_equal(mask.numpy()[:, 0], valid)
    assert not out[~valid].any() and not hid[2].any() and out.shape == (4, 7, enc.output_size)
    for row in (0, 1, 3):
        np.testing.assert_array_equal(hid[row, :6], out[row, lengths[row] - 1, :6])
        if bidirectional:
            np.testing.assert_array_equal(hid[row, 6:], out[row, 0, 6:])


def attention_inputs():
    rng = np.random.RandomState(3)
    mask = np.ones((3, 1, 5), bool)
    mask[1, 0, 3:] = False
    mask[2, 0, 1:] = False
    return [rng.randn(3, 1, 6).astype(np.float32), rng.randn(3, 5, 8).astype(np.float32),
            mask]


@pytest.mark.parametrize("kind", ["bahdanau", "luong"])
def test_attention_matches_jax(kind):
    """Context vectors and weights of one query over masked keys to 1e-5."""
    q, keys, mask = attention_inputs()
    jatt = (jax_rnn.BahdanauAttention if kind == "bahdanau" else
            jax_rnn.LuongAttention)(hidden_size=6)

    def run(m, q, k, mask):
        return m(q, m.project_keys(k), k, mask)

    params = perturbed(jatt.init(jax.random.PRNGKey(0), q, keys, mask,
                                 method=run)["params"], 4)
    ctx_j, alphas_j = jatt.apply({"params": params}, q, keys, mask, method=run)
    att = BahdanauAttention(6, 8, 6) if kind == "bahdanau" else LuongAttention(6, 8)
    att.load_state_dict(port_state(params, "attention"), strict=True)
    with torch.no_grad():
        k = torch.tensor(keys)
        ctx, alphas = att(torch.tensor(q), att.project_keys(k), k, torch.tensor(mask))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(alphas_j), rtol=0, atol=1e-6)
    assert not alphas.numpy()[~mask].any()


@pytest.mark.parametrize("rnn_type,init_hidden,input_feeding,attention,num_layers", [
    ("gru", "bridge", True, "bahdanau", 1), ("lstm", "bridge", False, "luong", 2),
    ("gru", "last", True, "luong", 2), ("lstm", "last", False, "bahdanau", 1),
    ("lstm", "zero", True, "luong", 1), ("gru", "zero", False, "bahdanau", 2)])
def test_recurrent_decoder_matches_jax(rnn_type, init_hidden, input_feeding, attention,
                                       num_layers):
    """The teacher-forced unroll: logits, attentional vectors and the last
    state to 1e-5, from each initial state."""
    _, enc_out, mask = attention_inputs()
    rng = np.random.RandomState(6)
    enc_out = enc_out * mask[:, 0, :, None]
    enc_hidden = rng.randn(3, 8).astype(np.float32)
    trg_embed = rng.randn(3, 4, 5).astype(np.float32)
    jdec = jax_rnn.RecurrentDecoder(
        rnn_type=rnn_type, emb_size=5, hidden_size=6, encoder_output_size=8,
        attention=attention, num_layers=num_layers, vocab_size=11,
        init_hidden_option=init_hidden, input_feeding=input_feeding)
    args = tuple(map(jnp.asarray, (trg_embed, enc_out, enc_hidden, mask)))
    params = perturbed(jdec.init(jax.random.PRNGKey(0), *args, 4)["params"], 5)
    out_j, carry_j, _, vectors_j, _ = jdec.apply({"params": params}, *args, 4)
    dec = RecurrentDecoder(rnn_type, 5, 6, 8, attention, num_layers, 11,
                           init_hidden=init_hidden, input_feeding=input_feeding,
                           encoder_hidden_size=8)
    dec.load_state_dict(port_state(params, "decoder"), strict=True)
    with torch.no_grad():
        out, carry, vectors = dec(*map(torch.tensor, (trg_embed, enc_out, enc_hidden, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(vectors.numpy(), np.asarray(vectors_j), rtol=0, atol=1e-5)
    got, want = leaves(carry), leaves(carry_j)
    assert len(got) == len(want) == num_layers * (2 if rnn_type == "lstm" else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# ------------------------------------------------------------------- models
def rnn_cfg(name: str, dropout: float = 0.0):
    """The model section of a config, its dropouts set to ``dropout``."""
    cfg = load_config(REPO / "configs" / f"{name}.yaml")["model"]
    for side in ("encoder", "decoder"):
        cfg[side]["dropout"] = dropout
    cfg["decoder"]["hidden_dropout"] = dropout
    return cfg


def vocabs(tokens=TOKENS):
    return Vocabulary(tokens, SpecialSymbols()), JaxVocabulary(tokens, JaxSymbols())


def make_pair(name: str, seed: int = 0, compute_dtype=torch.float32):
    """(port model, port spec, JAX model, JAX spec, JAX params) with the
    same weights: the port's initialization, perturbed, with an eos column
    of the output layer made larger so that hypotheses end at various
    lengths."""
    cfg = rnn_cfg(name)
    tv, jv = vocabs()
    tmodel, tspec = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu",
                                compute_dtype=compute_dtype)
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    params = perturbed(torch_state_dict_to_flax(
        {k: v.numpy() for k, v in tmodel.state_dict().items()}), seed, noise=0.1)
    params["decoder"]["output_layer"]["kernel"][:, EOS] *= 4.0
    tmodel.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return SimpleNamespace(tmodel=tmodel, tspec=tspec, jmodel=jmodel, jspec=jspec,
                           params=params, cfg=cfg)


@pytest.fixture(scope="module")
def pairs():
    # seeds under which greedy stops early (rnn_reverse) or runs to the
    # limit with rows ending at several lengths (rnn_small)
    return {name: make_pair(name, seed) for name, seed in zip(CONFIGS, (0, 1))}


def source(seed: int = 5, b: int = 4, s: int = 8):
    """Token ids with eos, padded rows and a zero-length row."""
    rng = np.random.RandomState(seed)
    lengths = np.array([s, 5, 2, 0, s - 1, 3][:b])
    src = rng.randint(4, 24, size=(b, s))
    for row, n in enumerate(lengths):
        src[row, n:] = PAD
        if n:
            src[row, n - 1] = EOS
    return src, lengths, (src != PAD)[:, None, :]


def jax_shapes(jmodel):
    return jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                          jnp.ones((2, 5), jnp.int32), jnp.ones((2, 4), jnp.int32),
                          jnp.full((2,), 5), jnp.ones((2, 1, 5), bool),
                          jnp.ones((2, 1, 4), bool))["params"]


@pytest.mark.parametrize("name", CONFIGS)
def test_build_model_matches_the_jax_tree(name):
    """Both configs build as configured (GRU/LSTM, attention, initial
    state) with JAX's tree: ``torch_state_dict_to_flax`` of the port's
    state dict has JAX's paths and shapes, and ``flax_params_to_state_dict``
    gives the state dict back exactly."""
    cfg = load_config(REPO / "configs" / f"{name}.yaml")["model"]
    tv, jv = vocabs()
    tmodel, tspec = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    state = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    tree = torch_state_dict_to_flax(state)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape,
                                                        jax_shapes(jmodel))
    back = flax_params_to_state_dict(tree)
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        np.testing.assert_array_equal(back[key].numpy(), value)
    enc, dec = cfg["encoder"], cfg["decoder"]
    rnn = {"gru": nn.GRU, "lstm": nn.LSTM}
    assert type(tmodel.encoder.rnn) is rnn[enc["rnn_type"]]
    assert type(tmodel.decoder.rnn) is rnn[dec["rnn_type"]]
    assert tmodel.encoder.output_size == 2 * enc["hidden_size"]
    assert type(tmodel.decoder.attention).__name__.lower().startswith(dec["attention"])
    assert (tmodel.decoder.bridge_layer is not None) == (dec["init_hidden"] == "bridge")
    assert tspec == type(tspec)(**{k: getattr(jspec, k) for k in (
        "task", "pad_index", "bos_index", "eos_index", "unk_index", "sep_index",
        "specials", "lang_tags", "src_vocab_size", "trg_vocab_size")})


def forward_inputs():
    src, src_len, src_mask = source()
    rng = np.random.RandomState(9)
    trg = np.concatenate([np.full((4, 1), BOS), rng.randint(4, 24, size=(4, 5))], axis=1)
    trg_mask = np.ones((4, 1, 6), bool)
    trg_mask[2, 0, 3:] = False
    return src, trg, src_len, src_mask, trg_mask


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_logits_match_jax(pairs, name):
    """The teacher-forced pass (source prompt ignored, no CTC) to 1e-5 of
    the largest logit."""
    p = pairs[name]
    inputs = forward_inputs()
    ref = np.asarray(p.jmodel.apply({"params": p.params}, *map(jnp.asarray, inputs))[0])
    with torch.no_grad():
        got, ctc, mask = p.tmodel(*map(torch.tensor, inputs),
                                  src_prompt_mask=torch.ones(inputs[0].shape,
                                                             dtype=torch.long))
    assert ctc is None and got.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), inputs[3])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_recurrent_models_compute_in_float32_under_fp16():
    """With a bfloat16 compute dtype (``fp16: True``, as rnn_reverse.yaml
    sets it) JAX's recurrent model still computes in float32: its logits
    are float32 and equal those of the float32 model. The port builds it
    the same: float32 modules and embeddings, logits equal to JAX's, and a
    search model that is the model itself (nothing to cast)."""
    p = make_pair("rnn_reverse", compute_dtype=torch.bfloat16)
    tv, jv = vocabs()
    jmodel16, _ = jax_build_model(p.cfg, src_vocab=jv, trg_vocab=jv,
                                  compute_dtype=jnp.bfloat16)
    inputs = tuple(map(jnp.asarray, forward_inputs()))
    ref16 = jmodel16.apply({"params": p.params}, *inputs)[0]
    ref32 = np.asarray(p.jmodel.apply({"params": p.params}, *inputs)[0])
    assert ref16.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(ref16), ref32)
    m = p.tmodel
    assert m.encoder.dtype == m.decoder.dtype == torch.float32
    assert m.src_embed.dtype == m.trg_embed.dtype == torch.float32
    assert _cast_params_to_compute_dtype(m) is m
    with torch.no_grad():
        got = m(*map(torch.tensor, forward_inputs()))[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref32, rtol=0, atol=1e-5 * np.abs(ref32).max())


# ------------------------------------------------------------------- search
def search_inputs(p, seed=5, b=4):
    src, src_len, src_mask = source(seed, b)
    with torch.no_grad():
        enc, hidden, mask = p.tmodel.encode(torch.tensor(src), torch.tensor(src_len),
                                            torch.tensor(src_mask))
    return enc, hidden, mask, src


GREEDY_OPTIONS = [
    {}, {"return_prob": "hyp"},
    # options JAX's recurrent greedy does not read (the port ignores them too)
    {"min_output_length": 4, "generate_unk": False, "return_prob": "hyp",
     "repetition_penalty": 2.0, "no_repeat_ngram_size": 2, "encoder_input": True}]


@pytest.mark.parametrize("options", GREEDY_OPTIONS)
@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_matches_jax(pairs, name, options):
    """Token-identical, as many steps as JAX runs (rnn_reverse's rows all
    reach eos before the limit; finished rows go on emitting, as in JAX),
    float64 scores to 1e-5 relative."""
    p = pairs[name]
    enc, hidden, mask, src = search_inputs(p)
    options = dict(options)
    if options.pop("encoder_input", False):
        options["encoder_input"] = src
    ids_j, scores_j, _ = jax_greedy(p.params, p.jmodel, p.jspec, jnp.asarray(enc.numpy()),
                                    jnp.asarray(hidden.numpy()), jnp.asarray(mask.numpy()),
                                    30, **options)
    stats = {}
    ids_t, scores_t, att = greedy(p.tmodel, p.tspec, enc, hidden, mask, 30, device="cpu",
                                  stats=stats, **options)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    assert att is None and stats["decode_steps"] == ids_t.shape[1]
    assert (ids_t.shape[1] < 30) == (name == "rnn_reverse")
    first_eos = (ids_t == EOS).argmax(1)
    assert len(set(first_eos)) > 1, "the hypotheses should end at several lengths"
    if options.get("return_prob") == "hyp":
        assert scores_t.dtype == np.float64
        np.testing.assert_allclose(scores_t, scores_j, rtol=1e-5)
    else:
        assert scores_t is None


BEAM_CASES = [  # (beam size, n_best, alpha, options)
    (5, 1, 1.0, {}),
    (5, 2, 1.0, {"return_prob": "hyp"}),
    (3, 3, -1.0, {"return_prob": "hyp"}),
    (5, 5, 0.0, {"min_output_length": 3, "generate_unk": False, "return_prob": "hyp"}),
]


@pytest.mark.parametrize("k,n_best,alpha,options", BEAM_CASES)
@pytest.mark.parametrize("name", CONFIGS)
def test_beam_matches_jax(pairs, name, k, n_best, alpha, options):
    """Token-identical n-best lists (the length penalty on the ranked and
    the kept scores, finished beams at -inf, hypotheses collected as they
    end), scores to 1e-5 relative."""
    p = pairs[name]
    enc, hidden, mask, _ = search_inputs(p)
    ids_j, scores_j, _ = jax_beam_search(
        p.params, p.jmodel, p.jspec, jnp.asarray(enc.numpy()), jnp.asarray(hidden.numpy()),
        jnp.asarray(mask.numpy()), k, 20, alpha, n_best=n_best, **options)
    ids_t, scores_t, _ = beam_search(p.tmodel, p.tspec, enc, hidden, mask, k, 20, alpha,
                                     n_best=n_best, device="cpu", **options)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    assert ids_t.shape[0] == 4 * n_best and (ids_t == EOS).any()
    if options.get("return_prob") == "hyp":
        np.testing.assert_allclose(scores_t, scores_j, rtol=1e-5)


def test_beam_ties_among_minus_infinity():
    """With fewer finite candidates than beams (5 beams; 3 tokens that may
    be generated besides eos, none at the first step), the loop selects
    -inf candidates. The port takes tied candidates in index order
    (``_stable_topk``); numpy's ``argsort`` in JAX's loop orders ties its
    own way, which can only move hypotheses scored -inf, so the n-best
    lists with finite scores are identical."""
    values, indices = _stable_topk(torch.tensor([[0.5, -np.inf, -np.inf, 1.0, -np.inf]]), 4)
    assert indices.tolist() == [[3, 0, 1, 2]] and values[0, 2:].isinf().all()
    cfg = rnn_cfg("rnn_small")
    tv, jv = vocabs(["a", "b", "c"])
    tmodel, tspec = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    params = perturbed(torch_state_dict_to_flax(
        {k: v.numpy() for k, v in tmodel.state_dict().items()}), 3, noise=1.0)
    tmodel.load_state_dict(flax_params_to_state_dict(params), strict=True)
    src = np.array([[4, 5, 6, EOS], [6, 5, EOS, PAD]])
    src_len = np.array([4, 3])
    with torch.no_grad():
        enc, hidden, mask = tmodel.encode(torch.tensor(src), torch.tensor(src_len),
                                          torch.tensor((src != PAD)[:, None, :]))
    for n_best in (1, 3):
        ids_j, scores_j, _ = jax_beam_search(
            params, jmodel, jspec, jnp.asarray(enc.numpy()), jnp.asarray(hidden.numpy()),
            jnp.asarray(mask.numpy()), 5, 6, 1.0, n_best=n_best, generate_unk=False,
            return_prob="hyp")
        ids_t, scores_t, _ = beam_search(tmodel, tspec, enc, hidden, mask, 5, 6, 1.0,
                                         n_best=n_best, device="cpu", generate_unk=False,
                                         return_prob="hyp")
        assert np.isfinite(scores_t).all() and np.isfinite(scores_j).all()
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(scores_t, scores_j, rtol=1e-5)


# ------------------------------------------------------------------- update
def micro_batches():
    """Two micro-batches of three sentence pairs (padded to four rows by
    both trainers), one with a zero-length source row."""
    rng = np.random.RandomState(3)
    out = []
    for i in range(2):
        src_len = np.array([9, 6, 4]) if i == 0 else np.array([7, 0, 3])
        trg_len = np.array([8, 5, 7])
        src, trg = rng.randint(4, 24, size=(3, 9)), np.full((3, 8), PAD)
        for r in range(3):
            src[r, src_len[r]:] = PAD
            if src_len[r]:
                src[r, src_len[r] - 1] = EOS
            trg[r, 0], trg[r, trg_len[r] - 1] = BOS, EOS
            trg[r, 1:trg_len[r] - 1] = rng.randint(4, 24, size=trg_len[r] - 2)
        out.append((src, src_len, trg, trg_len))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_update_matches_jax(name):
    """One update of each config's optimizer (two accumulated micro-batches
    at dropout 0, the config's normalization): loss to 1e-5 relative,
    gradients to 1e-5 of the global norm (the torch bias halves that flax
    has no counterpart of take none, so each summed bias moves as JAX's
    one bias), weights after the update to 1e-5."""
    # pylint: disable=too-many-locals
    from joeys2t_tpu.config import parse_train_args as jax_parse_train_args
    from joeys2t_tpu.optim import build_gradient_clipper, build_optimizer
    from joeys2t_tpu.prediction import build_loss_function as jax_loss_function
    from joeys2t_tpu.training import TrainManager as JaxTrainManager
    import optax

    p = make_pair(name, seed=2)
    training = dict(load_config(REPO / "configs" / f"{name}.yaml")["training"],
                    batch_size=4, batch_multiplier=2)
    args = jax_parse_train_args(dict(training))
    ns = SimpleNamespace(model=p.jmodel, loss_fn=jax_loss_function(args, p.jspec),
                         args=args)
    ns._finish_loss = lambda *a: JaxTrainManager._finish_loss(ns, *a)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda prm, arrays, norm: JaxTrainManager._loss_and_metrics(
            ns, prm, arrays, jax.random.PRNGKey(0), norm), has_aux=True))
    targs = parse_train_args(dict(training))
    tm = TrainManager(p.tmodel, p.tspec, build_loss_function(targs, p.tspec), targs,
                      device="cpu", task="MT")
    seen, apply = {}, tm.apply_accum

    def capture():
        # the bias halves flax has no counterpart of take no gradient (None)
        seen["grads"] = {n: torch.zeros_like(q) if q.grad is None else q.grad.detach().clone()
                         for n, q in p.tmodel.named_parameters()}
        apply()

    tm.apply_accum = capture
    accum, ref_loss, port_loss = None, 0.0, 0.0
    for src, src_len, trg, trg_len in micro_batches():
        normalizer = (float((trg[:, 1:] != PAD).sum()) if targs.normalization == "tokens"
                      else 3.0)
        jb = JaxBatch(src, src_len, None, trg, trg_len, None, np.arange(3), PAD,
                      EOS).pad_to_shape(batch_size=4)
        arrays = {name: getattr(jb, name) for name in (
            "src", "trg_input", "trg", "src_length", "src_mask", "trg_mask", "trg_length",
            "src_prompt_mask", "trg_prompt_mask")}
        (value, _), grads = grad_fn(p.params, arrays, jnp.float32(normalizer))
        ref_loss += float(value)
        accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
        out = tm.train_batch(Batch(src, src_len, None, trg, trg_len, None, np.arange(3),
                                   PAD, EOS))
        port_loss += out["loss"].item()
    assert tm.stats.steps == 1
    assert abs(port_loss - ref_loss) <= 1e-5 * abs(ref_loss)
    ref_grads = flax_params_to_state_dict(accum)
    assert sorted(ref_grads) == sorted(seen["grads"])
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in seen["grads"].values())))
    for key, g in ref_grads.items():
        assert (seen["grads"][key] - g).abs().max().item() <= 1e-5 * norm, key
    tx = optax.chain(*(t for t in (build_gradient_clipper(args.__dict__),
                                   build_optimizer(args.__dict__)) if t is not None))
    updates, _ = tx.update(accum, tx.init(p.params), p.params)
    new = flax_params_to_state_dict(optax.apply_updates(p.params, updates))
    # Adam's first step moves a weight by lr * g / (|g| + eps): 1e-5 where
    # the gradient is well above eps, and where it is not, what the
    # gradients' own tolerance (1e-5 of the norm) allows through that ratio
    lr, eps, dg = targs.learning_rate, 1e-8, 1e-5 * norm
    for key, value in p.tmodel.state_dict().items():
        g = ref_grads[key].abs()
        tol = 1e-5 + lr * torch.clamp(eps * dg / (g + eps) ** 2, max=2.0)
        assert ((value - new[key]).abs() <= tol).all(), key


def test_dropout_draws_from_the_trainers_generator():
    """Two layers each side at dropout 0.3: in training mode every dropout
    (embeddings, between the layers, the decoder's hidden dropout) draws
    from the generator the model was given, so a seed repeats the logits,
    and torch's global generator is never drawn from."""
    cfg = rnn_cfg("rnn_small", dropout=0.3)
    for side in ("encoder", "decoder"):
        cfg[side]["num_layers"] = 2
    tv, _ = vocabs()
    model, _ = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    assert sum(isinstance(m, Dropout) and m.rate == 0.3 for m in model.modules()) == 5
    inputs = tuple(map(torch.tensor, forward_inputs()))
    with torch.no_grad():
        plain = model(*inputs)[0]
        model.train()
        runs, before = [], torch.get_rng_state()
        for _ in range(2):
            set_dropout_generator(model, torch.Generator().manual_seed(7))
            runs.append(model(*inputs)[0])
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(runs[0], runs[1]) and not torch.allclose(runs[0], plain)


@pytest.mark.parametrize("name", CONFIGS)
def test_initializer_draws_each_gate_as_jax(name):
    """xavier_uniform per gate: each (H, in) block of a flat GRU/LSTM
    weight has the spread of its own fans, sqrt(2 / (H + in)), as JAX's
    per-gate matrices have, not that of the flat (G*H, in) matrix; biases
    (``bias_initializer: uniform`` here) are drawn once per flax gate and
    the redundant torch halves stay zero."""
    cfg = rnn_cfg(name)
    cfg.update(bias_initializer="uniform", bias_init_weight=0.5)
    for side in ("encoder", "decoder"):
        cfg[side]["hidden_size"] = 96
    tv, jv = vocabs()
    model, _ = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    jmodel, _ = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    jstate = flax_params_to_state_dict(jax_initialize(
        jax.tree.map(lambda s: jnp.zeros(s.shape), jax_shapes(jmodel)), cfg, PAD, PAD,
        jax.random.PRNGKey(1)))
    lstm = cfg["encoder"]["rnn_type"] == "lstm"
    checked = 0
    for key, w in model.state_dict().items():
        if ".rnn." not in key:
            continue
        h = 96
        gates = w.shape[0] // h
        assert gates == (4 if lstm else 3)
        if key.split(".")[-1].startswith("weight"):
            want = (2.0 / (h + w.shape[1])) ** 0.5
            for state in (w, jstate[key]):
                for block in state.reshape(gates, h, -1):
                    assert abs(float(block.std()) / want - 1) < 0.08, key
                    assert float(block.abs().max()) <= want * 3 ** 0.5
            checked += 1
        else:
            drawn = [bool(b.abs().sum() > 0) for b in w.reshape(gates, h)]
            if "bias_ih" in key:
                assert all(drawn), key
            else:
                assert drawn == ([False] * 4 if lstm else [False, False, True]), key
            assert float(w.abs().max()) <= 0.5
    assert checked == 6  # weight_ih and weight_hh of both encoder directions and the decoder


# ------------------------------------------------------------------ the CLI
def cli_cfg(name: str, root, model_dir, **training):
    """``name``'s config on the cut of test/data/reverse/ under ``root``, on
    the CPU: rnn_reverse.yaml's data section (rnn_small.yaml reads
    test/data/toy/, which the repository does not hold) and the config's
    own model, training and testing sections."""
    cfg = load_config(REPO / "configs" / f"{name}.yaml")
    data = load_config(REPO / "configs" / "rnn_reverse.yaml")["data"]
    for split in ("train", "dev", "test"):
        data[split] = str(root / split)
    cfg.update(use_cuda=False, model_dir=str(model_dir), data=data)
    cfg["training"].update(training)
    return cfg


def write_cfg(path, cfg):
    path.write_text(dump_yaml(cfg), encoding="utf-8")
    return path


def test_jax_checkpoint_tests_alike_through_both_clis(tmp_path):
    """rnn_reverse.yaml trained two updates by the JAX package on the CPU;
    ``jax_checkpoint_to_port`` converts its checkpoint, and the port's
    ``test`` (greedy) and ``translate`` write JAX's hypotheses;
    ``load_model_dir`` -> ``generate`` gives ``translate``'s."""
    from joeys2t_tpu.prediction import test as jax_test
    from joeys2t_tpu.training import train as jax_train

    root = write_reverse_cut(tmp_path / "reverse", n_train=40, n_dev=6, n_test=5)
    jax_dir, port_dir = tmp_path / "jax_model", tmp_path / "port_model"
    jcfg = cli_cfg("rnn_reverse", root, jax_dir, updates=2, validation_freq=1000,
                   logging_freq=100, epochs=1)
    jax_dir.mkdir()
    jax_train(copy.deepcopy(jcfg), skip_test=True)
    port_dir.mkdir()
    state = jax_checkpoint_to_port(jax_dir / "latest.ckpt", port_dir / "best.ckpt")
    assert any(k.startswith("encoder.rnn.weight_hh_l0_reverse") for k in state["model_state"])
    for vocab in ("src_vocab.txt", "trg_vocab.txt"):
        shutil.copy(jax_dir / vocab, port_dir / vocab)
    cfg_path = write_cfg(port_dir / "config.yaml", dict(jcfg, model_dir=str(port_dir)))
    jax_test(copy.deepcopy(jcfg), output_path=str(tmp_path / "jax_out"))
    cli("test", cfg_path, "-o", tmp_path / "port_out")
    for split, n in (("dev", 6), ("test", 5)):
        port_hyps = (tmp_path / f"port_out.{split}").read_text(encoding="utf-8")
        assert port_hyps == (tmp_path / f"jax_out.{split}").read_text(encoding="utf-8")
        assert len(port_hyps.splitlines()) == n
    lines = (root / "test.src").read_text(encoding="utf-8")
    translated = cli("translate", cfg_path, stdin=lines).stdout.splitlines()
    assert translated == (tmp_path / "port_out.test").read_text(
        encoding="utf-8").splitlines()
    hub = load_model_dir(port_dir, use_cuda=False)
    assert hub.generate(lines.splitlines()) == translated


def test_rnn_small_through_the_port_cli_matches_jax(tmp_path):
    """rnn_small.yaml's model and training sections (GRU, Bahdanau, bridge,
    ``normalization: tokens``, plateau) on the reverse data through the
    port's ``train`` (3 updates, one validation), ``test`` (beam 5) and
    ``translate``; the JAX package's ``test`` on the port's checkpoint
    writes the same hypotheses, and ``load_model_dir`` -> ``generate``
    gives ``translate``'s."""
    from joeys2t_tpu.prediction import test as jax_test

    root = write_reverse_cut(tmp_path / "reverse", n_train=40, n_dev=6, n_test=5)
    model_dir, jax_dir = tmp_path / "model", tmp_path / "jax_model"
    cfg = cli_cfg("rnn_small", root, model_dir, updates=3, validation_freq=2,
                  logging_freq=1, epochs=2)
    assert cfg["testing"]["beam_size"] == 5
    cfg_path = write_cfg(tmp_path / "cfg.yaml", cfg)
    cli("train", cfg_path, "--skip-test")
    assert len((model_dir / "validations.txt").read_text().splitlines()) == 1
    cli("test", cfg_path, "-o", tmp_path / "port_out")
    lines = (root / "test.src").read_text(encoding="utf-8")
    translated = cli("translate", cfg_path, stdin=lines).stdout.splitlines()
    jax_dir.mkdir()
    state = torch.load(model_dir / "best.ckpt", weights_only=True)["model_state"]
    jax_save_checkpoint(jax_dir / "best.ckpt", {"model_state": torch_state_dict_to_flax(
        {k: v.numpy() for k, v in state.items()})})
    for vocab in ("src_vocab.txt", "trg_vocab.txt"):
        shutil.copy(model_dir / vocab, jax_dir / vocab)
    jax_test(dict(copy.deepcopy(cfg), model_dir=str(jax_dir)),
             output_path=str(tmp_path / "jax_out"))
    for split in ("dev", "test"):
        port_hyps = (tmp_path / f"port_out.{split}").read_text(encoding="utf-8")
        assert port_hyps == (tmp_path / f"jax_out.{split}").read_text(encoding="utf-8")
    assert translated == (tmp_path / "port_out.test").read_text(
        encoding="utf-8").splitlines()
    assert load_model_dir(model_dir, use_cuda=False).generate(lines.splitlines()) == \
        translated
