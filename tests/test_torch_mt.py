# coding: utf-8
"""Text-to-text translation (MT) in the port against the JAX package on the
CPU.

The models are ``configs/transformer_reverse.yaml``'s (2 + 2 layers, hidden
64, 4 heads of 16, pre-LN) at dropout 0 and float32, in four variants: as
configured (tied embeddings and tied softmax), ``synthetic_mt.yaml``'s
tying (own tables, tied softmax), no tying, and DeepNet (``initializer:
xavier_normal``). The vocabulary has a sep token and two language tags.
Weights are JAX's, initialized and perturbed from a seed, carried to the
port by ``flax_params_to_state_dict``. Held to JAX: the forward logits with
source and target prompts (to 1e-5 of the largest), one training update (as
test_torch_train.py holds it), greedy and beam tokens with the repetition
penalty, the n-gram blockers and forced prompts (identical; scores to 1e-5
relative), the plaintext and prompt datasets' batches, ``predict`` over
prompted data, and ``configs/transformer_reverse.yaml`` through the port's
command line (train, test, translate from stdin) against the JAX package's
``test`` and ``translate`` on the port's checkpoint."""
import copy
import io
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch.config import (SpecialSymbols, TestConfig, dump_yaml, load_config,
                                  parse_special_symbols, parse_train_args)
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.data.loader import load_data
from joeys2t_torch.hub_interface import load_model_dir
from joeys2t_torch.losses import build_loss_function
from joeys2t_torch.models import build_model
from joeys2t_torch.models.initialization import compute_alpha_beta
from joeys2t_torch.prediction import predict
from joeys2t_torch.search import beam_search, transformer_greedy
from joeys2t_torch.training import TrainManager
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.checkpoints import save_checkpoint as jax_save_checkpoint
from joeys2t_tpu.config import SpecialSymbols as JaxSymbols
from joeys2t_tpu.config import TestConfig as JaxTestConfig
from joeys2t_tpu.config import parse_special_symbols as jax_parse_special_symbols
from joeys2t_tpu.convert import torch_state_dict_to_flax
from joeys2t_tpu.data.batch import Batch as JaxBatch
from joeys2t_tpu.data.loader import load_data as jax_load_data
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.models.initialization import initialize_model as jax_initialize
from joeys2t_tpu.prediction import predict as jax_predict
from joeys2t_tpu.search import beam_search as jax_beam_search
from joeys2t_tpu.search import greedy as jax_greedy
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
from test_torch_data import REPO, few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

TOKENS = [f"t{i}" for i in range(40)]
SYMBOLS = dict(sep_token="<sep>", sep_id=4, lang_tags=["<de>", "<en>"])  # 47 ids
PAD, BOS, EOS, SEP = 1, 2, 3, 4
B, S = 3, 7


def mt_cfg(variant: str = "tied"):
    """transformer_reverse.yaml's model section at dropout 0, in one of the
    four variants of the module docstring."""
    cfg = load_config(REPO / "configs" / "transformer_reverse.yaml")["model"]
    for side in ("encoder", "decoder"):
        cfg[side]["dropout"] = 0.0
    if variant in ("untied", "plain", "deepnet"):
        cfg["tied_embeddings"] = False
    if variant in ("plain", "deepnet"):
        cfg["tied_softmax"] = False
    if variant == "deepnet":
        cfg["initializer"] = "xavier_normal"
    return cfg


def vocabs():
    return Vocabulary(TOKENS, SpecialSymbols(**SYMBOLS)), JaxVocabulary(
        TOKENS, JaxSymbols(**SYMBOLS))


def jax_params(jmodel, cfg, seed=0, noise=0.3):
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(seed)}, jnp.ones((2, 5), jnp.int32),
        jnp.ones((2, 4), jnp.int32), jnp.full((2,), 5), jnp.ones((2, 1, 5), bool),
        jnp.ones((2, 1, 4), bool))["params"]
    params = jax_initialize(params, cfg, PAD, PAD, jax.random.PRNGKey(seed + 1))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + noise * rng.randn(*x.shape).astype(
        np.float32), params)


def make_pair(variant="tied", seed=0):
    """(port model, port spec, JAX model, JAX spec, JAX params) with the
    same weights."""
    cfg = mt_cfg(variant)
    tv, jv = vocabs()
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    params = jax_params(jmodel, cfg, seed)
    tmodel, tspec = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    tmodel.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return SimpleNamespace(tmodel=tmodel, tspec=tspec, jmodel=jmodel, jspec=jspec,
                           params=params, cfg=cfg)


@pytest.fixture(scope="module")
def pairs():
    return {v: make_pair(v) for v in ("tied", "untied", "plain", "deepnet")}


def source(seed=5):
    rng = np.random.RandomState(seed)
    src = rng.randint(7, 47, size=(B, S))
    src[:, -1] = EOS
    src[2, 4:] = PAD
    src[2, 3] = EOS
    src[0, :2] = [5, SEP]  # a source prompt: <de> <sep> ...
    prompt = np.zeros((B, S), np.int64)
    prompt[0, :2] = 1
    return src, (src != PAD).sum(1), (src != PAD)[:, None, :], prompt


# ------------------------------------------------------------------- models
@pytest.mark.parametrize("name", ["synthetic_mt", "transformer_reverse",
                                  "transformer_small", "deepnet"])
def test_build_model_matches_the_jax_tree(name):
    """The configs build at full width with JAX's parameter names and
    shapes, each tensor once (a tied table under ``trg_embed`` only, as
    JAX keeps it), and JAX's ModelSpec."""
    cfg = load_config(REPO / "configs" / f"{'transformer_reverse' if name == 'deepnet' else name}.yaml")["model"]
    if name == "deepnet":
        cfg = dict(cfg, initializer="xavier_normal", tied_embeddings=False)
    n = 7000 if name == "synthetic_mt" else 30
    tv = Vocabulary([f"w{i}" for i in range(n)], SpecialSymbols())
    jv = JaxVocabulary([f"w{i}" for i in range(n)], JaxSymbols())
    tmodel, tspec = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.ones((2, 5), jnp.int32), jnp.ones((2, 4), jnp.int32),
                            jnp.full((2,), 5), jnp.ones((2, 1, 5), bool),
                            jnp.ones((2, 1, 4), bool))["params"]
    want = {k: tuple(v.shape) for k, v in flax_params_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in tmodel.parameters()) == sum(
        int(np.prod(s)) for s in want.values())
    assert dataclass_fields(tspec) == dataclass_fields(jspec)
    tied = cfg.get("tied_embeddings", False)
    assert (tmodel.src_embed is tmodel.trg_embed) == tied
    assert ("src_embed.lut.weight" in got) != tied
    if name == "synthetic_mt":
        assert 65e6 < sum(p.numel() for p in tmodel.parameters()) < 67e6


def dataclass_fields(spec):
    return {k: getattr(spec, k) for k in ("task", "pad_index", "bos_index", "eos_index",
                                          "unk_index", "sep_index", "specials",
                                          "lang_tags", "src_vocab_size",
                                          "trg_vocab_size")}


@pytest.mark.parametrize("variant", ["tied", "untied", "plain", "deepnet"])
def test_forward_logits_match_jax(pairs, variant):
    """Logits of the teacher-forced pass with source and target prompts to
    1e-5 of the largest (f32 summation order)."""
    p = pairs[variant]
    src, src_len, src_mask, src_prompt = source()
    rng = np.random.RandomState(9)
    trg = np.concatenate([np.full((B, 1), BOS), rng.randint(7, 47, size=(B, 5))], axis=1)
    trg[1, :3] = [BOS, 6, SEP]
    trg_mask = np.ones((B, 1, 6), bool)
    trg_mask[2, 0, 4:] = False
    trg_prompt = np.zeros((B, 6), np.int64)
    trg_prompt[1, :3] = 1
    ref = p.jmodel.apply({"params": p.params}, jnp.asarray(src), jnp.asarray(trg),
                         jnp.asarray(src_len), jnp.asarray(src_mask), jnp.asarray(trg_mask),
                         src_prompt_mask=jnp.asarray(src_prompt),
                         trg_prompt_mask=jnp.asarray(trg_prompt))[0]
    with torch.no_grad():
        got, ctc, _ = p.tmodel(*map(torch.tensor, (src, trg, src_len, src_mask, trg_mask,
                                                  src_prompt, trg_prompt)))
    assert ctc is None and p.tmodel.decoder.ctc_output_layer is None
    assert (p.tmodel.decoder.output_layer is None) == p.cfg["tied_softmax"]
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_deepnet_alpha_and_initialization():
    """xavier_normal at 6 + 6 layers: the residual alphas of every
    transformer layer, and the standard deviations of the initialized
    weights (beta-scaled feed-forward, value and output projections,
    gain 1 elsewhere) as JAX's draws give them."""
    cfg = mt_cfg("deepnet")
    for side in ("encoder", "decoder"):
        cfg[side]["num_layers"] = 6
    ab = compute_alpha_beta(6, 6)
    assert ab["alpha"]["encoder"] == 0.81 * (6**4 * 6)**(1 / 16)
    assert ab["alpha"]["decoder"] == (3 * 6)**0.25
    tv, jv = vocabs()
    model, _ = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    for side, layers in (("encoder", model.encoder.layers), ("decoder", model.decoder.layers)):
        for layer in layers:
            assert layer.alpha == layer.feed_forward.alpha == ab["alpha"][side]
    jmodel, _ = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    jstate = flax_params_to_state_dict(jax_params(jmodel, cfg, noise=0.0))
    state = model.state_dict()
    for name, w in state.items():
        if w.dim() < 2 or "embed" in name:
            continue
        side = "encoder" if name.startswith("encoder") else "decoder"
        beta = (ab["beta"][side] if any(k in name for k in ("feed_forward", "v_layer",
                                                            "output_layer")) else 1.0)
        want = beta * (2.0 / sum(w.shape)) ** 0.5
        for value in (w, jstate[name]):
            assert abs(float(value.std()) / want - 1) < 0.05, name


# ------------------------------------------------------------------- update
TRAINING = {"optimizer": "adamw", "adam_betas": [0.9, 0.98], "weight_decay": 0.01,
            "scheduling": "warmupinversesquareroot", "learning_rate": 2.0e-3,
            "learning_rate_min": 1.0e-6, "learning_rate_warmup": 10,
            "clip_grad_norm": 1.0, "batch_size": 4, "batch_type": "sentence",
            "batch_multiplier": 2, "normalization": "tokens", "label_smoothing": 0.1,
            "loss": "crossentropy"}


def mt_micro_batches():
    """Two micro-batches of three sentences (one padded to four rows by
    both trainers), the second with source and target prompts."""
    rng = np.random.RandomState(3)
    out = []
    for i in range(2):
        src = rng.randint(7, 47, size=(3, 9))
        src_len = np.array([9, 6, 4])
        trg = np.full((3, 8), PAD)
        trg_len = np.array([8, 5, 7])
        for r in range(3):
            src[r, src_len[r] - 1], src[r, src_len[r]:] = EOS, PAD
            trg[r, 0], trg[r, trg_len[r] - 1] = BOS, EOS
            trg[r, 1:trg_len[r] - 1] = rng.randint(7, 47, size=trg_len[r] - 2)
        src_prompt = trg_prompt = None
        if i == 1:
            src[0, :2], trg[0, 1:3] = [5, SEP], [6, SEP]
            src_prompt = np.zeros_like(src)
            src_prompt[0, :2] = 1
            trg_prompt = np.zeros_like(trg)
            trg_prompt[0, :3] = 1
        out.append((src, src_len, src_prompt, trg, trg_len, trg_prompt))
    return out


def test_update_matches_jax(pairs):
    """One update (two accumulated micro-batches, cross-entropy only,
    ``normalization: tokens``): loss to 1e-5 relative, gradients to 1e-4 of
    the global norm, weights after the update to 2 * lr."""
    p = make_pair("tied", seed=2)
    from joeys2t_tpu.config import parse_train_args as jax_parse_train_args
    from joeys2t_tpu.optim import build_gradient_clipper, build_optimizer, build_scheduler
    from joeys2t_tpu.optim import set_learning_rate
    from joeys2t_tpu.prediction import build_loss_function as jax_loss_function
    from joeys2t_tpu.training import TrainManager as JaxTrainManager
    import optax

    args = jax_parse_train_args(dict(TRAINING))
    ns = SimpleNamespace(model=p.jmodel, loss_fn=jax_loss_function(args, p.jspec), args=args)
    ns._finish_loss = lambda *a: JaxTrainManager._finish_loss(ns, *a)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda prm, arrays, norm: JaxTrainManager._loss_and_metrics(
            ns, prm, arrays, jax.random.PRNGKey(0), norm), has_aux=True))
    accum, ref_loss = None, 0.0
    targs = parse_train_args(TRAINING)
    tm = TrainManager(p.tmodel, p.tspec, build_loss_function(targs, p.tspec), targs,
                      device="cpu", task="MT")
    seen = {}
    apply = tm.apply_accum

    def capture():
        seen["grads"] = {n: q.grad.detach().clone() for n, q in p.tmodel.named_parameters()}
        apply()

    tm.apply_accum = capture
    port_loss = 0.0
    for src, src_len, src_prompt, trg, trg_len, trg_prompt in mt_micro_batches():
        ntokens = int((trg[:, 1:] != PAD).sum())
        jb = JaxBatch(src, src_len, src_prompt, trg, trg_len, trg_prompt, np.arange(3),
                      PAD, EOS).pad_to_shape(batch_size=4)
        arrays = {name: getattr(jb, name) for name in (
            "src", "trg_input", "trg", "src_length", "src_mask", "trg_mask", "trg_length",
            "src_prompt_mask", "trg_prompt_mask")}
        (value, _), grads = grad_fn(p.params, arrays, jnp.float32(ntokens))
        ref_loss += float(value)
        accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
        out = tm.train_batch(Batch(src, src_len, src_prompt, trg, trg_len, trg_prompt,
                                   np.arange(3), PAD, EOS))
        port_loss += out["loss"].item()
    assert tm.stats.steps == 1
    assert abs(port_loss - ref_loss) <= 1e-5 * abs(ref_loss)
    ref_grads = flax_params_to_state_dict(accum)
    assert sorted(ref_grads) == sorted(seen["grads"])
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in seen["grads"].values())))
    for name, g in ref_grads.items():
        assert (seen["grads"][name] - g).abs().max().item() <= 1e-4 * norm, name
    tx = optax.chain(build_gradient_clipper(args.__dict__), build_optimizer(args.__dict__))
    scheduler, _ = build_scheduler(args.__dict__, "min", hidden_size=64)
    opt_state = tx.init(p.params)
    set_learning_rate(opt_state[1], scheduler.step(0))
    updates, _ = tx.update(accum, opt_state, p.params)
    new = flax_params_to_state_dict(optax.apply_updates(p.params, updates))
    lr = scheduler.step(0)
    for name, value in p.tmodel.state_dict().items():
        assert (value - new[name]).abs().max().item() <= 2 * lr, name


# ------------------------------------------------------------------- search
GREEDY_CASES = [  # (max length, options, prompt rows forced)
    (12, {}, 0),
    (12, {"min_output_length": 5, "return_prob": "hyp"}, 0),
    (12, {"generate_unk": False}, 0),
    (12, {}, 3),
    (16, {"repetition_penalty": 2.0, "encoder_input": True}, 0),
    (20, {"no_repeat_ngram_size": 2}, 0),
    (20, {"no_repeat_ngram_size": 3, "encoder_input": True, "return_prob": "hyp"}, 0),
    (16, {"repetition_penalty": 1.5, "no_repeat_ngram_size": 2, "encoder_input": True,
          "return_prob": "hyp"}, 2),
]
BEAM_CASES = [  # (beam size, n_best, alpha, max length, options, prompt rows)
    (1, 1, -1.0, 12, {}, 0),
    (4, 3, 1.0, 12, {"return_prob": "hyp"}, 0),
    (3, 1, 1.0, 12, {}, 3),
    (5, 2, 1.0, 16, {"repetition_penalty": 2.0, "no_repeat_ngram_size": 2,
                     "encoder_input": True, "return_prob": "hyp"}, 0),
    (5, 5, -1.0, 12, {"no_repeat_ngram_size": 3, "min_output_length": 3,
                      "generate_unk": False, "return_prob": "hyp"}, 2),
]


def search_inputs(p, options, prompt_rows):
    """(encoder output, mask, options for both searches): the port's
    encoder output of ``source()``, the source ids as ``encoder_input``
    when asked, and a forced prefix of ``prompt_rows`` rows (the last
    row's mask stops after two tokens)."""
    src, src_len, src_mask, _ = source()
    with torch.no_grad():
        enc, _, mask = p.tmodel.encode(torch.tensor(src), torch.tensor(src_len),
                                       torch.tensor(src_mask))
    options = dict(options)
    if options.pop("encoder_input", False):
        options["encoder_input"] = src
    if prompt_rows:
        dp = np.array([[BOS, 5, SEP, 9], [BOS, 6, 8, SEP], [BOS, 10, 11, 12]])[:B]
        pm = np.ones_like(dp)
        pm[-1, 3:] = 0
        options.update(decoder_prompt=dp, trg_prompt_mask=pm)
    return enc.numpy(), mask.numpy(), options


def jaxify(options):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in options.items()}


@pytest.mark.parametrize("variant", ["tied", "untied"])
@pytest.mark.parametrize("max_len,options,prompt_rows", GREEDY_CASES)
def test_greedy_matches_jax(pairs, variant, max_len, options, prompt_rows):
    p = pairs[variant]
    enc, mask, options = search_inputs(p, options, prompt_rows)
    ids_j, scores_j, _ = jax_greedy(p.params, p.jmodel, p.jspec, jnp.asarray(enc), None,
                                    jnp.asarray(mask), max_len, **jaxify(options))
    ids_t, scores_t, _ = transformer_greedy(p.tmodel, p.tspec, torch.tensor(enc),
                                            torch.tensor(mask), max_len, device="cpu",
                                            **options)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    if prompt_rows:
        dp, pm = options["decoder_prompt"], options["trg_prompt_mask"]
        for row, prompt, forced in zip(ids_t, dp, pm):
            n = int(forced.sum()) - 1
            assert list(row[:n]) == list(prompt[1:n + 1])
    if options.get("return_prob") == "hyp":
        np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reorder", ["physical", "auto"])
@pytest.mark.parametrize("k,n_best,alpha,max_len,options,prompt_rows", BEAM_CASES)
def test_beam_matches_jax(pairs, reorder, k, n_best, alpha, max_len, options, prompt_rows):
    p = pairs["untied"]
    enc, mask, options = search_inputs(p, options, prompt_rows)
    ids_j, scores_j, _ = jax_beam_search(p.params, p.jmodel, p.jspec, jnp.asarray(enc),
                                         None, jnp.asarray(mask), k, max_len, alpha,
                                         n_best=n_best, beam_reorder=reorder,
                                         **jaxify(options))
    ids_t, scores_t, _ = beam_search(p.tmodel, p.tspec, torch.tensor(enc), None,
                                     torch.tensor(mask), k, max_len, alpha, n_best=n_best,
                                     device="cpu", beam_reorder=reorder, **options)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    if options.get("return_prob") == "hyp":
        np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-5)


# ------------------------------------------------------------------ datasets
def write_reverse_cut(root, n_train=60, n_dev=12, n_test=8):
    """The first lines of test/data/reverse/ under ``root``."""
    root.mkdir(parents=True, exist_ok=True)
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        for side in ("src", "trg"):
            lines = (REPO / "test" / "data" / "reverse" / f"{split}.{side}").read_text(
                encoding="utf-8").splitlines()[:n]
            (root / f"{split}.{side}").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return root


def reverse_data_cfg(root, symbols=None, **extra):
    cfg = copy.deepcopy(load_config(REPO / "configs" / "transformer_reverse.yaml")["data"])
    for split in ("train", "dev", "test"):
        cfg[split] = str(root / split)
    cfg.pop("sample_train_subset")
    cfg.pop("sample_dev_subset")
    cfg["special_symbols"] = dict(cfg["special_symbols"], **(symbols or {}))
    cfg.update(extra)
    return cfg


def both_data(cfg, splits):
    port = load_data(dict(cfg, special_symbols=parse_special_symbols(cfg["special_symbols"])),
                     datasets=splits, task="MT")
    ref = jax_load_data(dict(copy.deepcopy(cfg), special_symbols=jax_parse_special_symbols(
        cfg["special_symbols"])), datasets=splits, task="MT")
    return port, ref


BATCH_FIELDS = ("src", "src_length", "src_mask", "src_prompt_mask", "trg", "trg_input",
                "trg_length", "trg_mask", "trg_prompt_mask", "indices")


def assert_batches_equal(port_iter, ref_iter):
    port_batches, ref_batches = list(port_iter), list(ref_iter)
    assert len(port_batches) == len(ref_batches) > 1
    for a, b in zip(port_batches, ref_batches):
        assert (a.nseqs, a.ntokens, a.has_trg) == (b.nseqs, b.ntokens, b.has_trg)
        for name in BATCH_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("batch_type,batch_size", [("sentence", 7), ("token", 60)])
def test_plaintext_batches_match_jax(tmp_path, batch_type, batch_size):
    root = write_reverse_cut(tmp_path / "reverse")
    (pv_src, pv_trg, p_train, p_dev, p_test), (jv_src, jv_trg, j_train, j_dev, j_test) = \
        both_data(reverse_data_cfg(root), ["train", "dev", "test"])
    assert pv_src.log_vocab(60) == jv_src.log_vocab(60)
    assert pv_trg.log_vocab(60) == jv_trg.log_vocab(60)
    for port, ref in ((p_train, j_train), (p_dev, j_dev), (p_test, j_test)):
        assert len(port) == len(ref) and port.src == list(ref.src) and port.trg == list(
            ref.trg)
        assert port.get_list(port.trg_lang, tokenized=True) == ref.get_list(
            ref.trg_lang, tokenized=True)
        kw = dict(batch_size=batch_size, batch_type=batch_type, seed=42,
                  shuffle=port is p_train, pad_index=PAD, eos_index=EOS)
        assert_batches_equal(port.make_iter(**kw), ref.make_iter(**kw))


PROMPT_SYMBOLS = {"sep_token": "<sep>", "sep_id": 4, "lang_tags": ["<de>", "<en>"]}


def write_prompt_data(root):
    """A dev set with prompts: a TSV with ``src_prompt``/``trg_prompt``
    columns, and the same data as plaintext files with prompt files."""
    rng = np.random.RandomState(7)
    rows = []
    for i in range(10):
        src = " ".join(rng.choice(list("abcdefgh"), size=rng.randint(2, 7)))
        trg = " ".join(reversed(src.split()))
        src_prompt = "<de> " + " ".join(rng.choice(list("abcd"), size=rng.randint(0, 9)))
        trg_prompt = "<en> " + " ".join(rng.choice(list("efgh"), size=rng.randint(0, 3)))
        rows.append((src, trg, src_prompt.strip(), trg_prompt.strip()))
    root.mkdir(parents=True, exist_ok=True)
    (root / "dev.tsv").write_text(
        "src\ttrg\tsrc_prompt\ttrg_prompt\n" + "".join("\t".join(r) + "\n" for r in rows),
        encoding="utf-8")
    for col, ext in enumerate(("src", "trg", "src_prompt", "trg_prompt")):
        (root / f"plain.{ext}").write_text("".join(r[col] + "\n" for r in rows),
                                          encoding="utf-8")
    (root / "vocab.txt").write_text("\n".join(list("abcdefgh")) + "\n", encoding="utf-8")
    return root


def prompt_data_cfg(root, dataset_type="tsv", max_length=30):
    side = {"level": "word", "lowercase": False, "max_length": max_length,
            "voc_file": str(root / "vocab.txt")}
    return {"dev": str(root / ("dev" if dataset_type == "tsv" else "plain")),
            "dataset_type": dataset_type, "src": dict(side, lang="src"),
            "trg": dict(side, lang="trg"),
            "special_symbols": dict(PROMPT_SYMBOLS)}


@pytest.mark.parametrize("max_length", [30, 8])
def test_prompt_datasets_match_jax(tmp_path, max_length):
    """TSV prompt columns: items (``prompt <sep> item``, the prompt cut from
    the left keeping its language tag) and batches with both prompt masks
    equal JAX's; the port's plaintext prompt files give the same batches."""
    root = write_prompt_data(tmp_path / "prompts")
    (_, tv, _, port, _), (_, jv, _, ref, _) = both_data(
        prompt_data_cfg(root, max_length=max_length), ["dev"])
    assert tv.sep_index == SEP and tv.lookup("<de>") == 5
    assert port.has_prompt == {"src": True, "trg": True} == dict(ref.has_prompt)
    for i in range(len(port)):
        assert port[i] == ref[i]
    kw = dict(batch_size=4, seed=42, shuffle=False, pad_index=PAD, eos_index=EOS)
    assert_batches_equal(port.make_iter(**kw), ref.make_iter(**kw))
    (_, _, _, plain, _), _ = both_data(prompt_data_cfg(root, "plain", max_length), ["dev"])
    assert plain.has_prompt == port.has_prompt
    assert_batches_equal(plain.make_iter(**kw), port.make_iter(**kw))


def test_stream_prompts_match_jax(tmp_path):
    """Translate-mode input ``text <sep> prompt`` is split as JAX's
    ``StreamDataset._split_at_sep`` splits it, and its batch forces the
    target prompt."""
    root = write_prompt_data(tmp_path / "prompts")
    cfg = prompt_data_cfg(root)
    (_, _, _, _, port), (_, _, _, _, ref) = both_data(cfg, ["stream"])
    for data in (port, ref):
        data.set_item("a b c <sep> <de> d d")
        data.set_item("e f", trg_prompt="<en> g")
        data.set_item("h", src_prompt="<de> a")
    for i in range(3):
        assert port[i] == ref[i] and port.cache[i] == tuple(ref.cache[i])
    kw = dict(batch_size=3, seed=1, shuffle=False, pad_index=PAD, eos_index=EOS)
    (a,), (b,) = list(port.make_iter(**kw)), list(ref.make_iter(**kw))
    for name in BATCH_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("testing", [
    {}, {"beam_size": 3, "beam_alpha": 1.0, "n_best": 2, "return_prob": "hyp"},
    {"repetition_penalty": 1.8, "no_repeat_ngram_size": 2}])
def test_predict_with_prompts_matches_jax(tmp_path, testing):
    """``predict`` over the prompted TSV: hypotheses (the forced prompt cut
    off in post-processing) and BLEU equal JAX's."""
    root = write_prompt_data(tmp_path / "prompts")
    (_, tv, _, port, _), (_, jv, _, ref, _) = both_data(prompt_data_cfg(root), ["dev"])
    cfg = mt_cfg("untied")
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    params = jax_params(jmodel, cfg, seed=4)
    tmodel, tspec = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    args = dict(batch_size=4, batch_type="sentence", max_output_length=10,
                eval_metrics=["bleu"], **testing)
    got = predict(tmodel, tspec, port, args=TestConfig(**args), device="cpu")
    want = jax_predict(params, jmodel, jspec, ref, args=JaxTestConfig(**args))
    assert got[2] == want[2] and got[3] == want[3]
    assert got[0]["bleu"] == want[0]["bleu"]
    assert all("<sep>" not in h for h in got[2])
    if testing.get("return_prob") == "hyp":
        np.testing.assert_allclose(np.asarray(got[4], np.float64),
                                   np.asarray(want[4], np.float64), rtol=1e-5)


# ---------------------------------------------------------------- the CLI
ENV = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, OMP_NUM_THREADS="2")


def cli(*args, stdin=None):
    return subprocess.run([sys.executable, "-m", "joeys2t_torch", *map(str, args)],
                          cwd=REPO, env=ENV, input=stdin, capture_output=True, text=True,
                          timeout=600, check=True)


def reverse_cfg(root, model_dir):
    """transformer_reverse.yaml on the cut of test/data/reverse/: on the
    CPU, 3 updates with one validation, greedy as configured."""
    cfg = load_config(REPO / "configs" / "transformer_reverse.yaml")
    cfg.update(use_cuda=False, model_dir=str(model_dir), data=reverse_data_cfg(root))
    cfg["training"].update(updates=3, validation_freq=2, logging_freq=1, epochs=2)
    cfg["testing"].pop("load_model")
    return cfg


def test_reverse_config_through_the_cli_matches_jax(tmp_path, monkeypatch):
    """``train``, ``test -o`` and ``translate`` (stdin) of the port; the
    JAX package's ``test`` and ``translate`` on the port's checkpoint
    (converted by ``torch_state_dict_to_flax``) write the same hypotheses,
    and ``load_model_dir`` -> ``generate`` gives ``translate``'s."""
    from joeys2t_tpu.prediction import test as jax_test
    from joeys2t_tpu.prediction import translate as jax_translate

    root = write_reverse_cut(tmp_path / "reverse", n_train=40, n_dev=6, n_test=5)
    model_dir, jax_dir = tmp_path / "model", tmp_path / "jax_model"
    cfg = reverse_cfg(root, model_dir)
    (tmp_path / "cfg.yaml").write_text(dump_yaml(cfg), encoding="utf-8")
    cli("train", tmp_path / "cfg.yaml", "--skip-test")
    for name in ("src_vocab.txt", "trg_vocab.txt", "validations.txt", "best.ckpt",
                 "2.hyps"):
        assert (model_dir / name).exists(), name
    cli("test", tmp_path / "cfg.yaml", "-o", tmp_path / "port_out")
    lines = (root / "test.src").read_text(encoding="utf-8")
    port_translate = cli("translate", tmp_path / "cfg.yaml", stdin=lines).stdout.splitlines()

    jax_dir.mkdir()
    state = torch.load(model_dir / "best.ckpt", weights_only=True)["model_state"]
    jax_save_checkpoint(jax_dir / "best.ckpt", {"model_state": torch_state_dict_to_flax(
        {k: v.numpy() for k, v in state.items()})})
    for name in ("src_vocab.txt", "trg_vocab.txt"):
        (jax_dir / name).write_bytes((model_dir / name).read_bytes())
    jcfg = dict(copy.deepcopy(cfg), model_dir=str(jax_dir))
    jax_test(copy.deepcopy(jcfg), output_path=str(tmp_path / "jax_out"))
    for split in ("dev", "test"):
        port_hyps = (tmp_path / f"port_out.{split}").read_text(encoding="utf-8")
        assert port_hyps == (tmp_path / f"jax_out.{split}").read_text(encoding="utf-8")
        assert len(port_hyps.splitlines()) == {"dev": 6, "test": 5}[split]
    stdin = io.StringIO(lines)
    stdin.isatty = lambda: False
    monkeypatch.setattr(sys, "stdin", stdin)
    jax_translate(copy.deepcopy(jcfg), output_path=str(tmp_path / "jax_translate"))
    assert port_translate == (tmp_path / "jax_translate").read_text(
        encoding="utf-8").splitlines()
    assert port_translate == (tmp_path / "port_out.test").read_text(
        encoding="utf-8").splitlines()
    hub = load_model_dir(model_dir, use_cuda=False)
    assert hub.generate(lines.splitlines()) == port_translate
