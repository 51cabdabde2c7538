# coding: utf-8
"""The port's prediction path against the JAX package on the CPU.

One set of JAX weights (2 + 2 layers, hidden 32, 2 heads, float32, every
leaf perturbed) goes to the port through ``flax_params_to_state_dict``; the
dev set of the synthetic corpus goes through the JAX ``predict`` and the
port's: the same hypotheses token for token, the same WER, and loss, ppl
and acc to 1e-5 relative, for ``return_prob`` "none", "hyp" and "ref". A
JAX checkpoint, converted by ``jax_checkpoint_to_port``, run through the
port's ``test`` writes the same hypothesis files as the JAX ``test``. Then
the evaluation tokenizer and WER, and ``CheckpointManager``."""
import copy
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from joeys2t_torch.checkpoints import CheckpointManager
from joeys2t_torch.config import parse_global_args
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.metrics import wer
from joeys2t_torch.prediction import predict, prepare
from joeys2t_torch.prediction import test as port_test
from joeys2t_torch.tokenizers import EvaluationTokenizer
from joeys2t_tpu.checkpoints import CheckpointManager as JaxCheckpointManager
from joeys2t_tpu.checkpoints import save_checkpoint as jax_save_checkpoint
from joeys2t_tpu.config import parse_global_args as jax_parse_global_args
from joeys2t_tpu.metrics import wer as jax_wer
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.models.initialization import initialize_model as jax_initialize
from joeys2t_tpu.prediction import build_loss_function as jax_loss_function
from joeys2t_tpu.prediction import predict as jax_predict
from joeys2t_tpu.prediction import prepare as jax_prepare
from joeys2t_tpu.prediction import test as jax_test
from joeys2t_tpu.tokenizers import EvaluationTokenizer as JaxEvaluationTokenizer
from test_torch_data import REPO, few_threads, make_corpus, tiny_cfg  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, the tiny config, and perturbed float32 JAX weights."""
    tmp = tmp_path_factory.mktemp("prediction")
    corpus = make_corpus(tmp / "data")
    cfg = tiny_cfg(corpus, tmp / "model")
    (tmp / "model").mkdir()  # prepare() writes the vocabulary there
    args = jax_parse_global_args(copy.deepcopy(cfg), mode="test")
    vocab_tokens = (corpus / "char.txt").read_text(encoding="utf-8").splitlines()
    from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary

    model, _ = jax_build_model(cfg["model"], trg_vocab=JaxVocabulary(
        vocab_tokens, args.data["special_symbols"]))
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 40, 80)),
                        jnp.zeros((2, 4), jnp.int32), jnp.full((2,), 40), None,
                        jnp.ones((2, 1, 4), bool))["params"]
    params = jax_initialize(params, cfg["model"], 1, 1, jax.random.PRNGKey(1))
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.3 * rng.randn(*x.shape).astype(np.float32), params)
    return tmp, corpus, cfg, params


def jax_side(cfg, params, return_prob, **testing):
    cfg = copy.deepcopy(cfg)
    cfg["testing"].update(return_prob=return_prob, **testing)
    args = jax_parse_global_args(cfg, mode="train")
    model, spec, _, loss_fn, _, dev, _ = jax_prepare(args, mode="train")
    return jax_predict(params, model, spec, dev, loss_fn=jax_loss_function(args.train, spec),
                       compute_loss=True, normalization=args.train.normalization,
                       args=args.test)


def port_side(cfg, params, return_prob, **testing):
    cfg = copy.deepcopy(cfg)
    cfg["testing"].update(return_prob=return_prob, **testing)
    args = parse_global_args(cfg, mode="train")
    model, spec, loss_fn, _, dev, _ = prepare(args, mode="train")
    model.load_state_dict(flax_params_to_state_dict(params))
    stats = {}
    out = predict(model, spec, dev, loss_fn=loss_fn, compute_loss=True,
                  normalization=args.train.normalization, args=args.test, stats=stats)
    return out, stats


@pytest.mark.parametrize("return_prob", ["none", "hyp", "ref"])
def test_predict_matches_jax(setup, return_prob):
    _, _, cfg, params = setup
    ref = jax_side(cfg, params, return_prob)
    (scores, refs, hyps, decoded, seq_scores, _), stats = port_side(cfg, params,
                                                                    return_prob)
    assert decoded == ref[3]  # token for token
    assert hyps == ref[2] and refs == ref[1]
    for name in ("loss", "ppl", "acc"):
        assert math.isfinite(scores[name])
        assert abs(scores[name] - ref[0][name]) <= 1e-5 * abs(ref[0][name]), name
    if return_prob == "ref":
        assert stats["batches"] == 2 and stats.get("decode_steps", 0) == 0
    else:
        assert scores["wer"] == ref[0]["wer"]
        # max_output_length 80 becomes the bucket 96, as in JAX: a hypothesis
        # that never emits eos is 96 tokens long
        assert max(len(d) for d in decoded) <= 96
        assert any(len(d) > 80 for d in decoded)
    assert len(seq_scores) == (0 if return_prob == "none" else 8)
    for a, b in zip(seq_scores, ref[4]):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-5, atol=1e-5)


BEAM = {"beam_size": 5, "beam_alpha": 1.0, "max_output_length": 12}


@pytest.mark.parametrize("n_best", [1, 2])
def test_predict_beam_matches_jax(setup, n_best):
    """Beam 5 with ``n_best`` hypotheses and their scores: token for token
    and to 1e-5 relative, with the 1-best scored."""
    _, _, cfg, params = setup
    ref = jax_side(cfg, params, "hyp", n_best=n_best, **BEAM)
    (scores, refs, hyps, decoded, seq_scores, _), stats = port_side(
        cfg, params, "hyp", n_best=n_best, **BEAM)
    assert decoded == ref[3] and hyps == ref[2] and refs == ref[1]
    assert len(decoded) == 8 * n_best and scores["wer"] == ref[0]["wer"]
    assert 0 < stats["decode_steps"] <= 2 * 16  # 12 rounds up to the bucket 16
    assert len(seq_scores) == 8 * n_best
    np.testing.assert_allclose(np.asarray(seq_scores, np.float64),
                               np.asarray(ref[4], np.float64), rtol=1e-5)


@pytest.mark.parametrize("n_best", [1, 2])
def test_beam_test_writes_the_files_jax_writes(setup, n_best):
    """``test -o`` with beam 5 and ``n_best`` hypotheses an example from a
    converted JAX checkpoint writes the JAX ``test``'s files."""
    tmp, _, cfg, params = setup
    jax_dir, port_dir = tmp / f"jax_beam{n_best}", tmp / f"port_beam{n_best}"
    jax_dir.mkdir()
    port_dir.mkdir()
    jax_save_checkpoint(jax_dir / "best.ckpt", {"model_state": params})
    torch.save({"model_state": flax_params_to_state_dict(params)}, port_dir / "best.ckpt")
    for out_dir in (jax_dir, port_dir):
        run_cfg = dict(copy.deepcopy(cfg), model_dir=str(out_dir))
        run_cfg["testing"].update(n_best=n_best, **BEAM)
        (jax_test if out_dir == jax_dir else port_test)(
            run_cfg, output_path=str(out_dir / "out"))
    names = sorted(p.name for p in jax_dir.glob("out*"))
    assert names == sorted(p.name for p in port_dir.glob("out*"))
    assert len(names) == 2 * n_best  # dev and test, one file per rank
    for name in names:
        assert (port_dir / name).read_text(encoding="utf-8") == \
            (jax_dir / name).read_text(encoding="utf-8"), name


def test_converted_jax_checkpoint_tests_like_jax(setup):
    tmp, _, cfg, params = setup
    jax_dir, port_dir = tmp / "jax_model", tmp / "port_ckpt"
    jax_dir.mkdir()
    port_dir.mkdir()
    opt_state = jax.tree.map(np.asarray, optax.adamw(1e-3).init(params))
    jax_save_checkpoint(jax_dir / "best.ckpt", {
        "model_state": params, "optimizer_state": opt_state, "scaler_state": None,
        "scheduler_state": {"step": 7, "rate": 1e-3},
        "train_iter_state": np.random.default_rng(3).bit_generator.state,
        "stats_state": {"epochs": 2, "steps": 7, "total_tokens": 10, "total_correct": 3,
                        "best_ckpt_score": np.float64(80.5), "best_ckpt_iter": 6}})
    jax_cfg = dict(copy.deepcopy(cfg), model_dir=str(jax_dir))
    jax_test(jax_cfg, output_path=str(jax_dir / "out"))

    # the conversion imports neither JAX nor optax
    code = ("import sys; from joeys2t_torch.convert import jax_checkpoint_to_port\n"
            f"jax_checkpoint_to_port({str(jax_dir / 'best.ckpt')!r}, "
            f"{str(port_dir / 'best.ckpt')!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'flax', 'joeys2t_tpu')]\nassert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
    ckpt = torch.load(port_dir / "best.ckpt", weights_only=True)
    assert ckpt["optimizer_state"] is None and ckpt["stats_state"]["best_ckpt_score"] == 80.5
    assert ckpt["train_iter_state"] == np.random.default_rng(3).bit_generator.state

    port_cfg = dict(copy.deepcopy(cfg), model_dir=str(port_dir))
    port_test(port_cfg, output_path=str(port_dir / "out"))
    for split in ("dev", "test"):
        port_lines = (port_dir / f"out.{split}").read_text(encoding="utf-8")
        assert port_lines == (jax_dir / f"out.{split}").read_text(encoding="utf-8")
        assert len(port_lines.splitlines()) == 8


def test_evaluation_tokenizer_and_wer_match_jax():
    rng = np.random.RandomState(4)
    words = ["Hello", "world", "it's", "U.S.A.", "3.14", "1,000", "co-op", "9-5", "&amp;",
             "<skipped>", "(paren)", "end.", "Quote\"", "naïve", "x/y", "--", "!", "a,b"]
    pairs = [(" ".join(rng.choice(words, size=rng.randint(0, 9))),
              " ".join(rng.choice(words, size=rng.randint(1, 9)))) for _ in range(60)]
    for tokenize in ("13a", "none"):
        for lowercase in (False, True):
            for no_punc in (False, True):
                kw = dict(lowercase=lowercase, tokenize=tokenize, no_punc=no_punc)
                port, ref = EvaluationTokenizer(**kw), JaxEvaluationTokenizer(**kw)
                for hyp, r in pairs:
                    assert port(hyp) == ref(hyp) and port(r) == ref(r), (kw, hyp, r)
                hyps, refs = zip(*pairs)
                assert wer(list(hyps), list(refs), port) == jax_wer(list(hyps), list(refs),
                                                                    ref)
    # intl and zh are ported (tests/test_torch_tooling.py); ja-mecab needs MeCab
    with pytest.raises(NotImplementedError):
        EvaluationTokenizer(tokenize="ja-mecab")


@pytest.mark.parametrize("keep,minimize", [(2, True), (3, False), (0, True)])
def test_checkpoint_manager_matches_jax(tmp_path, keep, minimize):
    """One sequence of validation scores, gated and flagged as the trainers
    do, leaves the same files and symlinks on disk after every save."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    port = CheckpointManager(port_dir, keep_best_ckpts=keep, minimize_metric=minimize)
    ref = JaxCheckpointManager(jax_dir, keep_best_ckpts=keep, minimize_metric=minimize)
    best = math.inf if minimize else -math.inf
    scores = [5.0, 3.0, 4.0, 1.0, 6.0, 2.0, 2.5, 0.5, float("nan")]
    for step, score in enumerate(scores, 1):
        final = math.isnan(score)
        new_best = not final and (score < best if minimize else score > best)
        best = score if new_best else best
        key = -score if minimize else score
        is_better = not port.ckpt_queue or key > port.ckpt_queue[0][0]
        if final or keep < 0 or is_better:
            port.save(step, {"step": torch.tensor(step)}, new_best, score)
            ref.save(step, {"step": np.asarray(step)}, new_best, score)

        def listing(d):
            return sorted((p.name, os.readlink(p) if p.is_symlink() else None)
                          for p in d.iterdir())

        assert listing(port_dir) == listing(jax_dir), step
        assert [k for k, _ in sorted(port.ckpt_queue)] == [k for k, _ in
                                                           sorted(ref.ckpt_queue)]


@pytest.mark.parametrize("n_best,lowercase", [(1, False), (2, True)])
def test_evaluate_matches_jax(n_best, lowercase):
    """``evaluate`` scores decoded hypotheses as the JAX one does, picking the
    1-best of each n-best group."""
    from types import SimpleNamespace

    from joeys2t_torch.config import TestConfig
    from joeys2t_torch.prediction import evaluate
    from joeys2t_tpu.config import TestConfig as JaxTestConfig
    from joeys2t_tpu.prediction import evaluate as jax_evaluate

    class Detok:
        def post_process(self, t, generate_unk=True):
            return t if isinstance(t, str) else " ".join(t)

    refs = ["The cat, sat.", "a b c d", "Hello World!", "x"]
    data = SimpleNamespace(trg_lang="trg", tokenizer={"trg": Detok()}, trg=refs)
    best = ["the cat sat.", "a b d", "Hello World!", "y z"]
    hyps = [h for b in best for h in ([b] + ["q"] * (n_best - 1))]
    kw = dict(load_model=None, batch_size=2, batch_type="sentence", max_output_length=-1,
              min_output_length=1,
              eval_metrics=["token_accuracy", "sequence_accuracy", "wer"],
              sacrebleu_cfg={"lowercase": lowercase}, beam_size=n_best, beam_alpha=1.0,
              n_best=n_best, return_attention=False, return_prob="none", generate_unk=True,
              repetition_penalty=-1, no_repeat_ngram_size=-1)
    scores, out_refs = evaluate({}, hyps, data, TestConfig(**kw))
    ref_scores, ref_refs = jax_evaluate({}, hyps, data, JaxTestConfig(**kw))
    assert out_refs == ref_refs == refs
    assert scores == ref_scores and set(scores) == set(kw["eval_metrics"])


def test_checkpoint_helpers_match_jax(tmp_path):
    """Symlink rotation, checkpoint lookup, the n-best reverse index and the
    n-best hypothesis files behave as the JAX helpers."""
    from joeys2t_torch import helpers
    from joeys2t_tpu import helpers as jax_helpers

    results = {}
    for name, mod in (("port", helpers), ("jax", jax_helpers)):
        d = tmp_path / name
        d.mkdir()
        for step in (1, 2):
            (d / f"{step}.ckpt").write_bytes(b"x")
        assert mod.get_latest_checkpoint(d).name in ("1.ckpt", "2.ckpt")
        prev = [mod.latest_checkpoint_update(d / f"{s}.ckpt", "latest.ckpt") for s in (1, 2)]
        latest = mod.get_latest_checkpoint(d)
        resolved = [mod.resolve_ckpt_path(None, d)]
        (d / "best.ckpt").symlink_to("1.ckpt")
        resolved += [mod.resolve_ckpt_path(None, d), mod.resolve_ckpt_path(d / "2.ckpt", d)]
        mod.save_hypothese(d / "hyps.txt", ["a", "b", "c", "d"], n_best=2)
        mod.save_hypothese(d / "one.txt", ["a", "b"], n_best=1)
        results[name] = (
            [None if p is None else p.name for p in prev], latest.name,
            [p.name for p in resolved],
            [mod.expand_reverse_index([2, 0, 1], n) for n in (1, 3)],
            sorted((p.name, p.read_text()) for p in d.glob("*.txt")),
            os.readlink(d / "latest.ckpt"))
    assert results["port"] == results["jax"]
    with pytest.raises((FileNotFoundError, AssertionError)):
        helpers.resolve_ckpt_path(None, tmp_path)
