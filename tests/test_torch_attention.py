# coding: utf-8
"""Returned cross-attention, its files and plots, against the JAX package on
the CPU at float32.

- Transformer greedy: the port's ``transformer_greedy(return_attention=True)``
  against JAX's on the same seeded weights (test_torch_search.py's models:
  2 + 2 layers, hidden 128), tokens identical and the (B, L, S) attention
  to 1e-5 absolute; each row sums to 1 over the valid frames, is 0 past
  them and on finished rows, and the returning layer takes the plain math
  once a step.
- ``test -a`` on transformer_reverse.yaml's model (random seeded weights,
  no training): the port's and JAX's ``test`` on the same checkpoint write
  the same hypotheses and the same ``.att.<i>.png`` files, the attention of
  ``predict`` agrees to 1e-5 in dataset order, and the hub's
  ``attention_probs`` equal JAX's hub's.
- Validation of a recurrent model writes ``att.<step>.<i>.png`` for the
  ``print_valid_sents`` examples, as JAX's does, with the TensorBoard
  scalars and figures beside them (the recurrent greedy attention itself is
  held to JAX in tests/test_torch_rnn.py).
"""
import copy
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch.config import dump_yaml, load_config, parse_global_args
from joeys2t_torch.hub_interface import load_model_dir
from joeys2t_torch.models.modules import MultiHeadedAttention
from joeys2t_torch.plotting import store_attention_plots
from joeys2t_torch.prediction import predict, prepare
from joeys2t_torch.prediction import test as port_test
from joeys2t_torch.search import transformer_greedy
from joeys2t_tpu.checkpoints import save_checkpoint as jax_save_checkpoint
from joeys2t_tpu.convert import torch_state_dict_to_flax
from joeys2t_tpu.search import transformer_greedy as jax_transformer_greedy
from test_torch_data import few_threads  # noqa: F401 - fixture
from test_torch_model import TOKENS
from test_torch_mt import reverse_data_cfg, write_reverse_cut
from test_torch_search import models, with_eos_scale

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5  # float32 attention probabilities, port against JAX

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def pair():
    return models(TOKENS)


@pytest.mark.parametrize("eos_scale,max_len", [(1.0, 12), (1.6, 16)])
def test_transformer_greedy_attention_matches_jax(pair, eos_scale, max_len):
    enc, mask = pair["enc"], pair["mask"]

    def run(params, tmodel):
        ref = jax_transformer_greedy(params, pair["jmodel"], pair["jspec"],
                                     jnp.asarray(enc), jnp.asarray(mask), max_len,
                                     return_attention=True, return_prob="hyp")
        MultiHeadedAttention.weight_steps = 0
        stats = {}
        out = transformer_greedy(tmodel, pair["tspec"], torch.tensor(enc),
                                 torch.tensor(mask), max_len, device="cpu", stats=stats,
                                 return_attention=True, return_prob="hyp")
        return ref, out, stats["decode_steps"]

    (ids_j, _, att_j), (ids_t, _, att_t), steps = with_eos_scale(pair, eos_scale, run)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    assert att_t.dtype == np.float32 and att_t.shape == np.asarray(att_j).shape
    np.testing.assert_allclose(att_t, np.asarray(att_j), rtol=0, atol=ATOL)
    assert MultiHeadedAttention.weight_steps == steps  # the last layer's, once a step
    valid = mask[:, 0, :]
    for row, ids in zip(att_t, ids_t):
        eos = np.flatnonzero(ids == 3)
        live = (eos[0] + 1) if len(eos) else steps
        np.testing.assert_allclose(row[:live].sum(-1), 1.0, atol=1e-5)
        assert (row[live:] == 0).all()
    assert (att_t[~valid[:, None, :].repeat(att_t.shape[1], 1)] == 0).all()
    # no attention asked: the same tokens, no plain steps
    MultiHeadedAttention.weight_steps = 0
    plain = with_eos_scale(pair, eos_scale, lambda _, tmodel: transformer_greedy(
        tmodel, pair["tspec"], torch.tensor(enc), torch.tensor(mask), max_len,
        device="cpu"))
    np.testing.assert_array_equal(plain[0], ids_t)
    assert plain[2] is None and MultiHeadedAttention.weight_steps == 0


def _reverse_model_dirs(tmp_path):
    """transformer_reverse.yaml's model with seeded random weights in a port
    model directory (config, vocabularies, best.ckpt) and the same weights
    in a JAX one; returns (port cfg, JAX cfg)."""
    root = write_reverse_cut(tmp_path / "reverse", n_train=20, n_dev=5, n_test=4)
    cfg = load_config(REPO / "configs" / "transformer_reverse.yaml")
    cfg.update(use_cuda=False, model_dir=str(tmp_path / "model"), data=reverse_data_cfg(root))
    cfg["testing"].pop("load_model")
    cfg["testing"]["max_output_length"] = 12
    port_dir, jax_dir = Path(cfg["model_dir"]), tmp_path / "jax_model"
    port_dir.mkdir()
    jax_dir.mkdir()
    model = prepare(parse_global_args(copy.deepcopy(cfg), mode="train"), mode="train")[0]
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=gen))
    torch.save({"model_state": model.state_dict()}, port_dir / "best.ckpt")
    jax_save_checkpoint(jax_dir / "best.ckpt", {"model_state": torch_state_dict_to_flax(
        {k: v.numpy() for k, v in model.state_dict().items()})})
    jcfg = dict(copy.deepcopy(cfg), model_dir=str(jax_dir))
    for directory, c in ((port_dir, cfg), (jax_dir, jcfg)):
        for name in ("src_vocab.txt", "trg_vocab.txt"):
            (directory / name).write_bytes((port_dir / name).read_bytes())
        (directory / "config.yaml").write_text(dump_yaml(c), encoding="utf-8")
    return cfg, jcfg


def test_save_attention_matches_jax(tmp_path):
    """``test -a`` writes JAX's hypotheses and JAX's plot files; the
    attention ``predict`` returns equals JAX's in dataset order; the hub's
    ``score`` returns JAX's hub's attention and ``plot_attention`` draws."""
    from joeys2t_tpu.hub_interface import load_model_dir as jax_load_model_dir
    from joeys2t_tpu.prediction import predict as jax_predict
    from joeys2t_tpu.prediction import prepare as jax_prepare
    from joeys2t_tpu.prediction import test as jax_test
    from joeys2t_tpu.config import parse_global_args as jax_parse_global_args

    cfg, jcfg = _reverse_model_dirs(tmp_path)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port_test(copy.deepcopy(cfg), output_path=str(tmp_path / "port" / "out"),
              save_attention=True)
    jax_test(copy.deepcopy(jcfg), output_path=str(tmp_path / "jax" / "out"),
             save_attention=True)
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "out.dev.att.0.png" in port_files and "out.test.att.3.png" in port_files
    for split in ("dev", "test"):
        assert (tmp_path / "port" / f"out.{split}").read_text() == \
            (tmp_path / "jax" / f"out.{split}").read_text()

    args = parse_global_args(copy.deepcopy(cfg), mode="test")
    model, spec, loss_fn, _, dev, _ = prepare(args, mode="test")
    test_args = copy.deepcopy(args.test).__class__(**dict(args.test.__dict__,
                                                          return_attention=True))
    port_att = predict(model, spec, dev, loss_fn=loss_fn, args=test_args, device="cpu")[5]
    jargs = jax_parse_global_args(copy.deepcopy(jcfg), mode="test")
    jmodel, jspec, params, jloss, _, jdev, _ = jax_prepare(jargs, mode="test")
    jtest_args = type(jargs.test)(**dict(jargs.test.__dict__, return_attention=True))
    jax_att = jax_predict(params, jmodel, jspec, jdev, loss_fn=jloss, args=jtest_args)[5]
    assert len(port_att) == len(jax_att) == 5
    for a, b in zip(port_att, jax_att):
        np.testing.assert_allclose(a, b[:, :a.shape[1]], rtol=0, atol=ATOL)

    lines = (Path(cfg["data"]["test"]).with_suffix(".src")).read_text().splitlines()[:3]
    hub, jhub = load_model_dir(cfg["model_dir"], use_cuda=False), jax_load_model_dir(
        jcfg["model_dir"])
    scored, jscored = hub.score(lines), jhub.score(lines)
    for out, ref in zip(scored, jscored):
        assert out.translation == ref.translation
        for a, b in zip(out.attention_probs, ref.attention_probs):
            np.testing.assert_allclose(a, np.asarray(b)[:, :np.asarray(a).shape[1]],
                                       rtol=0, atol=ATOL)
    hyp = scored[0].translation[0]
    rows, cols = len(hyp.split()) + 1, len(lines[0].split()) + 1  # tokens and eos
    att = np.zeros((rows, cols), np.float32)
    given = np.asarray(scored[0].attention_probs[0])[:rows, :cols]
    att[:given.shape[0], :given.shape[1]] = given
    fig = hub.plot_attention(lines[0], hyp, att)
    assert fig is not None
    assert hub.generate(lines, return_attention=True) == [s.translation[0] for s in scored]


def _events(directory: Path):
    """The (tag, value) scalars and the image tags of the TensorBoard event
    files under ``directory`` (TFRecord frames: length, crc, data, crc)."""
    from tensorboardX.proto import event_pb2

    scalars, images = [], []
    for path in sorted(directory.glob("events.out.tfevents.*")):
        data = path.read_bytes()
        pos = 0
        while pos < len(data):
            (length,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + length])
            pos += 12 + length + 4
            for value in event.summary.value:
                if value.HasField("image"):
                    images.append(value.tag)
                else:
                    scalars.append((value.tag, event.step))
    return scalars, images


def test_recurrent_validation_writes_plots_and_tensorboard(tmp_path):
    """A recurrent model's validation returns its attention whether asked or
    not, so it plots the ``print_valid_sents`` examples (0, 3 and 6 of the 5
    dev sentences: 0 and 3) at every validation, as JAX's does; rank 0's
    TensorBoard writer holds the training and validation scalars and the
    plots."""
    pytest.importorskip("tensorboardX")
    from joeys2t_torch.training import TrainManager

    root = write_reverse_cut(tmp_path / "reverse", n_train=24, n_dev=5, n_test=4)
    cfg = load_config(REPO / "configs" / "rnn_reverse.yaml")
    cfg.update(use_cuda=False, model_dir=str(tmp_path / "model"), data=reverse_data_cfg(root))
    cfg["training"].update(updates=2, validation_freq=1, logging_freq=1, batch_size=12,
                           batch_multiplier=1)
    for side in ("encoder", "decoder"):
        cfg["model"][side]["hidden_size"] = 16
    cfg["testing"]["max_output_length"] = 8
    Path(cfg["model_dir"]).mkdir()
    args = parse_global_args(copy.deepcopy(cfg), mode="train")
    model, spec, loss_fn, train_data, dev_data, _ = prepare(args, mode="train")
    tm = TrainManager(model, spec, loss_fn, args.train, seed=args.seed, model_cfg=args.model,
                      device="cpu", model_dir=args.model_dir, task="MT",
                      dev_args=args.test, num_workers=0)
    tm.train_and_validate(train_data, dev_data)
    plots = sorted(p.name for p in Path(cfg["model_dir"]).glob("att.*.png"))
    assert plots == ["att.1.0.png", "att.1.3.png", "att.2.0.png", "att.2.3.png"]
    scalars, images = _events(Path(cfg["model_dir"]) / "tensorboard")
    tags = {tag for tag, _ in scalars}
    assert {"train/batch_loss", "train/batch_acc", "train/learning_rate", "valid/bleu",
            "valid/ppl"} <= tags
    assert ("train/batch_loss", 2) in scalars
    assert sorted(set(images)) == ["attention/0.", "attention/3."]


def test_speech_plots_label_the_subsampled_frames(tmp_path):
    """A speech source labels its rows with the subsampled frames' indices up
    to the last attended one (JAX hands matplotlib the feature rows and
    writes nothing); a text source with its tokens, trimmed as JAX trims."""
    att = np.zeros((4, 9), np.float32)  # (steps, padded frames)
    att[:3, :6] = 1.0 / 6
    written = store_attention_plots([att], [["a", "b", "</s>"]],
                                    [np.ones((40, 80), np.float32)],
                                    str(tmp_path / "speech"), [0, 1])
    assert written == [str(tmp_path / "speech.0.png")]
    written = store_attention_plots([att], [["a", "b", "</s>"]], [["x", "y"]],
                                    str(tmp_path / "text"), [0])
    assert written == [str(tmp_path / "text.0.png")]
