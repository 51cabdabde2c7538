# coding: utf-8
"""The optimizers besides Adam, and ``freeze``, against optax and the JAX
package's chains on the CPU at float32.

- Each of sgd (with and without ``momentum``), adagrad, adadelta, rmsprop
  and adafactor, with and without weight decay, for 3 updates at changing
  rates on parameters of several shapes (adafactor: factored (256, 130),
  (130, 256) and (3, 128, 160), and unfactored ones), against
  ``joeys2t_tpu.optim.build_optimizer``'s chain: weights to 1e-6 relative;
  the state dict resumes the third update bit for bit.
- One speech model's trainer (test_torch_train.py's model and batches),
  two updates with global-norm clipping on (the norm is above the limit),
  against JAX's clip -> optimizer chain -> ``optax.masked(set_to_zero())``
  on the port's own gradients, for every optimizer, with the encoder frozen
  (tests/test_freeze.py's setting) and without: weights to 1e-6 relative,
  the frozen encoder bit-unchanged, the decoder moved, the clip factor the
  same as without ``freeze``.
- Adafactor under ``model_parallel: 2`` on two gloo ranks equals one
  process: the factored statistics and the block RMS are the whole
  parameter's; ``freeze`` under ``-d``, ``model_parallel: 2`` and
  ``pipeline_parallel: 2`` keeps the encoder bit-unchanged on every rank
  (the ranks run as subprocesses of this file).
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from joeys2t_torch import optim as port_optim
from joeys2t_torch.config import SpecialSymbols, parse_train_args
from joeys2t_torch.losses import build_loss_function
from joeys2t_torch.models import build_model
from joeys2t_torch.parallel import distributed
from joeys2t_torch.training import TrainManager, frozen_prefixes
from joeys2t_torch.vocabulary import Vocabulary
from test_torch_data import few_threads  # noqa: F401 - fixture
from test_torch_ddp import launch
from test_torch_train import TOKENS, TRAINING, micro_batches, model_cfg, port_batch

pytestmark = pytest.mark.usefixtures("few_threads")

RTOL, ATOL = 1e-6, 1e-7  # float32 weights, port against optax
OPTIMIZERS = [("sgd", {}), ("sgd", {"momentum": 0.9, "weight_decay": 0.01}),
              ("adagrad", {}), ("adagrad", {"weight_decay": 0.01}),
              ("adadelta", {}), ("adadelta", {"weight_decay": 0.01}),
              ("rmsprop", {}), ("rmsprop", {"weight_decay": 0.01}),
              ("adafactor", {}), ("adafactor", {"weight_decay": 0.01})]
SHAPES = [(256, 130), (130, 256), (3, 128, 160), (64, 127), (130,), (5, 7)]
RATES = [1e-2, 5e-3, 2e-2]


def _jax_chain(name, extra):
    from joeys2t_tpu.optim import build_optimizer

    return build_optimizer(dict({"optimizer": name, "learning_rate": RATES[0]}, **extra))


def _grads(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("name,extra", OPTIMIZERS)
def test_optimizer_matches_optax(name, extra):
    import jax.numpy as jnp
    import optax

    from joeys2t_tpu.optim import set_learning_rate

    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    tx = _jax_chain(name, extra)
    params = [jnp.asarray(p) for p in init]
    state = tx.init(params)
    port = [torch.nn.Parameter(torch.tensor(p)) for p in init]
    opt = port_optim.build_optimizer(dict({"optimizer": name, "learning_rate": RATES[0]},
                                          **extra), port)
    saved = None
    for step, rate in enumerate(RATES):
        grads = _grads(step + 1)
        set_learning_rate(state, rate)
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, params)
        params = optax.apply_updates(params, updates)
        port_optim.set_learning_rate(opt, rate)
        if step == 2:  # resume the last update from the state dict
            fresh = [torch.nn.Parameter(p.detach().clone()) for p in port]
            resumed = port_optim.build_optimizer({"optimizer": name, **extra}, fresh)
            resumed.load_state_dict(saved)
            port_optim.set_learning_rate(resumed, rate)
            for p, g in zip(fresh, grads):
                p.grad = torch.tensor(g)
            resumed.step()
        for p, g in zip(port, grads):
            p.grad = torch.tensor(g)
        opt.step()
        if step == 1:
            saved = copy.deepcopy(opt.state_dict())  # as a checkpoint holds it
        for got, want in zip(port, params):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                                       atol=ATOL)
    for got, again in zip(port, fresh):
        assert torch.equal(got, again)
    if name == "adafactor":
        factored = [st for st in opt.state.values() if "v_row" in st]
        assert len(factored) == 3


def test_frozen_prefixes_match_jax():
    """tests/test_freeze.py's ``frozen_prefixes`` cases."""
    from joeys2t_tpu.training import frozen_prefixes as jax_frozen_prefixes

    for cfg in ({"encoder": {"freeze": True, "embeddings": {}},
                 "decoder": {"embeddings": {"freeze": True}}},
                {}, {"decoder": {"freeze": True}, "encoder": {"embeddings": {"freeze": True}}}):
        assert frozen_prefixes(cfg) == jax_frozen_prefixes(cfg)


def _trainer_updates(name, extra, freeze, updates=2):
    """``updates`` updates of the trainer (two micro-batches each) from
    seeded weights: (the initial state, the gradients before clipping of
    each update, the weights after each, the global norms the clip saw)."""
    cfg = model_cfg()
    if freeze:
        cfg["encoder"] = dict(cfg["encoder"], freeze=True)
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    model, spec = build_model(cfg, trg_vocab=vocab, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    init = {n: p.detach().clone() for n, p in model.state_dict().items()}
    args = parse_train_args(dict(TRAINING, optimizer=name, clip_grad_norm=0.5,
                                 scheduling=None, **extra))
    tm = TrainManager(model, spec, build_loss_function(args, spec), args, model_cfg=cfg,
                      device="cpu")
    grads, weights, norms = [], [], []
    apply, clipper = tm.apply_accum, tm.clipper

    def capture():
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        apply()
        weights.append({n: p.detach().clone() for n, p in model.named_parameters()})

    def clip(g):
        norms.append(float(clipper(g)))

    tm.apply_accum, tm.clipper = capture, clip
    for mb in micro_batches(2 * updates):
        tm.train_batch(port_batch(*mb))
    assert tm.stats.steps == updates
    return init, grads, weights, norms


@pytest.mark.parametrize("name,extra", [OPTIMIZERS[1], OPTIMIZERS[3], OPTIMIZERS[5],
                                        OPTIMIZERS[7], OPTIMIZERS[9],
                                        ("adamw", {"weight_decay": 0.01})])
def test_trainer_update_with_freeze_matches_jax(name, extra):
    import jax
    import optax

    from joeys2t_torch.convert import flax_params_to_state_dict
    from joeys2t_tpu.config import parse_train_args as jax_parse_train_args
    from joeys2t_tpu.convert import torch_state_dict_to_flax
    from joeys2t_tpu.optim import build_gradient_clipper, build_optimizer, set_learning_rate
    from joeys2t_tpu.training import _freeze_mask

    init, grads, weights, norms = _trainer_updates(name, extra, freeze=True)
    _, _, _, free_norms = _trainer_updates(name, extra, freeze=False, updates=1)
    # the clip sees the frozen gradients: the same first norm as without freeze
    assert norms[0] == free_norms[0] and norms[0] > 0.5

    def flax(state):
        return torch_state_dict_to_flax({k: v.numpy() for k, v in state.items()})

    jargs = jax_parse_train_args(dict(TRAINING, optimizer=name, clip_grad_norm=0.5,
                                      scheduling=None, **extra))
    params = flax(init)
    # JAX's TrainConfig has no `momentum` field, so its trainer drops it;
    # its build_optimizer reads it from the config it is given
    tx = optax.chain(build_gradient_clipper(jargs.__dict__),
                     build_optimizer(dict(jargs.__dict__, momentum=extra.get("momentum", 0))))
    tx = optax.chain(tx, optax.masked(optax.set_to_zero(), _freeze_mask(params, {"encoder"})))
    state = tx.init(params)
    set_learning_rate(state[0][1], jargs.learning_rate)
    for step in range(2):
        updates, state = tx.update(flax(grads[step]), state, params)
        params = optax.apply_updates(params, updates)
        want = flax_params_to_state_dict(jax.tree.map(np.asarray, params))
        for n, got in weights[step].items():
            np.testing.assert_allclose(got.numpy(), want[n].numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=n)
    for n, got in weights[1].items():
        if n.startswith("encoder."):
            assert torch.equal(got, init[n]), n
    assert any(not torch.equal(got, init[n]) for n, got in weights[1].items()
               if n.startswith("decoder."))


# ------------------------------------------------- adafactor, model_parallel 2
def tp_job():
    from test_torch_ddp import text_rows, TRAINING as DDP_TRAINING

    side = {"type": "transformer", "num_layers": 1, "num_heads": 2, "hidden_size": 128,
            "ff_size": 256, "dropout": 0.0, "layer_norm": "pre",
            "embeddings": {"embedding_dim": 128, "scale": True}}
    cfg = {"initializer": "xavier_uniform", "attention_impl": "xla", "encoder": dict(side),
           "decoder": dict(side)}
    vocab = Vocabulary([f"t{i}" for i in range(40)], SpecialSymbols())
    model, _ = build_model(cfg, src_vocab=vocab, trg_vocab=vocab, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    training = dict(DDP_TRAINING, optimizer="adafactor", weight_decay=0.01,
                    learning_rate=1e-2, normalization="tokens")
    return dict(cfg=cfg, state=model.state_dict(), training=training,
                rows=text_rows(6, 7, 43, n_micro=1))


def adafactor_update(job: dict, model_parallel: int) -> dict:
    """``tp_update`` of ``job`` that also returns the optimizer's state
    gathered as a checkpoint holds it (by parameter name), and whether a
    fresh trainer that loads it takes back this rank's state bit for bit."""
    from joeys2t_torch.training import TrainManager as Manager
    from test_torch_tp import tp_update

    made = []
    init = Manager.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    Manager.__init__ = keep
    try:
        out = tp_update(job, job["rows"], model_parallel)
    finally:
        Manager.__init__ = init
    tm = made[0]
    state = tm._optimizer_state()
    names = dict(enumerate(tm._names))
    out["state"] = {names[i]: st for i, st in state["state"].items()}
    fresh = made[0].__class__.__new__(made[0].__class__)
    fresh.__dict__.update(tm.__dict__)
    fresh.optimizer = port_optim.build_optimizer(tm.args.__dict__, tm.params,
                                                 **_shards(tm))
    fresh._load_optimizer_state(state)
    out["reloaded"] = all(
        torch.equal(fresh.optimizer.state[p][k], v) for p in tm.params
        for k, v in tm.optimizer.state[p].items() if torch.is_tensor(v) and v.dim())
    return out


def _shards(tm) -> dict:
    dims = {p: d for p, d in zip(tm.params, tm._split) if d is not None}
    return dict(shard_dims=dims, shard_group=None if tm.tp is None else tm.tp.group,
                shard_world=1 if tm.tp is None else tm.tp.world)


def test_adafactor_model_parallel_equals_one_process(tmp_path):
    """Two ranks with ``model_parallel: 2`` take the update one process
    takes; the checkpoint's optimizer state, gathered, is one process's
    (the factored statistics whole: a row statistic along the split dim is
    the same on both ranks), and a trainer that loads it shards it back
    bit for bit."""
    job = tp_job()
    single = adafactor_update(job, 1)
    torch.save(job, tmp_path / "job.pt")
    launch([__file__, "adafactor", tmp_path / "job.pt", tmp_path], tmp_path, world=2)
    for r in range(2):
        got = torch.load(tmp_path / f"adafactor{r}.pt", weights_only=False)
        assert got["shapes"]["encoder.layers.0.feed_forward.pwff_layer.0.weight"] == (128, 128)
        assert got["reloaded"]
        for n, want in single["params"].items():
            if n.endswith("k_layer.bias"):
                # softmax ignores the key bias: its gradient is rounding, whose
                # sign adafactor's scale-free step takes (lr either way)
                continue
            np.testing.assert_allclose(got["params"][n].numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=n)
            for k, v in single["state"][n].items():
                if torch.is_tensor(v) and v.dim():
                    assert got["state"][n][k].shape == v.shape, (n, k)
                    # squared gradients: twice the gradients' 1e-5, on the
                    # tensor's own scale
                    np.testing.assert_allclose(got["state"][n][k].numpy(), v.numpy(),
                                               rtol=1e-4, atol=1e-4 * float(v.abs().max()),
                                               err_msg=f"{n} {k}")
    factored = [n for n, st in single["state"].items() if "v_row" in st]
    assert "encoder.layers.0.feed_forward.pwff_layer.0.weight" in factored


FREEZE_LAYOUTS = {"data parallel": {}, "model_parallel": {"model_parallel": 2},
                  "pipeline_parallel": {"pipeline_parallel": 2}}


def test_freeze_holds_on_every_rank_of_every_layout(tmp_path):
    """``freeze`` under ``-d`` (two data ranks), ``model_parallel: 2`` and
    ``pipeline_parallel: 2`` (tests/test_torch_tp.py's 2 + 2-layer model,
    clipping on): the encoder comes out bit-unchanged on every rank and
    the decoder moves, as on one process."""
    from test_torch_ddp import split, text_rows
    from test_torch_tp import tp_cfg

    cfg = tp_cfg("plain")
    cfg["encoder"]["freeze"] = True
    vocab = Vocabulary([f"t{i}" for i in range(40)], SpecialSymbols())
    model, _ = build_model(cfg, src_vocab=vocab, trg_vocab=vocab, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    micro = text_rows(6, 7, 43, n_micro=1)
    job = dict(cfg=cfg, state=model.state_dict(), union=micro, rows=split(micro),
               training={"optimizer": "adamw", "weight_decay": 0.01, "learning_rate": 1e-2,
                         "clip_grad_norm": 0.5, "batch_size": 2, "batch_type": "sentence",
                         "loss": "crossentropy", "normalization": "tokens"})
    torch.save(job, tmp_path / "job.pt")
    launch([__file__, "freeze", tmp_path / "job.pt", tmp_path], tmp_path, world=2)
    for r in range(2):
        got = torch.load(tmp_path / f"freeze{r}.pt", weights_only=False)
        assert sorted(got) == sorted(FREEZE_LAYOUTS)
        for name, params in got.items():
            for n, v in job["state"].items():
                if n.startswith("encoder."):
                    assert torch.equal(params[n], v), (name, r, n)
            assert any(not torch.equal(params[n], v) for n, v in job["state"].items()
                       if n.startswith("decoder.")), (name, r)


def worker_freeze(job_path: Path, out: Path) -> None:
    from test_torch_tp import tp_update

    job = torch.load(job_path, weights_only=False)
    results = {}
    for name, layout in FREEZE_LAYOUTS.items():
        rows = job["rows"][distributed.rank()] if not layout else job["union"]
        layout_job = dict(job, training=dict(job["training"],
                                             **{k: v for k, v in layout.items()
                                                if k != "model_parallel"}))
        results[name] = tp_update(layout_job, rows, layout.get("model_parallel", 1))["params"]
    torch.save(results, out / f"freeze{distributed.rank()}.pt")


def worker_adafactor(job_path: Path, out: Path) -> None:
    job = torch.load(job_path, weights_only=False)
    torch.save(adafactor_update(job, 2), out / f"adafactor{distributed.rank()}.pt")


if __name__ == "__main__":
    torch.set_num_threads(2)
    with distributed.process_group(use_cuda=False):
        {"adafactor": worker_adafactor, "freeze": worker_freeze}[sys.argv[1]](
            Path(sys.argv[2]), Path(sys.argv[3]))
