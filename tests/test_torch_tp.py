# coding: utf-8
"""Tensor parallelism (``training: model_parallel``) on the CPU: gloo ranks
against one process and against the JAX package's (data, model) mesh.

- The set of sharded tensors and their split dims equal JAX's
  ``tp_param_shardings`` through the converter's names, for the
  transformer, the Conformer and a mixture-of-experts encoder.
- One update on four gloo ranks, model 2 x data 2 (rank r: data rank
  r // 2, model rank r % 2), float32 at dropout 0: the
  loss and the gradients before clipping (gathered) equal the JAX
  package's ``shard_params_tp`` on ``get_mesh(4, model_parallel=2)`` on the
  union of the data ranks' rows, and the weights after the update; plain,
  with ``sequence_parallel`` (sequences the group does not divide, padded),
  and with 4 experts, 2 a rank; and a Conformer speech model with
  ``sequence_parallel`` (63 subsampled frames) against the port's single
  process.
- ``TrainManager`` from the reverse task's config with ``model_parallel: 2``
  (two ranks): the first update's weights equal the port's single process
  and the JAX ``TrainManager`` on its (data 4, model 2) mesh, the greedy
  validation's hypotheses the single process's, and the checkpoint loads
  in a single-process ``test``; at dropout 0.1 every replicated parameter
  is bit-identical on the model ranks after two updates.
- The layouts JAX refuses raise by name.

The ranks run as subprocesses of this file (``tests/test_torch_ddp.py``'s
``launch``); they import no JAX.
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from joeys2t_torch.config import ConfigurationError, SpecialSymbols, parse_train_args
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.losses import build_loss_function
from joeys2t_torch.models import build_model
from joeys2t_torch.parallel import distributed, tp
from joeys2t_torch.training import TrainManager
from joeys2t_torch.vocabulary import Vocabulary
from test_torch_ddp import EOS, PAD, TRAINING, close, launch, split, text_rows

REPO = Path(__file__).resolve().parents[1]
SIDE = {"type": "transformer", "num_layers": 2, "num_heads": 2, "hidden_size": 16,
        "ff_size": 32, "dropout": 0.0, "layer_norm": "pre",
        "embeddings": {"embedding_dim": 16, "scale": True}}
TOKENS = [f"t{i}" for i in range(40)]


def tp_cfg(variant: str) -> dict:
    """tests/test_tensor_parallel.py's model (2 + 2 layers of hidden 16, 2
    heads, feed-forward 32) as a text model; "experts": 4 experts in each
    encoder layer; "sequence_parallel": the model key set."""
    cfg = {"initializer": "xavier_uniform", "attention_impl": "xla",
           "encoder": dict(SIDE), "decoder": dict(SIDE)}
    if variant == "experts":
        cfg["encoder"]["num_experts"] = 4
    if variant == "sequence_parallel":
        cfg["sequence_parallel"] = True
    return cfg


VARIANTS = ["plain", "sequence_parallel", "experts"]


# ------------------------------------------------------------ the split
def conformer_cfg() -> dict:
    return {"encoder": {"type": "conformer", "num_layers": 2, "num_heads": 2,
                        "hidden_size": 16, "ff_size": 32, "dropout": 0.0,
                        "in_channels": 8, "conv_channels": 16, "conv_kernel_sizes": [3, 3],
                        "depthwise_conv_kernel_size": 7, "layer_norm": "pre",
                        "embeddings": {"embedding_dim": 8}},
            "decoder": dict(SIDE)}


@pytest.mark.parametrize("variant", ["transformer", "conformer", "experts"])
def test_sharded_tensors_match_jax(variant):
    """The port's sharded tensors and split dims are JAX's ``_spec_for``'s:
    each JAX leaf is marked with its index, carried to the port's name by
    the converter, and a flax kernel's (in, out) split is a torch weight's
    (out, in) one the other way round."""
    from jax.sharding import PartitionSpec as P

    from joeys2t_torch.convert import flax_params_to_state_dict
    from joeys2t_tpu.convert import torch_state_dict_to_flax
    from joeys2t_tpu.parallel import get_mesh
    from joeys2t_tpu.parallel.tp import tp_param_shardings

    vocab = Vocabulary(TOKENS, SpecialSymbols())
    if variant == "conformer":
        model, _ = build_model(conformer_cfg(), trg_vocab=vocab, device="cpu")
    else:
        model, _ = build_model(tp_cfg("experts" if variant == "experts" else "plain"),
                               src_vocab=vocab, trg_vocab=vocab, device="cpu")
    tree = torch_state_dict_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    leaves = []

    def mark(x):
        leaves.append(x)
        return np.full(np.shape(x), len(leaves) - 1, np.float32)

    import jax

    marked = jax.tree.map(mark, tree)
    specs = jax.tree.leaves(tp_param_shardings(tree, get_mesh(4, model_parallel=2)),
                            is_leaf=lambda x: hasattr(x, "spec"))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    want = {}
    for name, value in flax_params_to_state_dict(marked).items():
        i = int(value.flatten()[0])
        spec = specs[i].spec
        if spec == P():
            continue
        dim = list(spec).index("model")
        if paths[i].endswith("['kernel']") and np.ndim(leaves[i]) == 2:
            dim = 1 - dim
        want[name] = dim
    got = {n: tp.split_dim(n) for n in model.state_dict() if tp.split_dim(n) is not None}
    assert got == want and got


# ------------------------------------------------------ one update, 4 ranks
def speech_sp_job():
    """A Conformer speech model under ``sequence_parallel``: four
    utterances of at most 250 frames (63 after subsampling, which the model
    group does not divide), with the same weights on every rank."""
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    cfg = conformer_cfg()
    cfg["encoder"].update(in_channels=80, conv_kernel_sizes=[5, 5])
    cfg["sequence_parallel"] = True
    model, _ = build_model(cfg, trg_vocab=vocab, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    rng = np.random.RandomState(8)
    src_len, trg_len = np.array([250, 201, 150, 230]), np.array([7, 5, 3, 6])
    src = rng.randn(4, 250, 80).astype(np.float32)
    trg = np.full((4, 7), PAD)
    for r in range(4):
        src[r, src_len[r]:] = 1.0
        trg[r, 0], trg[r, trg_len[r] - 1] = 2, EOS
        trg[r, 1:trg_len[r] - 1] = rng.randint(4, 40, size=trg_len[r] - 2)
    micro = [(src, src_len, trg, trg_len)]
    return dict(cfg=cfg, state=model.state_dict(), task="S2T",
                training=dict(TRAINING, normalization="tokens", loss="crossentropy-ctc",
                              ctc_weight=0.3),
                rows=split(micro), union=micro)

def update_job(variant: str):
    """(JAX's update on the union rows with its TP placement, the job of
    the port's ranks)."""
    import jax

    from joeys2t_torch.convert import flax_params_to_state_dict
    from joeys2t_tpu.config import SpecialSymbols as JaxSymbols
    from joeys2t_tpu.models import build_model as jax_build_model
    from joeys2t_tpu.models.initialization import initialize_model
    from joeys2t_tpu.parallel import get_mesh
    from joeys2t_tpu.parallel.mesh import set_default_mesh
    from joeys2t_tpu.parallel.tp import shard_params_tp
    from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
    from test_torch_ddp import jax_update

    cfg = tp_cfg(variant)
    jv = JaxVocabulary(TOKENS, JaxSymbols())
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    import jax.numpy as jnp

    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0)}, jnp.ones((2, 5), jnp.int32),
        jnp.ones((2, 4), jnp.int32), jnp.full((2,), 5), jnp.ones((2, 1, 5), bool),
        jnp.ones((2, 1, 4), bool))["params"]
    params = initialize_model(params, cfg, PAD, PAD, jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(
        np.float32), params)
    micro = text_rows(6, 7, 43, n_micro=1)
    training = dict(TRAINING, normalization="tokens")
    ctx = get_mesh(4, model_parallel=2)
    set_default_mesh(ctx)  # the sequence-parallel constraint reads it
    try:
        ref = jax_update(jmodel, jspec, shard_params_tp(params, ctx), training, micro, "MT")
    finally:
        set_default_mesh(None)
    job = dict(cfg=cfg, state=flax_params_to_state_dict(params), training=training,
               rows=split(micro))
    return ref, job


_RESULTS: dict = {}


def tp_results(tmp: Path) -> dict:
    """variant -> (the four ranks' results, JAX's), computed once."""
    if _RESULTS:
        return _RESULTS
    refs, jobs = {}, {}
    for variant in VARIANTS:
        refs[variant], jobs[variant] = update_job(variant)
    jobs["conformer_sp"] = speech_sp_job()
    refs["conformer_sp"] = tp_update(jobs["conformer_sp"], jobs["conformer_sp"]["union"], 1)
    torch.save(jobs, tmp / "job.pt")
    launch([__file__, "update", tmp / "job.pt", tmp], tmp, world=4)
    ranks = [torch.load(tmp / f"update{r}.pt", weights_only=False) for r in range(4)]
    _RESULTS.update({v: ([r[v] for r in ranks], refs[v]) for v in jobs})
    return _RESULTS


@pytest.mark.parametrize("variant", VARIANTS + ["conformer_sp"])
def test_model_2_by_data_2_equals_jax(tmp_path_factory, variant):
    """Loss, gathered gradients before clipping and weights after the update
    of every rank equal JAX's tensor-parallel update to 1e-5 (the Conformer:
    the port's single process's)."""
    ranks, ref = tp_results(tmp_path_factory.mktemp("tp"))[variant]
    for got in ranks:
        close(got, ref, 1e-5, TRAINING["learning_rate"])
        for name, shape in got["shapes"].items():  # each rank trained on its shards
            want = list(ref["params"][name].shape)
            if tp.split_dim(name) is not None:
                want[tp.split_dim(name)] //= 2
            assert list(shape) == want, name


# ------------------------------------------- TrainManager from the config
def reverse_cfg(tmp: Path) -> dict:
    """tests/test_tensor_parallel.py's reverse-task run: 64 / 8 / 8
    generated pairs, configs/transformer_reverse.yaml cut to 2 + 2 layers of
    hidden 16, 2 heads, feed-forward 32, dropout 0, batches of 16, one
    update a batch; on the CPU."""
    sys.path.insert(0, str(REPO / "scripts"))
    from generate_reverse_task import generate_samples

    from joeys2t_torch.config import load_config

    data = tmp / "data"
    data.mkdir(exist_ok=True)
    for name, n, seed in [("train", 64, 1), ("dev", 8, 2), ("test", 8, 3)]:
        src, trg = generate_samples(n, high=10, min_len=3, max_len=8, seed=seed)
        (data / f"{name}.src").write_text("\n".join(src) + "\n")
        (data / f"{name}.trg").write_text("\n".join(trg) + "\n")
    cfg = load_config(REPO / "configs" / "transformer_reverse.yaml")
    cfg["use_cuda"] = False
    cfg["data"].update(train=str(data / "train"), dev=str(data / "dev"),
                       test=str(data / "test"), sample_train_subset=-1,
                       sample_dev_subset=-1)
    cfg["training"].update(epochs=1, validation_freq=10, logging_freq=10, batch_size=16,
                           batch_multiplier=1, keep_best_ckpts=1)
    cfg["model"]["attention_impl"] = "xla"
    for side in ("encoder", "decoder"):
        cfg["model"][side].update(num_layers=2, num_heads=2, hidden_size=16, ff_size=32,
                                  dropout=0.0)
        cfg["model"][side]["embeddings"]["embedding_dim"] = 16
    return cfg


def jax_first_update(cfg: dict, model_dir: Path, **layout) -> tuple:
    """The JAX ``TrainManager`` with ``layout`` (on its 8 devices) from
    ``cfg``: (its initial weights, its weights after one train step on the
    first unshuffled batch of 16), as port state dicts."""
    import jax

    from joeys2t_torch.convert import flax_params_to_state_dict
    from joeys2t_tpu.config import parse_global_args, set_validation_args
    from joeys2t_tpu.helpers import make_model_dir
    from joeys2t_tpu.parallel.mesh import set_default_mesh
    from joeys2t_tpu.prediction import prepare
    from joeys2t_tpu.training import TrainManager as JaxTrainManager

    cfg = copy.deepcopy(cfg)
    cfg["model_dir"] = str(model_dir)
    cfg["training"].update(layout)
    make_model_dir(model_dir)
    args = parse_global_args(cfg, rank=0, mode="train")
    model, spec, params, loss_fn, train_data, _, _ = prepare(args, rank=0, mode="train")
    start = flax_params_to_state_dict(jax.device_get(params))
    trainer = JaxTrainManager(
        model=model, spec=spec, params=params, loss_fn=loss_fn, model_dir=args.model_dir,
        task=args.task, seed=args.seed, train_args=args.train,
        dev_args=set_validation_args(args.test), num_workers=0, model_cfg=args.model)
    try:
        it, _ = train_data.make_iter(batch_size=16, batch_type="sentence", seed=7,
                                     shuffle=False, num_workers=0, eos_index=spec.eos_index,
                                     pad_index=spec.pad_index, return_sampler=True)
        _, _, arrays, norm = trainer._prepare_batch(next(iter(it)))
        new, _, _ = trainer._jit_train_step(trainer.params, trainer.opt_state,
                                            jax.random.PRNGKey(0), arrays, norm)
        after = flax_params_to_state_dict(jax.device_get(new))
    finally:
        set_default_mesh(None)
    return start, after


def port_first_update(cfg: dict, state: dict, model_dir: Path, updates: int = 1):
    """The port's ``TrainManager`` from ``cfg`` (with ``state``) in this
    process or as a rank: ``updates`` updates on the first unshuffled
    batches of 16, then a greedy validation (``<updates>.ckpt`` and
    ``.hyps``); returns (the manager, the weights after the first update,
    the gradients before clipping of the first update)."""
    from joeys2t_torch.config import parse_global_args, set_validation_args
    from joeys2t_torch.prediction import prepare

    cfg = copy.deepcopy(cfg)
    cfg["model_dir"] = str(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    args = parse_global_args(cfg, rank=distributed.rank(), mode="train")
    model, spec, loss_fn, train_data, dev_data, _ = prepare(
        args, rank=distributed.rank(), mode="train")
    model.load_state_dict(state, strict=True)
    tm = TrainManager(model, spec, loss_fn, args.train, seed=args.seed, model_cfg=args.model,
                      device="cpu", model_dir=args.model_dir, task=args.task,
                      dev_args=set_validation_args(args.test))
    grads, reduce = {}, tm.reduce_gradients

    def capture():
        reduce()
        if not grads:
            grads.update({n: g.clone() for n, g in tm.full_gradients().items()})

    tm.reduce_gradients = capture
    it = train_data.make_iter(batch_size=16, batch_type="sentence", seed=7, shuffle=False,
                              eos_index=spec.eos_index, pad_index=spec.pad_index)
    first = None
    for _, batch in zip(range(updates), it):
        tm.train_batch(batch)
        if first is None:
            tm._sync_model()
            first = {n: p.detach().clone() for n, p in model.state_dict().items()}
    tm._validate(dev_data)
    return tm, first, grads


def check_first_update(got: dict, got_grads: dict, single: dict, single_grads: dict,
                       jax_after: dict, start: dict, lr: float) -> None:
    """The layout's first update against one process (the gradients before
    clipping to 1e-5 of their norm) and the weights against one process's
    and JAX's to 1e-5, plus what Adam's first step makes of that tolerance
    where a gradient is near its eps (``test_torch_ddp.close``: the key
    biases, whose gradient is zero but for rounding)."""
    close(dict(loss=1.0, grads=got_grads, params=got),
          dict(loss=1.0, grads=single_grads, params=single), 1e-5, lr)
    close(dict(loss=1.0, grads=got_grads, params=got),
          dict(loss=1.0, grads=single_grads, params=jax_after), 1e-5, lr)
    assert any(not torch.equal(got[n], start[n]) for n in start)


_MANAGER: dict = {}


def manager_results(tmp: Path, key: str) -> dict:
    """``TrainManager`` with ``{key: 2}`` on two ranks, one process and JAX
    on the reverse task, computed once a key."""
    if key in _MANAGER:
        return _MANAGER[key]
    cfg = reverse_cfg(tmp)
    start, jax_after = jax_first_update(cfg, tmp / "jax", **{key: 2})
    single_tm, single, single_grads = port_first_update(cfg, start, tmp / "single")
    dropout = copy.deepcopy(cfg)
    for side in ("encoder", "decoder"):
        dropout["model"][side]["dropout"] = 0.1
    job = dict(cfg=cfg, key=key, state=start, dropout=dropout)
    torch.save(job, tmp / "manager.pt")
    launch([__file__, "manager", tmp / "manager.pt", tmp], tmp)
    ranks = [torch.load(tmp / f"manager{r}.pt", weights_only=False) for r in range(2)]
    hyps = {tag: (tmp / tag / "1.hyps").read_text().splitlines() for tag in ("single", key)}
    _MANAGER[key] = dict(start=start, jax=jax_after, single=single, ranks=ranks, hyps=hyps,
                         single_grads=single_grads, cfg=cfg, tmp=tmp)
    return _MANAGER[key]


def test_train_manager_model_parallel_from_config(tmp_path_factory):
    """``model_parallel: 2`` through the trainer: the first update's weights
    equal one process's and JAX's on its (data 4, model 2) mesh; its
    gradients equal one process's; the greedy validation's hypotheses equal
    one process's; the checkpoint is whole, a single-process ``test``
    reads it and decodes as the validation did, and resuming from it gives
    each rank its shards and Adam moments back."""
    from joeys2t_torch.prediction import test

    r = manager_results(tmp_path_factory.mktemp("manager"), "model_parallel")
    for rank in r["ranks"]:
        check_first_update(rank["first"], rank["grads"], r["single"], r["single_grads"],
                           r["jax"], r["start"], r["cfg"]["training"]["learning_rate"])
    assert r["hyps"]["model_parallel"] == r["hyps"]["single"]
    assert all(rank["resumed"] for rank in r["ranks"])
    cfg = copy.deepcopy(r["cfg"])
    cfg["model_dir"] = str(r["tmp"] / "model_parallel")
    cfg["testing"]["load_model"] = str(r["tmp"] / "model_parallel" / "1.ckpt")
    out = r["tmp"] / "tested"
    test(cfg, output_path=str(out))
    assert (out.parent / "tested.dev").read_text().splitlines() == r["hyps"]["single"]


def test_dropout_keeps_replicated_weights_identical_on_model_ranks(tmp_path_factory):
    """At dropout 0.1 under ``model_parallel: 2`` every replicated parameter
    is bit-identical on the two model ranks after two updates (the dropout
    generator seeded by data rank, every rank drawing the same shapes)."""
    r = manager_results(tmp_path_factory.mktemp("manager"), "model_parallel")
    a, b = (rank["dropout"] for rank in r["ranks"])
    replicated = [n for n in a if tp.split_dim(n) is None]
    assert replicated and all(torch.equal(a[n], b[n]) for n in replicated)
    moved = [n for n in replicated if not torch.equal(a[n], r["start"][n])]
    assert len(moved) > len(replicated) // 2


# ------------------------------------------------------------- negatives
def test_layouts_jax_refuses_raise_by_name():
    """A world that model_parallel does not divide (here one process, as
    plain ``train`` is), tensor with pipeline parallelism."""
    with pytest.raises(ConfigurationError, match="model_parallel=2"):
        distributed.set_layout(model_parallel=2)
    with pytest.raises(ConfigurationError, match="pipeline_parallel"):
        parse_train_args(dict(TRAINING, model_parallel=2, pipeline_parallel=2))
    with pytest.raises(ConfigurationError, match="mutually exclusive"):
        distributed.set_layout(model_parallel=2, pipeline_parallel=2)


# --------------------------------------------------------------- workers
def tp_update(job: dict, rows: list, model_parallel: int) -> dict:
    """One update of ``job``'s model on ``rows`` (this rank's, or all of
    them in one process) with ``model_parallel``: the loss over the data
    ranks, the gradients before clipping and the weights after, whole, and
    the shapes this process trained."""
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    task = job.get("task", "MT")
    model, spec = build_model(job["cfg"], src_vocab=vocab if task == "MT" else None,
                              trg_vocab=vocab, device="cpu")
    model.load_state_dict(job["state"], strict=True)
    args = parse_train_args(dict(job["training"], model_parallel=model_parallel))
    tm = TrainManager(model, spec, build_loss_function(args, spec), args,
                      model_cfg=job["cfg"], device="cpu", task=task)
    seen, reduce = {}, tm.reduce_gradients

    def capture():
        reduce()
        seen["grads"] = {n: g.clone() for n, g in tm.full_gradients().items()}

    tm.reduce_gradients = capture
    src, src_len, trg, trg_len = rows[0]
    out = tm.train_batch(Batch(src, src_len, None, trg, trg_len, None, np.arange(len(src)),
                               PAD, EOS, task=task))
    tm._sync_model()
    return dict(shapes={n: tuple(p.shape) for n, p in tm.net.named_parameters()},
                loss=distributed.all_reduce_counts([out["loss"].item()])[0],
                grads=seen["grads"],
                params={n: p.detach().clone() for n, p in model.named_parameters()})


def worker_update(job_path: Path, out: Path) -> None:
    """Each variant's update on this rank's data rows, model_parallel 2."""
    jobs = torch.load(job_path, weights_only=False)
    results = {variant: tp_update(job, job["rows"][distributed.rank() // 2], 2)
               for variant, job in jobs.items()}
    torch.save(results, out / f"update{distributed.rank()}.pt")


def worker_manager(job_path: Path, out: Path) -> None:
    """The trainer with ``{key: 2}`` from the job's config on this rank;
    then at dropout 0.1, two updates, and this rank's trained parameters."""
    from joeys2t_torch.config import parse_global_args
    from joeys2t_torch.prediction import prepare

    job = torch.load(job_path, weights_only=False)
    cfg = copy.deepcopy(job["cfg"])
    cfg["training"][job["key"]] = 2
    tm, first, grads = port_first_update(cfg, job["state"], out / job["key"])
    # resuming from the whole checkpoint gives this rank its shards and moments again
    cfg = dict(cfg, model_dir=str(out / job["key"]))
    cfg["training"] = dict(cfg["training"], load_model=str(out / job["key"] / "1.ckpt"))
    args = parse_global_args(cfg, rank=distributed.rank(), mode="train")
    model, spec, loss_fn, _, _, _ = prepare(args, rank=distributed.rank(), mode="train")
    resumed = TrainManager(model, spec, loss_fn, args.train, seed=args.seed,
                           model_cfg=args.model, device="cpu", task=args.task)
    same = all(torch.equal(a, b) for a, b in zip(resumed.net.state_dict().values(),
                                                   tm.net.state_dict().values()))
    for p, q in zip(resumed.params, tm.params):
        mine, theirs = resumed.optimizer.state[p], tm.optimizer.state[q]
        same &= all(torch.equal(mine[k], theirs[k]) for k in ("exp_avg", "exp_avg_sq"))
    dropout = copy.deepcopy(job["dropout"])
    dropout["training"][job["key"]] = 2
    tm, _, _ = port_first_update(dropout, job["state"], out / f"{job['key']}_dropout",
                                 updates=2)
    trained = {n: p.detach().clone() for n, p in tm.net.named_parameters()}
    torch.save(dict(first=first, grads=grads, dropout=trained, resumed=same),
               out / f"manager{distributed.rank()}.pt")


def worker_remat(job_path: Path, out: Path) -> None:
    """One update of the job's mixture-of-experts model without and with
    ``remat``, data-parallel (this rank's rows) and then under
    ``model_parallel: 2`` (every row)."""
    job = torch.load(job_path, weights_only=False)
    results = {}
    for mp, rows in ((1, job["rows"][distributed.rank()]), (2, job["union"])):
        for remat in (False, True):
            results[(mp, remat)] = tp_update(dict(job, cfg=dict(job["cfg"], remat=remat)),
                                             rows, mp)
    torch.save(results, out / f"remat{distributed.rank()}.pt")


WORKERS = {"update": worker_update, "manager": worker_manager, "remat": worker_remat}

if __name__ == "__main__":
    torch.set_num_threads(2)
    with distributed.process_group(use_cuda=False):
        WORKERS[sys.argv[1]](Path(sys.argv[2]), Path(sys.argv[3]))
