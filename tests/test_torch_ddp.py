# coding: utf-8
"""Data-parallel training on the CPU: two gloo ranks against one process
and against the JAX package.

Each multi-process test starts its ranks as subprocesses of this file
(``python tests/test_torch_ddp.py <worker> <job> <dir>``) with torchrun's
variables set, so they join through ``distributed.process_group`` as a
``-d`` run does; every rank's wait has a timeout of its own (``TIMEOUT``
seconds), so a hang fails the test instead of stalling the suite. The
workers import neither JAX nor the JAX package.

- ``ShardedSubsetSampler``: world 2 and 3, every rank, two epochs, the same
  indices as the JAX package's.
- One update on two ranks, float32 at dropout 0, for a speech transformer
  (cross-entropy only, so its CTC head takes no gradient), a transformer MT
  model with ``batch_multiplier`` 1 and 2 and ``normalization`` batch and
  tokens, the recurrent rnn_reverse model (its LSTM ``bias_hh`` halves take
  no gradient) and a mixture-of-experts model (its load-balance term over
  the global batch): rank r holds rows r and r + 2 of each micro-batch of
  four. The loss, the gradients before clipping and the parameters after
  the update equal the port's single-process update on the four rows and
  the JAX package's (1e-6 and 1e-5; parameters as Adam's first step allows
  within the gradients' tolerance, as tests/test_torch_moe.py bounds them).
- Sharded ``predict``, greedy and beam 5, and ``test``: in ``predict_*``
  and ``lockstep`` of tests/test_torch_ddp_loop.py.
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from joeys2t_torch.config import SpecialSymbols, parse_train_args
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.data.samplers import ShardedSubsetSampler
from joeys2t_torch.losses import build_loss_function
from joeys2t_torch.models import build_model
from joeys2t_torch.parallel import distributed
from joeys2t_torch.training import TrainManager
from joeys2t_torch.vocabulary import Vocabulary

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300  # seconds a multi-process test waits for its ranks
PAD, BOS, EOS = 1, 2, 3


# --------------------------------------------------------------- launching
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv, tmp: Path, world: int = 2):
    """Run ``python argv`` as ranks 0..world-1 of a gloo group (torchrun's
    variables), wait at most ``TIMEOUT`` seconds, and fail with the ranks'
    errors if one fails (the others are stopped then) or the wait runs
    out."""
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        rank_env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
        out, err = (open(tmp / f"rank{r}.{k}", "w+", encoding="utf-8")
                    for k in ("out", "err"))
        logs.append((out, err))
        procs.append(subprocess.Popen([sys.executable, *map(str, argv)],
                                      cwd=REPO, env=rank_env, stdout=out, stderr=err))
    deadline = time.monotonic() + TIMEOUT
    # a rank that fails leaves the others waiting for it: stop them at once
    while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
        if time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if any(p.poll() is None for p in procs):
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"ranks stopped ({[p.returncode for p in procs]}) after one failed or "
                    f"{TIMEOUT} s ran out: {read_logs(logs)}")
    text = read_logs(logs)
    for out, err in logs:
        out.close()
        err.close()
    assert all(p.returncode == 0 for p in procs), text


def read_logs(logs) -> str:
    text = []
    for r, (_, err) in enumerate(logs):
        err.seek(0)
        text.append(f"--- rank {r} stderr ---\n{err.read()[-4000:]}")
    return "\n".join(text)


# ----------------------------------------------------------------- sampler
class _Source:
    def __init__(self, n: int):
        self.indices = list(range(n))
        self.random_subset = -1

    def __len__(self):
        return len(self.indices)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sharded_sampler_matches_jax(world, shuffle):
    """Every rank's indices over two epochs (the cut list carries over to
    the next epoch's permutation) equal the JAX package's sampler's."""
    from joeys2t_tpu.data.samplers import ShardedSubsetSampler as JaxSampler

    for rank in range(world):
        port, ref = (cls(_Source(23), shuffle=shuffle, seed=7, num_replicas=world,
                         rank=rank) for cls in (ShardedSubsetSampler, JaxSampler))
        for epoch in range(2):
            port.set_seed(7 + epoch)
            ref.set_seed(7 + epoch)
            got, want = list(port), list(ref)
            assert got == want and len(got) == 23 // world, (rank, epoch)
        assert port.data_source.indices == ref.data_source.indices


def test_sharded_sampler_outside_a_group_is_the_whole_set():
    sampler = ShardedSubsetSampler(_Source(5), shuffle=False)
    assert (sampler.num_replicas, sampler.rank) == (1, 0) and list(sampler) == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        ShardedSubsetSampler(_Source(5), shuffle=False, num_replicas=2, rank=2)


# ------------------------------------------------------------------ update
def run_update(job: dict) -> list:
    """One update of each variant of ``job`` on the rows this process holds
    (the job's ``rows`` for its rank): the global loss, the gradients
    before clipping, the parameters after the update. Runs in a process
    group (each rank its rows) or alone (all rows)."""
    vocab = Vocabulary(job["tokens"], SpecialSymbols(**job["symbols"]))
    mt = job["task"] == "MT"
    results = []
    for training, micro in job["variants"]:
        model, spec = build_model(job["model"], src_vocab=vocab if mt else None,
                                  trg_vocab=vocab, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
        model.load_state_dict(job["state"], strict=True)
        args = parse_train_args(dict(training))
        tm = TrainManager(model, spec, build_loss_function(args, spec), args,
                          device="cpu", task=job["task"])
        seen, apply = {}, tm.apply_accum

        def capture(model=model, seen=seen, apply=apply):
            seen["grads"] = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                             for n, p in model.named_parameters()}
            apply()

        tm.apply_accum = capture
        loss = 0.0
        for arrays in micro[distributed.rank()]:
            src, src_len, trg, trg_len = arrays
            out = tm.train_batch(Batch(src, src_len, None, trg, trg_len, None,
                                       np.arange(len(src)), PAD, EOS, task=job["task"]))
            loss += out["loss"].item()
        assert tm.stats.steps == 1
        results.append(dict(loss=distributed.all_reduce_counts([loss])[0],
                            grads=seen["grads"],
                            params={n: p.detach().clone()
                                    for n, p in model.state_dict().items()}))
    return results


def speech_rows(seed: int, n_micro: int = 2):
    """Micro-batches of four utterances (80 features): rank 0's rows (0, 2)
    hold the longest source, 256 frames, rank 1's (1, 3) are shorter, so
    the ranks agree on the padding; 17-token targets at most (bucket
    sizes, so the JAX package pads no frame or token)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_micro):
        src_len, trg_len = np.array([256, 201, 150, 230]), np.array([17, 12, 6, 15])
        src = np.ones((4, 256, 80), np.float32)  # the collate's pad value
        trg = np.full((4, 17), PAD, np.int64)
        for r in range(4):
            src[r, :src_len[r]] = rng.randn(src_len[r], 80)
            trg[r, 0], trg[r, trg_len[r] - 1] = BOS, EOS
            trg[r, 1:trg_len[r] - 1] = rng.randint(4, 40, size=trg_len[r] - 2)
        out.append((src, src_len, trg, trg_len))
    return out


def text_rows(seed: int, lo: int, hi: int, n_micro: int = 2):
    """Micro-batches of four sentence pairs, token ids in [lo, hi): rank 1's
    sources are shorter than rank 0's longest."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_micro):
        src_len, trg_len = np.array([9, 6, 4, 7]), np.array([8, 5, 7, 3])
        src, trg = rng.randint(lo, hi, size=(4, 9)), np.full((4, 8), PAD)
        for r in range(4):
            src[r, src_len[r] - 1], src[r, src_len[r]:] = EOS, PAD
            trg[r, 0], trg[r, trg_len[r] - 1] = BOS, EOS
            trg[r, 1:trg_len[r] - 1] = rng.randint(lo, hi, size=trg_len[r] - 2)
        out.append((src, src_len, trg, trg_len))
    return out


def split(micro, world: int = 2):
    """Rank r's rows r, r + world, ... of each micro-batch."""
    out = []
    for r in range(world):
        mine = []
        for src, src_len, trg, trg_len in micro:
            rows = np.arange(r, len(src), world)
            # each rank's own batch is as long as its longest row
            s, t = int(src_len[rows].max()), int(trg_len[rows].max())
            mine.append((src[rows][:, :s], src_len[rows], trg[rows][:, :t], trg_len[rows]))
        out.append(mine)
    return out


SPEECH = {"initializer": "xavier_uniform", "bias_initializer": "zeros",
          "encoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                      "embeddings": {"embedding_dim": 80}, "hidden_size": 32, "ff_size": 64,
                      "dropout": 0.0, "subsample": True, "conv_kernel_sizes": [5, 5],
                      "conv_channels": 32, "in_channels": 80, "layer_norm": "pre"},
          "decoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                      "embeddings": {"embedding_dim": 32, "scale": True, "dropout": 0.0},
                      "hidden_size": 32, "ff_size": 64, "dropout": 0.0,
                      "layer_norm": "pre"}}
TRAINING = {"optimizer": "adamw", "adam_betas": [0.9, 0.98], "weight_decay": 0.01,
            "learning_rate": 1.0e-3, "clip_grad_norm": 1.0, "batch_size": 2,
            "batch_type": "sentence", "label_smoothing": 0.1, "loss": "crossentropy"}
VARIANTS = {"s2t": [(1, "batch"), (1, "tokens"), (2, "batch"), (2, "tokens")],
            "mt": [(1, "batch"), (1, "tokens"), (2, "batch"), (2, "tokens")],
            "rnn": [(2, "tokens")], "moe": [(2, "tokens")]}
CASES = [(case, bm, norm) for case, variants in VARIANTS.items() for bm, norm in variants]


def case_setup(case: str):
    """(JAX model, JAX spec, JAX params, vocabulary tokens and symbols,
    model config, task, union micro-batches, training config)."""
    import jax
    import jax.numpy as jnp

    from joeys2t_tpu.config import SpecialSymbols as JaxSymbols
    from joeys2t_tpu.models import build_model as jax_build_model
    from joeys2t_tpu.models.initialization import initialize_model
    from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary

    if case == "s2t":
        tokens = [f"t{i}" for i in range(36)]
        jmodel, jspec = jax_build_model(SPEECH, trg_vocab=JaxVocabulary(tokens, JaxSymbols()))
        params = jax.jit(jmodel.init)(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 40, 80)),
            jnp.zeros((2, 4), jnp.int32), jnp.full((2,), 40), None,
            jnp.ones((2, 1, 4), bool))["params"]
        params = initialize_model(params, SPEECH, 1, 1, jax.random.PRNGKey(1))
        rng = np.random.RandomState(1)
        params = jax.tree.map(
            lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(np.float32), params)
        return (jmodel, jspec, params, tokens, {}, SPEECH, "S2T", speech_rows(4),
                TRAINING)
    if case == "rnn":
        from test_torch_rnn import TOKENS, make_pair

        from joeys2t_torch.config import load_config

        p = make_pair("rnn_reverse", seed=2)
        training = dict(load_config(REPO / "configs" / "rnn_reverse.yaml")["training"],
                        batch_size=2, scheduling=None, learning_rate=1.0e-3)
        return (p.jmodel, p.jspec, p.params, TOKENS, {}, p.cfg, "MT",
                text_rows(5, 4, 24), training)
    from test_torch_moe import moe_cfg
    from test_torch_mt import SYMBOLS, TOKENS, jax_params, mt_cfg
    from test_torch_mt import vocabs as mt_vocabs

    cfg = moe_cfg() if case == "moe" else mt_cfg("plain")
    _, jv = mt_vocabs()
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    return (jmodel, jspec, jax_params(jmodel, cfg, seed=3), TOKENS, SYMBOLS, cfg, "MT",
            text_rows(6, 7, 47), TRAINING)


def jax_update(jmodel, jspec, params, training: dict, micro, task: str) -> dict:
    """The JAX package's single-process update on the union rows: loss,
    gradients and parameters after the optax chain."""
    import jax
    import jax.numpy as jnp
    import optax

    from joeys2t_torch.convert import flax_params_to_state_dict
    from joeys2t_tpu.config import parse_train_args as jax_parse_train_args
    from joeys2t_tpu.data.batch import Batch as JaxBatch
    from joeys2t_tpu.optim import build_gradient_clipper, build_optimizer
    from joeys2t_tpu.prediction import build_loss_function as jax_loss_function
    from joeys2t_tpu.training import TrainManager as JaxTrainManager

    args = jax_parse_train_args(dict(training))
    ns = SimpleNamespace(model=jmodel, loss_fn=jax_loss_function(args, jspec), args=args)
    ns._finish_loss = lambda *a: JaxTrainManager._finish_loss(ns, *a)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda prm, arrays, norm: JaxTrainManager._loss_and_metrics(
            ns, prm, arrays, jax.random.PRNGKey(0), norm), has_aux=True))
    accum, loss = None, 0.0
    for src, src_len, trg, trg_len in micro:
        jb = JaxBatch(src, src_len, None, trg, trg_len, None, np.arange(len(src)), PAD,
                      EOS, task=task)
        normalizer = jb.nseqs if args.normalization == "batch" else jb.ntokens
        jb = jb.pad_to_shape(batch_size=len(src))
        arrays = {name: getattr(jb, name) for name in (
            "src", "trg_input", "trg", "src_length", "src_mask", "trg_mask", "trg_length",
            "src_prompt_mask", "trg_prompt_mask")}
        (value, _), grads = grad_fn(params, arrays, jnp.float32(normalizer))
        loss += float(value)
        accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
    tx = optax.chain(*(t for t in (build_gradient_clipper(args.__dict__),
                                   build_optimizer(args.__dict__)) if t is not None))
    updates, _ = tx.update(accum, tx.init(params), params)
    return dict(loss=loss, grads=flax_params_to_state_dict(accum),
                params=flax_params_to_state_dict(optax.apply_updates(params, updates)))


_RESULTS: dict = {}


def case_results(case: str, tmp: Path) -> dict:
    """Per variant of ``case``: (rank 0's and rank 1's two-rank update, the
    port's single-process update on the union, JAX's), computed once."""
    if case in _RESULTS:
        return _RESULTS[case]
    from joeys2t_torch.convert import flax_params_to_state_dict

    jmodel, jspec, params, tokens, symbols, cfg, task, micro, training = case_setup(case)
    variants = [(dict(training, batch_multiplier=bm, normalization=norm), micro[:bm])
                for bm, norm in VARIANTS[case]]
    job = dict(task=task, model=cfg, tokens=tokens, symbols=symbols,
               state=flax_params_to_state_dict(params),
               variants=[(t, split(m)) for t, m in variants])
    torch.save(job, tmp / "job.pt")
    launch([__file__, "update", tmp / "job.pt", tmp], tmp)
    ranks = [torch.load(tmp / f"update{r}.pt", weights_only=False) for r in range(2)]
    union = run_update(dict(job, variants=[(t, [m]) for t, m in variants]))
    ref = [jax_update(jmodel, jspec, params, t, m, task) for t, m in variants]
    _RESULTS[case] = {v: (ranks[0][i], ranks[1][i], union[i], ref[i])
                      for i, v in enumerate(VARIANTS[case])}
    return _RESULTS[case]


def close(got: dict, want: dict, tol: float, lr: float) -> None:
    """Loss to ``tol`` relative, gradients to ``tol`` of the global norm,
    parameters to ``tol`` plus what Adam's first step makes of the
    gradients' tolerance where a gradient is near eps."""
    assert abs(got["loss"] - want["loss"]) <= tol * abs(want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in want["grads"].values())))
    assert norm > 0
    for key, g in want["grads"].items():
        assert (got["grads"][key] - g).abs().max().item() <= tol * norm, key
    eps, dg = 1e-8, tol * norm
    for key, value in got["params"].items():
        g = want["grads"][key].abs()
        bound = tol + lr * torch.clamp(eps * dg / (g + eps) ** 2, max=2.0)
        assert ((value - want["params"][key]).abs() <= bound).all(), key


@pytest.mark.parametrize("case,bm,norm", CASES)
def test_two_ranks_equal_one_process_on_the_union(tmp_path_factory, case, bm, norm):
    """Both ranks end with the same parameters, and the two-rank update
    equals the port's single-process update on the four rows to 1e-6."""
    rank0, rank1, union, _ = case_results(case, tmp_path_factory.mktemp(case))[(bm, norm)]
    for key, value in rank0["params"].items():
        assert torch.equal(value, rank1["params"][key]), key
    close(rank0, union, 1e-6, TRAINING["learning_rate"])


@pytest.mark.parametrize("case,bm,norm", CASES)
def test_two_ranks_equal_jax_on_the_union(tmp_path_factory, case, bm, norm):
    """The two-rank update equals the JAX package's single-process update
    on the four rows to 1e-5: the port divides by the global batch's count
    as single-process JAX does (JAX's own multi-process path divides by
    each process's count, ROADMAP.md §C)."""
    rank0, _, _, ref = case_results(case, tmp_path_factory.mktemp(case))[(bm, norm)]
    close(rank0, ref, 1e-5, TRAINING["learning_rate"])


def test_params_without_gradient_are_left_out_of_ddp():
    """A speech model under a loss without CTC leaves its CTC head out, a
    model with LSTMs their ``bias_hh``; nothing else."""
    vocab = Vocabulary([f"t{i}" for i in range(36)], SpecialSymbols())
    model, spec = build_model(SPEECH, trg_vocab=vocab, device="cpu")
    for loss, want in (("crossentropy", ["decoder.ctc_output_layer.weight"]),
                       ("crossentropy-ctc", [])):
        args = parse_train_args(dict(TRAINING, loss=loss, ctc_weight=0.3))
        tm = TrainManager(model, spec, build_loss_function(args, spec), args, device="cpu")
        assert tm.ddp is None and tm._params_without_gradient() == want


# ----------------------------------------------------------------- workers
def worker_update(job_path: Path, out: Path) -> None:
    results = run_update(torch.load(job_path, weights_only=False))
    torch.save(results, out / f"update{distributed.rank()}.pt")


def port_predict(cfg: dict, state: dict, testing: dict):
    """The port's ``predict`` of the dev set with ``testing`` (loss
    included): (scores, references, hypotheses, tokens, sequence scores)."""
    import copy

    from joeys2t_torch.config import parse_global_args
    from joeys2t_torch.prediction import predict, prepare

    cfg = copy.deepcopy(cfg)
    cfg["testing"].update(testing)
    args = parse_global_args(cfg, mode="train")
    model, spec, loss_fn, _, dev, _ = prepare(args, rank=distributed.rank(), mode="train")
    model.load_state_dict(state)
    return predict(model, spec, dev, loss_fn=loss_fn, compute_loss=True,
                   normalization=args.train.normalization, args=args.test)[:5]


def worker_predict(job_path: Path, out: Path) -> None:
    job = torch.load(job_path, weights_only=False)
    results = [port_predict(job["cfg"], job["state"], t) for t in job["variants"]]
    torch.save(results, out / f"predict{distributed.rank()}.pt")


def worker_lockstep(job_path: Path, out: Path) -> None:
    """One epoch of ``train_and_validate`` on this rank's shard: the
    updates it took and the batches its own iterator produced."""
    from joeys2t_torch.config import parse_global_args, set_validation_args
    from joeys2t_torch.prediction import prepare

    cfg = torch.load(job_path, weights_only=False)
    args = parse_global_args(cfg, mode="train")
    model, spec, loss_fn, train_data, dev_data, _ = prepare(
        args, rank=distributed.rank(), mode="train")
    tm = TrainManager(model, spec, loss_fn, args.train, seed=args.seed,
                      model_cfg=args.model, device="cpu", model_dir=args.model_dir,
                      task=args.task, dev_args=set_validation_args(args.test))
    local, agree = [0], tm._agree

    def counting(batch):
        local[0] += batch is not None
        return agree(batch)

    tm._agree = counting
    tm.train_and_validate(train_data=train_data, valid_data=dev_data)
    torch.save({"steps": tm.stats.steps, "local_batches": local[0]},
               out / f"lockstep{distributed.rank()}.pt")


WORKERS = {"update": worker_update, "predict": worker_predict, "lockstep": worker_lockstep}

if __name__ == "__main__":
    torch.set_num_threads(2)
    with distributed.process_group(use_cuda=False):
        WORKERS[sys.argv[1]](Path(sys.argv[2]), Path(sys.argv[3]))
