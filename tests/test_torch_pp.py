# coding: utf-8
"""Pipeline parallelism (``training: pipeline_parallel``) on the CPU: gloo
ranks against the JAX package's GPipe and against one process.

- ``pipeline_apply`` over 4 and 2 stages (four ranks: one pipe group of
  4, then two groups of 2) of tests/test_pipeline_parallel.py's stack (8
  pre-norm layers of hidden 16, 2 heads, feed-forward 32; a batch of 8 x 6)
  with its microbatch counts (4 over 4 stages; 1 and 8 over 2): the
  output and the gradients of sum(y^2) with respect to every layer and
  the input equal JAX's ``pipeline_apply`` on the forced host devices to
  1e-5 (of the gradients' norm).
- The model's split around its layer stacks (``encode_pre_layers`` ...
  ``decode_post_layers``) equals the whole forward, for a transformer text
  model and a Conformer encoder.
- ``TrainManager`` from the reverse task's config with
  ``pipeline_parallel: 2`` (two ranks, both stacks staged): the first
  update's gradients and weights equal one process's and the weights JAX's
  ``TrainManager`` on its (data 4, pipe 2) mesh, the greedy validation's
  hypotheses one process's, and every rank ends with the same weights.
- A mixture-of-experts or recurrent encoder is refused by name.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from joeys2t_torch.config import ConfigurationError, SpecialSymbols
from joeys2t_torch.models import build_model
from joeys2t_torch.models.modules import TransformerEncoderLayer
from joeys2t_torch.parallel import distributed
from joeys2t_torch.parallel.pp import PipePlan, pipeline_apply
from joeys2t_torch.training import TrainManager
from joeys2t_torch.vocabulary import Vocabulary
from test_torch_ddp import launch
from test_torch_tp import SIDE, TOKENS, check_first_update, conformer_cfg, manager_results

H, FF, HEADS, L = 16, 32, 2, 8
B, S_LEN = 8, 6
CASES = [(4, 4), (2, 1), (2, 8)]  # (stages, microbatches)


def jax_stack():
    """JAX's layers, weights, input and mask, and its pipelined output and
    gradients for each case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from joeys2t_tpu.models.modules import TransformerEncoderLayer as JaxLayer
    from joeys2t_tpu.parallel.pp import pipeline_apply as jax_pipeline_apply
    from joeys2t_tpu.parallel.pp import stack_layer_params

    layer = JaxLayer(size=H, ff_size=FF, num_heads=HEADS, dropout=0.0,
                     layer_norm_position="pre")
    rng = np.random.RandomState(0)
    x = rng.randn(B, S_LEN, H).astype(np.float32)
    mask = np.ones((B, 1, S_LEN), bool)
    mask[1, 0, 4:] = False  # a padded row
    per_layer = [layer.init(jax.random.PRNGKey(i), x, mask, True)["params"]
                 for i in range(L)]

    def layer_fn(p, h, m):
        return layer.apply({"params": p}, h, m, True)

    stacked = stack_layer_params(per_layer)
    refs = {}
    for stages, m in CASES:
        mesh = Mesh(np.asarray(jax.devices()[:stages]), ("pipe",))

        def loss(p, xx):
            y = jax_pipeline_apply(layer_fn, p, xx, m, mesh, "pipe", jnp.asarray(mask))
            return jnp.sum(y ** 2), y

        grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
        (_, y), (g_p, g_x) = grad_fn(stacked, jnp.asarray(x))
        refs[(stages, m)] = dict(y=np.asarray(y), x=np.asarray(g_x),
                                 layers=[jax.tree.map(lambda a, i=i: np.asarray(a[i]), g_p)
                                         for i in range(L)])
    return per_layer, x, mask, refs


_RESULTS: dict = {}


def pipe_results(tmp: Path) -> dict:
    if _RESULTS:
        return _RESULTS
    from joeys2t_torch.convert import flax_params_to_state_dict

    per_layer, x, mask, refs = jax_stack()
    job = dict(layers=[flax_params_to_state_dict(p) for p in per_layer], x=x, mask=mask)
    torch.save(job, tmp / "job.pt")
    launch([__file__, "pipe", tmp / "job.pt", tmp], tmp, world=4)
    ranks = [torch.load(tmp / f"pipe{r}.pt", weights_only=False) for r in range(4)]
    for case in CASES:
        want = refs[case]
        layers = [flax_params_to_state_dict(g) for g in want["layers"]]
        _RESULTS[case] = ([r[case] for r in ranks], dict(want, layers=layers))
    return _RESULTS


@pytest.mark.parametrize("stages,micro", CASES)
def test_pipeline_matches_jax(tmp_path_factory, stages, micro):
    """Every rank's output, and the gradients of its stage's layers and of
    the input, equal JAX's GPipe: each layer's gradient once, on its own
    stage (the broadcast hands the last stage the cotangent once)."""
    ranks, want = pipe_results(tmp_path_factory.mktemp("pipe"))[(stages, micro)]
    norm = float(np.sqrt(sum(float((v.double() ** 2).sum()) for g in want["layers"]
                             for v in g.values())))
    for got in ranks:
        np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-5 * norm)
        for i, grads in got["layers"].items():
            for name, g in grads.items():
                np.testing.assert_allclose(g.numpy(), want["layers"][i][name].numpy(),
                                           rtol=0, atol=1e-5 * norm, err_msg=f"{i} {name}")
    staged = sorted(i for got in ranks[:stages] for i in got["layers"])
    assert staged == list(range(L))  # every layer on exactly one stage


# ------------------------------------------------------------- the split
def test_split_around_the_stacks_equals_the_forward():
    """``encode_pre_layers`` -> the layers -> ``encode_post_layers`` and the
    decoder's split give the whole forward's output (a text model with a
    target prompt; a Conformer encoder with padded frames)."""
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    model, _ = build_model({"encoder": dict(SIDE), "decoder": dict(SIDE)}, src_vocab=vocab,
                           trg_vocab=vocab, device="cpu")
    rng = np.random.RandomState(3)
    src = torch.tensor(rng.randint(4, 40, size=(2, 5)))
    trg = torch.tensor(rng.randint(4, 40, size=(2, 4)))
    src_len = torch.tensor([5, 3])
    src_mask = (torch.arange(5)[None] < src_len[:, None])[:, None]
    trg_mask = torch.ones((2, 1, 4), dtype=torch.bool)
    prompt = torch.tensor([[1, 0, 0, 0], [0, 0, 0, 0]])
    with torch.no_grad():
        want, _, _ = model(src, trg, src_len, src_mask, trg_mask, None, prompt)
        x, mask = model.encode_pre_layers(src, src_len, src_mask)
        for layer in model.encoder.layers:
            x = layer(x, mask)
        memory = model.encode_post_layers(x)
        y, full = model.decode_pre_layers(trg, trg_mask, prompt)
        for layer in model.decoder.layers:
            y = layer(y, memory, mask, full)
        got, ctc = model.decode_post_layers(y, memory)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert ctc is None

    model, _ = build_model(dict(conformer_cfg(), encoder=dict(conformer_cfg()["encoder"],
                                                             num_layers=4)),
                           trg_vocab=vocab, device="cpu")
    feats = torch.tensor(rng.randn(2, 37, 8).astype(np.float32))
    lengths = torch.tensor([37, 28])
    with torch.no_grad():
        want, _, want_mask = model.encode(feats, lengths)
        x, mask = model.encode_pre_layers(feats, lengths)
        for layer in model.encoder.layers:
            x = layer(x, mask)
        got = model.encode_post_layers(x)
    assert torch.equal(mask, want_mask)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------- TrainManager from the config
def test_train_manager_pipeline_parallel_from_config(tmp_path_factory):
    """``pipeline_parallel: 2`` through the trainer (4 microbatches, both
    stacks staged): the first update's gradients and weights equal one
    process's, the weights JAX's on its (data 4, pipe 2) mesh, the greedy
    validation's hypotheses one process's; both ranks end two updates at
    dropout 0.1 with the same weights, every one of them."""
    r = manager_results(tmp_path_factory.mktemp("manager"), "pipeline_parallel")
    for rank in r["ranks"]:
        check_first_update(rank["first"], rank["grads"], r["single"], r["single_grads"],
                           r["jax"], r["start"], r["cfg"]["training"]["learning_rate"])
    assert r["hyps"]["pipeline_parallel"] == r["hyps"]["single"]
    a, b = (rank["dropout"] for rank in r["ranks"])
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_pipeline_refuses_what_jax_refuses():
    """A mixture-of-experts encoder and a recurrent one raise by name, as
    JAX's ``_init_pipeline`` refuses them."""
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    experts = {"encoder": dict(SIDE, num_experts=2), "decoder": dict(SIDE)}
    recurrent = {"encoder": {"type": "recurrent", "rnn_type": "gru", "hidden_size": 16,
                             "embeddings": {"embedding_dim": 16}},
                 "decoder": dict(SIDE)}
    for cfg, match in ((experts, "MoE"), (recurrent, "transformer and conformer")):
        model, _ = build_model(cfg, src_vocab=vocab, trg_vocab=vocab, device="cpu")
        tm = TrainManager.__new__(TrainManager)
        tm.model, tm.device = model, torch.device("cpu")
        tm.layout = SimpleNamespace(inner=2, inner_group=None, inner_ranks=[0, 1],
                                    inner_rank=0)
        tm.args = SimpleNamespace(pipeline_microbatches=0)
        with pytest.raises(ConfigurationError, match=match):
            tm._init_pipeline(42)


# --------------------------------------------------------------- workers
def worker_pipe(job_path: Path, out: Path) -> None:
    """Each case on this rank's stage: the output, the input's gradient and
    this stage's layers' gradients."""
    job = torch.load(job_path, weights_only=False)
    results = {}
    for stages, m in CASES:
        layout = distributed.set_layout(pipeline_parallel=stages)
        plan = PipePlan(layout.inner_group, layout.inner_ranks, layout.inner_rank, m)
        layers = torch.nn.ModuleList(
            TransformerEncoderLayer(H, FF, HEADS, 0.0, layer_norm_position="pre")
            for _ in range(L))
        for layer, state in zip(layers, job["layers"]):
            layer.load_state_dict(state, strict=True)
        mine = plan.stage_slice(L)

        def run(h, mask, mine=mine, layers=layers):
            for layer in layers[mine]:
                h = layer(h, mask)
            return h

        x = torch.tensor(job["x"], requires_grad=True)
        y = pipeline_apply(run, x, plan, torch.tensor(job["mask"]))
        (y ** 2).sum().backward()
        results[(stages, m)] = dict(
            y=y.detach().numpy(), x=x.grad.numpy(),
            layers={i: {n: p.grad.clone() for n, p in layers[i].named_parameters()}
                    for i in range(L)[mine]})
    distributed.set_layout()
    torch.save(results, out / f"pipe{distributed.rank()}.pt")


WORKERS = {"pipe": worker_pipe}

if __name__ == "__main__":
    torch.set_num_threads(2)
    with distributed.process_group(use_cuda=False):
        WORKERS[sys.argv[1]](Path(sys.argv[2]), Path(sys.argv[3]))
