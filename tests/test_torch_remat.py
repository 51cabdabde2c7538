# coding: utf-8
"""``remat`` and ``moment_dtype`` in the port against the JAX package on the
CPU.

``remat`` (model-level, or per side on the encoder and decoder, read as the
JAX package reads it) runs each transformer encoder layer, Conformer layer
and decoder layer under ``torch.utils.checkpoint``: at dropout 0.1 the
recomputation replays the dropout of the forward (the port's dropout and
the flash seed draw from the trainer's generator), so the gradients equal
those without ``remat`` to 1e-6 and the generator ends where it would; at
dropout 0 the logits and gradients equal the JAX model built with
``remat`` to 1e-5. ``moment_dtype: bfloat16``: three Adam and three AdamW
updates equal optax's ``mu_dtype`` chain to 1e-5, with the first moment
stored in bfloat16 and equal to JAX's ``mu``, the second in float32, and
it survives a checkpoint round trip. On two gloo ranks, a mixture-of-experts
model at dropout 0.1 takes the same gradients with ``remat`` as without:
its routing sums' differentiable all-reduce runs again in the
recomputation, over the world in a data-parallel run and over the data
group only under ``model_parallel: 2``.

Sizes: 2 + 2 layers of hidden 32, 2 heads (head dim 16, the flash route)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch import optim as port_optim
from joeys2t_torch.config import ConfigurationError, SpecialSymbols, parse_train_args
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.losses import build_loss_function
from joeys2t_torch.models import build_model
from joeys2t_torch.training import TrainManager
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.config import SpecialSymbols as JaxSymbols
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.models.initialization import initialize_model as jax_initialize
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
from test_torch_data import few_threads  # noqa: F401
from test_torch_ddp import SPEECH, speech_rows

pytestmark = pytest.mark.usefixtures("few_threads")
TOKENS = [f"t{i}" for i in range(36)]
REPO_TESTS = Path(__file__).resolve().parent


def speech_cfg(dropout: float, kind: str = "transformer", **remat) -> dict:
    cfg = {**SPEECH, **{k: v for k, v in remat.items() if k == "remat"}}
    enc, dec = dict(SPEECH["encoder"], dropout=dropout), dict(SPEECH["decoder"],
                                                              dropout=dropout)
    dec["embeddings"] = dict(dec["embeddings"], dropout=dropout)
    if kind == "conformer":
        enc.update(type="conformer", depthwise_conv_kernel_size=7, macaron="paper",
                   layerscale=0.1)
    for side, d in (("encoder", enc), ("decoder", dec)):
        if f"{side}_remat" in remat:
            d["remat"] = remat[f"{side}_remat"]
    return dict(cfg, encoder=enc, decoder=dec)


def test_remat_keys_are_read_as_jax_reads_them():
    """The model-level key sets both sides; a side's own key sets that side;
    without either there is no remat (the key is no longer dropped)."""
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    for remat, want in (({}, (False, False)), ({"remat": True}, (True, True)),
                        ({"encoder_remat": True}, (True, False)),
                        ({"decoder_remat": True}, (False, True))):
        model, _ = build_model(speech_cfg(0.0, **remat), trg_vocab=vocab, device="cpu")
        assert (model.encoder.remat, model.decoder.remat) == want, remat
    model, _ = build_model(speech_cfg(0.0, "conformer", remat=True), trg_vocab=vocab,
                           device="cpu")
    assert model.encoder.remat


def update_grads(cfg: dict):
    """One training micro-batch at the config's dropout through the trainer:
    the loss, the gradients and the generator's state after it."""
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    model, spec = build_model(cfg, trg_vocab=vocab, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    args = parse_train_args({"optimizer": "adamw", "batch_size": 4,
                             "loss": "crossentropy-ctc", "ctc_weight": 0.3,
                             "label_smoothing": 0.1})
    tm = TrainManager(model, spec, build_loss_function(args, spec), args, device="cpu")
    src, src_len, trg, trg_len = speech_rows(2, n_micro=1)[0]
    _, _, arrays, normalizer = tm._prepare_batch(
        Batch(src, src_len, None, trg, trg_len, None, np.arange(4), 1, 3, task="S2T"))
    loss, _ = tm._loss_and_metrics(arrays, normalizer)
    loss.backward()
    return (loss.item(), {n: p.grad for n, p in model.named_parameters()},
            tm.generator.get_state())


@pytest.mark.parametrize("kind", ["transformer", "conformer"])
def test_remat_replays_dropout(kind):
    """At dropout 0.1, from the same generator seed: the loss, every
    gradient (to 1e-6) and the generator's final state equal those without
    remat, so the recomputation drew the forward's masks again."""
    plain = update_grads(speech_cfg(0.1, kind))
    remat = update_grads(speech_cfg(0.1, kind, remat=True))
    assert remat[0] == plain[0]
    assert sorted(remat[1]) == sorted(plain[1])
    for name, g in plain[1].items():
        assert (remat[1][name] - g).abs().max().item() <= 1e-6, name
    assert torch.equal(remat[2], plain[2])
    # and the dropout did fire: without it the loss is another
    assert update_grads(speech_cfg(0.0, kind))[0] != plain[0]


def model_inputs():
    rng = np.random.RandomState(4)
    lengths = np.array([120, 90, 61])
    src = np.ones((3, 120, 80), np.float32)
    for i, n in enumerate(lengths):
        src[i, :n] = rng.randn(n, 80)
    trg_input = np.concatenate([np.full((3, 1), 2), rng.randint(4, 40, (3, 6))], axis=1)
    trg_mask = np.ones((3, 1, 7), bool)
    trg_mask[2, 0, 5:] = False
    weights = rng.randn(3, 7, 40).astype(np.float32)
    return src, trg_input, lengths, trg_mask, weights


@pytest.mark.parametrize("kind", ["transformer", "conformer"])
def test_remat_model_matches_jax_remat(kind):
    """The JAX model built with ``remat`` and the port's, same weights, at
    dropout 0 in training mode: logits to 1e-5 of the largest, and the
    gradients of a fixed weighting of the logits to 1e-5 of the largest."""
    cfg = speech_cfg(0.0, kind, remat=True)
    jmodel, _ = jax_build_model(cfg, trg_vocab=JaxVocabulary(TOKENS, JaxSymbols()))
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 40, 80)),
                         jnp.zeros((2, 4), jnp.int32), jnp.full((2,), 40), None,
                         jnp.ones((2, 1, 4), bool))["params"]
    params = jax_initialize(params, cfg, 1, 1, jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32), params)
    src, trg_input, lengths, trg_mask, weights = model_inputs()

    def jax_loss(p):
        logits, _, _ = jmodel.apply({"params": p}, jnp.asarray(src), jnp.asarray(trg_input),
                                    jnp.asarray(lengths), None, jnp.asarray(trg_mask),
                                    deterministic=False, rngs={"dropout":
                                                               jax.random.PRNGKey(0)})
        return jnp.sum(logits * weights), logits

    (_, ref_logits), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    model, _ = build_model(cfg, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()),
                           device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    model.train()
    assert model.encoder.remat and model.decoder.remat
    logits, _, _ = model(torch.tensor(src), torch.tensor(trg_input), torch.tensor(lengths),
                         None, torch.tensor(trg_mask))
    (logits * torch.tensor(weights)).sum().backward()
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, rtol=0,
                               atol=1e-5 * np.abs(ref_logits).max())
    ref_grads = flax_params_to_state_dict(ref_grads)
    scale = max(g.abs().max().item() for g in ref_grads.values())
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert (got - ref_grads[name]).abs().max().item() <= 1e-5 * scale, name


def find_mu(state):
    """optax's ScaleByAdamState.mu inside the injected chain's state."""
    if hasattr(state, "mu"):
        return state.mu
    inner = getattr(state, "inner_state", None)
    for s in (inner,) if inner is not None else (state if isinstance(state, tuple) else ()):
        mu = find_mu(s)
        if mu is not None:
            return mu
    return None


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_moment_dtype_matches_optax_mu_dtype(name):
    """Three updates from fixed gradients at a fixed rate with
    ``moment_dtype: bfloat16``: the weights to 1e-5 of optax's, the first
    moment stored in bfloat16 and equal to JAX's ``mu`` (optax rounds the
    weakly typed b1 to bfloat16 in ``b1 * mu``, and so does the port), the
    second in float32."""
    import optax

    from joeys2t_tpu.optim import build_optimizer as jax_build_optimizer
    from joeys2t_tpu.optim import set_learning_rate as jax_set_lr

    cfg = {"optimizer": name, "adam_betas": [0.9, 0.98], "learning_rate": 1e-2,
           "weight_decay": 0.1, "moment_dtype": "bfloat16"}
    rng = np.random.RandomState(3)
    w = rng.randn(6, 4).astype(np.float32)
    gs = [rng.randn(6, 4).astype(np.float32) for _ in range(3)]
    tx = jax_build_optimizer(cfg)
    params, state = jnp.asarray(w), tx.init(jnp.asarray(w))
    param = torch.nn.Parameter(torch.tensor(w))
    opt = port_optim.build_optimizer(parse_train_args(dict(cfg, batch_size=1)).__dict__,
                                     [param])
    for g in gs:
        jax_set_lr(state, 1e-2)
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
        port_optim.set_learning_rate(opt, 1e-2)
        param.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(params), rtol=0, atol=1e-5)
    mu = find_mu(state)
    exp_avg = opt.state[param]["exp_avg"]
    assert mu.dtype == jnp.bfloat16 and exp_avg.dtype == torch.bfloat16
    assert opt.state[param]["exp_avg_sq"].dtype == torch.float32
    np.testing.assert_array_equal(exp_avg.float().numpy(), np.asarray(mu.astype(jnp.float32)))


def test_moment_dtype_in_the_trainer_and_its_checkpoint():
    """``moment_dtype`` parses as JAX parses it (float16 is refused); a
    trained optimizer keeps the first moment in bfloat16, also after its
    state is saved and loaded into a new one."""
    base = {"optimizer": "adam", "batch_size": 4, "loss": "crossentropy"}
    assert parse_train_args(base).moment_dtype is None
    with pytest.raises(ConfigurationError):
        parse_train_args(dict(base, moment_dtype="float16"))
    args = parse_train_args(dict(base, moment_dtype="BFloat16"))
    assert args.moment_dtype == "bfloat16"
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    model, spec = build_model(speech_cfg(0.0), trg_vocab=vocab, device="cpu")
    tm = TrainManager(model, spec, build_loss_function(args, spec), args, device="cpu")
    src, src_len, trg, trg_len = speech_rows(3, n_micro=1)[0]
    tm.train_batch(Batch(src, src_len, None, trg, trg_len, None, np.arange(4), 1, 3,
                         task="S2T"))
    state = tm.optimizer.state_dict()
    moments = {i: s["exp_avg"] for i, s in state["state"].items()}
    assert moments and all(m.dtype == torch.bfloat16 for m in moments.values())
    again = port_optim.build_optimizer(args.__dict__, tm.params)
    again.load_state_dict(state)
    for p in tm.params:
        p.grad = torch.zeros_like(p)
    again.step()
    for i, p in enumerate(tm.params):
        assert again.state[p]["exp_avg"].dtype == torch.bfloat16
        if i in moments:  # the CTC head of this cross-entropy model has none
            b1 = torch.tensor(0.9, dtype=torch.bfloat16).item()  # as optax rounds it
            assert torch.equal(again.state[p]["exp_avg"], moments[i] * b1)


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_remat_with_experts_on_two_ranks(tmp_path_factory, model_parallel):
    """Two gloo ranks (data-parallel, then one model group of two), 4
    experts an encoder layer, dropout 0.1: the loss and the gradients
    before clipping with ``remat`` equal those without to 1e-6."""
    from test_torch_ddp import launch, split, text_rows
    from test_torch_tp import TOKENS as TP_TOKENS
    from test_torch_tp import TRAINING, tp_cfg

    if not _REMAT:
        tmp = tmp_path_factory.mktemp("remat")
        cfg = tp_cfg("experts")
        for side in ("encoder", "decoder"):
            cfg[side] = dict(cfg[side], dropout=0.1)
        vocab = Vocabulary(TP_TOKENS, SpecialSymbols())
        model, _ = build_model(cfg, src_vocab=vocab, trg_vocab=vocab, device="cpu")
        micro = text_rows(6, 7, 43, n_micro=1)
        torch.save(dict(cfg=cfg, state=model.state_dict(), training=dict(TRAINING),
                        rows=split(micro), union=micro), tmp / "job.pt")
        launch([REPO_TESTS / "test_torch_tp.py", "remat", tmp / "job.pt", tmp], tmp)
        _REMAT.update(torch.load(tmp / "remat0.pt", weights_only=False))
    plain, remat = _REMAT[(model_parallel, False)], _REMAT[(model_parallel, True)]
    assert abs(plain["loss"] - remat["loss"]) <= 1e-6 * abs(plain["loss"])
    for name, g in plain["grads"].items():
        np.testing.assert_allclose(remat["grads"][name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


_REMAT: dict = {}
