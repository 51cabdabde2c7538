# coding: utf-8
"""The port's training update against the JAX package on the CPU.

One f32 update at dropout 0 with ``batch_multiplier`` 2 (two accumulated
micro-batches, one of three utterances padded to four rows) goes through the
port's ``TrainManager`` and through the JAX model, ``XentCTCLoss``,
``TrainManager._finish_loss`` and the optax chain of ``build_optimizer`` and
``build_gradient_clipper``, from the same weights (``flax_params_to_state_dict``)
and the same numpy inputs. Then the optimizer, clipping, schedulers, ``Batch``
and the training mode of the model.

Size: hidden 128, 2 heads (head dim 64, so attention takes the flash route),
ff 256, 2 encoder and 1 decoder layer, a 40-token vocabulary.

The JAX package is imported inside the functions that use it:
``one_update`` also serves ``tests/test_torch_cuda.py`` on a machine
without JAX."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from joeys2t_torch import optim as port_optim
from joeys2t_torch.config import ConfigurationError, SpecialSymbols, parse_train_args
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.losses import build_loss_function
from joeys2t_torch.models import build_model
from joeys2t_torch.models.modules import set_dropout_generator
from joeys2t_torch.ops import flash_attention as fa
from joeys2t_torch.training import TrainManager
from joeys2t_torch.vocabulary import Vocabulary


def model_cfg(dropout=0.0):
    return {
        "initializer": "xavier_uniform", "bias_initializer": "zeros",
        "encoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                    "embeddings": {"embedding_dim": 80}, "hidden_size": 128,
                    "ff_size": 256, "dropout": dropout, "subsample": True,
                    "conv_kernel_sizes": [5, 5], "conv_channels": 128, "in_channels": 80,
                    "layer_norm": "pre", "activation": "relu"},
        "decoder": {"type": "transformer", "num_layers": 1, "num_heads": 2,
                    "embeddings": {"embedding_dim": 128, "scale": True, "dropout": dropout},
                    "hidden_size": 128, "ff_size": 256, "dropout": dropout,
                    "layer_norm": "pre", "activation": "relu"},
    }


TRAINING = {"optimizer": "adamw", "adam_betas": [0.9, 0.98], "weight_decay": 0.01,
            "scheduling": "warmupinversesquareroot", "learning_rate": 2.0e-3,
            "learning_rate_min": 1.0e-6, "learning_rate_warmup": 10,
            "clip_grad_norm": 1.0, "batch_size": 4, "batch_type": "sentence",
            "batch_multiplier": 2, "normalization": "batch", "label_smoothing": 0.1,
            "loss": "crossentropy-ctc", "ctc_weight": 0.3}
TOKENS = [f"t{i}" for i in range(36)]  # + 4 specials = 40 ids
T_SRC, T_TRG = 256, 17  # bucket sizes, so the JAX package pads no frame or token


def micro_batches(n=2, seed=0):
    """(src, src_length, trg, trg_length) of three utterances each: raw
    targets bos ... eos padded with pad, and a row whose target length makes
    its CTC infeasible-free but short."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lengths = np.array([T_SRC, 201, 150])
        src = np.zeros((3, T_SRC, 80), np.float32)
        for i, length in enumerate(lengths):
            src[i, :length] = rng.randn(length, 80)
        trg_len = np.array([T_TRG, 12, 6])
        trg = np.full((3, T_TRG), 1, np.int64)
        for i, length in enumerate(trg_len):
            trg[i, 0], trg[i, length - 1] = 2, 3
            trg[i, 1:length - 1] = rng.randint(4, 40, size=length - 2)
        out.append((src, lengths, trg, trg_len))
    return out


def port_batch(src, lengths, trg, trg_len):
    return Batch(src, lengths, None, trg, trg_len, None, np.arange(3), 1, 3, task="S2T")


def one_update(device, state=None, cfg=None):
    """One update of the port (two micro-batches) on ``device`` of the model
    ``cfg`` (``model_cfg()`` unless given): the accumulated gradients before
    clipping, the weights (and buffers) after the update, the loss and the
    learning rates before and after."""
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    model, spec = build_model(cfg or model_cfg(), trg_vocab=vocab, device=device,
                              generator=torch.Generator().manual_seed(3))
    if state is not None:
        model.load_state_dict(state)
    args = parse_train_args(TRAINING)
    tm = TrainManager(model, spec, build_loss_function(args, spec), args, device=device)
    lrs = [tm.current_lr]
    seen = {}
    apply = tm.apply_accum

    def capture():
        seen["grads"] = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        apply()

    tm.apply_accum = capture
    losses = [tm.train_batch(port_batch(*mb)) for mb in micro_batches()]
    assert [out["stepped"] for out in losses] == [False, True] and tm.stats.steps == 1
    lrs.append(tm.current_lr)
    grad_norm = math.sqrt(sum(float(g.double().square().sum())
                              for g in seen["grads"].values()))
    return dict(loss=sum(out["loss"].item() for out in losses), grads=seen["grads"],
                grad_norm=grad_norm, lr=lrs[0], lrs=lrs,
                params={n: p.detach().cpu().clone() for n, p in model.state_dict().items()},
                dtypes={p.dtype for p in model.parameters()})


def jax_update(cfg=None):
    """The same update through the JAX package."""
    import jax
    import jax.numpy as jnp
    import optax

    from joeys2t_tpu.config import SpecialSymbols as JaxSymbols
    from joeys2t_tpu.config import parse_train_args as jax_parse_train_args
    from joeys2t_tpu.data.batch import Batch as JaxBatch
    from joeys2t_tpu.models import build_model as jax_build_model
    from joeys2t_tpu.models.initialization import initialize_model
    from joeys2t_tpu.optim import (build_gradient_clipper, build_optimizer,
                                   build_scheduler, set_learning_rate)
    from joeys2t_tpu.prediction import build_loss_function as jax_loss_function
    from joeys2t_tpu.training import TrainManager as JaxTrainManager
    from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary

    cfg = cfg or model_cfg()
    model, spec = jax_build_model(cfg, trg_vocab=JaxVocabulary(TOKENS, JaxSymbols()))
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 40, 80)),
                                 jnp.zeros((2, 4), jnp.int32), jnp.full((2,), 40), None,
                                 jnp.ones((2, 1, 4), bool))["params"]
    params = initialize_model(params, cfg, 1, 1, jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)  # no parameter keeps its trivial value
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(np.float32), params)
    args = jax_parse_train_args(dict(TRAINING))
    ns = SimpleNamespace(model=model, loss_fn=jax_loss_function(args, spec), args=args)
    ns._finish_loss = lambda *a: JaxTrainManager._finish_loss(ns, *a)

    def loss_fn(p, arrays, normalizer):  # dropout 0: the key is never drawn from
        return JaxTrainManager._loss_and_metrics(ns, p, arrays, jax.random.PRNGKey(0),
                                                 normalizer)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    accum, loss = None, 0.0
    for src, lengths, trg, trg_len in micro_batches():
        batch = JaxBatch(src, lengths, None, trg, trg_len, None, np.arange(3), 1, 3,
                         task="S2T").pad_to_shape(batch_size=4)
        assert batch.src.shape[1] == T_SRC and batch.trg.shape[1] == T_TRG - 1
        arrays = {name: getattr(batch, name) for name in (
            "src", "trg_input", "trg", "src_length", "src_mask", "trg_mask", "trg_length",
            "src_prompt_mask", "trg_prompt_mask")}
        (value, _), grads = grad_fn(params, arrays, jnp.float32(3.0))
        loss += float(value)
        accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
    tx = optax.chain(build_gradient_clipper(args.__dict__), build_optimizer(args.__dict__))
    scheduler, _ = build_scheduler(args.__dict__, "min", hidden_size=128)
    opt_state = tx.init(params)
    lrs = [scheduler.step(0)]
    set_learning_rate(opt_state[1], lrs[0])
    updates, _ = tx.update(accum, opt_state, params)
    lrs.append(scheduler.step(1))
    return dict(params=params, loss=loss, grads=flax_params_to_state_dict(accum),
                new_params=flax_params_to_state_dict(optax.apply_updates(params, updates)),
                lrs=lrs)


@pytest.fixture(scope="module")
def updates():
    ref = jax_update()
    return ref, one_update("cpu", flax_params_to_state_dict(ref["params"]))


def test_update_loss_and_gradients_match_jax(updates):
    """Loss to 1e-5 relative; every gradient to 1e-4 of the global gradient
    norm (f32, summation order; the port's CTC is F.ctc_loss, the JAX one a
    log-space scan)."""
    ref, port = updates
    assert abs(port["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert sorted(port["grads"]) == sorted(ref["grads"])
    assert port["grad_norm"] > 1.0  # clip_grad_norm 1.0 is active
    for name, g in ref["grads"].items():
        err = (port["grads"][name] - g).abs().max().item()
        assert err <= 1e-4 * port["grad_norm"], (name, err)


def test_update_parameters_and_rates_match_jax(updates):
    """Weights after the update to 2 * lr: Adam's first step moves each
    weight by about +-lr whatever its gradient, so a near-zero gradient may
    flip the sign. The learning rate before and after the update: the
    scheduler's step(0) and step(1)."""
    ref, port = updates
    assert port["lrs"] == ref["lrs"]
    assert port["dtypes"] == {torch.float32}
    for name, p in ref["new_params"].items():
        err = (port["params"][name] - p).abs().max().item()
        assert err <= 2 * port["lr"], (name, err)
    moved = sum(int((port["params"][n] != flax_params_to_state_dict(ref["params"])[n]).any())
                for n in port["params"])
    assert moved == len(port["params"])


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("name,cfg", [
    ("noam", {"learning_rate_factor": 2.0, "learning_rate_warmup": 7}),
    ("warmupexponentialdecay", {"learning_rate_peak": 1e-3, "learning_rate_warmup": 5,
                                "learning_rate_decay_length": 9}),
    ("warmupinversesquareroot", {"learning_rate": 2e-3, "learning_rate_warmup": 10,
                                 "learning_rate_min": 1e-6}),
    ("plateau", {"learning_rate": 1e-3, "patience": 2, "decrease_factor": 0.5}),
    ("decaying", {"learning_rate": 1e-3, "decaying_step_size": 3}),
    ("exponential", {"learning_rate": 1e-3, "decrease_factor": 0.9}),
])
def test_schedulers_match_jax(name, cfg):
    """30 steps (and for plateau 30 validations) of every scheduler, exact
    to 1e-12, and their state dicts."""
    from joeys2t_tpu import optim as jax_optim

    cfg = dict(cfg, scheduling=name)
    port, port_at = port_optim.build_scheduler(cfg, "min", hidden_size=256)
    ref, ref_at = jax_optim.build_scheduler(cfg, "min", hidden_size=256)
    assert port_at == ref_at
    scores = np.random.RandomState(0).rand(30)
    for step in range(30):
        if port_at == "validation":
            a, b = port.step_metric(scores[step]), ref.step_metric(scores[step])
        else:
            a, b = port.step(step), ref.step(step)
        assert abs(a - b) <= 1e-12, (step, a, b)
    assert port.state_dict() == ref.state_dict()


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_global_norm_clipping_matches_optax(max_norm):
    """Below and above max_norm; the clipper also returns the norm."""
    import jax.numpy as jnp

    from joeys2t_tpu.optim import build_gradient_clipper as jax_clipper

    rng = np.random.RandomState(2)
    grads = [rng.randn(7, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    ref, _ = jax_clipper({"clip_grad_norm": max_norm}).update(
        [jnp.asarray(g) for g in grads], None)
    port = [torch.tensor(g) for g in grads]
    norm = port_optim.build_gradient_clipper({"clip_grad_norm": max_norm})(port)
    assert abs(norm.item() - math.sqrt(sum((g ** 2).sum() for g in grads))) < 1e-5
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
    value = [torch.tensor(g) for g in grads]
    port_optim.build_gradient_clipper({"clip_grad_val": 0.3})(value)
    for p, g in zip(value, grads):
        np.testing.assert_array_equal(p.numpy(), np.clip(g, -0.3, 0.3))


@pytest.mark.parametrize("name,wd", [("adam", 0.1), ("adamw", 0.1)])
def test_optimizer_update_matches_optax(name, wd):
    """Two updates from fixed gradients at a fixed rate: optax's eps outside
    the square root and, for adamw, decay applied as -lr * (adam + wd * w)."""
    import jax.numpy as jnp
    import optax

    from joeys2t_tpu.optim import build_optimizer as jax_build_optimizer
    from joeys2t_tpu.optim import set_learning_rate as jax_set_lr

    cfg = {"optimizer": name, "adam_betas": [0.9, 0.98], "learning_rate": 1e-2,
           "weight_decay": wd}
    rng = np.random.RandomState(3)
    w = rng.randn(6, 4).astype(np.float32)
    gs = [rng.randn(6, 4).astype(np.float32) for _ in range(2)]
    tx = jax_build_optimizer(cfg)
    params, state = jnp.asarray(w), tx.init(jnp.asarray(w))
    param = torch.nn.Parameter(torch.tensor(w))
    opt = port_optim.build_optimizer(cfg, [param])
    for g in gs:
        jax_set_lr(state, 1e-2)
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
        port_optim.set_learning_rate(opt, 1e-2)
        param.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(params), rtol=1e-6,
                               atol=1e-7)


def test_unported_options_raise():
    """Every optimizer of the JAX package, sgd's ``momentum`` and
    ``profile_dir`` are read now, and ``freeze`` builds a trainer; an
    optimizer JAX does not know is refused by name."""
    for extra, cls in (({"optimizer": "sgd", "momentum": 0.9}, port_optim.SGD),
                       ({"optimizer": "rmsprop"}, port_optim.RMSprop),
                       ({"optimizer": "adafactor", "profile_dir": "profile"},
                        port_optim.Adafactor)):
        args = parse_train_args(dict(TRAINING, **extra))
        assert isinstance(port_optim.build_optimizer(args.__dict__, [torch.zeros(2)]), cls)
    assert parse_train_args(dict(TRAINING, momentum=0.9)).momentum == 0.9
    assert parse_train_args(dict(TRAINING, profile_dir="profile")).profile_dir.name == \
        "profile"
    with pytest.raises(ConfigurationError, match="optimizer"):
        parse_train_args(dict(TRAINING, optimizer="lamb"))
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    model, spec = build_model(model_cfg(), trg_vocab=vocab, device="cpu")
    args = parse_train_args(TRAINING)
    frozen = dict(model_cfg(), encoder=dict(model_cfg()["encoder"], freeze=True))
    tm = TrainManager(model, spec, build_loss_function(args, spec), args, model_cfg=frozen,
                      device="cpu")
    assert {id(p) for p in tm._frozen} == {id(p) for p in model.encoder.parameters()}


@pytest.mark.parametrize("option,error", [
    ({"encoder": {"type": "recurrent"}}, ConfigurationError),
    ({"tied_embeddings": True}, ConfigurationError),
    ({"tied_embeddings": True, "tied_softmax": True}, ConfigurationError),
])
def test_unported_model_options_raise(option, error):
    """A recurrent encoder of speech features is refused, as JAX refuses it
    (RNN models are for text); tied embeddings need a source vocabulary,
    which a speech model has not. (Moses pretokenization and Huggingface
    datasets are ported: tests/test_torch_text_data.py.)"""
    cfg = model_cfg()
    for key, value in option.items():
        if isinstance(value, dict):
            cfg[key] = dict(cfg[key], **value)
        else:
            cfg[key] = value
    with pytest.raises(error):
        build_model(cfg, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()), device="cpu")


# ------------------------------------------------------------- partial load
def _encoder_states(num_layers, hidden=64):
    """(JAX params, port state dict) of a speech model with ``num_layers``
    encoder layers of width ``hidden``, every tensor drawn from a seed: the
    port model's, converted to JAX's tree by ``torch_state_dict_to_flax``."""
    from joeys2t_tpu.convert import torch_state_dict_to_flax

    cfg = model_cfg()
    for side in ("encoder", "decoder"):
        cfg[side] = dict(cfg[side], hidden_size=hidden, ff_size=hidden)
    cfg["encoder"].update(num_layers=num_layers, conv_channels=hidden)
    cfg["decoder"]["embeddings"] = dict(cfg["decoder"]["embeddings"], embedding_dim=hidden)
    model, _ = build_model(cfg, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()), device="cpu")
    gen = torch.Generator().manual_seed(num_layers + hidden)
    state = {k: torch.randn(v.shape, generator=gen) for k, v in model.state_dict().items()}
    return torch_state_dict_to_flax({k: v.numpy() for k, v in state.items()}), state


@pytest.mark.parametrize("src_layers,dst_layers,prefix", [
    (16, 12, "encoder"), (2, 3, "encoder"), (16, 12, "decoder")])
def test_partial_load_matches_jax(src_layers, dst_layers, prefix):
    """Loading the encoder (or decoder) of a checkpoint: the tensors in both
    load, the model's own extra layers keep their init, the checkpoint's
    extra layers are ignored, the rest of the model is untouched."""
    from joeys2t_torch.checkpoints import partial_load
    from joeys2t_tpu.checkpoints import partial_load as jax_partial_load

    src_params, src_state = _encoder_states(src_layers)
    dst_params, dst_state = _encoder_states(dst_layers)
    merged, stats = partial_load(dst_state, src_state, prefix)
    ref = flax_params_to_state_dict(jax_partial_load(dst_params, src_params, prefix))
    assert sorted(merged) == sorted(ref) == sorted(dst_state)
    for name, value in merged.items():
        assert torch.equal(value, ref[name]), name
    per_layer = sum(k.startswith("encoder.layers.0.") for k in dst_state)
    if prefix == "encoder":
        assert stats["layers_loaded"] == min(src_layers, dst_layers)
        assert stats["layers_ignored"] == max(0, src_layers - dst_layers)
        assert stats["missing"] == per_layer * max(0, dst_layers - src_layers)
        assert stats["unexpected"] == per_layer * max(0, src_layers - dst_layers)
        changed = {k for k in merged if not torch.equal(merged[k], dst_state[k])}
        assert changed and all(k.startswith("encoder.") for k in changed)
    else:  # the decoders are alike: all of it loads
        assert stats["missing"] == stats["unexpected"] == stats["layers_ignored"] == 0


def test_partial_load_shape_mismatch_raises():
    from joeys2t_torch.checkpoints import partial_load
    from joeys2t_tpu.checkpoints import partial_load as jax_partial_load

    src_params, src_state = _encoder_states(2, hidden=32)
    dst_params, dst_state = _encoder_states(2, hidden=64)
    with pytest.raises(ValueError, match="shape mismatch"):
        partial_load(dst_state, src_state, "encoder")
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_partial_load(dst_params, src_params, "encoder")


# -------------------------------------------------------------------- batch
def test_batch_and_pad_to_shape_match_jax():
    from joeys2t_tpu.data.batch import Batch as JaxBatch

    src, lengths, trg, trg_len = micro_batches(1, seed=5)[0]
    port = Batch(src[:, :230], np.minimum(lengths, 230), None, trg, trg_len, None,
                 np.arange(3), 1, 3, task="S2T")
    ref = JaxBatch(src[:, :230], np.minimum(lengths, 230), None, trg, trg_len, None,
                   np.arange(3), 1, 3, task="S2T")
    assert (port.nseqs, port.ntokens) == (ref.nseqs, ref.ntokens)
    for a, b in ((port, ref), (port.pad_to_shape(8), ref.pad_to_shape(8)),
                 (port.pad_to_shape(5, src_len=300, trg_len=20),
                  ref.pad_to_shape(5, src_len=300, trg_len=20))):
        for name in ("src", "src_length", "trg_input", "trg", "trg_length", "trg_mask",
                     "indices"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert a.src_mask is None and b.src_mask is None
    padded = port.pad_to_shape(5)
    assert list(padded.src_length[3:]) == [1, 1] and list(padded.trg_length[3:]) == [0, 0]
    loss = np.float32(12.0)
    for norm in ("batch", "tokens", "none", "sum"):
        assert port.normalize(loss, norm, n_accumulation=2) == ref.normalize(
            loss, norm, n_accumulation=2)
    # token batches with prompt masks: padded, cut to the decoder input and
    # sorted with their rows, as JAX's
    tokens = np.where(trg == 3, 5, trg)[:, :12]
    src_prompt, trg_prompt = (tokens > 20).astype(np.int32), (trg > 20).astype(np.int32)
    port = Batch(tokens, np.array([12, 9, 5]), src_prompt, trg, trg_len, trg_prompt,
                 np.arange(3), 1, 3)
    ref = JaxBatch(tokens, np.array([12, 9, 5]), src_prompt, trg, trg_len, trg_prompt,
                   np.arange(3), 1, 3)
    for a, b in ((port, ref), (port.pad_to_shape(4), ref.pad_to_shape(4))):
        assert a.sort_by_src_length() == b.sort_by_src_length()
        for name in ("src", "src_mask", "src_prompt_mask", "trg_input", "trg_prompt_mask",
                     "indices"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


# ------------------------------------------------------------ training mode
def test_train_mode_routes_key_masked_attention_through_flash(monkeypatch):
    """In train() with dropout 0.1, the encoder self-attention and the
    decoder cross-attention go through FlashAttention with dropout (seeds
    from the trainer's generator), the causal self-attention does not. The
    meta device stands in for the card, as in test_torch_isolation.py."""
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    model, _ = build_model(model_cfg(dropout=0.1), trg_vocab=vocab, device="cpu")
    model = model.to("meta").train()
    calls = []

    def record(q, k, v, bias, sm_scale, num_heads, dropout_rate, seed, plain):
        calls.append((q.device.type, q.shape, k.shape, dropout_rate, seed is not None,
                      plain))
        return torch.empty_like(q)

    monkeypatch.setattr(fa.FlashAttention, "apply", record)
    src = torch.empty(2, 90, 80, device="meta")
    trg_in = torch.zeros(2, 7, dtype=torch.long, device="meta")
    with pytest.raises(RuntimeError, match="generator"):
        model(src, trg_in, torch.tensor([90, 60], device="meta"),
              trg_mask=torch.ones(2, 1, 7, dtype=torch.bool, device="meta"))
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    calls.clear()
    logits, ctc, _ = model(src, trg_in, torch.tensor([90, 60], device="meta"),
                           trg_mask=torch.ones(2, 1, 7, dtype=torch.bool, device="meta"))
    assert logits.shape == (2, 7, 40) and ctc.shape == (2, 23, 40)
    assert len(calls) == 3  # 2 encoder self + 1 decoder cross
    assert all(c[0] == "meta" and c[3] == 0.1 and c[4] and not c[5] for c in calls)
    assert [c[1][1] for c in calls] == [23, 23, 7]  # query lengths: enc, enc, dec


def test_bf16_update_keeps_float32_masters():
    """A bf16 model with dropout trains on float32 masters: gradients and
    weights stay float32 and every weight moves; the same seed gives the same
    update."""
    def run():
        vocab = Vocabulary(TOKENS, SpecialSymbols())
        model, spec = build_model(model_cfg(dropout=0.1), trg_vocab=vocab, device="cpu",
                                  compute_dtype=torch.bfloat16,
                                  generator=torch.Generator().manual_seed(4))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        args = parse_train_args(dict(TRAINING, batch_multiplier=1))
        tm = TrainManager(model, spec, build_loss_function(args, spec), args, seed=11,
                          device="cpu")
        out = tm.train_batch(port_batch(*micro_batches(1, seed=6)[0]))
        assert out["stepped"] and math.isfinite(out["loss"].item())
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters())
        return out["loss"].item(), model.state_dict()

    (l1, s1), (l2, s2) = run(), run()
    assert l1 == l2 and all(torch.equal(s1[n], s2[n]) for n in s1)
