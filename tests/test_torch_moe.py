# coding: utf-8
"""The mixture-of-experts feed-forward (switch-style top-1 routing, dense
dispatch) in the port against the JAX package on the CPU.

``MoEFeedForward`` alone (pre- and post-norm, with and without padded
tokens) and a 2 + 2-layer text model with 4 experts in each encoder layer,
as tests/test_moe.py builds it (without the mesh), with JAX's weights
carried by ``flax_params_to_state_dict``: the forward to 1e-5, the
load-balance term to 1e-6 over the valid tokens, one update with the term
in the loss, greedy and beam tokens, the initializer's fans of the expert
tensors and the converter's leaves."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch.config import parse_train_args
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.losses import build_loss_function
from joeys2t_torch.models import build_model
from joeys2t_torch.models.modules import MoEFeedForward
from joeys2t_torch.search import beam_search, transformer_greedy
from joeys2t_torch.training import TrainManager
from joeys2t_tpu.config import parse_train_args as jax_parse_train_args
from joeys2t_tpu.convert import torch_state_dict_to_flax
from joeys2t_tpu.data.batch import Batch as JaxBatch
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.models import modules as jax_modules
from joeys2t_tpu.search import beam_search as jax_beam_search
from joeys2t_tpu.search import greedy as jax_greedy
from test_torch_data import few_threads  # noqa: F401
from test_torch_mt import EOS, PAD, jax_params, source, vocabs

pytestmark = pytest.mark.usefixtures("few_threads")


def moe_cfg(num_experts: int = 4, initializer: str = "xavier_uniform"):
    """tests/test_moe.py's model: 2 + 2 pre-norm layers of hidden 16, 2
    heads, feed-forward 32, ``num_experts`` experts in each encoder layer,
    at dropout 0."""
    side = {"type": "transformer", "num_layers": 2, "num_heads": 2, "hidden_size": 16,
            "ff_size": 32, "dropout": 0.0, "layer_norm": "pre",
            "embeddings": {"embedding_dim": 16, "scale": True}}
    return {"initializer": initializer, "attention_impl": "xla",
            "encoder": dict(side, num_experts=num_experts), "decoder": dict(side)}


@pytest.fixture(scope="module")
def pair():
    cfg = moe_cfg()
    tv, jv = vocabs()
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    params = jax_params(jmodel, cfg, seed=1)
    tmodel, tspec = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    tmodel.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return SimpleNamespace(tmodel=tmodel, tspec=tspec, jmodel=jmodel, jspec=jspec,
                           params=params, cfg=cfg)


def aux_of(mutated) -> float:
    return float(sum(jnp.sum(jnp.asarray(v))
                     for v in jax.tree.leaves(mutated.get("aux_loss", {}))))


# ------------------------------------------------------------------- module
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("layer_norm_position", ["pre", "post"])
def test_moe_feed_forward_matches_jax(layer_norm_position, padded):
    """Output to 1e-5 and the load-balance term to 1e-6, its statistics
    over the valid tokens only when ``token_valid`` is given; every expert
    is chosen somewhere."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 16).astype(np.float32)
    valid = np.ones((3, 7), bool)
    valid[1, 4:], valid[2, 1:] = False, False
    jff = jax_modules.MoEFeedForward(input_size=16, ff_size=32, num_experts=4, dropout=0.0,
                                     layer_norm_position=layer_norm_position)
    kwargs = {"token_valid": jnp.asarray(valid)} if padded else {}
    params = jff.init(jax.random.PRNGKey(0), jnp.asarray(x), **kwargs)["params"]
    params = jax.tree.map(lambda p: np.asarray(p) + 0.3 * rng.randn(*p.shape).astype(
        np.float32), params)
    ref, mutated = jff.apply({"params": params}, jnp.asarray(x), mutable=["aux_loss"],
                             **kwargs)
    ff = MoEFeedForward(16, 32, 4, dropout=0.0, layer_norm_position=layer_norm_position)
    ff.load_state_dict({k[len("feed_forward."):]: v for k, v in flax_params_to_state_dict(
        {"feed_forward": params}).items()}, strict=True)
    with torch.no_grad():
        got = ff(torch.tensor(x), torch.tensor(valid) if padded else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert abs(float(ff.aux_loss) - aux_of(mutated)) <= 1e-6
    with torch.no_grad():
        router = torch.nn.functional.linear(
            torch.nn.functional.layer_norm(torch.tensor(x), (16,), ff.layer_norm.weight,
                                           ff.layer_norm.bias, 1e-6)
            if layer_norm_position == "pre" else torch.tensor(x), ff.router.weight)
    assert len(set(router.argmax(-1).flatten().tolist())) == 4


# -------------------------------------------------------------------- model
def test_moe_model_tree_and_converter_leaves(pair):
    """The port's parameter names and shapes are JAX's: the experts' w1 (E,
    H, F), b1 (E, F), w2 (E, F, H), b2 (E, H) as they are, the router
    transposed; ``torch_state_dict_to_flax`` of the port's state dict gives
    JAX's tree back exactly, and the decoder has no experts."""
    state = {k: v.numpy() for k, v in pair.tmodel.state_dict().items()}
    tree = torch_state_dict_to_flax(state)
    assert jax.tree.structure(tree) == jax.tree.structure(pair.params)
    for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(pair.params)):
        np.testing.assert_array_equal(got, want)
    for layer in range(2):
        ff = f"encoder.layers.{layer}.feed_forward."
        assert state[ff + "w1"].shape == (4, 16, 32) and state[ff + "b1"].shape == (4, 32)
        assert state[ff + "w2"].shape == (4, 32, 16) and state[ff + "b2"].shape == (4, 16)
        np.testing.assert_array_equal(
            state[ff + "router.weight"],
            np.asarray(pair.params["encoder"][f"layer_{layer}"]["feed_forward"]["router"][
                "kernel"]).T)
    assert not any("w1" in k for k in state if k.startswith("decoder"))


def model_inputs():
    src, src_len, src_mask, src_prompt = source()
    rng = np.random.RandomState(9)
    trg = np.concatenate([np.full((3, 1), 2), rng.randint(7, 47, size=(3, 5))], axis=1)
    trg_mask = np.ones((3, 1, 6), bool)
    trg_mask[2, 0, 4:] = False
    return src, trg, src_len, src_mask, trg_mask, src_prompt


def test_moe_model_forward_and_aux_term_match_jax(pair):
    """Logits to 1e-5 of the largest, and the model's load-balance term
    (the sum over its MoE layers, each over the source's valid tokens: a
    padded row is in the batch) to 1e-6."""
    inputs = model_inputs()
    (ref, _, _), mutated = pair.jmodel.apply(
        {"params": pair.params}, *map(jnp.asarray, inputs[:5]),
        src_prompt_mask=jnp.asarray(inputs[5]), mutable=["aux_loss"])
    with torch.no_grad():
        got, _, _ = pair.tmodel(*map(torch.tensor, inputs))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    aux = sum(m.aux_loss for m in pair.tmodel.modules() if isinstance(m, MoEFeedForward))
    assert abs(float(aux) - aux_of(mutated)) <= 1e-6 and float(aux) >= 2.0 - 1e-6


TRAINING = {"optimizer": "adamw", "adam_betas": [0.9, 0.98], "weight_decay": 0.01,
            "learning_rate": 1.0e-3, "clip_grad_norm": 1.0, "batch_size": 4,
            "batch_type": "sentence", "batch_multiplier": 2, "normalization": "tokens",
            "label_smoothing": 0.1, "loss": "crossentropy"}


def test_moe_update_matches_jax():
    """One update (two accumulated micro-batches at dropout 0, AdamW) with
    the load-balance term in the loss as JAX adds it (0.01 * aux divided by
    the accumulation count): the logged loss (term included) to 1e-5
    relative, gradients (the router's too) to 1e-5 of the global norm,
    weights after the update as Adam's step allows within that tolerance."""
    # pylint: disable=too-many-locals
    from joeys2t_tpu.optim import build_gradient_clipper, build_optimizer
    from joeys2t_tpu.prediction import build_loss_function as jax_loss_function
    from joeys2t_tpu.training import TrainManager as JaxTrainManager
    import optax
    from test_torch_mt import mt_micro_batches

    cfg = moe_cfg()
    tv, jv = vocabs()
    jmodel, jspec = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    params = jax_params(jmodel, cfg, seed=2)
    tmodel, tspec = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    tmodel.load_state_dict(flax_params_to_state_dict(params), strict=True)
    args = jax_parse_train_args(dict(TRAINING))
    ns = SimpleNamespace(model=jmodel, loss_fn=jax_loss_function(args, jspec), args=args)
    ns._finish_loss = lambda *a: JaxTrainManager._finish_loss(ns, *a)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda prm, arrays, norm: JaxTrainManager._loss_and_metrics(
            ns, prm, arrays, jax.random.PRNGKey(0), norm), has_aux=True))
    targs = parse_train_args(dict(TRAINING))
    tm = TrainManager(tmodel, tspec, build_loss_function(targs, tspec), targs,
                      device="cpu", task="MT")
    seen, apply = {}, tm.apply_accum

    def capture():
        seen["grads"] = {n: q.grad.detach().clone() for n, q in tmodel.named_parameters()}
        apply()

    tm.apply_accum = capture
    accum, ref_loss, port_loss, ref_nll = None, 0.0, 0.0, 0.0
    for src, src_len, src_prompt, trg, trg_len, trg_prompt in mt_micro_batches():
        ntokens = int((trg[:, 1:] != PAD).sum())
        jb = JaxBatch(src, src_len, src_prompt, trg, trg_len, trg_prompt, np.arange(3),
                      PAD, EOS).pad_to_shape(batch_size=4)
        arrays = {name: getattr(jb, name) for name in (
            "src", "trg_input", "trg", "src_length", "src_mask", "trg_mask", "trg_length",
            "src_prompt_mask", "trg_prompt_mask")}
        (value, metrics), grads = grad_fn(params, arrays, jnp.float32(ntokens))
        ref_loss += float(value)
        ref_nll += float(metrics[1])
        accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
        out = tm.train_batch(Batch(src, src_len, src_prompt, trg, trg_len, trg_prompt,
                                   np.arange(3), PAD, EOS))
        port_loss += out["loss"].item()
    assert tm.stats.steps == 1
    assert abs(port_loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert ref_loss - ref_nll > 0.01  # the term is in the loss (label smoothing aside)
    ref_grads = flax_params_to_state_dict(accum)
    assert sorted(ref_grads) == sorted(seen["grads"])
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in seen["grads"].values())))
    for key, g in ref_grads.items():
        assert (seen["grads"][key] - g).abs().max().item() <= 1e-5 * norm, key
    assert seen["grads"]["encoder.layers.0.feed_forward.router.weight"].abs().max() > 0
    tx = optax.chain(build_gradient_clipper(args.__dict__), build_optimizer(args.__dict__))
    updates, _ = tx.update(accum, tx.init(params), params)
    new = flax_params_to_state_dict(optax.apply_updates(params, updates))
    lr, eps, dg = targs.learning_rate, 1e-8, 1e-5 * norm
    for key, value in tmodel.state_dict().items():
        g = ref_grads[key].abs()
        tol = 1e-5 + lr * torch.clamp(eps * dg / (g + eps) ** 2, max=2.0)
        assert ((value - new[key]).abs() <= tol).all(), key


def test_moe_validation_loss_leaves_out_the_term(pair):
    """Validation's loss is the cross-entropy alone, as JAX's eval apply
    computes it: the model's forward in eval mode returns the same logits
    whatever the term, and ``predict`` reports their loss."""
    from joeys2t_torch.prediction import _eval_loss

    src, trg, src_len, _, _, _ = model_inputs()
    trg = np.concatenate([trg, np.full((3, 1), EOS)], 1)
    trg[2, 3:] = [EOS, PAD, PAD, PAD]
    batch = Batch(src, src_len, None, trg, np.array([7, 7, 4]), None, np.arange(3), PAD,
                  EOS)
    loss_fn = build_loss_function(parse_train_args(dict(TRAINING, label_smoothing=0.0)),
                                  pair.tspec)
    total, _, _ = _eval_loss(pair.tmodel, loss_fn, batch, torch.device("cpu"), False)
    logits = pair.jmodel.apply({"params": pair.params}, jnp.asarray(batch.src),
                               jnp.asarray(batch.trg_input), jnp.asarray(batch.src_length),
                               jnp.asarray(batch.src_mask), jnp.asarray(batch.trg_mask))[0]
    lp = np.asarray(jax.nn.log_softmax(logits, -1), np.float64)
    nll = -sum(lp[b, t, batch.trg[b, t]] for b in range(3) for t in range(batch.trg.shape[1])
               if batch.trg[b, t] != PAD)
    assert abs(total - nll) <= 1e-5 * abs(nll)


# ------------------------------------------------------------------- search
@pytest.mark.parametrize("k,n_best", [(1, 1), (4, 2)])
def test_moe_search_matches_jax(pair, k, n_best):
    """Greedy (k 1) and beam (4 beams, 2-best) token-identical, scores to
    1e-5 relative."""
    src, src_len, src_mask, _ = source()
    with torch.no_grad():
        enc, _, mask = pair.tmodel.encode(torch.tensor(src), torch.tensor(src_len),
                                          torch.tensor(src_mask))
    if k == 1:
        ids_j, scores_j, _ = jax_greedy(pair.params, pair.jmodel, pair.jspec,
                                        jnp.asarray(enc.numpy()), None,
                                        jnp.asarray(mask.numpy()), 12, return_prob="hyp")
        ids_t, scores_t, _ = transformer_greedy(pair.tmodel, pair.tspec, enc, mask, 12,
                                                device="cpu", return_prob="hyp")
    else:
        ids_j, scores_j, _ = jax_beam_search(pair.params, pair.jmodel, pair.jspec,
                                             jnp.asarray(enc.numpy()), None,
                                             jnp.asarray(mask.numpy()), k, 12, 1.0,
                                             n_best=n_best, return_prob="hyp")
        ids_t, scores_t, _ = beam_search(pair.tmodel, pair.tspec, enc, None, mask, k, 12,
                                         1.0, n_best=n_best, device="cpu",
                                         return_prob="hyp")
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- initialization
@pytest.mark.parametrize("initializer", ["xavier_uniform", "xavier_normal"])
def test_moe_initializer_fans(initializer):
    """The experts' w1 (E, H, F) and w2 (E, F, H) take the fans of JAX's
    layout with E as the receptive field, (H + F) * E; b1 (E, F) and b2
    (E, H) are drawn as weight matrices (their leaf is not ``bias``), and
    under xavier_normal every tensor of the feed-forward, router included,
    takes DeepNet's beta; JAX's draws have the same spreads."""
    from joeys2t_torch.models.initialization import compute_alpha_beta
    from joeys2t_tpu.models.initialization import initialize_model as jax_initialize

    cfg = moe_cfg(num_experts=8, initializer=initializer)
    for side in ("encoder", "decoder"):
        cfg[side].update(hidden_size=64, ff_size=256, num_heads=4,
                         embeddings={"embedding_dim": 64, "scale": True})
    tv, jv = vocabs()
    model, _ = build_model(cfg, src_vocab=tv, trg_vocab=tv, device="cpu")
    jmodel, _ = jax_build_model(cfg, src_vocab=jv, trg_vocab=jv)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.ones((2, 5), jnp.int32), jnp.ones((2, 4), jnp.int32),
                            jnp.full((2,), 5), jnp.ones((2, 1, 5), bool),
                            jnp.ones((2, 1, 4), bool))["params"]
    jstate = flax_params_to_state_dict(jax_initialize(
        jax.tree.map(lambda s: jnp.zeros(s.shape), shapes), cfg, PAD, PAD,
        jax.random.PRNGKey(3)))
    beta = (compute_alpha_beta(2, 2)["beta"]["encoder"]
            if initializer == "xavier_normal" else 1.0)
    fans = {"w1": (64 + 256) * 8, "w2": (256 + 64) * 8, "b1": 8 + 256, "b2": 8 + 64,
            "router.weight": 8 + 64}
    for leaf, fan in fans.items():
        key = f"encoder.layers.1.feed_forward.{leaf}"
        want = beta * (2.0 / fan) ** 0.5
        for value in (model.state_dict()[key], jstate[key]):
            assert abs(float(value.std()) / want - 1) < 0.1, (key, float(value.std()), want)
