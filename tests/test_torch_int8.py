# coding: utf-8
"""The port's int8 decode caches (``cache_cross_int8``, ``cache_self_int8``)
against the JAX package's on the CPU, where the JAX decoder takes its einsum
path (``_decode_einsum``, which folds the scales into q and the scores) and
the port its decode attention's plain version.

Model as in test_torch_model.py (2 + 2 layers, hidden 128, head dim 64,
a 40-token vocabulary), float32, with both int8 flags. Tolerances:
``init_cache`` int8 values equal and scales to 1e-6 relative, on inputs
whose projections are exact in float32 (dyadic weights and activations), so
both sides round the same numbers; decode-step logits to 1e-5 on a cache
shared by both; greedy and beam-5 tokens identical (beam under JAX's
``physical`` reorder and its default, the ancestry map), n-best scores to
1e-4 relative.

Why 1e-4 for the scores: each int8 self slot is rounded from a float32
projection, and the two frameworks' matrix products differ in their last
bit (their summation orders differ, torch's with the thread count and the
CPU), which now and then rounds one value a step the other way (seen: one
beam score of 20 off by 5.5e-5 relative, tokens identical). The decode-step
test takes that out: the port's step writes JAX's quantized slot, after
the port's own is checked to equal it but for values within 1e-3 of a
rounding boundary."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.models import build_model
from joeys2t_torch.search import beam_search, transformer_greedy
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.config import SpecialSymbols as JaxSpecialSymbols
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.search import beam_search as jax_beam_search
from joeys2t_tpu.search import transformer_greedy as jax_greedy
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
from test_torch_model import CFG, LENGTHS, TOKENS, features, jax_s2t

FLAGS = [{"cache_cross_int8": True, "cache_self_int8": True},
         {"cache_cross_int8": True}, {"decoder": {"cache_self_int8": True}}]


def with_flags(flags):
    cfg = copy.deepcopy(CFG)
    for key, value in flags.items():
        if isinstance(value, dict):
            cfg[key].update(value)
        else:
            cfg[key] = value
    return cfg


def models(flags):
    """The JAX and the port model with the same perturbed float32 weights
    (test_torch_model.jax_s2t) and int8 ``flags``, and the encoder output
    of ``features()`` (JAX's, which both decoders take)."""
    cfg = with_flags(flags)
    _, _, params, _ = jax_s2t()
    jmodel, jspec = jax_build_model(cfg, trg_vocab=JaxVocabulary(TOKENS,
                                                                 JaxSpecialSymbols()))
    tmodel, tspec = build_model(cfg, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()),
                                device="cpu")
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    enc, _, mask = jmodel.apply({"params": params}, jnp.asarray(features()),
                                jnp.asarray(LENGTHS), None, method="encode")
    return dict(jmodel=jmodel, jspec=jspec, params=params, tmodel=tmodel, tspec=tspec,
                enc=np.asarray(enc), mask=np.asarray(mask))


@pytest.fixture(scope="module")
def pair():
    return models(FLAGS[0])


def test_flags_reach_the_decoder():
    for flags in FLAGS:
        model, _ = build_model(with_flags(flags), device="cpu",
                               trg_vocab=Vocabulary(TOKENS, SpecialSymbols()))
        cross = flags.get("cache_cross_int8", False)
        own = flags.get("cache_self_int8", flags.get("decoder", {}).get("cache_self_int8"))
        assert (model.decoder.cache_cross_int8, model.decoder.cache_self_int8) == (
            cross, bool(own))


def _dyadic(rng, shape, scale):
    """Small integers times a power of two: sums of their products are
    exact in float32 in any order."""
    return (rng.randint(-4, 5, size=shape) * scale).astype(np.float32)


def test_init_cache_matches_jax(pair):
    """Values and scales of every layer's int8 caches; the padded frames,
    filled with large values, are left out of the channel scales on both
    sides (their values still quantize, clipped to +-127)."""
    rng = np.random.RandomState(3)
    params = jax.tree.map(np.array, pair["params"])
    for i in range(2):
        att = params["decoder"][f"layer_{i}"]["src_trg_att"]
        for name in ("k_layer", "v_layer"):
            att[name]["kernel"] = _dyadic(rng, att[name]["kernel"].shape, 1 / 64)
            att[name]["bias"] = _dyadic(rng, att[name]["bias"].shape, 1 / 16)
    tmodel = copy.deepcopy(pair["tmodel"])
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    mask = pair["mask"]
    enc = _dyadic(rng, pair["enc"].shape, 1 / 8)
    enc[~mask[:, 0, :]] = 40.0  # padding: far above every valid frame
    assert (~mask).any()
    cache_j = pair["jmodel"].apply({"params": params}, jnp.asarray(enc), 6,
                                   src_valid=jnp.asarray(mask[:, 0, :]), method="init_cache")
    with torch.no_grad():
        cache_t = tmodel.init_cache(torch.tensor(enc), 6, torch.tensor(mask))
    for layer in ("layer_0", "layer_1"):
        for name in ("cross_k", "cross_v", "self_k", "self_v"):
            got, ref = cache_t[layer][name], np.asarray(cache_j[layer][name])
            assert got.dtype == torch.int8 and got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{layer} {name}")
        for name in ("cross_k_scale", "cross_v_scale", "self_k_scale", "self_v_scale"):
            got, ref = cache_t[layer][name], np.asarray(cache_j[layer][name])
            assert got.dtype == torch.float32 and got.shape == ref.shape
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, err_msg=f"{layer} {name}")
        # the valid frames set the scales: no valid value clips
        k = cache_t[layer]["cross_k"].numpy()
        assert np.abs(k[np.broadcast_to(mask[:, :, :, None], k.shape)]).max() == 127
        assert np.asarray(cache_t[layer]["cross_k_scale"]).max() < 1.0


def test_decode_steps_match_jax(pair, monkeypatch):
    """Four decode steps over one int8 cache (JAX's, copied to the port):
    logits to 1e-5, and the slot each step writes: the port's quantization
    of its own projection equals JAX's slot but where the value lies within
    1e-3 of a rounding boundary, and the step then goes on with JAX's slot,
    so both sides attend over the same cache."""
    from joeys2t_torch.models import modules

    jmodel, params, tmodel = pair["jmodel"], pair["params"], pair["tmodel"]
    enc, mask = jnp.asarray(pair["enc"]), jnp.asarray(pair["mask"])
    cache_j = jmodel.apply({"params": params}, enc, 6, src_valid=mask[:, 0, :],
                           method="init_cache")
    own_quantize, slots = modules.quantize_per_position, []

    def jax_slot(x):
        own_q, own_s = own_quantize(x)
        ref_q, ref_s = slots.pop(0)
        np.testing.assert_allclose(own_s.numpy(), ref_s.numpy(), rtol=1e-5)
        off = own_q.numpy() != ref_q.numpy()
        ratio = (x.float() / own_s[..., None]).numpy()
        assert np.abs(np.abs(ratio[off] - np.floor(ratio[off])) - 0.5).max(
            initial=0.0) < 1e-3
        assert np.abs(own_q.numpy().astype(int) - ref_q.numpy()).max() <= 1
        return ref_q, ref_s

    monkeypatch.setattr(modules, "quantize_per_position", jax_slot)
    with torch.no_grad():
        cache_t = tmodel.init_cache(torch.tensor(pair["enc"]), 6, torch.tensor(pair["mask"]))
        for layer in ("layer_0", "layer_1"):  # one cache for both sides
            for name, value in cache_j[layer].items():
                cache_t[layer][name] = torch.tensor(np.array(value))
        tokens = np.random.RandomState(8).randint(4, 40, size=(4, 6)).astype(np.int32)
        tokens[:, 0] = 2
        for step in range(4):
            logits_j, cache_j, _ = jmodel.apply(
                {"params": params}, jnp.asarray(tokens[:, step:step + 1]), step, cache_j,
                mask, method="decode_step")
            slots[:] = [(torch.tensor(np.array(cache_j[layer][name][:, :, step])),
                         torch.tensor(np.array(cache_j[layer][name + "_scale"][:, :, step])))
                        for layer in ("layer_0", "layer_1") for name in ("self_k", "self_v")]
            logits_t = tmodel.decode_step(torch.tensor(tokens[:, step:step + 1]).long(),
                                          step, cache_t)
            assert not slots  # every layer wrote its key and value slot
            np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-5,
                                       rtol=1e-5, err_msg=f"step {step}")
            for layer in ("layer_0", "layer_1"):
                for name in ("self_k", "self_v", "self_k_scale", "self_v_scale"):
                    np.testing.assert_array_equal(cache_t[layer][name].numpy(),
                                                  np.asarray(cache_j[layer][name]),
                                                  err_msg=f"{layer} {name} step {step}")


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("eos_scale,kwargs", [
    (1.0, {}), (-2.0, {"return_prob": "hyp", "min_output_length": 3})])
def test_greedy_tokens_match_jax(flags, eos_scale, kwargs):
    p = models(flags)
    params = jax.tree.map(np.array, p["params"])
    params["decoder"]["output_layer"]["kernel"][:, 3] *= eos_scale
    out_j, scores_j, _ = jax_greedy(params, p["jmodel"], p["jspec"], jnp.asarray(p["enc"]),
                                    jnp.asarray(p["mask"]), 12, **kwargs)
    with torch.no_grad():
        p["tmodel"].decoder.output_layer.weight[3] *= eos_scale
    out_t, scores_t, _ = transformer_greedy(p["tmodel"], p["tspec"], torch.tensor(p["enc"]),
                                            torch.tensor(p["mask"]), 12, device="cpu",
                                            **kwargs)
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
    if scores_t is not None:
        np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("reorder", ["physical", "auto"])
@pytest.mark.parametrize("n_best,alpha,eos_scale", [(1, 1.0, 1.0), (5, 1.0, 1.2),
                                                    (2, -1.0, 3.0)])
def test_beam_search_matches_jax(pair, reorder, n_best, alpha, eos_scale):
    """Beam 5 over int8 caches, both sides under the same ``beam_reorder``:
    the physical reorder moves the self buffers' scales with their values
    (the cross caches and their scales are shared and never moved), the
    ancestry map of ``auto`` reads them where they were written; both give
    the same hypotheses."""
    params = jax.tree.map(np.array, pair["params"])
    params["decoder"]["output_layer"]["kernel"][:, 3] *= eos_scale
    tmodel = copy.deepcopy(pair["tmodel"])
    with torch.no_grad():
        tmodel.decoder.output_layer.weight[3] *= eos_scale
    ids_j, scores_j, _ = jax_beam_search(
        params, pair["jmodel"], pair["jspec"], jnp.asarray(pair["enc"]), None,
        jnp.asarray(pair["mask"]), 5, 12, alpha, n_best=n_best, beam_reorder=reorder,
        return_prob="hyp")
    ids_t, scores_t, _ = beam_search(tmodel, pair["tspec"], torch.tensor(pair["enc"]), None,
                                     torch.tensor(pair["mask"]), 5, 12, alpha, n_best=n_best,
                                     device="cpu", return_prob="hyp", beam_reorder=reorder)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    np.testing.assert_allclose(scores_t, np.asarray(scores_j), rtol=1e-4)
    if eos_scale == 3.0:  # the best beams end early
        assert (ids_t[::n_best] == 3).any(axis=1).all()
