# coding: utf-8
"""``attention_impl`` (of the model, or of the encoder's or decoder's own
section, as joeys2t_tpu/models/model.py:293 and :370 read it) on the CPU.

``xla`` routes every attention of its side to the plain versions of the
kernels (flash forward and backward, decode attention with and without the
ancestry map), on any device; ``auto``, ``flash`` and ``decode_kernel``
route to the kernel wrappers, which run their plain versions on a CPU
tensor only. Held here: the flags each value sets; outputs under every
value equal to JAX's under the same value (teacher-forced logits, and lazy
beam tokens); and the routing itself, on meta tensors, where a kernel
wrapper raises (it runs on cpu or cuda only) and a plain version runs."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.models import build_model
from joeys2t_torch.models.modules import MultiHeadedAttention
from joeys2t_torch.search import beam_search
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.search import beam_search as jax_beam_search
from test_torch_beam_lazy import CFG, LENGTHS, TOKENS, asr_pair

IMPLS = ["auto", "xla", "flash", "decode_kernel"]


def with_impl(model=None, encoder=None, decoder=None):
    cfg = copy.deepcopy(CFG)
    if model is not None:
        cfg["attention_impl"] = model
    if encoder is not None:
        cfg["encoder"]["attention_impl"] = encoder
    if decoder is not None:
        cfg["decoder"]["attention_impl"] = decoder
    return cfg


def plain_flags(model):
    return {side: {m.plain for m in getattr(model, side).modules()
                   if isinstance(m, MultiHeadedAttention)} for side in ("encoder", "decoder")}


@pytest.mark.parametrize("impls,expected", [
    ({}, (False, False)), ({"model": "xla"}, (True, True)),
    ({"encoder": "xla"}, (True, False)), ({"decoder": "xla"}, (False, True)),
    ({"model": "flash", "decoder": "xla"}, (False, False)),
    ({"model": "decode_kernel"}, (False, False))])
def test_attention_impl_sets_each_side(impls, expected):
    """The model's key wins over a side's, as in JAX."""
    model, _ = build_model(with_impl(**impls), device="cpu",
                           trg_vocab=Vocabulary(TOKENS, SpecialSymbols()))
    assert plain_flags(model) == {"encoder": {expected[0]}, "decoder": {expected[1]}}


def test_unknown_attention_impl_is_refused():
    with pytest.raises(ValueError, match="attention_impl"):
        build_model(with_impl(model="triton"), device="cpu",
                    trg_vocab=Vocabulary(TOKENS, SpecialSymbols()))


@pytest.mark.parametrize("impl", IMPLS)
def test_outputs_match_jax_under_every_value(impl):
    """Teacher-forced logits (encoder self-attention and decoder cross
    attention through flash or its plain version) and lazy beam-4 tokens
    (decode attention with the ancestry map): the port under ``impl``
    against JAX under the same value (on the CPU JAX takes its einsum path
    under each), to 1e-5 and token for token."""
    p = asr_pair(with_impl(model=impl))
    assert plain_flags(p["tmodel"])["decoder"] == {impl == "xla"}
    rng = np.random.RandomState(4)
    feats = rng.randn(3, 120, 20).astype(np.float32)
    trg = rng.randint(4, 24, size=(3, 6))
    trg_mask = np.ones((3, 1, 6), bool)
    logits_j, _, _ = p["jmodel"].apply({"params": p["params"]}, jnp.asarray(feats),
                                       jnp.asarray(trg), jnp.asarray(LENGTHS), None,
                                       jnp.asarray(trg_mask))
    with torch.no_grad():
        logits_t, _, _ = p["tmodel"](torch.tensor(feats), torch.tensor(trg),
                                     torch.tensor(LENGTHS), trg_mask=torch.tensor(trg_mask))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-5)
    ids_j, _, _ = jax_beam_search(p["params"], p["jmodel"], p["jspec"], jnp.asarray(p["enc"]),
                                  None, jnp.asarray(p["mask"]), 4, 10, 1.0)
    ids_t, _, _ = beam_search(p["tmodel"], p["tspec"], torch.tensor(p["enc"]), None,
                              torch.tensor(p["mask"]), 4, 10, 1.0, device="cpu")
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))


def test_xla_takes_the_plain_versions_off_the_cpu():
    """On meta tensors (neither cpu nor cuda) the kernel wrappers raise and
    the plain versions run: ``xla`` reaches only the plain versions, the
    other values only the wrappers."""
    gen = torch.Generator().manual_seed(0)
    for impl in IMPLS:
        model, _ = build_model(with_impl(model=impl), device="cpu",
                               trg_vocab=Vocabulary(TOKENS, SpecialSymbols()), generator=gen)
        layer = model.decoder.layers[0]
        att = copy.deepcopy(layer.src_trg_att).to("meta")
        x, mem = torch.empty(2, 3, 64, device="meta"), torch.empty(2, 5, 64, device="meta")
        key_mask = torch.ones(2, 1, 5, dtype=torch.bool, device="meta")
        self_att = copy.deepcopy(layer.trg_trg_att).to("meta")
        cache = torch.empty(6, 4, 7, 16, device="meta")
        bias = torch.empty(6, 7, device="meta")
        anc = torch.empty(2, 3, 7, dtype=torch.int32, device="meta")
        q = torch.empty(6, 1, 64, device="meta")
        calls = [lambda: att(mem, mem, x, key_mask),
                 lambda: self_att.step_self(q, cache, cache.clone(), 2, bias),
                 lambda: self_att.step_self_ancestry(q, cache, cache.clone(), 2, bias, anc)]
        for call in calls:
            if impl == "xla":
                assert call().device.type == "meta"
            else:
                with pytest.raises(ValueError, match="runs on cpu or cuda"):
                    call()


def test_xla_gradients_flow_through_the_plain_flash_backward():
    """One backward of the encoder under ``xla`` equals the one under
    ``auto`` on the CPU (both the flash backward's plain version)."""
    grads = {}
    for impl in ("auto", "xla"):
        model, _ = build_model(with_impl(model=impl), device="cpu",
                               trg_vocab=Vocabulary(TOKENS, SpecialSymbols()),
                               generator=torch.Generator().manual_seed(1))
        feats = torch.tensor(np.random.RandomState(2).randn(2, 60, 20).astype(np.float32))
        enc, _, _ = model.encode(feats, torch.tensor([60, 41]))
        enc.float().pow(2).sum().backward()
        grads[impl] = {n: p.grad for n, p in model.encoder.named_parameters()
                       if p.grad is not None}
    assert grads["auto"].keys() == grads["xla"].keys() and grads["auto"]
    for name, g in grads["auto"].items():
        torch.testing.assert_close(grads["xla"][name], g, rtol=1e-5, atol=1e-6, msg=name)


def test_flash_autograd_function_takes_the_plain_pair():
    """``flash_attention_flat(..., plain=True)`` on CPU tensors gives the
    wrapper's outputs and gradients (the same plain functions)."""
    from joeys2t_torch.ops.flash_attention import flash_attention_flat, key_bias

    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.randn(2, n, 32).astype(np.float32), requires_grad=True)
               for n in (4, 6, 6))
    bias = key_bias(torch.tensor([[True] * 6, [True] * 3 + [False] * 3]), 2, 6, "cpu")
    outs = []
    for plain in (False, True):
        out = flash_attention_flat(q, k, v, bias, 0.25, 2, plain=plain)
        grads = torch.autograd.grad(out.sum(), (q, k, v))
        outs.append((out.detach(), grads))
    torch.testing.assert_close(outs[1][0], outs[0][0])
    for a, b in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(a, b)
