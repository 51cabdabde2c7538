# coding: utf-8
"""The port's model against the JAX package on the CPU: one set of JAX
weights goes to the port through ``flax_params_to_state_dict``, the same
numpy inputs go through both, and encoder outputs, decode-step logits and
caches, teacher-forced logits and greedy tokens are compared at float32.

Size: 2 encoder and 2 decoder layers, hidden 128, 2 heads (head dim 64),
ff 256, a 40-token vocabulary; and configs/mustc_asr.yaml's model section
(hidden 512, 8 heads of 64, ff 2048) cut to 1 encoder and 1 decoder layer."""
import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from joeys2t_torch.config import SpecialSymbols, parse_yaml
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.models import build_model
from joeys2t_torch.models.modules import (Conv1dSubsampler, MultiHeadedAttention,
                                          TransformerDecoderLayer,
                                          TransformerEncoderLayer)
from joeys2t_torch.search import transformer_greedy
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.config import SpecialSymbols as JaxSpecialSymbols
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.models.initialization import initialize_model as jax_initialize
from joeys2t_tpu.models.modules import Conv1dSubsampler as JaxConv1dSubsampler
from joeys2t_tpu.models.modules import MultiHeadedAttention as JaxMHA
from joeys2t_tpu.models.modules import TransformerDecoderLayer as JaxDecoderLayer
from joeys2t_tpu.models.modules import TransformerEncoderLayer as JaxEncoderLayer
from joeys2t_tpu.search import transformer_greedy as jax_greedy
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary

CFG = {
    "initializer": "xavier_uniform", "bias_initializer": "zeros",
    "encoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                "embeddings": {"embedding_dim": 80}, "hidden_size": 128,
                "ff_size": 256, "dropout": 0.1, "subsample": True,
                "conv_kernel_sizes": [5, 5], "conv_channels": 128, "in_channels": 80,
                "layer_norm": "pre", "activation": "relu"},
    "decoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                "embeddings": {"embedding_dim": 128, "scale": True, "dropout": 0.1},
                "hidden_size": 128, "ff_size": 256, "dropout": 0.1,
                "layer_norm": "pre", "activation": "relu"},
}
TOKENS = [f"t{i}" for i in range(36)]  # + 4 specials = 40 ids
B, T = 4, 560  # 140 frames after subsampling: the JAX encoder pads to 256
LENGTHS = np.array([560, 430, 301, 500])


def jax_s2t(seed=0, compute_dtype=jnp.float32):
    """The JAX model with xavier-initialized float32 weights, every leaf
    (biases and LayerNorm too) perturbed so no parameter keeps its trivial
    value."""
    vocab = JaxVocabulary(TOKENS, JaxSpecialSymbols())
    model, spec = jax_build_model(CFG, trg_vocab=vocab, compute_dtype=compute_dtype)
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((B, 40, 80)),
                        jnp.zeros((B, 4), jnp.int32), jnp.full((B,), 40), None,
                        jnp.ones((B, 1, 4), bool))["params"]
    params = jax_initialize(params, CFG, 1, 1, jax.random.PRNGKey(seed + 1))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(np.float32), params)
    return model, spec, params, vocab


def port_from_jax(params, compute_dtype=torch.float32):
    """The port model on the CPU carrying the JAX weights."""
    model, spec = build_model(CFG, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()),
                              compute_dtype=compute_dtype, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params))
    return model, spec


def features(seed=0):
    return np.random.RandomState(seed + 100).randn(B, T, 80).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jmodel, jspec, params, _ = jax_s2t()
    tmodel, tspec = port_from_jax(params)
    src = features()
    enc_j, _, mask_j = jmodel.apply({"params": params}, jnp.asarray(src),
                                    jnp.asarray(LENGTHS), None, method="encode")
    with torch.no_grad():
        enc_t, _, mask_t = tmodel.encode(torch.tensor(src), torch.tensor(LENGTHS))
    return dict(jmodel=jmodel, jspec=jspec, params=params, tmodel=tmodel, tspec=tspec,
                src=src, enc_j=enc_j, mask_j=mask_j, enc_t=enc_t, mask_t=mask_t)


# configs/mustc_asr.yaml's model section (hidden 512, 8 heads of head dim
# 64, ff 2048, conv subsampler [5, 5] of 512 channels, untied) cut to 1
# encoder and 1 decoder layer: the 8-head models' attention shape, whose
# bf16 forward takes the wgmma kernel's two tiles on the card
with open(Path(__file__).resolve().parents[1] / "configs" / "mustc_asr.yaml",
          encoding="utf-8") as _f:
    CFG_D64 = yaml.safe_load(_f)["model"]
CFG_D64["encoder"]["num_layers"] = CFG_D64["decoder"]["num_layers"] = 1
B64, T64 = 3, 300  # 75 frames after subsampling
LENGTHS64 = np.array([300, 211, 97])


@pytest.fixture(scope="module")
def pair_d64():
    """The JAX model and the port at mustc_asr's widths (8 heads of 64), one
    set of perturbed xavier weights, and both encoders' outputs."""
    vocab = JaxVocabulary(TOKENS, JaxSpecialSymbols())
    jmodel, jspec = jax_build_model(CFG_D64, trg_vocab=vocab, compute_dtype=jnp.float32)
    params = jmodel.init({"params": jax.random.PRNGKey(64)}, jnp.zeros((B64, 40, 80)),
                         jnp.zeros((B64, 4), jnp.int32), jnp.full((B64,), 40), None,
                         jnp.ones((B64, 1, 4), bool))["params"]
    params = jax_initialize(params, CFG_D64, 1, 1, jax.random.PRNGKey(65))
    rng = np.random.RandomState(64)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.02 * rng.randn(*x.shape).astype(np.float32), params)
    tmodel, tspec = build_model(CFG_D64, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()),
                                compute_dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    src = np.random.RandomState(164).randn(B64, T64, 80).astype(np.float32)
    enc_j, _, mask_j = jmodel.apply({"params": params}, jnp.asarray(src),
                                    jnp.asarray(LENGTHS64), None, method="encode")
    with torch.no_grad():
        enc_t, _, mask_t = tmodel.encode(torch.tensor(src), torch.tensor(LENGTHS64))
    return dict(jmodel=jmodel, jspec=jspec, params=params, tmodel=tmodel, tspec=tspec,
                enc_j=enc_j, mask_j=mask_j, enc_t=enc_t, mask_t=mask_t)


def test_d64_encoder_output_matches(pair_d64):
    """mustc_asr's 8-head, head-dim-64 encoder layer at full width: the
    port's attention (the flash route's plain version on the CPU) against
    the JAX package's, float32, within 1e-5."""
    assert CFG_D64["encoder"]["hidden_size"] // CFG_D64["encoder"]["num_heads"] == 64
    np.testing.assert_array_equal(pair_d64["mask_t"].numpy(), np.asarray(pair_d64["mask_j"]))
    assert pair_d64["enc_t"].shape == (B64, 75, 512)
    np.testing.assert_allclose(pair_d64["enc_t"].numpy(), np.asarray(pair_d64["enc_j"]),
                               atol=1e-5, rtol=1e-5)


def test_d64_greedy_tokens_match(pair_d64):
    """Greedy search of the 8-head, head-dim-64 model: the same tokens as
    JAX's, the decode steps' attention at head dim 64."""
    out_j, _, _ = jax_greedy(pair_d64["params"], pair_d64["jmodel"], pair_d64["jspec"],
                             pair_d64["enc_j"], pair_d64["mask_j"], 10)
    out_t, _, _ = transformer_greedy(pair_d64["tmodel"], pair_d64["tspec"],
                                     pair_d64["enc_t"], pair_d64["mask_t"], 10,
                                     device="cpu")
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
    assert out_t.shape == (B64, 10) and len(set(np.asarray(out_t).ravel())) > 1


def test_subsampled_lengths_match():
    lengths = np.arange(1, 3001)
    ks = (5, 5)
    ref = JaxConv1dSubsampler.get_out_seq_lens(jnp.asarray(lengths), ks)
    out = Conv1dSubsampler.get_out_seq_lens(torch.tensor(lengths), ks)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_encoder_output_matches(pair):
    np.testing.assert_array_equal(pair["mask_t"].numpy(), np.asarray(pair["mask_j"]))
    assert pair["enc_t"].shape == (B, 140, 128)
    np.testing.assert_allclose(pair["enc_t"].numpy(), np.asarray(pair["enc_j"]),
                               atol=1e-5, rtol=1e-5)


def test_teacher_forced_logits_match(pair):
    rng = np.random.RandomState(7)
    trg = rng.randint(4, 40, size=(B, 9)).astype(np.int32)
    trg_mask = np.ones((B, 1, 9), bool)
    trg_mask[1, :, 6:] = False
    logits_j, ctc_j, _ = pair["jmodel"].apply(
        {"params": pair["params"]}, jnp.asarray(pair["src"]), jnp.asarray(trg),
        jnp.asarray(LENGTHS), None, jnp.asarray(trg_mask))
    with torch.no_grad():
        logits_t, ctc_t, _ = pair["tmodel"](
            torch.tensor(pair["src"]), torch.tensor(trg).long(), torch.tensor(LENGTHS),
            trg_mask=torch.tensor(trg_mask))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ctc_t.numpy(), np.asarray(ctc_j), atol=1e-4, rtol=1e-4)


def test_decode_steps_and_caches_match(pair):
    jmodel, params, tmodel = pair["jmodel"], pair["params"], pair["tmodel"]
    enc_j, mask_j = pair["enc_j"], pair["mask_j"]
    max_len = 6
    cache_j = jmodel.apply({"params": params}, enc_j, max_len,
                           src_valid=mask_j[:, 0, :], method="init_cache")
    with torch.no_grad():
        mask_t = torch.tensor(np.asarray(mask_j))
        cache_t = tmodel.init_cache(torch.tensor(np.asarray(enc_j)), max_len, mask_t)
        for name in ("cross_k", "cross_v"):
            np.testing.assert_allclose(cache_t["layer_1"][name].numpy(),
                                       np.asarray(cache_j["layer_1"][name]), atol=1e-5)
        tokens = np.random.RandomState(8).randint(4, 40, size=(B, max_len)).astype(np.int32)
        tokens[:, 0] = 2  # bos
        for step in range(4):
            logits_j, cache_j, _ = jmodel.apply(
                {"params": params}, jnp.asarray(tokens[:, step:step + 1]), step, cache_j,
                mask_j, method="decode_step")
            logits_t = tmodel.decode_step(
                torch.tensor(tokens[:, step:step + 1]).long(), step, cache_t)
            np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                       atol=1e-4, rtol=1e-4, err_msg=f"step {step}")
            for layer in ("layer_0", "layer_1"):
                for name in ("self_k", "self_v"):
                    np.testing.assert_allclose(cache_t[layer][name].numpy(),
                                               np.asarray(cache_j[layer][name]),
                                               atol=1e-5, err_msg=f"{layer} {name} {step}")


@pytest.mark.parametrize("eos_scale,kwargs", [
    (1.0, {}),
    (-2.0, {}),  # some rows end early and pad the rest
    (-5.0, {}),  # every row ends at step 2: the loop stops there
    (-2.0, {"return_prob": "hyp", "generate_unk": False, "min_output_length": 3}),
])
def test_greedy_tokens_match(pair, eos_scale, kwargs):
    """Same tokens as the JAX greedy search; the eos logit is rescaled in
    both models to steer when rows finish."""
    params = jax.tree.map(np.array, pair["params"])
    params["decoder"]["output_layer"]["kernel"][:, 3] *= eos_scale
    out_j, scores_j, _ = jax_greedy(params, pair["jmodel"], pair["jspec"],
                                    pair["enc_j"], pair["mask_j"], 12, **kwargs)
    tmodel = pair["tmodel"]
    w = tmodel.decoder.output_layer.weight
    saved = w.detach().clone()
    stats = {}
    try:
        with torch.no_grad():
            w[3] *= eos_scale
        out_t, scores_t, _ = transformer_greedy(
            tmodel, pair["tspec"], pair["enc_t"], pair["mask_t"], 12,
            device="cpu", stats=stats, **kwargs)
    finally:
        with torch.no_grad():
            w.copy_(saved)
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
    ends = [list(r).index(3) + 1 if 3 in r else 12 for r in out_t]
    assert stats["decode_steps"] == max(ends)
    for row, end in zip(out_t, ends):
        assert (row[end:] == 1).all()  # pad after eos
    if eos_scale == -5.0:
        assert max(ends) == 2
    if scores_t is not None:
        np.testing.assert_allclose(scores_t, np.asarray(scores_j), atol=1e-4)


def test_attention_with_key_mask_matches():
    """Full-length attention through the flash route (the plain version on
    the CPU) against the JAX module's einsum path."""
    rng = np.random.RandomState(9)
    jmha = JaxMHA(num_heads=2, size=128, dropout=0.0)
    x = rng.randn(3, 21, 128).astype(np.float32)
    mem = rng.randn(3, 17, 128).astype(np.float32)
    mask = np.arange(17)[None, None, :] < np.array([17, 9, 4])[:, None, None]
    params = jax.tree.map(np.asarray, jmha.init({"params": jax.random.PRNGKey(3)},
                                                mem, mem, x, mask)["params"])
    out_j, _ = jmha.apply({"params": params}, mem, mem, x, jnp.asarray(mask))
    tmha = MultiHeadedAttention(2, 128).eval()
    tmha.load_state_dict({k.replace("att.", ""): v for k, v in flax_params_to_state_dict(
        {"att": params}).items()})
    with torch.no_grad():
        out_t = tmha(torch.tensor(mem), torch.tensor(mem), torch.tensor(x),
                     torch.tensor(mask))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)


def _port_module(module, params):
    """Load a JAX module's parameters into the matching port module."""
    state = flax_params_to_state_dict({"m": params})
    module.load_state_dict({k[2:]: v for k, v in state.items()})
    return module.eval()


@pytest.mark.parametrize("norm,act", [("post", "gelu"), ("pre", "swish")])
def test_layers_match_in_other_norm_and_activation(norm, act):
    """The layer branches the flagship config does not take: post-LN and the
    gelu (tanh approximation) / swish activations."""
    rng = np.random.RandomState(11)
    kw = dict(size=128, ff_size=256, num_heads=2, dropout=0.0, alpha=1.0,
              layer_norm_position=norm, activation=act)
    x = rng.randn(3, 13, 128).astype(np.float32)
    mem = rng.randn(3, 17, 128).astype(np.float32)
    src_mask = np.arange(17)[None, None, :] < np.array([17, 9, 4])[:, None, None]
    trg_mask = np.tril(np.ones((1, 13, 13), bool)) & (
        np.arange(13)[None, None, :] < np.array([13, 13, 8])[:, None, None])
    perturb = lambda p: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), p)

    jenc = JaxEncoderLayer(**kw)
    p_enc = perturb(jenc.init({"params": jax.random.PRNGKey(0)}, x, src_mask[:, :, :13])
                    ["params"])
    jdec = JaxDecoderLayer(**kw)
    p_dec = perturb(jdec.init({"params": jax.random.PRNGKey(1)}, x, mem, src_mask,
                              trg_mask)["params"])
    tkw = dict(size=128, ff_size=256, num_heads=2, dropout=0.0, alpha=1.0,
               layer_norm_position=norm, activation=act)
    tenc = _port_module(TransformerEncoderLayer(**tkw), p_enc)
    tdec = _port_module(TransformerDecoderLayer(**tkw), p_dec)
    enc_mask = src_mask[:, :, :13]
    out_j = jenc.apply({"params": p_enc}, x, enc_mask)
    dec_j, _ = jdec.apply({"params": p_dec}, x, mem, src_mask, trg_mask)
    with torch.no_grad():
        out_t = tenc(torch.tensor(x), torch.tensor(enc_mask))
        dec_t = tdec(torch.tensor(x), torch.tensor(mem), torch.tensor(src_mask),
                     torch.tensor(trg_mask))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), atol=1e-5, rtol=1e-5)


def test_vocabulary_matches_jax():
    ids = np.random.RandomState(10).randint(0, 40, size=(5, 12))
    port = Vocabulary(TOKENS, SpecialSymbols())
    ref = JaxVocabulary(TOKENS, JaxSpecialSymbols())
    assert len(port) == len(ref) == 40
    assert port.arrays_to_sentences(ids) == ref.arrays_to_sentences(ids)
    assert [port.lookup(t) for t in ("t3", "<s>", "nope")] == \
        [ref.lookup(t) for t in ("t3", "<s>", "nope")]


def test_yaml_reader_matches_pyyaml():
    """The port reads configs without PyYAML; every repository config, flow
    mappings over several lines included, parses exactly as yaml.safe_load
    does."""
    paths = sorted(glob.glob("configs/*.yaml"))
    for path in paths:
        text = open(path, encoding="utf-8").read()
        assert parse_yaml(text) == yaml.safe_load(text), path
    assert len(paths) >= 20
