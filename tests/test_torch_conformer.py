# coding: utf-8
"""The port's Conformer encoder against the JAX package's on the CPU.

JAX weights (perturbed so that no parameter, BatchNorm statistic or
LayerScale keeps its initial value) go to the port through
``flax_params_to_state_dict``; the same numpy inputs go through both, in
float32. Sizes: hidden 128, 2 heads (head dim 64: the port's attention takes
its flash route, the plain version here), ff 256, depthwise kernel 15, 2 + 2
layers. Tolerances: modules, encoder output and teacher-forced logits to
1e-5 (absolute and relative), greedy tokens identical; one training update
as test_torch_train.py holds the transformer's (loss 1e-5 relative,
gradients 1e-4 of their global norm, weights 2 * lr), the BatchNorm
statistics unchanged by it. Then the two speech configs that now build: the
Conformer's and the librispeech_100h flagship's (SentencePiece targets),
with a tokenizer model written by ``tools/spm_fixture.py``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch.config import (ConfigurationError, SpecialSymbols, check_ported,
                                  load_config, parse_global_args, parse_yaml)
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.models import build_model
from joeys2t_torch.models.modules import ConformerEncoderLayer, ConvolutionModule
from joeys2t_torch.search import transformer_greedy
from joeys2t_torch.tokenizers import SentencePieceTokenizer, build_tokenizer
from joeys2t_torch.tools import spm_fixture
from joeys2t_torch.vocabulary import Vocabulary, build_vocab
from joeys2t_tpu.config import SpecialSymbols as JaxSpecialSymbols
from joeys2t_tpu.convert import torch_state_dict_to_flax
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.models.initialization import initialize_model as jax_initialize
from joeys2t_tpu.models.modules import ConformerEncoderLayer as JaxConformerLayer
from joeys2t_tpu.models.modules import ConvolutionModule as JaxConvolutionModule
from joeys2t_tpu.search import transformer_greedy as jax_greedy
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
from test_torch_data import few_threads  # noqa: F401
from test_torch_model import LENGTHS, TOKENS, features
from test_torch_train import jax_update, model_cfg, one_update

TOL = dict(atol=1e-5, rtol=1e-5)


def perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(np.float32), params)


def port_module(module, params):
    state = flax_params_to_state_dict({"m": params})
    module.load_state_dict({k[2:]: v for k, v in state.items()})
    return module.eval()


@pytest.mark.parametrize("norm_type", ["layernorm", "batchnorm"])
def test_convolution_module_matches_jax(norm_type):
    x = np.random.RandomState(0).randn(3, 21, 128).astype(np.float32)
    jmod = JaxConvolutionModule(hidden_size=128, channels=128, depthwise_kernel_size=15,
                                dropout=0.0, norm_type=norm_type)
    params = perturbed(jmod.init({"params": jax.random.PRNGKey(0)}, x)["params"], 1)
    tmod = port_module(ConvolutionModule(128, 128, 15, 0.0, norm_type=norm_type), params)
    with torch.no_grad():
        out = tmod(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jmod.apply({"params": params}, x)),
                               **TOL)
    # the state dict converts back to the JAX tree, BatchNorm statistics included
    back = torch_state_dict_to_flax({f"encoder.{k}": v.numpy() for k, v in
                                     tmod.state_dict().items()})["encoder"]
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)


LAYER_CASES = [  # (macaron, layer_norm, layerscale, conv norm)
    ("reference", "pre", 0.0, "layernorm"), ("reference", "post", 0.0, "batchnorm"),
    ("reference", "pre", 0.0, "batchnorm"), ("paper", "pre", 0.0, "layernorm"),
    ("paper", "pre", 0.1, "layernorm"), ("paper", "pre", 0.1, "batchnorm")]


@pytest.mark.parametrize("macaron,norm,layerscale,conv_norm", LAYER_CASES)
def test_conformer_layer_matches_jax(macaron, norm, layerscale, conv_norm):
    """Both macaron forms (the reference's double norm of the last
    feed-forward's input in pre-norm), pre and post norm, LayerScale."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 19, 128).astype(np.float32)
    mask = np.arange(19)[None, None, :] < np.array([19, 11, 6])[:, None, None]
    kw = dict(size=128, ff_size=256, num_heads=2, dropout=0.0,
              depthwise_conv_kernel_size=15, layer_norm_position=norm,
              conv_norm_type=conv_norm, macaron=macaron, layerscale_init=layerscale)
    jlayer = JaxConformerLayer(**kw)
    params = perturbed(jlayer.init({"params": jax.random.PRNGKey(3)}, x, mask)["params"], 4)
    assert ("ls_ff1" in params) == (layerscale > 0)
    tlayer = port_module(ConformerEncoderLayer(
        128, 256, 2, 0.0, 15, 1.0, norm, conv_norm_type=conv_norm, macaron=macaron,
        layerscale_init=layerscale), params)
    with torch.no_grad():
        out = tlayer(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jlayer.apply({"params": params}, x,
                                                                    mask)), **TOL)


@pytest.mark.parametrize("kw", [dict(macaron="paper", layer_norm_position="post"),
                                dict(macaron="reference", layerscale_init=0.1)])
def test_conformer_layer_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        ConformerEncoderLayer(128, 256, 2, **kw)


def conformer_cfg(macaron="paper", layerscale=0.1, conv_norm="layernorm", dropout=0.0):
    return {
        "initializer": "xavier_uniform", "bias_initializer": "zeros",
        "encoder": {"type": "conformer", "num_layers": 2, "num_heads": 2,
                    "embeddings": {"embedding_dim": 80}, "hidden_size": 128,
                    "ff_size": 256, "dropout": dropout, "subsample": True,
                    "conv_kernel_sizes": [5, 5], "conv_channels": 128, "in_channels": 80,
                    "layer_norm": "pre", "depthwise_conv_kernel_size": 15,
                    "macaron": macaron, "layerscale": layerscale, "conv_norm": conv_norm},
        "decoder": model_cfg(dropout)["decoder"] | {"num_layers": 2},
    }


MODELS = {"paper-layerscale": conformer_cfg(),
          "reference-batchnorm": conformer_cfg("reference", 0.0, "batchnorm")}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    cfg = MODELS[request.param]
    b = len(LENGTHS)
    jmodel, jspec = jax_build_model(cfg, trg_vocab=JaxVocabulary(TOKENS, JaxSpecialSymbols()))
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((b, 40, 80)),
                         jnp.zeros((b, 4), jnp.int32), jnp.full((b,), 40), None,
                         jnp.ones((b, 1, 4), bool))["params"]
    params = perturbed(jax_initialize(params, cfg, 1, 1, jax.random.PRNGKey(1)), 5)
    tmodel, tspec = build_model(cfg, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()),
                                device="cpu")
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    return dict(cfg=cfg, jmodel=jmodel, jspec=jspec, params=params, tmodel=tmodel,
                tspec=tspec)


def test_state_dict_converts_to_the_jax_tree(pair):
    back = torch_state_dict_to_flax({k: v.numpy() for k, v in
                                     pair["tmodel"].state_dict().items()})
    assert jax.tree.structure(back) == jax.tree.structure(pair["params"])
    jax.tree.map(np.testing.assert_array_equal, back, pair["params"])


def test_encoder_logits_and_greedy_match_jax(pair):
    jmodel, params, tmodel = pair["jmodel"], pair["params"], pair["tmodel"]
    src = features()
    enc_j, _, mask_j = jmodel.apply({"params": params}, jnp.asarray(src),
                                    jnp.asarray(LENGTHS), None, method="encode")
    rng = np.random.RandomState(7)
    trg = rng.randint(4, 40, size=(len(LENGTHS), 9)).astype(np.int32)
    trg_mask = np.ones((len(LENGTHS), 1, 9), bool)
    trg_mask[1, :, 6:] = False
    logits_j, ctc_j, _ = jmodel.apply({"params": params}, jnp.asarray(src), jnp.asarray(trg),
                                      jnp.asarray(LENGTHS), None, jnp.asarray(trg_mask))
    with torch.no_grad():
        enc_t, _, mask_t = tmodel.encode(torch.tensor(src), torch.tensor(LENGTHS))
        logits_t, ctc_t, _ = tmodel(torch.tensor(src), torch.tensor(trg).long(),
                                    torch.tensor(LENGTHS), trg_mask=torch.tensor(trg_mask))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    valid = np.asarray(mask_j)[:, 0, :, None]
    np.testing.assert_allclose(enc_t.numpy() * valid, np.asarray(enc_j) * valid, **TOL)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(ctc_t.numpy() * valid, np.asarray(ctc_j) * valid, **TOL)
    out_j, _, _ = jax_greedy(params, jmodel, pair["jspec"], enc_j, mask_j, 12)
    out_t, _, _ = transformer_greedy(tmodel, pair["tspec"], enc_t, mask_t, 12, device="cpu")
    np.testing.assert_array_equal(out_t, np.asarray(out_j))


def test_initialization_keeps_the_constants():
    """LayerScale starts at the config's constant, BatchNorm at weight 1,
    bias 0, running mean 0 and variance 1; every other weight is drawn."""
    cfg = conformer_cfg("paper", 0.1, "batchnorm")
    model, _ = build_model(cfg, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()),
                           device="cpu", generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    layer = "encoder.layers.1."
    for name in ("ls_ff1", "ls_att", "ls_conv", "ls_ff2"):
        assert torch.equal(state[layer + name], torch.full((128,), 0.1))
    bn = layer + "conv_module.batch_norm."
    for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                        ("running_var", 1.0)):
        assert torch.equal(state[bn + name], torch.full((128,), value)), name
    assert state[layer + "conv_module.depthwise_conv.weight"].shape == (128, 1, 15)
    assert state[layer + "conv_module.depthwise_conv.weight"].std() > 0.01
    assert "running_mean" not in dict(model.named_parameters())  # a buffer


@pytest.fixture(scope="module")
def updates():
    cfg = conformer_cfg("paper", 0.1, "batchnorm")
    ref = jax_update(cfg)
    return ref, one_update("cpu", flax_params_to_state_dict(ref["params"]), cfg)


def test_update_matches_jax(updates):
    """One float32 update at dropout 0 (two accumulated micro-batches) of a
    Conformer with LayerScale and BatchNorm: loss, gradients, weights and
    rates as test_torch_train.py holds the transformer's; the frozen
    BatchNorm statistics take no gradient and do not move."""
    ref, port = updates
    assert abs(port["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert port["lrs"] == ref["lrs"] and port["grad_norm"] > 1.0
    stats = {n for n in ref["grads"] if "running_" in n}
    assert len(stats) == 4 and not stats & set(port["grads"])
    assert sorted(port["grads"]) == sorted(set(ref["grads"]) - stats)
    for name, g in port["grads"].items():
        err = (g - ref["grads"][name]).abs().max().item()
        assert err <= 1e-4 * port["grad_norm"], (name, err)
    before = flax_params_to_state_dict(ref["params"])
    for name, p in ref["new_params"].items():
        err = (port["params"][name] - p).abs().max().item()
        assert err <= 2 * port["lr"], (name, err)
        if name in stats:
            assert torch.equal(port["params"][name], before[name]) and torch.equal(p,
                                                                                  before[name])
        else:
            assert not torch.equal(port["params"][name], before[name]), name


def test_yaml_reader_keeps_refusing_anchors_and_block_strings():
    for text in ("a: &x 1\nb: *x", "a: |\n  two\n  lines", "a: >\n  folded",
                 "a: {b: 1", "a: {b}"):
        with pytest.raises(ConfigurationError):
            parse_yaml(text)
    assert parse_yaml("a: {b: [1, {c: d}],\n    e: 'f g'}\n") == {
        "a": {"b": [1, {"c": "d"}], "e": "f g"}}


@pytest.mark.parametrize("name", ["synthetic_asr_conformer.yaml", "librispeech_100h.yaml"])
def test_speech_configs_build(name, tmp_path):
    """The config read by the port's YAML reader, its target side on a
    SentencePiece unigram model from the fixture (the Conformer's char
    targets switched to it), passes ``check_ported`` and builds its model
    at full width (depth cut to one layer a side to keep the test quick)."""
    cfg = load_config(f"configs/{name}")
    pieces = spm_fixture.corpus_pieces(["a small speech corpus of words"] * 3, 60)
    trg = cfg["data"]["trg"]
    trg.update(level="bpe", tokenizer_type="sentencepiece",
               voc_file=str(spm_fixture.write_vocab(tmp_path / "vocab.txt", pieces)))
    trg.setdefault("tokenizer_cfg", {})["model_file"] = str(
        spm_fixture.write_model(tmp_path / "spm.model", pieces, "unigram"))
    cfg.update(use_cuda=False, model_dir=str(tmp_path))
    check_ported(parse_global_args(copy.deepcopy(cfg), mode="test"))
    cfg["data"]["special_symbols"] = SpecialSymbols()
    tokenizer = build_tokenizer(cfg["data"], "S2T")
    assert isinstance(tokenizer["trg"], SentencePieceTokenizer)
    _, vocab = build_vocab(cfg["data"], "S2T")
    model_cfg_ = copy.deepcopy(cfg["model"])
    for side in ("encoder", "decoder"):
        model_cfg_[side]["num_layers"] = 1
    model, _ = build_model(model_cfg_, trg_vocab=vocab, device="cpu")
    enc = model.encoder
    assert enc.hidden_size == 512 and len(vocab) == len(pieces) - 3 + 4
    if name.startswith("synthetic"):
        layer = enc.layers[0]
        assert (layer.macaron, layer.layerscale_init) == ("paper", 0.1)
        assert layer.conv_module.depthwise_conv.weight.shape == (512, 1, 31)


@pytest.mark.usefixtures("few_threads")
def test_conformer_config_trains_through_the_cli(tmp_path):
    """configs/synthetic_asr_conformer.yaml (read by the port's YAML reader)
    through ``train`` and ``test -o`` on the CPU, cut as
    test_torch_data.tiny_cfg cuts the transformer config: 2 + 2 layers,
    hidden 32, 4 updates, 2 validations, greedy."""
    from joeys2t_torch.__main__ import main
    from joeys2t_torch.checkpoints import load_checkpoint
    from joeys2t_torch.config import dump_yaml
    from test_torch_data import make_corpus, tiny_cfg

    data = make_corpus(tmp_path / "data")
    tiny = tiny_cfg(data, tmp_path / "model")
    cfg = load_config("configs/synthetic_asr_conformer.yaml")
    cfg.update(use_cuda=False, fp16=False, model_dir=tiny["model_dir"], data=tiny["data"],
               training=tiny["training"], testing=tiny["testing"])
    for side in ("encoder", "decoder"):
        cfg["model"][side].update(num_layers=2, hidden_size=32, ff_size=64, num_heads=2)
    cfg["model"]["encoder"]["conv_channels"] = 32
    cfg["model"]["decoder"]["embeddings"]["embedding_dim"] = 32
    cfg_path = tmp_path / "conformer.yaml"
    cfg_path.write_text(dump_yaml(cfg), encoding="utf-8")
    main(["train", str(cfg_path)])
    main(["test", str(cfg_path), "-o", str(tmp_path / "out")])
    model_dir = tmp_path / "model"
    assert len((model_dir / "validations.txt").read_text().splitlines()) == 2
    state = load_checkpoint(model_dir / "latest.ckpt")["model_state"]
    assert "encoder.layers.1.ls_ff2" in state and "encoder.linear.weight" in state
    assert all(torch.isfinite(v).all() for v in state.values())
    assert not torch.equal(state["encoder.layers.0.ls_conv"], torch.full((32,), 0.1))
    for split in ("dev", "test"):
        assert len((tmp_path / f"out.{split}").read_text().splitlines()) == 8
