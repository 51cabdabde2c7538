# coding: utf-8
"""``embeddings.load_pretrained`` against the JAX package on the CPU.

``prepare`` of both packages builds ``configs/transformer_reverse.yaml``'s
model on the first lines of test/data/reverse/ and merges a word2vec-style
text table, which the test writes itself, into the source table (MT, not
tied) and the target table (unless ``tied_embeddings``). The table holds a
few vocabulary words, a special, an out-of-vocabulary word (ignored) and
not every word (the missing rows keep their initialized values). The
loaded rows of the port's tables, mapped to the JAX tree by
``torch_state_dict_to_flax``, equal JAX's to 1e-6; every other row equals
the port's own initialization without the key. With tied embeddings
neither package loads anything."""
import copy
from pathlib import Path

import numpy as np
import pytest

from joeys2t_torch.config import load_config, parse_global_args
from joeys2t_torch.prediction import prepare
from joeys2t_tpu.config import parse_global_args as jax_parse_global_args
from joeys2t_tpu.convert import torch_state_dict_to_flax
from joeys2t_tpu.prediction import prepare as jax_prepare
from test_torch_data import REPO, few_threads  # noqa: F401
from test_torch_mt import reverse_data_cfg, write_reverse_cut

pytestmark = pytest.mark.usefixtures("few_threads")


def write_table(path, words, dim, seed):
    rng = np.random.RandomState(seed)
    rows = {w: rng.randn(dim).round(4).astype(np.float32) for w in words}
    path.write_text(f"{len(rows)} {dim}\n" + "".join(
        f"{w} {' '.join(f'{x:.4f}' for x in row)}\n" for w, row in rows.items()),
        encoding="utf-8")
    return rows


def config(tmp_path, tied, load):
    cfg = copy.deepcopy(load_config(REPO / "configs" / "transformer_reverse.yaml"))
    cfg["data"] = reverse_data_cfg(write_reverse_cut(tmp_path / "data", 40, 6, 6))
    cfg["use_cuda"] = False
    model_dir = tmp_path / f"model_{tied}_{load}"
    model_dir.mkdir(exist_ok=True)  # where prepare writes the vocabularies
    cfg["model_dir"] = str(model_dir)
    cfg["training"]["overwrite"] = True
    cfg["model"]["tied_embeddings"] = tied
    cfg["model"]["tied_softmax"] = tied
    dim = cfg["model"]["encoder"]["embeddings"]["embedding_dim"]
    words = (REPO / "test" / "data" / "reverse" / "train.src").read_text(
        encoding="utf-8").split()
    vocab_words = list(dict.fromkeys(words))[:6]
    tables = {}
    if load:
        for i, side in enumerate(("encoder", "decoder")):
            path = tmp_path / f"{side}.vec"
            tables[side] = write_table(path, vocab_words[i:i + 4] + ["</s>", "not-a-word"],
                                       dim, seed=i)
            cfg["model"][side]["embeddings"]["load_pretrained"] = str(path)
    return cfg, tables


def port_tables(cfg):
    """The port's prepared model as the JAX tree, and the vocabularies
    ``prepare`` wrote to the model directory (tokens in id order)."""
    model = prepare(parse_global_args(copy.deepcopy(cfg), mode="train"))[0]
    vocabs = {side: (Path(cfg["model_dir"]) / f"{lang}_vocab.txt").read_text(
        encoding="utf-8").splitlines() for side, lang in (("encoder", "src"),
                                                          ("decoder", "trg"))}
    tree = torch_state_dict_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    return tree, vocabs


@pytest.mark.parametrize("tied", [False, True])
def test_pretrained_tables_match_jax(tmp_path, tied):
    cfg, tables = config(tmp_path, tied, load=True)
    plain_cfg, _ = config(tmp_path, tied, load=False)
    port, vocabs = port_tables(cfg)
    fresh, _ = port_tables(plain_cfg)
    ref = jax_prepare(jax_parse_global_args(copy.deepcopy(cfg), mode="train"))[2]
    assert ("src_embed" in port) == ("src_embed" in ref) == (not tied)
    for name, side in (("src_embed", "encoder"), ("trg_embed", "decoder")):
        if name not in port:
            continue
        got = port[name]["lut"]["embedding"]
        want = np.asarray(ref[name]["lut"]["embedding"])
        init = fresh[name]["lut"]["embedding"]
        assert got.shape == want.shape == init.shape
        loaded = np.zeros(len(got), bool)
        if not tied:  # a tied table loads nothing, in either package
            for word, row in tables[side].items():
                if word in vocabs[side]:
                    idx = vocabs[side].index(word)
                    loaded[idx] = True
                    np.testing.assert_allclose(got[idx], row, rtol=0, atol=1e-6)
            assert loaded.sum() == 5  # four words and </s>; not-a-word is ignored
        np.testing.assert_allclose(got[loaded], want[loaded], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[~loaded], init[~loaded])
