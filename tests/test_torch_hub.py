# coding: utf-8
"""Serving from a model directory against the JAX package on the CPU.

A tiny JAX model directory (``configs/synthetic_asr.yaml`` cut as
test_torch_data.tiny_cfg cuts it, its target side switched to ``level: bpe,
tokenizer_type: sentencepiece`` with a unigram model that
``tools/spm_fixture.py`` draws from the train transcripts) holds a JAX
checkpoint of perturbed float32 weights; its port twin holds the same
files with the checkpoint converted by ``convert.jax_checkpoint_to_port``.
``load_model_dir`` of each must give the same ``generate`` hypotheses, the
same ``score`` tokens and probabilities (to 1e-5 relative) with and without
references, and ``Transcriber.from_hub`` the same detokenized transcripts
of speech-like waveforms."""
import copy
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from joeys2t_torch.config import dump_yaml, load_config
from joeys2t_torch.convert import jax_checkpoint_to_port
from joeys2t_torch.hub_interface import load_model_dir
from joeys2t_torch.serving import Transcriber
from joeys2t_torch.tools import spm_fixture
from joeys2t_tpu.checkpoints import save_checkpoint as jax_save_checkpoint
from joeys2t_tpu.config import SpecialSymbols as JaxSpecialSymbols
from joeys2t_tpu.hub_interface import load_model_dir as jax_load_model_dir
from joeys2t_tpu.models import build_model as jax_build_model
from joeys2t_tpu.models.initialization import initialize_model as jax_initialize
from joeys2t_tpu.serving import Transcriber as JaxTranscriber
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
from test_torch_data import few_threads, make_corpus, tiny_cfg  # noqa: F401
from test_torch_serving import speechlike

pytestmark = pytest.mark.usefixtures("few_threads")


def transcripts(tsv):
    rows = tsv.read_text(encoding="utf-8").splitlines()
    col = rows[0].split("\t").index("trg")
    return [r.split("\t")[col] for r in rows[1:]]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(JAX model dir, port model dir, test feature paths, dev references)."""
    tmp = tmp_path_factory.mktemp("hub")
    corpus = make_corpus(tmp / "data")
    pieces = spm_fixture.corpus_pieces(transcripts(corpus / "train.tsv"), 200, "unigram")
    model_file = spm_fixture.write_model(tmp / "spm_unigram.model", pieces, "unigram")
    voc_file = spm_fixture.write_vocab(tmp / "spm_vocab.txt", pieces)
    jax_dir, port_dir = tmp / "jax_model", tmp / "port_model"
    cfg = tiny_cfg(corpus, jax_dir)
    cfg["data"]["trg"].update(level="bpe", tokenizer_type="sentencepiece",
                              voc_file=str(voc_file),
                              tokenizer_cfg={"model_file": str(model_file)})
    cfg["testing"]["max_output_length"] = 12
    tokens = voc_file.read_text(encoding="utf-8").splitlines()
    model, _ = jax_build_model(cfg["model"], trg_vocab=JaxVocabulary(
        tokens, JaxSpecialSymbols()))
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 40, 80)),
                        jnp.zeros((2, 4), jnp.int32), jnp.full((2,), 40), None,
                        jnp.ones((2, 1, 4), bool))["params"]
    params = jax_initialize(params, cfg["model"], 1, 1, jax.random.PRNGKey(1))
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.3 * rng.randn(*x.shape).astype(np.float32), params)
    for out in (jax_dir, port_dir):
        out.mkdir()
        # a published directory: the config names files that are not there,
        # and the directory holds them
        shipped = copy.deepcopy(cfg)
        shipped["data"]["trg"]["voc_file"] = "/elsewhere/trg_vocab.txt"
        shipped["data"]["trg"]["tokenizer_cfg"]["model_file"] = "/elsewhere/spm.model"
        shipped["model_dir"] = "/elsewhere"
        (out / "config.yaml").write_text(dump_yaml(shipped), encoding="utf-8")
        shutil.copy(voc_file, out / "trg_vocab.txt")
        shutil.copy(model_file, out / "spm.model")
    jax_save_checkpoint(jax_dir / "best.ckpt", {"model_state": params})
    jax_checkpoint_to_port(jax_dir / "best.ckpt", port_dir / "best.ckpt")
    feats = sorted(str(p) for p in (corpus / "feats").glob("test-*.npy"))[:5]
    return jax_dir, port_dir, feats, transcripts(corpus / "dev.tsv")[:5]


@pytest.fixture(scope="module")
def hubs(dirs):
    jax_dir, port_dir, _, _ = dirs
    return jax_load_model_dir(jax_dir), load_model_dir(port_dir, use_cuda=False)


@pytest.mark.parametrize("testing", [{}, {"beam_size": 5, "beam_alpha": 1.0}])
def test_generate_matches_jax(dirs, hubs, testing):
    _, _, feats, _ = dirs
    jax_hub, port_hub = hubs
    got = port_hub.generate(feats, **testing)
    assert got == jax_hub.generate(feats, **testing)
    assert len(got) == 5 and all(isinstance(t, str) and t for t in got)
    assert not any("▁" in t for t in got)  # SentencePiece pieces joined to text


@pytest.mark.parametrize("with_trg,testing", [
    (False, {}), (False, {"beam_size": 5, "beam_alpha": 1.0, "n_best": 2}), (True, {})])
def test_score_matches_jax(dirs, hubs, with_trg, testing):
    _, _, feats, refs = dirs
    jax_hub, port_hub = hubs
    trg = refs if with_trg else None
    got = port_hub.score(feats, trg=trg, **testing)
    want = jax_hub.score(feats, trg=trg, **testing)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.translation == w.translation and g.tokens == w.tokens
        for name in ("token_probs", "sequence_probs"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                for x, y in zip(a, b):
                    np.testing.assert_allclose(np.asarray(x, np.float64),
                                               np.asarray(y, np.float64), rtol=1e-5,
                                               atol=1e-6)
        # the attention a greedy decode returns, as JAX's (JAX pads its rows'
        # frames to the batch's bucket): 1e-5 at float32; beam returns none
        assert (g.attention_probs is None) == (w.attention_probs is None)
        for a, b in zip(g.attention_probs or [], w.attention_probs or []):
            a, b = np.asarray(a), np.asarray(b)
            np.testing.assert_allclose(a, b[:, :a.shape[1]], rtol=0, atol=1e-5)
            assert not b[:, a.shape[1]:].any()
    if with_trg:
        assert [g.translation for g in got] == refs


def test_model_dir_files_and_refusals(dirs, hubs):
    _, port_dir, _, _ = dirs
    _, port_hub = hubs
    tok = port_hub.dataset.tokenizer["trg"]
    assert tok.model_file == port_dir / "spm.model"  # found in the directory
    assert port_hub.args.device.type == "cpu"
    # a speech source's columns are its subsampled frames (JAX labels them
    # with the feature rows, which matplotlib refuses)
    _, _, feats, refs = dirs
    scored = port_hub.score(feats[:1])[0]
    att = np.asarray(scored.attention_probs[0])
    rows = len(port_hub.dataset.tokenizer["trg"](refs[0], is_train=False)) + 1
    fig = port_hub.plot_attention(feats[0], refs[0], np.resize(att, (rows, att.shape[1])))
    assert len(fig.axes[0].get_xticklabels()) == att.shape[1]
    with pytest.raises(TypeError):
        port_hub.generate("not a list")


def test_transcriber_from_hub_matches_jax(hubs):
    jax_hub, port_hub = hubs
    jax_asr, port_asr = JaxTranscriber.from_hub(jax_hub), Transcriber.from_hub(port_hub)
    assert (port_asr.norm_means, port_asr.norm_vars) == (jax_asr.norm_means,
                                                         jax_asr.norm_vars)
    rng = np.random.RandomState(2)
    waves = [speechlike(rng, n) for n in (16000, 23000, 30000)]
    for kw in ({}, {"beam_size": 5}):
        texts = port_asr.transcribe(waves, max_output_length=10, **kw)
        assert texts == jax_asr.transcribe(waves, max_output_length=10, **kw)
        assert not any("▁" in t for t in texts)


def test_port_trained_model_dir_serves(dirs, tmp_path):
    """The port's own ``train`` with SentencePiece targets copies the model
    file into the model directory; ``load_model_dir`` of that directory
    generates what ``translate`` prints, and ``Transcriber.from_hub`` serves
    detokenized text."""
    import io
    import sys

    from joeys2t_torch.__main__ import main

    jax_dir, _, feats, _ = dirs
    cfg = load_config(jax_dir / "config.yaml")
    data = Path(feats[0]).parents[1]
    model_dir = tmp_path / "trained"
    cfg.update(model_dir=str(model_dir))
    cfg["data"]["trg"]["voc_file"] = str(jax_dir / "trg_vocab.txt")
    cfg["data"]["trg"]["tokenizer_cfg"]["model_file"] = str(jax_dir / "spm.model")
    for split in ("train", "dev", "test"):
        cfg["data"][split] = str(data / split)
    cfg_path = tmp_path / "spm.yaml"
    cfg_path.write_text(dump_yaml(cfg), encoding="utf-8")
    main(["train", str(cfg_path)])
    assert (model_dir / "spm.model").read_bytes() == (jax_dir / "spm.model").read_bytes()
    stdin, stdout = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = io.StringIO("".join(f"{p}\n" for p in feats)), io.StringIO()
    try:
        main(["translate", str(cfg_path)])
        printed = sys.stdout.getvalue().splitlines()
    finally:
        sys.stdin, sys.stdout = stdin, stdout
    hub = load_model_dir(model_dir, use_cuda=False)
    assert hub.generate(feats) == printed and len(printed) == 5
    texts = Transcriber.from_hub(hub).transcribe(
        [speechlike(np.random.RandomState(3), 20000)], max_output_length=8)
    assert len(texts) == 1 and texts[0] and "▁" not in texts[0]
