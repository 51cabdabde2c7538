# coding: utf-8
"""The port's subword tokenizers against the JAX package's on the CPU.

SentencePiece models come from ``joeys2t_torch.tools.spm_fixture`` (unigram
and BPE, a few dozen to a few hundred pieces drawn from a text), subword-nmt
codes from the port's own ``bpe.learn_bpe`` (held to JAX's first). Pieces,
decoded text and the tokenizer classes' pre- and post-processing (prompts
included) must be identical. Sampling (SentencePiece ``alpha``, BPE
``dropout``) is compared draw for draw: the JAX side draws from the global
``random`` module seeded with ``random.seed(s)``, the port from its own
``random.Random`` seeded with ``s``."""
import random

import numpy as np
import pytest

from joeys2t_torch import bpe as port_bpe
from joeys2t_torch.config import ConfigurationError, SpecialSymbols
from joeys2t_torch.spm import MiniSentencePiece
from joeys2t_torch.tokenizers import (FastBPETokenizer, SentencePieceTokenizer,
                                      SubwordNMTTokenizer, _build_tokenizer)
from joeys2t_torch.tools import spm_fixture
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu import bpe as jax_bpe
from joeys2t_tpu.config import SpecialSymbols as JaxSpecialSymbols
from joeys2t_tpu.spm import MiniSentencePiece as JaxMiniSentencePiece
from joeys2t_tpu.tokenizers import FastBPETokenizer as JaxFastBPETokenizer
from joeys2t_tpu.tokenizers import SentencePieceTokenizer as JaxSentencePieceTokenizer
from joeys2t_tpu.tokenizers import SubwordNMTTokenizer as JaxSubwordNMTTokenizer
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary

WORDS = ("the a of speech recognition system transcribes spoken words into text and "
         "translation models learn from parallel corpora while subword units cover "
         "rare names like zürich or naïve café").split()


def sentences(seed, n):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, size=rng.randint(3, 12))) for _ in range(n)]


TRAIN, HELD_OUT = sentences(0, 60), sentences(1, 12) + ["unseen qqq xylophone", "A  B\tC"]


@pytest.fixture(scope="module", params=[("unigram", 300), ("bpe", 120), ("unigram", 40)],
                ids=["unigram300", "bpe120", "unigram40"])
def spm_model(request, tmp_path_factory):
    model_type, size = request.param
    pieces = spm_fixture.corpus_pieces(TRAIN, size, model_type)
    tmp = tmp_path_factory.mktemp("spm")
    path = spm_fixture.write_model(tmp / f"{model_type}{size}.model", pieces, model_type)
    return path, pieces, spm_fixture.write_vocab(tmp / "vocab.txt", pieces)


def test_fixture_writes_what_both_readers_read(spm_model):
    path, pieces, _ = spm_model
    port, ref = MiniSentencePiece.from_file(path), JaxMiniSentencePiece.from_file(path)
    assert port.pieces == ref.pieces and port.model_type == ref.model_type
    assert [(p, t) for p, _, t in port.pieces] == [(p, t) for p, _, t in pieces]
    np.testing.assert_allclose([s for _, s, _ in port.pieces], [s for _, s, _ in pieces],
                               rtol=1e-6)  # scores are stored as float32
    assert port.model_type == (2 if "bpe" in path.name else 1)
    assert len(port) == len(pieces) >= 40


@pytest.mark.parametrize("restrict", [False, True])
def test_sentencepiece_pieces_and_decode_match_jax(spm_model, restrict):
    """``encode`` (pieces and ids) and ``decode``; with ``restrict`` both
    readers first get a vocabulary without a third of the pieces
    (``SetVocabulary``)."""
    path, pieces, _ = spm_model
    port, ref = MiniSentencePiece.from_file(path), JaxMiniSentencePiece.from_file(path)
    if restrict:
        kept = [p for i, (p, _, _) in enumerate(pieces) if i % 3]
        port.SetVocabulary(kept)
        ref.SetVocabulary(kept)
    for text in TRAIN[:20] + HELD_OUT:
        assert port.encode(text) == ref.encode(text), text
        assert port.encode(text, out_type=int) == ref.encode(text, out_type=int)
        assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))
    assert port.decode(port.encode("speech   recognition")) == "speech recognition"
    assert [port.piece_to_id(p) for p, _, _ in pieces[:50]] == \
        [ref.piece_to_id(p) for p, _, _ in pieces[:50]]
    assert port.piece_to_id("no such piece") == ref.piece_to_id("no such piece") == 0


@pytest.mark.parametrize("seed,alpha", [(0, 0.1), (7, 0.5)])
def test_sentencepiece_sampling_matches_jax(spm_model, seed, alpha):
    path, _, _ = spm_model
    port, ref = MiniSentencePiece.from_file(path), JaxMiniSentencePiece.from_file(path)
    random.seed(seed)
    port.rng.seed(seed)
    got = [port.sample_encode_as_pieces(t, nbest_size=5, alpha=alpha) for t in TRAIN[:15]]
    want = [ref.sample_encode_as_pieces(t, nbest_size=5, alpha=alpha) for t in TRAIN[:15]]
    assert got == want
    assert got != [port.encode(t) for t in TRAIN[:15]]  # sampling changed something


FREQS = {}
for _line in TRAIN:
    for _w in _line.split():
        FREQS[_w] = FREQS.get(_w, 0) + 1


@pytest.mark.parametrize("num_symbols,min_frequency", [(60, 2), (200, 1)])
def test_learn_bpe_matches_jax(tmp_path, num_symbols, min_frequency):
    merges = port_bpe.learn_bpe(FREQS, num_symbols, min_frequency)
    assert merges == jax_bpe.learn_bpe(FREQS, num_symbols, min_frequency) and merges
    port_bpe.write_codes(merges, tmp_path / "port.codes")
    jax_bpe.write_codes(merges, tmp_path / "jax.codes")
    assert (tmp_path / "port.codes").read_text() == (tmp_path / "jax.codes").read_text()
    assert port_bpe.load_codes(tmp_path / "port.codes") == \
        jax_bpe.load_codes(tmp_path / "jax.codes")


@pytest.fixture(scope="module")
def codes(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "codes.txt"
    port_bpe.write_codes(port_bpe.learn_bpe(FREQS, 80), path)
    return path


@pytest.mark.parametrize("vocab,glossaries,dropout,seed", [
    (False, [], 0.0, 0), (True, [], 0.0, 0), (False, ["zürich", "speech"], 0.0, 0),
    (True, ["rec[a-z]+"], 0.0, 0), (False, [], 0.3, 5), (True, ["speech"], 0.6, 9)])
def test_bpe_segmentation_matches_jax(codes, vocab, glossaries, dropout, seed):
    """``BPE.process_line`` with or without a vocabulary (segments outside it
    split again), glossaries (regular expressions kept whole), and seeded
    dropout."""
    port = port_bpe.BPE.from_file(codes)
    ref = jax_bpe.BPE.from_file(codes)
    if vocab:
        allowed = {w for w in sorted(FREQS)[::2]} | {w + "@@" for w in "aeiourst"}
        port.vocab, ref.vocab = set(allowed), set(allowed)
    port.glossaries, ref.glossaries = list(glossaries), list(glossaries)
    random.seed(seed)
    port.rng.seed(seed)
    for text in TRAIN[:20] + HELD_OUT:
        assert port.process_line(text, dropout) == ref.process_line(text, dropout), text
    if dropout:  # a second pass draws on
        assert port.process_line(TRAIN[0], dropout) == ref.process_line(TRAIN[0], dropout)


def _vocabs(tokens, sep_token=None):
    kw = {"sep_token": "<sep>", "sep_id": 4} if sep_token else {}
    return (Vocabulary(tokens, SpecialSymbols(**kw)),
            JaxVocabulary(tokens, JaxSpecialSymbols(**kw)))


def _tokenizers(kind, path, **extra):
    cfg = dict(level="bpe", lowercase=True, normalize=True, max_length=40, min_length=2)
    if kind == "sentencepiece":
        return (SentencePieceTokenizer(**cfg, model_file=str(path), **extra),
                JaxSentencePieceTokenizer(**cfg, model_file=str(path), **extra))
    cls = {"subword-nmt": (SubwordNMTTokenizer, JaxSubwordNMTTokenizer),
           "fastbpe": (FastBPETokenizer, JaxFastBPETokenizer)}[kind]
    return cls[0](**cfg, codes=str(path), **extra), cls[1](**cfg, codes=str(path), **extra)


@pytest.mark.parametrize("kind,extra", [
    ("sentencepiece", {}), ("sentencepiece", {"alpha": 0.3}), ("subword-nmt", {}),
    ("subword-nmt", {"dropout": 0.3, "glossaries": ["speech"]}), ("fastbpe", {})])
@pytest.mark.parametrize("with_sep", [False, True])
def test_tokenizer_classes_match_jax(spm_model, codes, kind, extra, with_sep):
    """Pre-processing, pieces in and out of training (seeded sampling),
    the length filter, and post-processing of decoder output: specials,
    unk, a forced ``<sep>`` prompt cut, and detokenized text."""
    path, pieces, voc_file = spm_model
    port, ref = _tokenizers(kind, path if kind == "sentencepiece" else codes, **extra)
    if kind == "sentencepiece":
        tokens = voc_file.read_text(encoding="utf-8").splitlines()
    else:
        tokens = sorted({p for t in TRAIN for p in ref(t)})
    vocab, jvocab = _vocabs(tokens, with_sep)
    port.set_vocab(vocab)
    ref.set_vocab(jvocab)
    assert port.specials == ref.specials and port.sep_token == ref.sep_token
    random.seed(11)
    port.rng.seed(11)
    for raw in TRAIN[:12] + ["  Zürich   CAFÉ naïve  ", "Speech Recognition"]:
        clean = port.pre_process(raw)
        assert clean == ref.pre_process(raw)
        assert port(clean, is_train=True) == ref(clean, is_train=True)
        assert port(clean) == ref(clean)
    for short in ("a", "a b", "of"):  # around min_length 2
        assert port(short, is_train=True) == ref(short, is_train=True)
    long = " ".join(WORDS * 2)
    assert port(long, is_train=True) is ref(long, is_train=True) is None
    assert port(long) == ref(long)
    sep = ["<sep>"] if with_sep else []
    for text in TRAIN[12:20]:
        hyp = ref(ref.pre_process(text))
        for seq in (hyp, ["<s>"] + hyp + ["</s>"], ["ab", "c"] + sep + hyp,
                    hyp[:2] + ["<unk>"] + hyp[2:], ["<unk>"], []):
            for unk in (True, False):
                for cut in (True, False):
                    assert port.post_process(list(seq), generate_unk=unk, cut_at_sep=cut) \
                        == ref.post_process(list(seq), generate_unk=unk, cut_at_sep=cut)
        if kind == "sentencepiece":
            assert "▁" not in port.post_process(hyp)
    assert repr(port).split("(")[1].split(",")[:4] == repr(ref).split("(")[1].split(",")[:4]


def test_build_tokenizer_and_copy_cfg_file(spm_model, codes, tmp_path):
    path, _, _ = spm_model
    sp = _build_tokenizer({"level": "bpe", "lang": "en", "tokenizer_type": "sentencepiece",
                           "tokenizer_cfg": {"model_file": str(path)}})
    nmt = _build_tokenizer({"level": "bpe", "lang": "en", "bpe_type": "subword-nmt",
                            "tokenizer_cfg": {"codes": str(codes)}})
    fast = _build_tokenizer({"level": "bpe", "lang": "en", "tokenizer_type": "fastbpe",
                             "tokenizer_cfg": {"codes": str(codes), "dropout": 0.5}})
    assert isinstance(sp, SentencePieceTokenizer) and isinstance(fast, FastBPETokenizer)
    assert type(nmt) is SubwordNMTTokenizer and fast.dropout == 0.0
    for tok in (sp, nmt):
        tok.copy_cfg_file(tmp_path)
    assert (tmp_path / path.name).read_bytes() == path.read_bytes()
    assert (tmp_path / codes.name).read_text() == codes.read_text()
    sp.copy_cfg_file(tmp_path)  # an existing copy stays
    with pytest.raises(Exception):
        _build_tokenizer({"level": "bpe", "lang": "en", "tokenizer_type": "wordpiece",
                          "tokenizer_cfg": {}})
    with pytest.raises(ConfigurationError):  # moses is the one pretokenizer
        _build_tokenizer({"level": "bpe", "lang": "en", "tokenizer_type": "sentencepiece",
                          "tokenizer_cfg": {"model_file": str(path), "pretokenizer": "spacy"}})


def test_empty_transcript_is_returned_not_asserted(spm_model):
    """A hypothesis of space pieces alone (an undertrained model emits them)
    detokenizes to the empty string: a transcript of nothing. The JAX
    tokenizer asserts there, which stops a validation or a ``test`` run;
    the port returns it (ROADMAP section C)."""
    path, _, voc_file = spm_model
    port, ref = _tokenizers("sentencepiece", path)
    vocab, jvocab = _vocabs(voc_file.read_text(encoding="utf-8").splitlines())
    port.set_vocab(vocab)
    ref.set_vocab(jvocab)
    for seq in (["▁"], ["▁", "</s>"], ["▁", "▁"]):
        assert port.post_process(list(seq)) == ""
        with pytest.raises(AssertionError):
            ref.post_process(list(seq))
    assert port.post_process(["▁", "▁the"]) == ref.post_process(["▁", "▁the"]) == "the"
