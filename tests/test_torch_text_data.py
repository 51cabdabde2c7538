# coding: utf-8
"""Moses pretokenization and Huggingface datasets against the JAX package on
the CPU, on data the tests write themselves.

- ``pretokenizer: moses``: a corpus with punctuation, quotes, apostrophes,
  ampersands and numbers goes through the port's and JAX's tokenizers
  (word level in English and German, with and without ``normalize`` and
  ``lowercase``; subword-nmt and SentencePiece on the pretokenized text):
  cleaned lines, pieces and detokenized hypotheses are equal; then a plain
  MT corpus with moses on both sides gives equal vocabularies, token lists
  and batches through ``load_data``.
- ``dataset_type: huggingface``: a ``DatasetDict`` of ``Translation`` rows
  (train, validation, test; an empty row, dropped; moses on one side) made
  with ``Dataset.from_dict(...)`` and saved with ``save_to_disk``, read by
  both packages: dev defaults to the ``validation`` split, and
  ``dataset_cfg.split`` (``hf_split``) picks one split for every set;
  vocabularies, token lists and batches are equal.

Each test skips where ``sacremoses`` or ``datasets`` does not import."""
import copy

import numpy as np
import pytest

from joeys2t_torch import bpe as port_bpe
from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.tokenizers import (BasicTokenizer, SentencePieceTokenizer,
                                      SubwordNMTTokenizer)
from joeys2t_torch.tools import spm_fixture
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.config import SpecialSymbols as JaxSpecialSymbols
from joeys2t_tpu.tokenizers import BasicTokenizer as JaxBasicTokenizer
from joeys2t_tpu.tokenizers import SentencePieceTokenizer as JaxSentencePieceTokenizer
from joeys2t_tpu.tokenizers import SubwordNMTTokenizer as JaxSubwordNMTTokenizer
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary
from test_torch_data import few_threads  # noqa: F401
from test_torch_mt import BATCH_FIELDS, EOS, PAD, both_data

pytestmark = pytest.mark.usefixtures("few_threads")

PIECES = ["Hello", "world", "it's", "don't", "the", "cat's", "hat", "costs", "$5.50",
          "(really)", "\"quoted\"", "A&B", "e.g.", "Mr.", "Smith", "isn't", "Zürich",
          "naïve", "café", "3,000", "years", "-", "well", "...", "Straße", "über",
          "Öl", "«Anführung»", "l'homme", "c'est", "50%", "@user", "#tag", "x+y"]
ENDINGS = [".", "!", "?", ",", ";", ":", ""]


def corpus(seed, n):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(PIECES, size=rng.randint(2, 9))) + str(rng.choice(ENDINGS))
            for _ in range(n)] + ["  Hello ,   world  !  ", "“Smart quotes” – and a dash…"]


def needs(module):
    return pytest.importorskip(module, reason=f"{module} does not import here")


def pair(cls_port, cls_jax, **cfg):
    return cls_port(**cfg), cls_jax(**cfg)


def vocabs(tokens):
    return Vocabulary(tokens, SpecialSymbols()), JaxVocabulary(tokens, JaxSpecialSymbols())


def check_tokenizers(port, ref, lines):
    """Cleaned lines, pieces, and hypotheses detokenized (with specials and
    unk among the pieces) equal."""
    tokens = sorted({p for line in lines for p in ref(ref.pre_process(line))})
    vocab, jvocab = vocabs(tokens)
    port.set_vocab(vocab)
    ref.set_vocab(jvocab)
    for line in lines:
        clean = port.pre_process(line)
        assert clean == ref.pre_process(line), line
        pieces = port(clean)
        assert pieces == ref(clean), line
        for seq in (pieces, ["<s>"] + pieces + ["</s>"], pieces[:1] + ["<unk>"] + pieces[1:]):
            for unk in (True, False):
                assert port.post_process(list(seq), generate_unk=unk) == ref.post_process(
                    list(seq), generate_unk=unk), seq
        assert port.post_process(clean) == ref.post_process(clean)


@pytest.mark.parametrize("lang,normalize,lowercase", [
    ("en", False, False), ("en", True, True), ("de", True, False), ("fr", False, True)])
def test_moses_word_tokenizer_matches_jax(lang, normalize, lowercase):
    needs("sacremoses")
    port, ref = pair(BasicTokenizer, JaxBasicTokenizer, level="word", lowercase=lowercase,
                     normalize=normalize, pretokenizer="moses", lang=lang)
    assert repr(port).endswith("pretokenizer=moses)") and repr(port) == repr(ref)
    lines = corpus(0, 40)
    check_tokenizers(port, ref, lines)
    # moses does something here: escapes and splits punctuation off
    assert any(port.pre_process(line) != line for line in lines)
    assert "&amp;" in " ".join(port.pre_process(line) for line in lines)


def test_moses_subword_tokenizers_match_jax(tmp_path):
    """subword-nmt and SentencePiece over moses-pretokenized text: the
    joined hypothesis is moses-detokenized after the subword join."""
    needs("sacremoses")
    lines = corpus(1, 40)
    pre = JaxBasicTokenizer(level="word", pretokenizer="moses", lang="en")
    clean = [pre.pre_process(line) for line in lines]
    freqs = {}
    for line in clean:
        for word in line.split():
            freqs[word] = freqs.get(word, 0) + 1
    codes = tmp_path / "codes.txt"
    port_bpe.write_codes(port_bpe.learn_bpe(freqs, 60), codes)
    check_tokenizers(*pair(SubwordNMTTokenizer, JaxSubwordNMTTokenizer, level="bpe",
                           codes=str(codes), pretokenizer="moses", lang="en",
                           normalize=True), lines)
    pieces = spm_fixture.corpus_pieces(clean, 120, "unigram")
    model = spm_fixture.write_model(tmp_path / "m.model", pieces, "unigram")
    check_tokenizers(*pair(SentencePieceTokenizer, JaxSentencePieceTokenizer, level="bpe",
                           model_file=str(model), pretokenizer="moses", lang="en"), lines)


SYMBOLS = {"unk_token": "<unk>", "unk_id": 0, "pad_token": "<pad>", "pad_id": 1,
           "bos_token": "<s>", "bos_id": 2, "eos_token": "</s>", "eos_id": 3}


def side(lang, moses=True, **extra):
    cfg = {"lang": lang, "level": "word", "max_length": 30, "voc_limit": 200,
           "voc_min_freq": 1, "lowercase": True, **extra}
    if moses:
        cfg["tokenizer_cfg"] = {"pretokenizer": "moses"}
    return cfg


def assert_same_data(port, ref, splits, batch_type="sentence", batch_size=5):
    (pv_src, pv_trg, *p_sets), (jv_src, jv_trg, *j_sets) = port, ref
    assert pv_src.log_vocab(80) == jv_src.log_vocab(80)
    assert pv_trg.log_vocab(80) == jv_trg.log_vocab(80)
    for name, p_set, j_set in zip(("train", "dev", "test"), p_sets, j_sets):
        if name not in splits:
            continue
        assert len(p_set) == len(j_set) > 0 and p_set.split == j_set.split
        for lang in (p_set.src_lang, p_set.trg_lang):
            assert p_set.get_list(lang) == list(j_set.get_list(lang))
            assert p_set.get_list(lang, tokenized=True) == list(
                j_set.get_list(lang, tokenized=True))
        kw = dict(batch_size=batch_size, batch_type=batch_type, seed=42,
                  shuffle=name == "train", pad_index=PAD, eos_index=EOS)
        port_batches = list(p_set.make_iter(**kw))
        ref_batches = list(j_set.make_iter(**kw))
        assert len(port_batches) == len(ref_batches) > 0
        for a, b in zip(port_batches, ref_batches):
            for field in BATCH_FIELDS:
                x, y = getattr(a, field), getattr(b, field)
                assert (x is None) == (y is None), field
                if x is not None:
                    np.testing.assert_array_equal(x, y, err_msg=f"{name} {field}")


def test_moses_plain_corpus_matches_jax(tmp_path):
    needs("sacremoses")
    for split, seed, n in (("train", 2, 40), ("dev", 3, 9), ("test", 4, 7)):
        for lang, shift in (("de", 0), ("en", 10)):
            (tmp_path / f"{split}.{lang}").write_text(
                "\n".join(corpus(seed + shift, n)) + "\n", encoding="utf-8")
    cfg = {split: str(tmp_path / split) for split in ("train", "dev", "test")}
    cfg.update(dataset_type="plain", src=side("de"), trg=side("en"),
               special_symbols=dict(SYMBOLS))
    splits = ["train", "dev", "test"]
    assert_same_data(*both_data(cfg, splits), splits)


def write_hf(path, empty_row=True):
    """A DatasetDict of de-en Translation rows, saved to ``path``."""
    datasets = needs("datasets")
    features = datasets.Features({"translation": datasets.Translation(languages=["de", "en"])})
    splits = {}
    for name, seed, n in (("train", 5, 40), ("validation", 6, 9), ("test", 7, 8)):
        rows = [{"de": de, "en": en} for de, en in zip(corpus(seed, n), corpus(seed + 10, n))]
        if empty_row:
            rows.insert(3, {"de": "", "en": "ein leerer Satz"})
        splits[name] = datasets.Dataset.from_dict({"translation": rows}, features=features)
    datasets.DatasetDict(splits).save_to_disk(str(path))
    return path


@pytest.mark.parametrize("dataset_cfg,moses,batch_type", [
    ({}, False, "sentence"), ({}, True, "token"), ({"split": "validation"}, False,
                                                   "sentence")])
def test_huggingface_dataset_matches_jax(tmp_path, dataset_cfg, moses, batch_type):
    needs("datasets")
    if moses:
        needs("sacremoses")
    path = str(write_hf(tmp_path / "hf"))
    cfg = {"train": path, "dev": path, "test": path, "dataset_type": "huggingface",
           "src": side("de", moses), "trg": side("en", False),
           "special_symbols": dict(SYMBOLS)}
    if dataset_cfg:
        cfg["dataset_cfg"] = copy.deepcopy(dataset_cfg)
    splits = ["train", "dev", "test"]
    port, ref = both_data(cfg, splits)
    assert_same_data(port, ref, splits, batch_type=batch_type,
                     batch_size=60 if batch_type == "token" else 5)
    expected = dataset_cfg.get("split")
    rows = {"train": 42, "validation": 11, "test": 10}  # the empty row dropped
    for p_set, name in zip(port[2:], rows):
        assert p_set.split == (expected or name)
        assert len(p_set) == rows[expected or name]


def test_huggingface_dataset_without_the_split_is_refused(tmp_path):
    needs("datasets")
    from joeys2t_torch.data.datasets import build_dataset

    path = str(write_hf(tmp_path / "hf", empty_row=False))
    tok = {lang: BasicTokenizer(level="word") for lang in ("de", "en")}
    with pytest.raises(ValueError, match="no split"):
        build_dataset("huggingface", path, "de", "en", "train", tokenizer=tok,
                      hf_split="nonesuch")
