# coding: utf-8
"""The port's host data pipeline against the JAX package on the CPU.

The corpus comes from ``scripts/generate_synthetic_asr.py`` (24 train, 8 dev
and 8 test utterances) and the data config from ``configs/synthetic_asr.yaml``
with its paths moved there. For the same config and numpy seed, the JAX
``load_data`` + ``make_iter`` and the port's give identical batches over two
shuffled epochs and the dev set: ``src`` bit for bit (SpecAugment draws
from numpy's global RNG on both sides), lengths and targets exactly. Then
the vocabulary, the word and char tokenizers, the manifest reader's row
drops, and ``zip:offset:size`` and ``.wav`` features.

The helpers ``make_corpus`` and ``tiny_cfg`` also serve
``test_torch_prediction.py`` and ``test_torch_cli.py``."""
import copy
import subprocess
import sys
import wave
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from joeys2t_torch.config import SpecialSymbols, load_config
from joeys2t_torch.data.audio_io import get_features, get_n_frames
from joeys2t_torch.data.datasets import build_dataset
from joeys2t_torch.data.loader import load_data
from joeys2t_torch.tokenizers import BasicTokenizer, SpeechProcessor
from joeys2t_torch.vocabulary import Vocabulary, build_vocab
from joeys2t_tpu.config import parse_special_symbols as jax_special_symbols
from joeys2t_tpu.data.audio_io import get_features as jax_get_features
from joeys2t_tpu.data.audio_io import get_n_frames as jax_get_n_frames
from joeys2t_tpu.data.datasets import build_dataset as jax_build_dataset
from joeys2t_tpu.data.loader import load_data as jax_load_data
from joeys2t_tpu.tokenizers import BasicTokenizer as JaxBasicTokenizer
from joeys2t_tpu.tokenizers import SpeechProcessor as JaxSpeechProcessor
from joeys2t_tpu.vocabulary import Vocabulary as JaxVocabulary

REPO = Path(__file__).resolve().parents[1]
BATCH_FIELDS = ("src", "src_length", "trg", "trg_input", "trg_length", "indices")


def make_corpus(out: Path) -> Path:
    """The synthetic corpus at test size: 24 train, 8 dev, 8 test."""
    subprocess.run([sys.executable, str(REPO / "scripts" / "generate_synthetic_asr.py"),
                    "--out", str(out), "--train", "24", "--dev", "8", "--test", "8"],
                   check=True, capture_output=True, timeout=120)
    return out


def tiny_cfg(data_dir: Path, model_dir: Path) -> dict:
    """``configs/synthetic_asr.yaml`` on the CPU at test size: 2 + 2 layers,
    hidden 32, 2 heads, f32, greedy, 4 updates of 8 utterances with a
    validation every 2."""
    cfg = load_config(REPO / "configs" / "synthetic_asr.yaml")
    cfg.update(use_cuda=False, fp16=False, model_dir=str(model_dir))
    for split in ("train", "dev", "test"):
        cfg["data"][split] = str(data_dir / split)
    cfg["data"]["trg"]["voc_file"] = str(data_dir / "char.txt")
    cfg["testing"].update(beam_size=1, batch_size=4)
    cfg["training"].update(updates=4, validation_freq=2, logging_freq=1, batch_size=8,
                           learning_rate_warmup=2, keep_best_ckpts=3)
    model = cfg["model"]
    for side in ("encoder", "decoder"):
        model[side].update(num_layers=2, hidden_size=32, ff_size=64, num_heads=2)
    model["encoder"]["conv_channels"] = 32
    model["decoder"]["embeddings"]["embedding_dim"] = 32
    return cfg


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads while a module runs: the suite runs several test
    files at once, and the small operators of a tiny model slow down many
    times over when every process keeps a thread per core busy."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("synthetic_asr"))


def data_cfgs(corpus, specaugment=True, cmvn_before=True):
    """(port data config, JAX data config), the same dict but for the
    special-symbol objects."""
    data = tiny_cfg(corpus, corpus / "model")["data"]
    tok_cfg = data["src"]["tokenizer_cfg"]
    if not specaugment:
        del tok_cfg["specaugment"]
    tok_cfg["cmvn"]["before"] = cmvn_before
    jax_data = copy.deepcopy(data)
    data["special_symbols"] = SpecialSymbols()
    jax_data["special_symbols"] = jax_special_symbols(jax_data["special_symbols"])
    return data, jax_data


def batches(load, cfg, batch_size, batch_type, np_seed=5):
    """Two shuffled training epochs (the sampler reseeded per epoch, as the
    trainer does) and the dev set, as the host arrays of every batch."""
    np.random.seed(np_seed)
    _, _, train, dev, _ = load(cfg=cfg, datasets=["train", "dev"], task="S2T")
    it, sampler = train.make_iter(batch_size=batch_size, batch_type=batch_type, seed=42,
                                  shuffle=True, return_sampler=True)
    out = []
    for epoch in (1, 2):
        sampler.set_seed(42 + epoch)
        out.extend(it)
    out.extend(dev.make_iter(batch_size=3, batch_type="sentence", seed=dev.seed))
    return out


@pytest.mark.parametrize("batch_type,batch_size,specaugment,cmvn_before", [
    ("sentence", 8, True, True),
    ("sentence", 5, True, False),
    ("sentence", 8, False, True),
    ("token", 2000, True, False),
    ("token", 1500, False, True),
])
def test_batches_match_jax(corpus, batch_type, batch_size, specaugment, cmvn_before):
    port_cfg, jax_cfg = data_cfgs(corpus, specaugment, cmvn_before)
    port = batches(load_data, port_cfg, batch_size, batch_type)
    ref = batches(jax_load_data, jax_cfg, batch_size, batch_type)
    assert len(port) == len(ref) and len(port) > 4
    for i, (a, b) in enumerate(zip(port, ref)):
        for name in BATCH_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), (i, name)
    if specaugment:  # the masks did fire: an epoch's batches differ from the next's
        assert not np.array_equal(port[0].src, port[len(port) // 2].src)


def test_vocabulary_matches_jax_and_round_trips(corpus, tmp_path):
    port_cfg, jax_cfg = data_cfgs(corpus)
    _, vocab = build_vocab(port_cfg, task="S2T")
    ref = JaxVocabulary(
        (corpus / "char.txt").read_text(encoding="utf-8").splitlines(),
        jax_cfg["special_symbols"])
    assert vocab._tokens == ref._tokens and len(vocab) == 31
    vocab.to_file(tmp_path / "vocab.txt")
    again = Vocabulary((tmp_path / "vocab.txt").read_text(encoding="utf-8").splitlines(),
                       SpecialSymbols())
    assert again == vocab
    rows, lengths, masks = vocab.sentences_to_ids([list("ab c"), list("z")])
    assert (rows, lengths, masks) == ref.sentences_to_ids([list("ab c"), list("z")])
    ids = np.array([[5, 6, 3, 7, 1], [1, 8, 9, 1, 1]])
    for cut in (True, False):
        assert vocab.arrays_to_sentences(ids, cut_at_eos=cut) == ref.arrays_to_sentences(
            ids, cut_at_eos=cut)


TEXTS = ["the quick brown fox jumps over lazy dog", "Speech Model", "  two  spaces ",
         "Ünïcödé ＮＦＫＣ “quotes” don’t", "punct, marks! here? yes: no.",
         "zero​width　ideographic", "a"]


@pytest.mark.parametrize("level,lowercase,normalize,max_length", [
    ("char", True, False, 512), ("char", False, True, 20), ("word", False, False, -1),
    ("word", True, True, 4)])
def test_basic_tokenizer_matches_jax(corpus, level, lowercase, normalize, max_length):
    kw = dict(level=level, lowercase=lowercase, normalize=normalize,
              max_length=max_length, min_length=2)
    port, ref = BasicTokenizer(**kw), JaxBasicTokenizer(**kw)
    vocab = Vocabulary(list("abcdefghijklmnopqrstuvwxyz") + ["▁"], SpecialSymbols())
    jvocab = JaxVocabulary(list("abcdefghijklmnopqrstuvwxyz") + ["▁"],
                           jax_special_symbols({}))
    port.set_vocab(vocab)
    ref.set_vocab(jvocab)
    synthetic = [line.split("\t")[3] for line in
                 (corpus / "dev.tsv").read_text(encoding="utf-8").splitlines()[1:]]
    for text in TEXTS + synthetic:
        clean = port.pre_process(text)
        assert clean == ref.pre_process(text), text
        for is_train in (False, True):
            assert port(clean, is_train=is_train) == ref(clean, is_train=is_train), text
        pieces = ref(clean) or []
        for generate_unk in (True, False):
            seq = ["<s>"] + pieces + ["<unk>", "</s>"]
            assert port.post_process(seq, generate_unk=generate_unk) == ref.post_process(
                seq, generate_unk=generate_unk), text
        assert port.post_process(clean) == ref.post_process(clean)


MANIFEST = ("id\tsrc\tn_frames\ttrg\tspeaker\n"
            "a\tfeats/a.npy\t20\thello world\ts1\n"
            "b\tfeats/b.npy\t20\t   \ts1\n"        # blank target: dropped
            "c\tfeats/c.npy\t10\thi\ts1\n"         # not above min_length: dropped
            "d\tfeats/d.npy\t30\ttab\\\there\ts1\n"  # escaped tab kept in the field
            "e\tfeats/e.npy\t30\t\"quoted\" text\ts1\n"
            "\n"
            "f\tfeats/f.npy\t40\tshort row\n"      # missing speaker: dropped
            "g\tfeats/g.npy\t50\tnan\tNA\n"        # no NA filtering: kept
            "h\t\t60\tempty src\ts2\n"             # blank src: dropped
            "i\tfeats/i.npy\t11\tback\\\\slash\ts1\n")


def test_manifest_rows_match_pandas_reader(tmp_path):
    (tmp_path / "m.tsv").write_text(MANIFEST, encoding="utf-8")
    kw = dict(level="frame", num_freq=80, min_length=10, max_length=3000)
    trg = dict(level="char", lowercase=True)
    port = build_dataset("speech", str(tmp_path / "m"), "src", "trg", "dev",
                         tokenizer={"src": SpeechProcessor(**kw),
                                    "trg": BasicTokenizer(**trg)},
                         has_prompt={"src": False, "trg": False}, task="S2T")
    ref = jax_build_dataset("speech", str(tmp_path / "m"), "src", "trg", "dev",
                            tokenizer={"src": JaxSpeechProcessor(**kw),
                                       "trg": JaxBasicTokenizer(**trg)},
                            has_prompt={"src": False, "trg": False}, task="S2T")
    assert len(port) == len(ref) == 5
    assert port.trg == ref.trg == ["hello world", "tab\there", '"quoted" text', "nan",
                                   "back\\slash"]
    assert port.src == list(ref.src)
    assert port.get_list("trg", tokenized=True) == ref.get_list("trg", tokenized=True)


def test_zip_and_wav_features_load(tmp_path):
    rng = np.random.RandomState(0)
    feats = rng.randn(37, 80).astype(np.float32)
    np.save(tmp_path / "x.npy", feats)
    with zipfile.ZipFile(tmp_path / "f.zip", "w", zipfile.ZIP_STORED) as z:
        z.write(tmp_path / "x.npy", "x.npy")
    with zipfile.ZipFile(tmp_path / "f.zip") as z:
        info = z.getinfo("x.npy")
    with (tmp_path / "f.zip").open("rb") as f:  # the data follows the local header
        f.seek(info.header_offset + 26)
        name_len, extra_len = np.frombuffer(f.read(4), "<u2")
    entry = f"f.zip:{info.header_offset + 30 + name_len + extra_len}:{info.file_size}"
    np.testing.assert_array_equal(get_features(tmp_path, entry), feats)
    np.testing.assert_array_equal(get_features(tmp_path, entry),
                                  jax_get_features(tmp_path, entry))

    n = 16000 * 2 + 123
    envelope = np.repeat(np.exp(rng.uniform(3, 8, size=n // 800 + 1)), 800)[:n]
    samples = np.clip(envelope * rng.randn(n), -32768, 32767).astype("<i2")
    with wave.open(str(tmp_path / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(samples.tobytes())
    port, ref = get_features(tmp_path, "a.wav"), jax_get_features(tmp_path, "a.wav")
    assert port.shape == ref.shape == (1 + (n - 400) // 160, 80)
    for samples_n in (n, 16000, 400, 12345):
        assert get_n_frames(samples_n, 16000) == jax_get_n_frames(samples_n, 16000)
    assert np.abs(port - ref).max() <= 5e-4  # the front-end tolerance, ROADMAP §C

    # mp3 is read through libmpg123 (tests/test_torch_tooling.py); a file
    # that holds no mp3 stream raises
    (tmp_path / "b.mp3").write_bytes(b"ID3")
    with pytest.raises(RuntimeError):
        get_features(tmp_path, "b.mp3")
