# coding: utf-8
"""
Writes SentencePiece models for tests: a ModelProto in the protobuf wire
format that ``joeys2t_torch.spm.MiniSentencePiece.from_file`` (and the JAX
package's reader) read, with the pieces, scores and model type given. It
trains nothing: ``corpus_pieces`` only draws a few hundred pieces from
transcripts, scored by frequency (unigram) or in merge order (BPE).

    from joeys2t_torch.tools import spm_fixture
    pieces = spm_fixture.corpus_pieces(lines, size=300, model_type="unigram")
    spm_fixture.write_model("spm.model", pieces, "unigram")
    spm_fixture.write_vocab("spm.vocab.txt", pieces)   # a voc_file for the config

The first three pieces are ``<unk>`` (unknown), ``<s>`` and ``</s>``
(control), as SentencePiece lays out a trained model.
"""
import math
import struct
import unicodedata
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

from joeys2t_torch.spm import BPE, CONTROL, NORMAL, SPACE_ESCAPE, UNIGRAM, UNKNOWN

MODEL_TYPES = {"unigram": UNIGRAM, "bpe": BPE}
SPECIALS = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    tag = _varint(number << 3 | wire)
    return tag + (_varint(len(payload)) + payload if wire == 2 else payload)


def model_proto(pieces: Sequence[Tuple[str, float, int]], model_type: str) -> bytes:
    """ModelProto bytes: one ``pieces`` message (field 1) a piece (its text,
    float score and type), then a TrainerSpec (field 2) holding the model
    type (its field 3)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = (_field(1, 2, piece.encode("utf-8")) + _field(2, 5, struct.pack("<f", score))
                + _field(3, 0, _varint(ptype)))
        out += _field(1, 2, body)
    out += _field(2, 2, _field(3, 0, _varint(MODEL_TYPES[model_type])))
    return bytes(out)


def write_model(path, pieces: Sequence[Tuple[str, float, int]], model_type: str) -> Path:
    """Write ``pieces`` (SPECIALS first, as ``corpus_pieces`` returns them)
    as a ``model_type`` ("unigram" or "bpe") SentencePiece model."""
    path = Path(path)
    path.write_bytes(model_proto(pieces, model_type))
    return path


def write_vocab(path, pieces: Sequence[Tuple[str, float, int]]) -> Path:
    """A ``voc_file`` of the model's normal pieces, one a line (the
    vocabulary puts its own specials first)."""
    path = Path(path)
    path.write_text("".join(f"{p}\n" for p, _, t in pieces if t == NORMAL),
                    encoding="utf-8")
    return path


def _words(lines: Iterable[str]) -> Counter:
    """``▁``-prefixed words of the lines, normalized as the reader does."""
    words = Counter()
    for line in lines:
        for word in unicodedata.normalize("NFKC", line).split():
            words[SPACE_ESCAPE + word] += 1
    return words


def corpus_pieces(lines: Iterable[str], size: int, model_type: str = "unigram",
                  max_len: int = 8) -> List[Tuple[str, float, int]]:
    """About ``size`` pieces for the words of ``lines``: every character, then
    for "unigram" the most frequent substrings of a word (up to ``max_len``
    characters, scored by log frequency), for "bpe" the pieces of the most
    frequent pair merges in order (scored -1, -2, ...: earlier merges first)."""
    words = _words(lines)
    chars = Counter()
    for word, n in words.items():
        for ch in word:
            chars[ch] += n
    if model_type == "unigram":
        counts = Counter(chars)
        for word, n in words.items():
            for i in range(len(word)):
                for j in range(i + 2, min(i + max_len, len(word)) + 1):
                    counts[word[i:j]] += n
        multi = [p for p, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
                 if len(p) > 1][:max(0, size - len(chars))]
        total = sum(counts.values())
        chosen = sorted(chars) + multi
        normal = [(p, math.log(counts[p] / total), NORMAL) for p in chosen]
    elif model_type == "bpe":
        split = {word: list(word) for word in words}
        merges = []
        while len(chars) + len(merges) < size:
            pairs = Counter()
            for word, n in words.items():
                symbols = split[word]
                for a, b in zip(symbols[:-1], symbols[1:]):
                    pairs[a, b] += n
            if not pairs:
                break
            (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
            if a + b not in merges:  # ("ab", "c") and ("a", "bc") make one piece
                merges.append(a + b)
            for word, symbols in split.items():
                i, out = 0, []
                while i < len(symbols):
                    if i + 1 < len(symbols) and (symbols[i], symbols[i + 1]) == (a, b):
                        out.append(a + b)
                        i += 2
                    else:
                        out.append(symbols[i])
                        i += 1
                split[word] = out
        normal = ([(p, -float(i + 1), NORMAL) for i, p in enumerate(merges)]
                  + [(c, -float(len(merges) + 1 + i), NORMAL)
                     for i, c in enumerate(sorted(chars))])
    else:
        raise ValueError(f"model type {model_type!r}: 'unigram' or 'bpe'")
    return SPECIALS + normal
