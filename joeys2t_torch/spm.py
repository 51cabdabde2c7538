# coding: utf-8
"""
SentencePiece model reader and segmenter (counterpart of
joeys2t_tpu/spm.py ``MiniSentencePiece``), needed because the card's machine
has no ``sentencepiece`` package.

It reads the ModelProto protobuf wire format of a ``.model`` file (pieces,
scores, types and the trainer's model type) and segments text as the JAX
package does:

  - normalization: NFKC, whitespace runs collapsed, spaces escaped as
    ``▁``, a dummy prefix;
  - unigram models: Viterbi over the piece scores, an unknown character
    scored at the lowest piece score minus 10;
  - BPE models: repeated best-scored merges, each merge candidate skipped
    with probability ``dropout`` when sampling;
  - ``encode``, ``sample_encode_as_pieces``, ``decode``, ``SetVocabulary``
    and ``piece_to_id``.

Sampling draws from ``rng``, a ``random.Random`` that the caller owns and
seeds (the JAX package draws from the global ``random`` module; both give
the same stream for the same seed).
"""
import random
import struct
import unicodedata
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

SPACE_ESCAPE = "▁"

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE = 1, 2  # TrainerSpec.model_type


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a protobuf message."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + length], pos + length
        elif wire == 5:  # 32-bit
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"Unsupported wire type {wire}")
        yield field, wire, val


class MiniSentencePiece:
    """A loaded SentencePiece model with a sentencepiece-like API subset."""

    def __init__(self, pieces: List[Tuple[str, float, int]], model_type: int = UNIGRAM,
                 rng: Optional[random.Random] = None):
        self.pieces = pieces
        self.model_type = model_type
        self.rng = rng if rng is not None else random.Random()
        self._scores: Dict[str, float] = {}
        self._types: Dict[str, int] = {}
        self._ids: Dict[str, int] = {}
        for i, (piece, score, ptype) in enumerate(pieces):
            if piece not in self._scores:
                self._scores[piece] = score
                self._types[piece] = ptype
                self._ids[piece] = i
        self._allowed: Optional[Set[str]] = None
        self.min_score = min((s for _, s, t in pieces if t == NORMAL), default=0.0)
        self.unk_penalty = 10.0
        self._max_piece_len = max((len(p) for p, _, t in pieces if t == NORMAL), default=1)

    @classmethod
    def from_file(cls, path: Path, rng: Optional[random.Random] = None
                  ) -> "MiniSentencePiece":
        pieces, model_type = [], UNIGRAM
        for field, wire, val in parse_fields(Path(path).read_bytes()):
            if field == 1 and wire == 2:  # a SentencePiece message
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in parse_fields(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        ptype = v2
                pieces.append((piece, score, ptype))
            elif field == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2 in parse_fields(val):
                    if f2 == 3 and w2 == 0:
                        model_type = v2
        return cls(pieces, model_type, rng)

    @staticmethod
    def _normalize(text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split()).replace(" ", SPACE_ESCAPE)
        return text if text.startswith(SPACE_ESCAPE) else SPACE_ESCAPE + text

    def _usable(self, piece: str) -> bool:
        return (piece in self._scores and self._types.get(piece) not in (CONTROL, UNKNOWN)
                and (self._allowed is None or piece in self._allowed))

    def _viterbi(self, text: str, scores: Dict[str, float]) -> List[str]:
        n = len(text)
        if n == 0:
            return []
        unk_score = self.min_score - self.unk_penalty
        best = [float("-inf")] * (n + 1)
        back: List[Tuple[int, str]] = [(0, "")] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            cand = text[i]  # a single character, known or not
            score = best[i] + (scores.get(cand, unk_score) if self._usable(cand)
                               else unk_score)
            if score > best[i + 1]:
                best[i + 1], back[i + 1] = score, (i, cand)
            for j in range(i + 2, min(i + self._max_piece_len, n) + 1):
                piece = text[i:j]
                if self._usable(piece):
                    score = best[i] + scores[piece]
                    if score > best[j]:
                        best[j], back[j] = score, (i, piece)
        out, i = [], n
        while i > 0:
            i, piece = back[i][0], back[i][1]
            out.append(piece)
        return out[::-1]

    def _bpe_segment(self, text: str, dropout: float = 0.0) -> List[str]:
        symbols = list(text)
        while len(symbols) > 1:
            best_score, best_idx = None, None
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                if self._usable(merged):
                    score = self._scores[merged]
                    if dropout and self.rng.random() < dropout:
                        continue
                    if best_score is None or score > best_score:
                        best_score, best_idx = score, i
            if best_idx is None:
                break
            symbols[best_idx:best_idx + 2] = [symbols[best_idx] + symbols[best_idx + 1]]
        return symbols

    def encode(self, text: str, out_type=str) -> List:
        norm = self._normalize(text)
        pieces = (self._bpe_segment(norm) if self.model_type == BPE
                  else self._viterbi(norm, self._scores))
        return pieces if out_type is str else [self.piece_to_id(p) for p in pieces]

    def sample_encode_as_pieces(self, text: str, nbest_size: int = 5,
                                alpha: float = 0.1) -> List[str]:
        """Subword regularization: BPE merge dropout with probability
        ``alpha``; unigram Viterbi over scores with Gaussian noise of
        standard deviation ``alpha`` times the lowest piece score's
        magnitude, one draw a piece in model order."""
        del nbest_size  # the JAX reader samples without an n-best lattice
        norm = self._normalize(text)
        if self.model_type == BPE:
            return self._bpe_segment(norm, dropout=alpha)
        sigma = max(alpha, 1e-6) * abs(self.min_score)
        noisy = {p: s + self.rng.gauss(0.0, sigma) for p, s in self._scores.items()}
        return self._viterbi(norm, noisy)

    def decode(self, pieces: List[str]) -> str:
        if isinstance(pieces, str):
            return pieces
        return "".join(pieces).replace(SPACE_ESCAPE, " ").strip()

    def SetVocabulary(self, itos: List[str]) -> None:  # noqa: N802
        self._allowed = set(itos)

    def piece_to_id(self, piece: str) -> int:
        return self._ids.get(piece, 0)

    def __len__(self) -> int:
        return len(self.pieces)
