# coding: utf-8
"""
Byte-pair encoding, file-compatible with subword-nmt (counterpart of
joeys2t_tpu/bpe.py): the card's machine has neither subword-nmt nor
fastBPE.

  - ``load_codes`` reads a subword-nmt codes file (an optional "#version:"
    line first);
  - ``BPE`` merges the highest-priority pair first, with optional
    BPE-dropout (Provilkov et al. 2020), glossaries, and the recursive split
    of segments outside the vocabulary (subword_nmt.apply_bpe's semantics);
  - ``learn_bpe`` and ``write_codes`` learn merge codes from a
    token-frequency dict and write them.

Dropout draws from ``BPE.rng``, a ``random.Random`` that the caller owns and
seeds (the JAX package draws from the global ``random`` module; both give the
same stream for the same seed).
"""
import random
import re
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple


def get_pairs(word: Tuple[str, ...]) -> Set[Tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def load_codes(codes_file: Path) -> Dict[Tuple[str, str], int]:
    """Read a subword-nmt codes file -> {pair: priority}. Keeps the FIRST
    occurrence of a pair (lowest merge index wins), like apply_bpe."""
    codes = {}
    with Path(codes_file).open("r", encoding="utf-8") as f:
        first = f.readline()
        if not first.startswith("#version:"):
            f.seek(0)
        for i, line in enumerate(f):
            parts = line.rstrip("\r\n").split(" ")
            if len(parts) != 2:
                continue
            pair = (parts[0], parts[1])
            if pair not in codes:
                codes[pair] = i
    return codes


class BPE:
    """Apply BPE merges to words (subword_nmt.apply_bpe.BPE equivalent)."""

    def __init__(self, codes: Dict[Tuple[str, str], int], separator: str = "@@",
                 vocab: Optional[Set[str]] = None,
                 glossaries: Optional[List[str]] = None,
                 rng: Optional[random.Random] = None):
        self.rng = rng if rng is not None else random.Random()
        self.bpe_codes = codes
        # for vocabulary-guarded splitting: pair joined -> parts
        self.bpe_codes_reverse = {pair[0] + pair[1]: pair for pair in codes}
        self.separator = separator
        self.vocab = vocab
        self.glossaries = glossaries or []
        self._cache: Dict[str, Tuple[str, ...]] = {}

    @classmethod
    def from_file(cls, codes_file: Path, separator: str = "@@",
                  rng: Optional[random.Random] = None) -> "BPE":
        return cls(load_codes(codes_file), separator=separator, rng=rng)

    def _encode_word(self, orig: str, dropout: float = 0.0) -> Tuple[str, ...]:
        """Encode one word; subword_nmt.apply_bpe.encode (version 0.2)."""
        if not dropout and orig in self._cache:
            return self._cache[orig]
        if len(orig) == 1:
            return (orig,)

        word = tuple(orig[:-1]) + (orig[-1] + "</w>",)
        while len(word) > 1:
            # find the highest-priority merge among current pairs
            pairs = [(self.bpe_codes[pair], i, pair)
                     for i, pair in enumerate(zip(word[:-1], word[1:]))
                     if (not dropout or self.rng.random() > dropout)
                     and pair in self.bpe_codes]
            if not pairs:
                break
            bigram = min(pairs)[2]
            positions = [i for (rank, i, pair) in pairs if pair == bigram]
            i = 0
            new_word = []
            for j in positions:
                if j < i:  # overlapping pair already merged
                    continue
                new_word.extend(word[i:j])
                new_word.append(bigram[0] + bigram[1])
                i = j + 2
            new_word.extend(word[i:])
            word = tuple(new_word)

        # strip sentence-end marker
        if word[-1] == "</w>":
            word = word[:-1]
        elif word[-1].endswith("</w>"):
            word = word[:-1] + (word[-1][:-4],)

        if not dropout:
            self._cache[orig] = word
        return word

    def _check_vocab_and_split(self, pieces: Iterable[str]) -> List[str]:
        """Recursively split segments not in the vocabulary
        (subword_nmt.apply_bpe.check_vocab_and_split)."""
        out = []
        pieces = list(pieces)
        for i, segment in enumerate(pieces):
            is_final = i == len(pieces) - 1
            if is_final:
                known = segment in self.vocab
            else:
                known = (segment + self.separator) in self.vocab
            if known:
                out.append(segment)
            else:
                self._recursive_split(segment, out, is_final)
        return out

    def _recursive_split(self, segment: str, out: List[str], final: bool) -> None:
        try:
            if final:
                left, right = self.bpe_codes_reverse[segment + "</w>"]
                right = right[:-4]
            else:
                left, right = self.bpe_codes_reverse[segment]
        except KeyError:
            out.append(segment)
            return

        if (left + self.separator) in self.vocab:
            out.append(left)
        else:
            self._recursive_split(left, out, False)

        if (final and right in self.vocab) or (not final and
                                               (right + self.separator) in self.vocab):
            out.append(right)
        else:
            self._recursive_split(right, out, final)

    def _isolate_glossaries(self, word: str) -> List[Tuple[str, bool]]:
        """Split `word` around glossary matches (subword_nmt
        apply_bpe.isolate_glossary semantics): matched spans pass through
        BPE unsegmented, the rest is segmented normally. Glossary entries
        are treated as regular expressions, like subword-nmt's."""
        parts: List[Tuple[str, bool]] = [(word, False)]
        for gloss in self.glossaries:
            pattern = re.compile(f"({gloss})")
            # re.split emits every capture group: with a glossary regex that
            # itself contains k groups, each match contributes 1 (our wrapper,
            # the whole match) + k (inner, substrings of the whole match)
            # fields. Classify by stride, not odd/even, and drop the inner
            # duplicates.
            ng = pattern.groups
            nxt: List[Tuple[str, bool]] = []
            for seg, is_gloss in parts:
                if is_gloss:
                    nxt.append((seg, True))
                    continue
                pieces = pattern.split(seg)
                for i, piece in enumerate(pieces):
                    pos = i % (ng + 1)
                    if pos == 0 and piece:  # between-match text
                        nxt.append((piece, False))
                    elif pos == 1 and piece:  # wrapper group = whole match
                        nxt.append((piece, True))
                    # pos >= 2: inner groups of the glossary regex — skip
            parts = nxt
        return parts

    def segment_word(self, word: str, dropout: float = 0.0) -> List[str]:
        if self.glossaries:
            pieces: List[str] = []
            for seg, is_gloss in self._isolate_glossaries(word):
                if is_gloss:
                    pieces.append(seg)
                else:
                    sub = list(self._encode_word(seg, dropout))
                    if self.vocab:
                        sub = self._check_vocab_and_split(sub)
                    pieces.extend(sub)
        else:
            pieces = list(self._encode_word(word, dropout))
            if self.vocab:
                pieces = self._check_vocab_and_split(pieces)
        if len(pieces) > 1:
            return [p + self.separator for p in pieces[:-1]] + [pieces[-1]]
        return pieces

    def process_line(self, line: str, dropout: float = 0.0) -> str:
        """Segment a whitespace-tokenized line (apply_bpe.BPE.process_line)."""
        leading = line[:len(line) - len(line.lstrip("\r\n "))]
        trailing = line[len(line.rstrip("\r\n ")):]
        segments = []
        for word in line.strip("\r\n ").split(" "):
            if not word:
                continue
            segments.extend(self.segment_word(word, dropout))
        return leading + " ".join(segments) + trailing


def learn_bpe(token_freqs: Dict[str, int], num_symbols: int,
              min_frequency: int = 2) -> List[Tuple[str, str]]:
    """Learn BPE merge operations from {word: count}
    (subword_nmt.learn_bpe equivalent, simple O(n*merges) variant)."""
    vocab = {tuple(w[:-1]) + (w[-1] + "</w>",): c for w, c in token_freqs.items()}
    merges: List[Tuple[str, str]] = []
    for _ in range(num_symbols):
        pairs = Counter()
        for word, c in vocab.items():
            for pair in zip(word[:-1], word[1:]):
                pairs[pair] += c
        if not pairs:
            break
        # most frequent; ties broken lexicographically for determinism
        best, best_count = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if best_count < min_frequency:
            break
        merges.append(best)
        merged = best[0] + best[1]
        new_vocab = {}
        for word, c in vocab.items():
            w = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    w.append(merged)
                    i += 2
                else:
                    w.append(word[i])
                    i += 1
            new_vocab[tuple(w)] = c
        vocab = new_vocab
    return merges


def write_codes(merges: List[Tuple[str, str]], path: Path) -> None:
    with Path(path).open("w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
