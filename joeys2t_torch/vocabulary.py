# coding: utf-8
"""
Vocabulary: token <-> id mapping (counterpart of joeys2t_tpu/vocabulary.py
``Vocabulary`` :25, ``sort_and_cut`` :134, ``_build_vocab`` :146,
``build_vocab`` :173). The id layout is the checkpoint contract: specials
first in the order unk/pad/bos/eos[/sep], then language tags, then the
corpus tokens in the order given, duplicates keeping their first id.
"""
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.helpers import flatten, read_list_from_file, write_list_to_file


class Vocabulary:
    """Immutable token <-> id table."""

    def __init__(self, tokens: List[str], cfg: SpecialSymbols) -> None:
        core = [cfg.unk_token, cfg.pad_token, cfg.bos_token, cfg.eos_token]
        self.specials = core + ([cfg.sep_token] if cfg.sep_token else [])
        self.lang_tags = list(cfg.lang_tags)

        self._tokens: List[str] = []
        self._ids: Dict[str, int] = {}
        for tok in (*self.specials, *self.lang_tags, *tokens):
            if tok not in self._ids:
                self._ids[tok] = len(self._tokens)
                self._tokens.append(tok)

        self.unk_index = cfg.unk_id
        self.pad_index = cfg.pad_id
        self.bos_index = cfg.bos_id
        self.eos_index = cfg.eos_id
        self.sep_index = cfg.sep_id if cfg.sep_token else None
        # the configured ids must land exactly where construction put the
        # special tokens: a mismatched config would silently corrupt decoding
        expected = dict(zip(core, (cfg.unk_id, cfg.pad_id, cfg.bos_id,
                                   cfg.eos_id)))
        if cfg.sep_token:
            expected[cfg.sep_token] = cfg.sep_id
        for tok, want in expected.items():
            if self._ids[tok] != want:
                raise ValueError(f"special token {tok!r} has id {self._ids[tok]}, "
                                 f"the config says {want}")

    def lookup(self, token: str) -> int:
        """Token id, or unk for out-of-vocabulary surface forms."""
        return self._ids.get(token, self.unk_index)

    def is_unk(self, token: str) -> bool:
        return self.lookup(token) == self.unk_index

    def __len__(self) -> int:
        return len(self._tokens)

    def __eq__(self, other) -> bool:
        return isinstance(other, Vocabulary) and self._tokens == other._tokens

    def to_file(self, file: Path) -> None:
        """One token per line; the line number is the id (read back through
        ``voc_file``)."""
        write_list_to_file(file, self._tokens)

    def sentences_to_ids(self, sentences: List[List[str]], bos: bool = True,
                         eos: bool = True
                         ) -> Tuple[List[List[int]], List[int], List[List[int]]]:
        """Token lists -> (id rows padded to the longest, true lengths,
        prompt masks). A prompt mask is 1 up to and including the first sep."""
        width = int(bos) + int(eos) + max(len(s) for s in sentences)
        head = [self.bos_index] if bos else []
        tail = [self.eos_index] if eos else []
        rows, lengths, masks = [], [], []
        for sent in sentences:
            ids = head + [self.lookup(t) for t in sent] + tail
            lengths.append(len(ids))
            rows.append(ids + [self.pad_index] * (width - len(ids)))
            prompt_end = 0
            if self.sep_index is not None and self.sep_index in ids:
                prompt_end = ids.index(self.sep_index) + 1
            masks.append([1] * prompt_end + [0] * (width - prompt_end))
        return rows, lengths, masks

    def arrays_to_sentences(self, arrays, cut_at_eos: bool = True,
                            skip_pad: bool = True) -> List[List[str]]:
        """Id rows back to token lists: everything up to and including the
        first eos (when cutting), with pads dropped."""
        out = []
        for row in arrays:
            row = np.asarray(row).ravel()
            if cut_at_eos:
                hits = np.flatnonzero(row == self.eos_index)
                if hits.size:
                    row = row[:hits[0] + 1]
            if skip_pad:
                row = row[row != self.pad_index]
            out.append([self._tokens[int(i)] for i in row])
        return out

    def log_vocab(self, k: int) -> str:
        return " ".join(f"({i}) {t}" for i, t in enumerate(self._tokens[:k]))

    def __repr__(self) -> str:
        return (f"{self.__class__.__name__}(len={len(self)}, "
                f"specials={self.specials}, lang_tags={self.lang_tags})")


def sort_and_cut(counter: Counter, max_size: int = sys.maxsize,
                 min_freq: int = -1) -> List[str]:
    """Vocabulary order from corpus counts: frequency descending, ties
    alphabetical."""
    items = counter.items()
    if min_freq > -1:
        items = [kv for kv in items if kv[1] >= min_freq]
    ranked = sorted(items, key=lambda kv: (-kv[1], kv[0]))
    return [tok for tok, _ in ranked[:max_size]]


def _build_vocab(cfg: Dict, special_symbols: SpecialSymbols, dataset=None) -> Vocabulary:
    """One side's vocabulary: from ``voc_file`` when given, else counted from
    the whole (not subsampled) training data."""
    max_size = int(cfg.get("voc_limit", sys.maxsize))
    if max_size <= 0:
        raise ValueError(f"voc_limit must be positive, got {max_size}")
    voc_file = cfg.get("voc_file", None)
    if voc_file is not None:
        tokens = read_list_from_file(Path(voc_file))
    elif dataset is not None:
        corpus = dataset.get_list(lang=cfg["lang"], tokenized=True, subsampled=False)
        tokens = sort_and_cut(Counter(flatten(corpus)), max_size,
                              cfg.get("voc_min_freq", 1))
    else:
        raise ValueError("Please provide a vocab file path or dataset.")
    vocab = Vocabulary(tokens, special_symbols)
    # every reserved token except unk itself must resolve to a real id
    for s in vocab.specials[1:] + vocab.lang_tags:
        if vocab.is_unk(s):
            raise ValueError(f"reserved token {s!r} maps to unk")
    return vocab


def build_vocab(cfg: Dict, task: str, dataset=None, model_dir: Optional[Path] = None
                ) -> Tuple[Optional[Vocabulary], Vocabulary]:
    """(source vocabulary, or None for S2T; target vocabulary). A side
    without ``voc_file`` reads the ``{src,trg}_vocab.txt`` saved in
    ``model_dir`` when one is given, so a resumed run keeps its id layout."""
    for side, fname in (("src", "src_vocab.txt"), ("trg", "trg_vocab.txt")):
        if side == "src" and task != "MT":
            continue
        if model_dir is not None and cfg[side].get("voc_file", None) is None:
            saved = Path(model_dir) / fname
            if not saved.is_file():
                raise FileNotFoundError(f"{saved} not found")
            cfg[side]["voc_file"] = saved.as_posix()
    symbols = cfg["special_symbols"]
    src_vocab = _build_vocab(cfg["src"], symbols, dataset) if task == "MT" else None
    trg_vocab = _build_vocab(cfg["trg"], symbols, dataset)
    if src_vocab is not None:
        for attr in ("pad_index", "bos_index", "eos_index", "sep_index"):
            if getattr(src_vocab, attr) != getattr(trg_vocab, attr):
                raise ValueError(f"source and target vocabularies differ in {attr}")
    return src_vocab, trg_vocab
