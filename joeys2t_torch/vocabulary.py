# coding: utf-8
"""
Vocabulary: token <-> id mapping (counterpart of joeys2t_tpu/vocabulary.py
``Vocabulary`` :25). The id layout is the checkpoint contract: specials
first in the order unk/pad/bos/eos[/sep], then language tags, then the
corpus tokens in the order given, duplicates keeping their first id.
"""
from typing import Dict, List

import numpy as np

from joeys2t_torch.config import SpecialSymbols


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

    def __len__(self) -> int:
        return len(self._tokens)

    def arrays_to_sentences(self, arrays) -> List[List[str]]:
        """Id rows back to token lists: everything up to and including the
        first eos, with pads dropped."""
        out = []
        for row in arrays:
            row = np.asarray(row).ravel()
            hits = np.flatnonzero(row == self.eos_index)
            if hits.size:
                row = row[:hits[0] + 1]
            row = row[row != self.pad_index]
            out.append([self._tokens[int(i)] for i in row])
        return out
