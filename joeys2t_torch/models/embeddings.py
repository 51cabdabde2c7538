# coding: utf-8
"""Token embeddings (counterpart of joeys2t_tpu/models/embeddings.py
``Embeddings`` :18), with ``attend`` (:39-41) for the tied softmax, and the
reader of pretrained tables (``load_pretrained_embeddings`` :44)."""
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)


class Embeddings(nn.Module):
    """Token embedding lookup with optional sqrt(d) scaling
    (joeynmt/embeddings.py:55-64)."""

    def __init__(self, vocab_size: int, embedding_dim: int = 64, scale: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.scale = scale
        self.dtype = dtype
        self.lut = nn.Embedding(vocab_size, embedding_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        emb = F.embedding(x, self.lut.weight).to(self.dtype)
        if self.scale:
            emb = emb * math.sqrt(self.embedding_dim)
        return emb

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (..., V) of hidden states (..., E) projected onto the table
        (the tied softmax), a plain matmul in the compute dtype as the
        untied output layer computes. The JAX module computes it in float32
        (its embeddings are float32); the two differ only below float32."""
        return torch.matmul(x.to(self.dtype), self.lut.weight.to(self.dtype).t())


def load_pretrained_embeddings(embed_path: Path, vocab, embedding_dim: int) -> np.ndarray:
    """A word2vec/GloVe-style text table (a ``count dim`` header, then one
    ``token v1 .. vd`` line a token) as a (len(vocab), dim) float32 array:
    the rows of the vocabulary's tokens (specials included) that the file
    holds, NaN elsewhere, so the caller keeps its initialized values there
    (joeynmt/embeddings.py:74-128). Raises if the file's dim differs."""
    table = np.full((len(vocab), embedding_dim), np.nan, dtype=np.float32)
    with Path(embed_path).open("r", encoding="utf-8", errors="ignore") as f_embed:
        vocab_size, dim = map(int, f_embed.readline().split())
        if dim != embedding_dim:
            raise ValueError(f"Embedding dimension doesn't match: {embed_path} has {dim}, "
                             f"the model {embedding_dim}.")
        loaded = 0
        for line in f_embed.readlines():
            tokens = line.rstrip().split(" ")
            if tokens[0] in vocab.specials or not vocab.is_unk(tokens[0]):
                idx = vocab.lookup(tokens[0])
                if idx < len(vocab):
                    table[idx] = np.array([float(t) for t in tokens[1:]], dtype=np.float32)
                    loaded += 1
    logger.warning("Loaded %d of %d pre-trained embedding vectors.", loaded, vocab_size)
    return table


def merge_pretrained(embed: Embeddings, table: np.ndarray) -> None:
    """Write the rows of ``table`` that are not NaN into ``embed``'s table
    in place."""
    with torch.no_grad():
        weight = embed.lut.weight
        new = torch.from_numpy(table).to(weight.device)
        weight.copy_(torch.where(torch.isnan(new), weight, new))
