# coding: utf-8
"""Token embeddings (counterpart of joeys2t_tpu/models/embeddings.py
``Embeddings`` :18)."""
import math

import torch
import torch.nn.functional as F
from torch import nn


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
