# coding: utf-8
"""
Transformer decoder (counterpart of joeys2t_tpu/models/decoders.py
``TransformerDecoder`` :27): the full teacher-forced pass with the CTC head
over the encoder output, and the KV-cached decode path (``init_cache`` and
``decode_step``) that greedy search runs. Caches are (B, H, S, D): the
cross-attention K/V are projected once per utterance, the self-attention
K/V fill a preallocated buffer one slot per step. The positional encoding
table and the cross-attention bias are built once per utterance, in
``init_cache``, and the self-attention bias once per step for all layers.
"""
from typing import Dict, Optional

import torch
from torch import nn

from joeys2t_torch.models.modules import (NEG_INF, Dropout, TransformerDecoderLayer, dense,
                                          layer_norm, sinusoidal_pe, subsequent_mask)


class TransformerDecoder(nn.Module):
    """Masked transformer decoder with an optional CTC output layer."""

    def __init__(self, num_layers: int = 4, num_heads: int = 8, hidden_size: int = 512,
                 ff_size: int = 2048, dropout: float = 0.1, emb_dropout: float = 0.1,
                 vocab_size: int = 1, layer_norm_position: str = "post",
                 activation: str = "relu", alpha: float = 1.0, ctc_layer: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_size = hidden_size
        self.layer_norm_position = layer_norm_position
        self.dtype = dtype
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(hidden_size, ff_size, num_heads, dropout, alpha,
                                    layer_norm_position, activation, dtype, device)
            for _ in range(num_layers))
        self.emb_dropout = Dropout(emb_dropout)
        self.layer_norm = (nn.LayerNorm(hidden_size, eps=1e-6, device=device)
                           if layer_norm_position == "pre" else None)
        self.output_layer = nn.Linear(hidden_size, vocab_size, bias=False, device=device)
        # CTC head over the encoder output (joeynmt/model.py:452-454)
        self.ctc_output_layer = (nn.Linear(hidden_size, vocab_size, bias=False,
                                           device=device) if ctc_layer else None)

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        if self.layer_norm is not None:
            x = layer_norm(self.layer_norm, x, self.dtype)
        return x

    def forward(self, trg_embed: torch.Tensor, encoder_output: torch.Tensor,
                src_mask: Optional[torch.Tensor], trg_mask: torch.Tensor):
        """Teacher-forced pass; returns (logits, hidden, ctc_logits)
        (joeynmt/decoders.py:567-625)."""
        t = trg_embed.shape[1]
        pe = sinusoidal_pe(t, trg_embed.shape[2], trg_embed.device)
        x = self.emb_dropout(trg_embed + pe.to(trg_embed.dtype)[None]).to(self.dtype)
        full_trg_mask = trg_mask & subsequent_mask(t, trg_mask.device)  # (B, T, T)
        for layer in self.layers:
            x = layer(x, encoder_output, src_mask, full_trg_mask)
        x = self._final(x)
        ctc_out = (None if self.ctc_output_layer is None
                   else dense(self.ctc_output_layer, encoder_output, self.dtype))
        return dense(self.output_layer, x, self.dtype), x, ctc_out

    def init_cache(self, encoder_output: torch.Tensor, max_len: int,
                   src_mask: Optional[torch.Tensor] = None) -> Dict[str, Dict]:
        """Decode cache: per layer the cross K/V projected once and zeroed
        self-attention buffers of ``max_len`` slots, all (B, H, S, Dh) in the
        compute dtype; and, shared by every layer and step, the positional
        encoding table (max_len, size) and the cross-attention bias (B, S)
        f32 from ``src_mask`` (B, 1, S) bool."""
        b, s = encoder_output.shape[:2]
        device = encoder_output.device
        shape = (b, self.num_heads, max_len, self.hidden_size // self.num_heads)
        cross_bias = torch.zeros((b, s), dtype=torch.float32, device=device)
        if src_mask is not None:
            cross_bias.masked_fill_(~src_mask[:, 0, :], NEG_INF)
        cache = {"pe": sinusoidal_pe(max_len, self.hidden_size, device),
                 "cross_bias": cross_bias}
        for i, layer in enumerate(self.layers):
            ck, cv = layer.precompute_cross_kv(encoder_output)  # (B, S, H, D)
            cache[f"layer_{i}"] = {
                "cross_k": ck.transpose(1, 2).contiguous(),
                "cross_v": cv.transpose(1, 2).contiguous(),
                "self_k": torch.zeros(shape, dtype=self.dtype, device=encoder_output.device),
                "self_v": torch.zeros(shape, dtype=self.dtype, device=encoder_output.device),
            }
        return cache

    def decode_step(self, trg_embed_t: torch.Tensor, index: int,
                    cache: Dict) -> torch.Tensor:
        """One decode step at position ``index`` -> logits (B, 1, V); the
        self-attention caches are updated in place."""
        x = (trg_embed_t + cache["pe"][index].to(trg_embed_t.dtype)).to(self.dtype)
        # slots 0..index are valid in every layer's self-attention buffer
        self_bias = torch.full((x.shape[0], cache["pe"].shape[0]), NEG_INF,
                               dtype=torch.float32, device=x.device)
        self_bias[:, :index + 1] = 0.0
        for i, layer in enumerate(self.layers):
            x = layer.decode_step(x, cache[f"layer_{i}"], index, self_bias,
                                  cache["cross_bias"])
        return dense(self.output_layer, self._final(x), self.dtype)
