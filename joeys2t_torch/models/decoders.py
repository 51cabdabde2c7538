# coding: utf-8
"""
Transformer decoder (counterpart of joeys2t_tpu/models/decoders.py
``TransformerDecoder`` :27): the full teacher-forced pass with the CTC head
over the encoder output (speech models), and the KV-cached decode path (``init_cache`` and
``decode_step``) that greedy and beam search run. Caches are (B, H, S, D):
the cross-attention K/V are projected once per utterance, the
self-attention K/V fill a preallocated buffer one slot per step. In beam
search (``beam_k`` K > 1) the self buffers hold B*K rows, one per beam,
while the cross K/V and their bias stay at B rows, shared by an
utterance's beams. The positional encoding table and the cross-attention
bias are built once per utterance, in ``init_cache``, and the
self-attention bias once per step for all layers.

With ``cache_cross_int8`` the cross K/V are stored in int8 with one f32
scale per (b, h, channel), taken over the valid source frames only; with
``cache_self_int8`` the self buffers are int8 with one f32 scale per (b, h,
slot), each slot quantized as it is written (joeys2t_tpu/models/decoders.py
:172-227). Decode attention reads them in its "channel" and "position"
layouts.
"""
from typing import Dict, Optional

import torch
from torch import nn

from joeys2t_torch.models.modules import (NEG_INF, Dropout, TransformerDecoderLayer, dense,
                                          layer_norm, sinusoidal_pe, subsequent_mask)


def _quantize_per_channel(x: torch.Tensor, src_mask: Optional[torch.Tensor]):
    """(B, H, S, D) -> int8 values and (B, H, D) f32 scales, the abs-max over
    the valid frames of ``src_mask`` (B, 1, S) only: padded frames would
    inflate the scale and cost the real ones precision."""
    xf = x.float()
    xs = xf if src_mask is None else xf.masked_fill(~src_mask[:, 0, None, :, None], 0.0)
    scale = xs.abs().amax(dim=2) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[:, :, None, :]), -127, 127)
    return q.to(torch.int8).contiguous(), scale.contiguous()


class TransformerDecoder(nn.Module):
    """Masked transformer decoder with an optional CTC output layer."""

    def __init__(self, num_layers: int = 4, num_heads: int = 8, hidden_size: int = 512,
                 ff_size: int = 2048, dropout: float = 0.1, emb_dropout: float = 0.1,
                 vocab_size: int = 1, layer_norm_position: str = "post",
                 activation: str = "relu", alpha: float = 1.0, ctc_layer: bool = False,
                 tied_softmax: bool = False, cache_cross_int8: bool = False,
                 cache_self_int8: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cache_cross_int8 = cache_cross_int8
        self.cache_self_int8 = cache_self_int8
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
        # with the tied softmax the model projects onto its embedding table
        # (joeynmt/model.py:482-490) and the decoder returns hidden states
        self.output_layer = (None if tied_softmax else
                             nn.Linear(hidden_size, vocab_size, bias=False, device=device))
        # CTC head over the encoder output (joeynmt/model.py:452-454)
        self.ctc_output_layer = (nn.Linear(hidden_size, vocab_size, bias=False,
                                           device=device) if ctc_layer else None)

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        if self.layer_norm is not None:
            x = layer_norm(self.layer_norm, x, self.dtype)
        return x

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        """Logits, or under the tied softmax the hidden states as they are."""
        return x if self.output_layer is None else dense(self.output_layer, x, self.dtype)

    def forward(self, trg_embed: torch.Tensor, encoder_output: torch.Tensor,
                src_mask: Optional[torch.Tensor], trg_mask: torch.Tensor,
                trg_prompt_embed: Optional[torch.Tensor] = None):
        """Teacher-forced pass; returns (logits, or hidden states under the
        tied softmax, hidden, ctc_logits) (joeynmt/decoders.py:567-625).
        ``trg_prompt_embed`` is the embedded target prompt mask, added to the
        input (:600-601)."""
        t = trg_embed.shape[1]
        pe = sinusoidal_pe(t, trg_embed.shape[2], trg_embed.device)
        x = trg_embed + pe.to(trg_embed.dtype)[None]
        if trg_prompt_embed is not None:
            x = x + trg_prompt_embed
        x = self.emb_dropout(x).to(self.dtype)
        full_trg_mask = trg_mask & subsequent_mask(t, trg_mask.device)  # (B, T, T)
        for layer in self.layers:
            x = layer(x, encoder_output, src_mask, full_trg_mask)
        x = self._final(x)
        ctc_out = (None if self.ctc_output_layer is None
                   else dense(self.ctc_output_layer, encoder_output, self.dtype))
        return self._project(x), x, ctc_out

    def init_cache(self, encoder_output: torch.Tensor, max_len: int,
                   src_mask: Optional[torch.Tensor] = None,
                   beam_k: int = 1) -> Dict[str, Dict]:
        """Decode cache: per layer the cross K/V projected once (B, H, S, Dh)
        and zeroed self-attention buffers of ``max_len`` slots (B*beam_k, H,
        max_len, Dh), in the compute dtype or int8 with their scales; and,
        shared by every layer and step, the positional encoding table
        (max_len, size) and the cross-attention bias (B, S) f32 from
        ``src_mask`` (B, 1, S) bool."""
        b, s = encoder_output.shape[:2]
        device = encoder_output.device
        shape = (b * beam_k, self.num_heads, max_len, self.hidden_size // self.num_heads)
        cross_bias = torch.zeros((b, s), dtype=torch.float32, device=device)
        if src_mask is not None:
            cross_bias.masked_fill_(~src_mask[:, 0, :], NEG_INF)
        cache = {"pe": sinusoidal_pe(max_len, self.hidden_size, device),
                 "cross_bias": cross_bias}
        for i, layer in enumerate(self.layers):
            ck, cv = layer.precompute_cross_kv(encoder_output)  # (B, S, H, D)
            ck, cv = ck.transpose(1, 2), cv.transpose(1, 2)
            if self.cache_cross_int8:
                (ck, ck_s), (cv, cv_s) = (_quantize_per_channel(x, src_mask) for x in (ck, cv))
                entry = {"cross_k": ck, "cross_k_scale": ck_s,
                         "cross_v": cv, "cross_v_scale": cv_s}
            else:
                entry = {"cross_k": ck.contiguous(), "cross_v": cv.contiguous()}
            if self.cache_self_int8:
                entry.update(
                    self_k=torch.zeros(shape, dtype=torch.int8, device=device),
                    self_v=torch.zeros(shape, dtype=torch.int8, device=device),
                    self_k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
                    self_v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device))
            else:
                entry.update(self_k=torch.zeros(shape, dtype=self.dtype, device=device),
                             self_v=torch.zeros(shape, dtype=self.dtype, device=device))
            cache[f"layer_{i}"] = entry
        return cache

    def decode_step(self, trg_embed_t: torch.Tensor, index: int, cache: Dict,
                    beam_k: int = 1,
                    trg_prompt_embed_t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step at position ``index`` -> logits (B*beam_k, 1, V),
        or hidden states under the tied softmax, over a cache made with the
        same ``beam_k``; the self-attention caches are updated in place.
        ``trg_prompt_embed_t`` is the embedded prompt mask of this
        position."""
        x = trg_embed_t + cache["pe"][index].to(trg_embed_t.dtype)
        if trg_prompt_embed_t is not None:
            x = x + trg_prompt_embed_t
        x = x.to(self.dtype)
        # slots 0..index are valid in every layer's self-attention buffer
        self_bias = torch.full((x.shape[0], cache["pe"].shape[0]), NEG_INF,
                               dtype=torch.float32, device=x.device)
        self_bias[:, :index + 1] = 0.0
        for i, layer in enumerate(self.layers):
            x = layer.decode_step(x, cache[f"layer_{i}"], index, self_bias,
                                  cache["cross_bias"], beam_k)
        return self._project(self._final(x))
