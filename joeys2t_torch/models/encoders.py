# coding: utf-8
"""
Transformer and Conformer encoders with the Conv1d/GLU audio subsampler
(counterpart of joeys2t_tpu/models/encoders.py ``TransformerEncoder`` :29,
``ConformerEncoder`` :174).

The JAX encoder pads the subsampled audio sequence to a multiple of 128 for
the TPU kernel's lanes (token sequences are never padded); the CUDA flash
kernel masks any key length itself, so the port does not pad. Padded frames
are masked keys either way, and the output is the same.

Under tensor parallelism with ``sequence_parallel`` (joeys2t_tpu
encoders.py :129, :248) the residual stream between the layers is this
rank's slice of the sequence (``parallel/tp.py`` ``seq_enter`` /
``seq_exit``), the sequence padded to a multiple of the model group with
masked frames. ``pre_layers`` / ``post_layers`` split the forward around
the layer stack for pipeline parallelism (joeys2t_tpu/models/model.py
:101-125).
"""
from typing import Optional, Sequence

import torch
from torch import nn

from joeys2t_torch.models.modules import (ConformerEncoderLayer, Conv1dSubsampler, Dropout,
                                          TransformerEncoderLayer, dense, layer_norm,
                                          rematerialized, sinusoidal_pe)
from joeys2t_torch.parallel.tp import seq_enter, seq_exit


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Bool validity mask (B, 1, max_len); True at valid frames."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])[:, None, :]


def run_layers(encoder: nn.Module, x: torch.Tensor, mask: torch.Tensor,
               layers=None, conformer: bool = False) -> torch.Tensor:
    """``layers`` (the encoder's, by default) over ``x``, rematerialized
    under ``remat``, inside the sequence-parallel region when the encoder
    has one."""
    layers = encoder.layers if layers is None else layers
    tp = encoder.tp
    seq_len = None
    if tp is not None and tp.sequence_parallel:
        x, mask, seq_len = seq_enter(x, mask, tp)
    for layer in layers:
        args = (x, mask, seq_len) if conformer else (x, mask)
        x = rematerialized(layer, *args) if encoder.remat else layer(*args)
    return x if seq_len is None else seq_exit(x, seq_len, tp)


class TransformerEncoder(nn.Module):
    """Transformer encoder with optional conv subsampling for S2T, and
    mixture-of-experts feed-forwards with ``num_experts > 0``."""

    def __init__(self, hidden_size: int = 512, ff_size: int = 2048, num_layers: int = 8,
                 num_heads: int = 4, dropout: float = 0.1, emb_dropout: float = 0.1,
                 layer_norm_position: str = "pre", activation: str = "relu",
                 alpha: float = 1.0, subsample: bool = False, in_channels: int = 80,
                 conv_channels: int = 512, conv_kernel_sizes: Sequence[int] = (3, 3),
                 dtype: torch.dtype = torch.float32, device=None, num_experts: int = 0,
                 remat: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.layer_norm_position = layer_norm_position
        self.dtype = dtype
        self.remat = remat  # rematerialize each layer in the backward
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(hidden_size, ff_size, num_heads, dropout, alpha,
                                    layer_norm_position, activation, dtype, device,
                                    num_experts)
            for _ in range(num_layers))
        self.emb_dropout = Dropout(emb_dropout)
        # final layer norm exists iff layer_norm == "pre" (joeynmt/encoders.py:223-226)
        self.layer_norm = (nn.LayerNorm(hidden_size, eps=1e-6, device=device)
                           if layer_norm_position == "pre" else None)
        self.subsampler = (Conv1dSubsampler(in_channels, conv_channels, hidden_size,
                                            conv_kernel_sizes, dtype, device)
                           if subsample else None)
        self.tp = None  # the model group under tensor parallelism

    @property
    def output_size(self) -> int:
        return self.hidden_size

    def forward(self, src_embed: torch.Tensor, src_length: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                src_prompt_embed: Optional[torch.Tensor] = None):
        """(B, T, E) fbank features (S2T) or embedded tokens (MT, plus the
        embedded source prompt mask, joeynmt/encoders.py:274-275) ->
        (output (B, T', H), None, mask (B, 1, T'))."""
        x, mask = self.pre_layers(src_embed, src_length, mask, src_prompt_embed)
        return self.post_layers(run_layers(self, x, mask)), None, mask

    def pre_layers(self, src_embed: torch.Tensor, src_length: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   src_prompt_embed: Optional[torch.Tensor] = None):
        """The forward up to the layer stack: (x (B, T', H), mask (B, 1, T'))."""
        if self.subsampler is not None:
            src_embed, src_length = self.subsampler(src_embed, src_length)
        if mask is None:
            mask = lengths_to_mask(src_length, src_embed.shape[1])
        pe = sinusoidal_pe(src_embed.shape[1], src_embed.shape[2], src_embed.device)
        x = src_embed + pe.to(src_embed.dtype)[None]
        if src_prompt_embed is not None:
            x = x + src_prompt_embed
        return self.emb_dropout(x).to(self.dtype), mask

    def post_layers(self, x: torch.Tensor) -> torch.Tensor:
        """The final layer norm (pre-norm), after the stack."""
        if self.layer_norm is not None:
            x = layer_norm(self.layer_norm, x, self.dtype)
        return x


class ConformerEncoder(nn.Module):
    """Conformer encoder: it always subsamples, then adds the sinusoidal
    positional encoding, projects (``linear``), applies the embedding
    dropout and the layers; no final norm (each layer ends with its own)."""

    def __init__(self, hidden_size: int = 512, ff_size: int = 2048, num_layers: int = 8,
                 num_heads: int = 4, dropout: float = 0.1, emb_dropout: float = 0.1,
                 layer_norm_position: str = "pre", alpha: float = 1.0,
                 depthwise_conv_kernel_size: int = 31, in_channels: int = 80,
                 conv_channels: int = 512, conv_kernel_sizes: Sequence[int] = (3, 3),
                 dtype: torch.dtype = torch.float32, conv_norm_type: str = "layernorm",
                 macaron: str = "reference", layerscale_init: float = 0.0, device=None,
                 remat: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.remat = remat  # rematerialize each layer in the backward
        self.layers = nn.ModuleList(
            ConformerEncoderLayer(hidden_size, ff_size, num_heads, dropout,
                                  depthwise_conv_kernel_size, alpha, layer_norm_position,
                                  dtype, conv_norm_type, macaron, layerscale_init, device)
            for _ in range(num_layers))
        self.linear = nn.Linear(hidden_size, hidden_size, device=device)
        self.emb_dropout = Dropout(emb_dropout)
        self.subsampler = Conv1dSubsampler(in_channels, conv_channels, hidden_size,
                                           conv_kernel_sizes, dtype, device)
        self.tp = None  # the model group under tensor parallelism

    @property
    def output_size(self) -> int:
        return self.hidden_size

    def forward(self, src_embed: torch.Tensor, src_length: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        """(B, T, E) fbank features -> (output (B, T', H), None, mask (B, 1,
        T')); the mask always comes from the subsampled lengths."""
        x, mask = self.pre_layers(src_embed, src_length, mask)
        return self.post_layers(run_layers(self, x, mask, conformer=True)), None, mask

    def pre_layers(self, src_embed: torch.Tensor, src_length: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, src_prompt_embed=None):
        """The forward up to the layer stack: (x (B, T', H), mask (B, 1, T'))."""
        del mask, src_prompt_embed
        x, src_length = self.subsampler(src_embed, src_length)
        mask = lengths_to_mask(src_length, x.shape[1])
        x = x + sinusoidal_pe(x.shape[1], x.shape[2], x.device).to(x.dtype)[None]
        return self.emb_dropout(dense(self.linear, x, self.dtype)).to(self.dtype), mask

    def post_layers(self, x: torch.Tensor) -> torch.Tensor:
        """Nothing: each Conformer layer ends with its own norm."""
        return x
