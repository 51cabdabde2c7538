# coding: utf-8
"""
Model facade and builder (counterpart of joeys2t_tpu/models/model.py:
``ModelSpec`` :28, ``Seq2SeqModel`` :56, ``build_model`` :236), for
speech-to-text with a transformer or conformer encoder.
"""
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from joeys2t_torch.config import ConfigurationError
from joeys2t_torch.helpers import resolve_device
from joeys2t_torch.models.decoders import TransformerDecoder
from joeys2t_torch.models.embeddings import Embeddings
from joeys2t_torch.models.encoders import ConformerEncoder, TransformerEncoder
from joeys2t_torch.models.initialization import initialize_model


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static metadata for a built model: the special-symbol ids and sizes
    that search needs (joeynmt/model.py:60-68)."""

    pad_index: int
    bos_index: int
    eos_index: int
    unk_index: int
    sep_index: Optional[int]
    lang_tags: Tuple[int, ...]
    trg_vocab_size: int

    @property
    def forbidden_at_generation(self) -> Tuple[int, ...]:
        """Tokens never generated: bos, sep, lang_tags (joeynmt/search.py:288)."""
        forbidden = [self.bos_index]
        if self.sep_index is not None:
            forbidden.append(self.sep_index)
        return tuple(forbidden) + tuple(self.lang_tags)


class Seq2SeqModel(nn.Module):
    """Encoder-decoder speech-to-text model: the source is fbank features,
    with no source embedding (joeynmt/model.py:396)."""

    def __init__(self, encoder: nn.Module, decoder: TransformerDecoder,
                 trg_embed: Embeddings):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.trg_embed = trg_embed

    def encode(self, src: torch.Tensor, src_length: torch.Tensor,
               src_mask: Optional[torch.Tensor] = None):
        """Returns (encoder_output, encoder_hidden, src_mask)."""
        return self.encoder(src, src_length, src_mask)

    def decode(self, trg_input: torch.Tensor, encoder_output: torch.Tensor,
               src_mask: Optional[torch.Tensor], trg_mask: torch.Tensor):
        """Teacher-forced decode; returns (logits, hidden, ctc_logits)."""
        return self.decoder(self.trg_embed(trg_input), encoder_output, src_mask, trg_mask)

    def forward(self, src: torch.Tensor, trg_input: torch.Tensor,
                src_length: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                trg_mask: Optional[torch.Tensor] = None):
        """Encode + decode; returns (logits, ctc_logits, src_mask)."""
        encoder_output, _, src_mask = self.encode(src, src_length, src_mask)
        logits, _, ctc_logits = self.decode(trg_input, encoder_output, src_mask, trg_mask)
        return logits, ctc_logits, src_mask

    def init_cache(self, encoder_output: torch.Tensor, max_len: int,
                   src_mask: Optional[torch.Tensor] = None, beam_k: int = 1) -> Dict:
        """Decode cache for ``max_len`` steps over ``encoder_output`` with
        its source mask (B, 1, S), for ``beam_k`` beams an utterance."""
        return self.decoder.init_cache(encoder_output, max_len, src_mask, beam_k)

    def decode_step(self, prev_tokens: torch.Tensor, index: int, cache: Dict,
                    beam_k: int = 1) -> torch.Tensor:
        """One KV-cached decode step -> logits (B*beam_k, 1, V) from
        ``prev_tokens`` (B*beam_k, 1); ``cache`` is updated in place."""
        return self.decoder.decode_step(self.trg_embed(prev_tokens), index, cache,
                                        beam_k)


def build_model(cfg: Dict, src_vocab=None, trg_vocab=None,
                compute_dtype: torch.dtype = torch.float32, device=None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Seq2SeqModel, ModelSpec]:
    """Build and initialize the model of the `model` config section
    (joeynmt/model.py:366-506): speech-to-text with a transformer or
    conformer encoder and a transformer decoder.

    Parameters are float32 (the JAX package's master weights) on ``device``
    (``cuda`` unless given), drawn by
    :func:`~joeys2t_torch.models.initialization.initialize_model` from
    ``generator`` (seed 42 when None). The model is returned in eval mode:
    no dropout, as the JAX package's default ``deterministic=True``."""
    device = resolve_device(device)
    if src_vocab is not None:
        raise NotImplementedError("text-to-text (MT) models are not ported yet")
    enc_cfg, dec_cfg = cfg["encoder"], cfg["decoder"]
    enc_type = enc_cfg.get("type", "transformer")
    if enc_type not in ("transformer", "conformer"):
        raise NotImplementedError(f"{enc_type} encoders are not ported yet")
    if dec_cfg.get("type", "transformer") != "transformer":
        raise NotImplementedError(f"{dec_cfg.get('type')} decoders are not ported yet")
    if cfg.get("tied_embeddings", False):
        raise ConfigurationError("tied embeddings need a source vocabulary (MT)")
    if cfg.get("tied_softmax", False):
        raise NotImplementedError("tied softmax is not ported yet")
    if enc_type == "transformer" and not enc_cfg.get("subsample", False):
        raise NotImplementedError("speech encoders without subsampling are not "
                                  "ported yet")
    if int(enc_cfg.get("num_experts", 0)) > 0:
        raise NotImplementedError("mixture-of-experts layers are not ported yet")

    pad = trg_vocab.pad_index
    enc_dropout = enc_cfg.get("dropout", 0.0)
    dec_dropout = dec_cfg.get("dropout", 0.0)
    with torch.device("meta"):
        common = dict(
            hidden_size=enc_cfg["hidden_size"], ff_size=enc_cfg["ff_size"],
            num_layers=enc_cfg["num_layers"], num_heads=enc_cfg["num_heads"],
            dropout=enc_dropout,
            emb_dropout=enc_cfg["embeddings"].get("dropout", enc_dropout),
            layer_norm_position=enc_cfg.get("layer_norm", "pre"),
            in_channels=enc_cfg["in_channels"], conv_channels=enc_cfg["conv_channels"],
            conv_kernel_sizes=tuple(enc_cfg.get("conv_kernel_sizes", [3, 3])),
            dtype=compute_dtype)
        if enc_type == "conformer":
            encoder = ConformerEncoder(
                depthwise_conv_kernel_size=enc_cfg.get("depthwise_conv_kernel_size", 31),
                conv_norm_type=enc_cfg.get("conv_norm", "layernorm"),
                macaron=enc_cfg.get("macaron", "reference"),
                layerscale_init=float(enc_cfg.get("layerscale", 0.0)), **common)
        else:
            encoder = TransformerEncoder(activation=enc_cfg.get("activation", "relu"),
                                         subsample=True, **common)
        decoder = TransformerDecoder(
            num_layers=dec_cfg["num_layers"], num_heads=dec_cfg["num_heads"],
            hidden_size=dec_cfg["hidden_size"], ff_size=dec_cfg["ff_size"],
            dropout=dec_dropout,
            emb_dropout=dec_cfg["embeddings"].get("dropout", dec_dropout),
            vocab_size=len(trg_vocab),
            layer_norm_position=dec_cfg.get("layer_norm", "post"),
            activation=dec_cfg.get("activation", "relu"), ctc_layer=True,
            cache_cross_int8=bool(cfg.get("cache_cross_int8",
                                          dec_cfg.get("cache_cross_int8", False))),
            cache_self_int8=bool(cfg.get("cache_self_int8",
                                         dec_cfg.get("cache_self_int8", False))),
            dtype=compute_dtype)
        trg_embed = Embeddings(
            len(trg_vocab), dec_cfg["embeddings"]["embedding_dim"],
            scale=dec_cfg["embeddings"].get("scale", False), dtype=compute_dtype)
        model = Seq2SeqModel(encoder, decoder, trg_embed)
    # parameters are made on the meta device and only then given memory, so
    # no default initializer runs and the global torch generator is untouched
    model = model.to_empty(device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(42)
    initialize_model(model, cfg, pad, pad, generator)
    spec = ModelSpec(
        pad_index=trg_vocab.pad_index, bos_index=trg_vocab.bos_index,
        eos_index=trg_vocab.eos_index, unk_index=trg_vocab.unk_index,
        sep_index=trg_vocab.sep_index,
        lang_tags=tuple(trg_vocab.lookup(t) for t in trg_vocab.lang_tags),
        trg_vocab_size=len(trg_vocab))
    return model.eval(), spec
