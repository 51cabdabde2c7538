# coding: utf-8
"""
Model facade and builder (counterpart of joeys2t_tpu/models/model.py:
``ModelSpec`` :28, ``Seq2SeqModel`` :56, ``build_model`` :236), for
speech-to-text with a transformer or conformer encoder and text-to-text
with a transformer or recurrent encoder, under a transformer or recurrent
decoder. ``remat`` (model-level, or a side's own key, read as JAX reads it
at :296 and :375) rematerializes each transformer or Conformer layer in the
backward (``modules.rematerialized``); recurrent sides ignore it, as in JAX.
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
from joeys2t_torch.models.initialization import compute_alpha_beta, initialize_model
from joeys2t_torch.models.modules import set_attention_impl
from joeys2t_torch.models.rnn import RecurrentDecoder, RecurrentEncoder


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static metadata for a built model: the task, the special-symbol ids
    and sizes that search needs (joeynmt/model.py:60-68)."""

    task: str
    pad_index: int
    bos_index: int
    eos_index: int
    unk_index: int
    sep_index: Optional[int]
    specials: Tuple[int, ...]
    lang_tags: Tuple[int, ...]
    src_vocab_size: Optional[int]
    trg_vocab_size: int

    @property
    def forbidden_at_generation(self) -> Tuple[int, ...]:
        """Tokens never generated: bos, sep, lang_tags (joeynmt/search.py:288)."""
        forbidden = [self.bos_index]
        if self.sep_index is not None:
            forbidden.append(self.sep_index)
        return tuple(forbidden) + tuple(self.lang_tags)


class Seq2SeqModel(nn.Module):
    """Encoder-decoder model. Speech models (S2T) read fbank features and
    have no source embedding (joeynmt/model.py:396); text models (MT) embed
    source tokens with ``src_embed``. Under tied embeddings one table serves
    both sides: it is the parameter of ``trg_embed`` only, so it appears
    once in ``parameters()`` and ``state_dict()``, where the JAX package
    keeps it (``trg_embed/lut``), and ``src_embed`` refers to the same
    module without registering it a second time. Under the tied softmax the
    logits are the decoder's hidden states projected onto the target table
    (:482-490). A recurrent decoder starts from the encoder's last states
    and computes its own logits."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 trg_embed: Embeddings, src_embed: Optional[Embeddings] = None,
                 tied_softmax: bool = False):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.trg_embed = trg_embed
        if src_embed is trg_embed:
            self.__dict__["src_embed"] = src_embed  # a reference, not a submodule
        else:
            self.src_embed = src_embed
        self.tied_softmax = tied_softmax

    def _output_logits(self, out: torch.Tensor) -> torch.Tensor:
        return self.trg_embed.attend(out) if self.tied_softmax else out

    def encode(self, src: torch.Tensor, src_length: torch.Tensor,
               src_mask: Optional[torch.Tensor] = None,
               src_prompt_mask: Optional[torch.Tensor] = None):
        """Returns (encoder_output, encoder_hidden, src_mask); ``src`` is
        (B, T) token ids for MT, with ``src_mask`` (B, 1, T) and an optional
        0/1 ``src_prompt_mask`` (B, T) whose embedding is added to the
        input (joeynmt/model.py:211-239)."""
        if self.src_embed is None:  # S2T: fbank features
            return self.encoder(src, src_length, src_mask)
        prompt = None if src_prompt_mask is None else self.src_embed(src_prompt_mask)
        return self.encoder(self.src_embed(src), src_length, src_mask, prompt)

    def decode(self, trg_input: torch.Tensor, encoder_output: torch.Tensor,
               src_mask: Optional[torch.Tensor], trg_mask: torch.Tensor,
               trg_prompt_mask: Optional[torch.Tensor] = None,
               encoder_hidden: Optional[torch.Tensor] = None):
        """Teacher-forced decode; returns (logits, hidden, ctc_logits). A
        recurrent decoder unrolls ``trg_input.shape[1]`` steps from
        ``encoder_hidden`` and reads no target prompt (model.py:161-167)."""
        if isinstance(self.decoder, RecurrentDecoder):
            out, hidden, _ = self.decoder(self.trg_embed(trg_input), encoder_output,
                                          encoder_hidden, src_mask)
            return out, hidden, None
        prompt = None if trg_prompt_mask is None else self.trg_embed(trg_prompt_mask)
        out, hidden, ctc = self.decoder(self.trg_embed(trg_input), encoder_output,
                                        src_mask, trg_mask, prompt)
        return self._output_logits(out), hidden, ctc

    def forward(self, src: torch.Tensor, trg_input: torch.Tensor,
                src_length: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                trg_mask: Optional[torch.Tensor] = None,
                src_prompt_mask: Optional[torch.Tensor] = None,
                trg_prompt_mask: Optional[torch.Tensor] = None):
        """Encode + decode; returns (logits, ctc_logits, src_mask)."""
        encoder_output, encoder_hidden, src_mask = self.encode(src, src_length, src_mask,
                                                               src_prompt_mask)
        logits, _, ctc_logits = self.decode(trg_input, encoder_output, src_mask, trg_mask,
                                            trg_prompt_mask, encoder_hidden)
        return logits, ctc_logits, src_mask

    # ------------------------------------ the pipeline-parallel split of the pass
    def encode_pre_layers(self, src: torch.Tensor, src_length: torch.Tensor,
                          src_mask: Optional[torch.Tensor] = None,
                          src_prompt_mask: Optional[torch.Tensor] = None):
        """The encoder up to its layer stack (joeys2t_tpu/models/model.py
        :101-120): (x, mask); the stack then runs in stages."""
        if self.src_embed is None:
            return self.encoder.pre_layers(src, src_length, src_mask)
        prompt = None if src_prompt_mask is None else self.src_embed(src_prompt_mask)
        return self.encoder.pre_layers(self.src_embed(src), src_length, src_mask, prompt)

    def encode_post_layers(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder after its stack (:122-125)."""
        return self.encoder.post_layers(x)

    def decode_pre_layers(self, trg_input: torch.Tensor, trg_mask: torch.Tensor,
                          trg_prompt_mask: Optional[torch.Tensor] = None):
        """The transformer decoder up to its layer stack (:127-135): (x, the
        causal mask (B, T, T))."""
        prompt = None if trg_prompt_mask is None else self.trg_embed(trg_prompt_mask)
        return self.decoder.pre_layers(self.trg_embed(trg_input), trg_mask, prompt)

    def decode_post_layers(self, x: torch.Tensor, encoder_output: torch.Tensor):
        """The decoder after its stack (:137-140): (logits, ctc_logits)."""
        out, ctc = self.decoder.post_layers(x, encoder_output)
        return self._output_logits(out), ctc

    def init_cache(self, encoder_output: torch.Tensor, max_len: int,
                   src_mask: Optional[torch.Tensor] = None, beam_k: int = 1) -> Dict:
        """Decode cache for ``max_len`` steps over ``encoder_output`` with
        its source mask (B, 1, S), for ``beam_k`` beams an utterance."""
        return self.decoder.init_cache(encoder_output, max_len, src_mask, beam_k)

    def decode_step(self, prev_tokens: torch.Tensor, index: int, cache: Dict,
                    beam_k: int = 1,
                    trg_prompt_mask_t: Optional[torch.Tensor] = None,
                    ancestry: Optional[torch.Tensor] = None,
                    return_attention: bool = False):
        """One KV-cached decode step -> logits (B*beam_k, 1, V) from
        ``prev_tokens`` (B*beam_k, 1), with the 0/1 prompt mask (B*beam_k, 1)
        of this position when decoding is forced; ``cache`` is updated in
        place. ``ancestry`` is the lazy beam reorder's (B, beam_k, S) map
        (joeys2t_tpu/models/model.py:216-232). With ``return_attention``
        it returns (logits, the last decoder layer's cross-attention (B, 1,
        S))."""
        prompt = None if trg_prompt_mask_t is None else self.trg_embed(trg_prompt_mask_t)
        out = self.decoder.decode_step(self.trg_embed(prev_tokens), index, cache, beam_k,
                                       prompt, ancestry, return_attention)
        if return_attention:
            return self._output_logits(out[0]), out[1]
        return self._output_logits(out)


def _embeddings(vocab, emb_cfg: Dict, dtype: torch.dtype) -> Embeddings:
    return Embeddings(len(vocab), emb_cfg["embedding_dim"],
                      scale=emb_cfg.get("scale", False), dtype=dtype)


def build_model(cfg: Dict, src_vocab=None, trg_vocab=None,
                compute_dtype: torch.dtype = torch.float32, device=None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Seq2SeqModel, ModelSpec]:
    """Build and initialize the model of the `model` config section
    (joeynmt/model.py:366-506): a transformer or conformer encoder of speech
    features (no ``src_vocab``), or a transformer (optionally with
    mixture-of-experts feed-forwards) or recurrent encoder of source tokens
    (MT), under a transformer or recurrent decoder.

    Parameters are float32 (the JAX package's master weights) on ``device``
    (``cuda`` unless given), drawn by
    :func:`~joeys2t_torch.models.initialization.initialize_model` from
    ``generator`` (seed 42 when None). Recurrent modules and their
    embeddings compute in float32 whatever ``compute_dtype`` says, as in
    JAX. The model is returned in eval mode: no dropout, as the JAX
    package's default ``deterministic=True``. ``attention_impl`` (of the
    model, or of a side) routes the side's attention:
    :func:`~joeys2t_torch.models.modules.set_attention_impl`."""
    # pylint: disable=too-many-locals,too-many-branches
    device = resolve_device(device)
    task = "MT" if src_vocab is not None else "S2T"
    enc_cfg, dec_cfg = cfg["encoder"], cfg["decoder"]
    enc_type = enc_cfg.get("type", "transformer")
    dec_type = dec_cfg.get("type", "transformer")
    if enc_type not in ("recurrent", "transformer", "conformer"):
        raise ConfigurationError("Invalid encoder type. Valid options: {`recurrent`, "
                                 "`transformer`, `conformer`}.")
    if dec_type not in ("recurrent", "transformer"):
        raise ConfigurationError("Invalid decoder type. Valid options: {`transformer`, "
                                 "`recurrent`}.")
    if enc_type == "recurrent" and task != "MT":
        raise ConfigurationError("RNN model not supported for s2t task. use transformer.")
    subsample = enc_cfg.get("subsample", False) or enc_type == "conformer"
    if task == "S2T" and not subsample:
        raise ConfigurationError("a speech encoder needs `subsample: True`")
    if task == "MT" and enc_type == "conformer":
        raise ConfigurationError("conformer encoders read speech features (S2T)")
    tied_embeddings = cfg.get("tied_embeddings", False)
    if tied_embeddings and (task != "MT" or src_vocab != trg_vocab):
        raise ConfigurationError("Embedding cannot be tied since vocabularies differ.")
    tied_softmax = cfg.get("tied_softmax", False)
    if tied_softmax and dec_cfg["embeddings"]["embedding_dim"] != dec_cfg["hidden_size"]:
        raise ConfigurationError(
            "For tied_softmax, the decoder embedding_dim and decoder hidden_size must be "
            "the same. The decoder must be a Transformer.")
    if task == "MT" and enc_type == "transformer" \
            and enc_cfg["embeddings"]["embedding_dim"] != enc_cfg["hidden_size"]:
        raise ConfigurationError("for transformer, emb_size must be the same as "
                                 "hidden_size.")
    # the DeepNet residual scale of xavier_normal (joeys2t_tpu/models/model.py:249-260)
    enc_alpha = dec_alpha = 1.0
    if cfg.get("initializer", "xavier_uniform") == "xavier_normal" \
            and enc_type == dec_type == "transformer":
        alpha = compute_alpha_beta(enc_cfg["num_layers"], dec_cfg["num_layers"])["alpha"]
        enc_alpha, dec_alpha = alpha["encoder"], alpha["decoder"]

    trg_pad = trg_vocab.pad_index
    src_pad = src_vocab.pad_index if task == "MT" else trg_pad
    enc_dropout = enc_cfg.get("dropout", 0.0)
    dec_dropout = dec_cfg.get("dropout", 0.0)
    enc_emb_dropout = enc_cfg["embeddings"].get("dropout", enc_dropout)
    dec_emb_dropout = dec_cfg["embeddings"].get("dropout", dec_dropout)
    with torch.device("meta"):
        if enc_type == "recurrent":
            encoder = RecurrentEncoder(
                rnn_type=enc_cfg.get("rnn_type", "gru"), hidden_size=enc_cfg["hidden_size"],
                emb_size=enc_cfg["embeddings"]["embedding_dim"],
                num_layers=enc_cfg.get("num_layers", 1), dropout=enc_dropout,
                emb_dropout=enc_emb_dropout,
                bidirectional=enc_cfg.get("bidirectional", True))
        else:
            common = dict(
                hidden_size=enc_cfg["hidden_size"], ff_size=enc_cfg["ff_size"],
                num_layers=enc_cfg["num_layers"], num_heads=enc_cfg["num_heads"],
                dropout=enc_dropout, emb_dropout=enc_emb_dropout,
                layer_norm_position=enc_cfg.get("layer_norm", "pre"), alpha=enc_alpha,
                dtype=compute_dtype,
                remat=bool(cfg.get("remat", enc_cfg.get("remat", False))))
            if subsample:
                common.update(in_channels=enc_cfg["in_channels"],
                              conv_channels=enc_cfg["conv_channels"],
                              conv_kernel_sizes=tuple(enc_cfg.get("conv_kernel_sizes",
                                                                  [3, 3])))
            if enc_type == "conformer":
                encoder = ConformerEncoder(
                    depthwise_conv_kernel_size=enc_cfg.get("depthwise_conv_kernel_size",
                                                           31),
                    conv_norm_type=enc_cfg.get("conv_norm", "layernorm"),
                    macaron=enc_cfg.get("macaron", "reference"),
                    layerscale_init=float(enc_cfg.get("layerscale", 0.0)), **common)
            else:
                encoder = TransformerEncoder(
                    activation=enc_cfg.get("activation", "relu"), subsample=subsample,
                    num_experts=int(enc_cfg.get("num_experts", 0)), **common)
        if dec_type == "recurrent":
            decoder = RecurrentDecoder(
                rnn_type=dec_cfg.get("rnn_type", "gru"),
                emb_size=dec_cfg["embeddings"]["embedding_dim"],
                hidden_size=dec_cfg["hidden_size"], encoder_output_size=encoder.output_size,
                attention=dec_cfg.get("attention", "bahdanau"),
                num_layers=dec_cfg.get("num_layers", 1), vocab_size=len(trg_vocab),
                dropout=dec_dropout, emb_dropout=dec_emb_dropout,
                hidden_dropout=dec_cfg.get("hidden_dropout", 0.0),
                init_hidden=dec_cfg.get("init_hidden", "bridge"),
                input_feeding=dec_cfg.get("input_feeding", True),
                activation=dec_cfg.get("activation", "tanh"),
                encoder_hidden_size=(encoder.output_size if enc_type == "recurrent"
                                     else None))
        else:
            decoder = TransformerDecoder(
                num_layers=dec_cfg["num_layers"], num_heads=dec_cfg["num_heads"],
                hidden_size=dec_cfg["hidden_size"], ff_size=dec_cfg["ff_size"],
                dropout=dec_dropout, emb_dropout=dec_emb_dropout,
                vocab_size=len(trg_vocab),
                layer_norm_position=dec_cfg.get("layer_norm", "post"),
                activation=dec_cfg.get("activation", "relu"), alpha=dec_alpha,
                ctc_layer=task == "S2T", tied_softmax=tied_softmax,
                cache_cross_int8=bool(cfg.get("cache_cross_int8",
                                              dec_cfg.get("cache_cross_int8", False))),
                cache_self_int8=bool(cfg.get("cache_self_int8",
                                             dec_cfg.get("cache_self_int8", False))),
                remat=bool(cfg.get("remat", dec_cfg.get("remat", False))),
                dtype=compute_dtype)
        # embeddings feed their side in its compute dtype: float32 for a
        # recurrent side (and for a table tied to one)
        src_dtype = compute_dtype if enc_type != "recurrent" else torch.float32
        trg_dtype = compute_dtype if dec_type != "recurrent" else torch.float32
        if tied_embeddings:
            src_dtype = trg_dtype = (compute_dtype if enc_type == dec_type == "transformer"
                                     else torch.float32)
        src_embed = (_embeddings(src_vocab, enc_cfg["embeddings"], src_dtype)
                     if task == "MT" else None)
        trg_embed = (src_embed if tied_embeddings else
                     _embeddings(trg_vocab, dec_cfg["embeddings"], trg_dtype))
        model = Seq2SeqModel(encoder, decoder, trg_embed, src_embed, tied_softmax)
    # parameters are made on the meta device and only then given memory, so
    # no default initializer runs and the global torch generator is untouched
    model = model.to_empty(device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(42)
    initialize_model(model, cfg, src_pad, trg_pad, generator)
    # JAX's attn_impl of each transformer side (joeys2t_tpu/models/model.py:293, :370)
    for side, side_cfg, side_type in ((encoder, enc_cfg, enc_type),
                                      (decoder, dec_cfg, dec_type)):
        if side_type != "recurrent":
            set_attention_impl(side, cfg.get("attention_impl",
                                             side_cfg.get("attention_impl", "auto")))
    spec = ModelSpec(
        task=task, pad_index=trg_vocab.pad_index, bos_index=trg_vocab.bos_index,
        eos_index=trg_vocab.eos_index, unk_index=trg_vocab.unk_index,
        sep_index=trg_vocab.sep_index,
        specials=tuple(trg_vocab.lookup(t) for t in trg_vocab.specials),
        lang_tags=tuple(trg_vocab.lookup(t) for t in trg_vocab.lang_tags),
        src_vocab_size=len(src_vocab) if src_vocab is not None else None,
        trg_vocab_size=len(trg_vocab))
    return model.eval(), spec
