# coding: utf-8
"""
Parameter initialization (counterpart of joeys2t_tpu/models/initialization.py
``initialize_model`` :83).

Draws every parameter from an explicit CPU ``torch.Generator`` in sorted
name order and copies it to the parameter's device, so one seed gives the
same weights on every device. The draws are the port's own: they do not
reproduce the JAX package's random numbers.
"""
import math
import re
from typing import Dict

import torch
from torch import nn

from joeys2t_torch.config import ConfigurationError


def compute_alpha_beta(num_enc_layers: int, num_dec_layers: int) -> Dict[str, Dict]:
    """DeepNet's residual scales (alpha) and initialization gains (beta) of
    each side (joeynmt/initialization.py:63-76)."""
    return {
        "alpha": {
            "encoder": 0.81 * (num_enc_layers**4 * num_dec_layers)**(1 / 16),
            "decoder": (3 * num_dec_layers)**(1 / 4),
        },
        "beta": {
            "encoder": 0.87 * (num_enc_layers**4 * num_dec_layers)**(-1 / 16),
            "decoder": (12 * num_dec_layers)**(-1 / 4),
        },
    }


def _make_init(name: str, scale: float, gain: float):
    """A function (shape, generator) -> float32 CPU tensor
    (joeynmt/initialization.py:154-169)."""
    scale = float(scale)
    if scale <= 0.0:
        raise ConfigurationError("incorrect init_weight")
    name = name.lower()

    def fan_sum(shape):
        # fan_in + fan_out of torch's Linear (out, in), Conv1d (out, in, k)
        # and Embedding (num, dim) weights, receptive field folded into both
        return (shape[0] + shape[1]) * math.prod(shape[2:])

    if name == "xavier_uniform":
        def fn(shape, gen):
            a = gain * math.sqrt(6.0 / fan_sum(shape))
            return torch.empty(shape).uniform_(-a, a, generator=gen)
    elif name == "xavier_normal":
        def fn(shape, gen):
            std = gain * math.sqrt(2.0 / fan_sum(shape))
            return torch.empty(shape).normal_(0.0, std, generator=gen)
    elif name == "uniform":
        def fn(shape, gen):
            return torch.empty(shape).uniform_(-scale, scale, generator=gen)
    elif name == "normal":
        def fn(shape, gen):
            return torch.empty(shape).normal_(0.0, scale, generator=gen)
    elif name == "zeros":
        def fn(shape, gen):
            del gen
            return torch.zeros(shape)
    else:
        raise ConfigurationError("Unknown initializer.")
    return fn


_RNN_LEAF = re.compile(r"(weight|bias)_(ih|hh)_l\d+(?:_reverse)?$")


def _rnn_tensor(kind: str, side: str, shape, model: nn.Module, name: str, init_fn,
                bias_fn, generator: torch.Generator) -> torch.Tensor:
    """A flat GRU/LSTM tensor drawn per flax gate (see ``initialize_model``)."""
    hidden = model.get_submodule(name.rsplit(".", 1)[0]).hidden_size
    gates = shape[0] // hidden
    if kind == "weight":
        return torch.cat([init_fn((hidden,) + tuple(shape[1:]), generator)
                          for _ in range(gates)])
    # the gates whose bias flax keeps in this torch tensor
    drawn = (range(gates) if side == "ih" else
             [2] if gates == 3 else [])
    return torch.cat([bias_fn((hidden,), generator) if g in drawn
                      else torch.zeros(hidden) for g in range(gates)])


@torch.no_grad()
def initialize_model(model: nn.Module, cfg: Dict, src_padding_idx: int,
                     trg_padding_idx: int, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter of ``model`` in place per the `model`
    config section (joeynmt/initialization.py:79-236): embeddings, biases
    and weight matrices by their initializers, LayerNorm scales to one, and
    the padding row of each embedding to zero, with the DeepNet gains under
    ``xavier_normal``. As in the JAX package, the
    conformer's parameters outside those rules keep their constants:
    LayerScale vectors (``ls_*``) the encoder's ``layerscale``, the frozen
    BatchNorm's weight and bias one and zero, its running mean and variance
    (buffers) zero and one.

    Where JAX's tensors are laid out otherwise, the port draws what JAX
    draws. A recurrent layer's flat ``weight_ih``/``weight_hh`` (G*H, in)
    is drawn one (H, in) gate block at a time, with that block's fans, as
    JAX initializes each flax gate's matrix; its biases are drawn one per
    flax gate (GRU: r, z, n of ``bias_ih`` and n of ``bias_hh``; LSTM: the
    four gates in ``bias_ih``), the redundant torch halves left at zero
    (joeys2t_tpu/convert.py:254-290). The experts' ``w1``/``w2`` take the
    fans of their JAX layout, and ``b1``/``b2`` are drawn as weight
    matrices, which is what JAX makes of them (their leaf is not ``bias``).
    ``init_rnn_orthogonal`` and ``lstm_forget_gate`` are not read, as in JAX."""
    gain = float(cfg.get("init_gain", 1.0))
    init = cfg.get("initializer", "xavier_uniform")
    if init == "xavier":
        init = "xavier_uniform"
    # DeepNet (joeynmt/initialization.py:196-207): under xavier_normal the
    # feed-forward, value and output projections of a transformer take the
    # side's beta as their gain; build_model scales the residuals by alpha
    beta = None
    if init == "xavier_normal" and cfg.get("encoder", {}).get(
            "type", "transformer") == "transformer" and cfg.get("decoder", {}).get(
            "type", "transformer") == "transformer":
        beta = compute_alpha_beta(cfg["encoder"]["num_layers"],
                                  cfg["decoder"]["num_layers"])["beta"]
    embed_init = cfg.get("embed_initializer", "xavier_uniform")
    if embed_init == "xavier":
        embed_init = "xavier_uniform"
    init_fn = _make_init(init, cfg.get("init_weight", 0.01), gain)
    embed_fn = _make_init(embed_init, cfg.get("embed_init_weight", 0.01),
                          float(cfg.get("embed_init_gain", 1.0)))
    bias_fn = _make_init(cfg.get("bias_initializer", "zeros"),
                         cfg.get("bias_init_weight", 0.01), gain)

    layerscale = float(cfg.get("encoder", {}).get("layerscale", 0.0))
    for name, p in sorted(model.named_parameters()):
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("ls_"):
            p.fill_(layerscale)
            continue
        if ".batch_norm." in name:
            p.fill_(1.0 if leaf == "weight" else 0.0)
            continue
        rnn = _RNN_LEAF.match(leaf) if ".rnn." in name else None
        expert = ".feed_forward." in name and leaf in ("w1", "b1", "w2", "b2")
        if "embed" in name and name.endswith("lut.weight"):
            value = embed_fn(shape, generator)
            value[src_padding_idx if "src_embed" in name else trg_padding_idx] = 0.0
        elif rnn is not None:
            value = _rnn_tensor(rnn.group(1), rnn.group(2), shape, model, name, init_fn,
                                bias_fn, generator)
        elif name.endswith("bias"):
            value = bias_fn(shape, generator)
        elif p.dim() > 1:
            fn = init_fn
            if beta is not None and any(
                    part in name for part in ("feed_forward", "v_layer", "output_layer")):
                side = next((k for k in ("encoder", "decoder") if k in name), None)
                fn = _make_init("xavier_normal", cfg.get("init_weight", 0.01),
                                1.0 if side is None else beta[side])
            # an expert tensor keeps JAX's (..., in, out) layout: drawn as its
            # reversed transpose, in torch's (out, in, ...) order, whose fans
            # are the ones JAX gives it (joeys2t_tpu/models/initialization.py:41-49)
            value = (fn(shape[::-1], generator).permute(*range(p.dim())[::-1])
                     if expert else fn(shape, generator))
        else:
            value = torch.ones(shape)  # LayerNorm scale
        p.copy_(value)
    for name, b in model.named_buffers():
        if name.endswith("running_mean") or name.endswith("running_var"):
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return model
