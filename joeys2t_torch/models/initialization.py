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
from typing import Dict

import torch
from torch import nn

from joeys2t_torch.config import ConfigurationError


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


@torch.no_grad()
def initialize_model(model: nn.Module, cfg: Dict, src_padding_idx: int,
                     trg_padding_idx: int, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter of ``model`` in place per the `model`
    config section (joeynmt/initialization.py:79-236): embeddings, biases
    and weight matrices by their initializers, LayerNorm scales to one, and
    the padding row of each embedding to zero. As in the JAX package, the
    conformer's parameters outside those rules keep their constants:
    LayerScale vectors (``ls_*``) the encoder's ``layerscale``, the frozen
    BatchNorm's weight and bias one and zero, its running mean and variance
    (buffers) zero and one."""
    gain = float(cfg.get("init_gain", 1.0))
    init = cfg.get("initializer", "xavier_uniform")
    if init == "xavier":
        init = "xavier_uniform"
    if init == "xavier_normal":
        raise NotImplementedError("the DeepNet (xavier_normal) initialization is not "
                                  "ported yet")
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
        if "embed" in name and name.endswith("lut.weight"):
            value = embed_fn(shape, generator)
            value[src_padding_idx if "src_embed" in name else trg_padding_idx] = 0.0
        elif name.endswith("bias"):
            value = bias_fn(shape, generator)
        elif p.dim() > 1:
            value = init_fn(shape, generator)
        else:
            value = torch.ones(shape)  # LayerNorm scale
        p.copy_(value)
    for name, b in model.named_buffers():
        if name.endswith("running_mean") or name.endswith("running_var"):
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return model
