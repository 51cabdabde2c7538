"""Model weights made from ``--seed`` on the device in one draw, handed to the
program and, after the window, made again for the reference."""
import math
from typing import Dict, Tuple

import torch

PAD = 1  # the benchmark's vocabularies: unk 0, pad 1, bos 2, eos 3


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 tensors by parameter name: one uniform draw in [-1, 1) over
    every parameter, scaled per tensor: matrices and convolutions by the
    Xavier-uniform bound of their fans, layer-norm scales 1 +- 0.1, biases
    and layer-norm shifts +- 0.02; the pad id's row (1) of the embedding
    tables and of the output layer zero, as a trained model keeps pad out of
    what it emits (search bans bos, and pad only in beam search). The order of
    the names fixes the draw."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.rand(sum(sizes), generator=_gen(seed, device), device=device) * 2.0 - 1.0
    out = {}
    for name, part in zip(names, torch.split(flat, sizes)):
        shape = shapes[name]
        x = part.view(shape)
        if name.endswith("norm.weight"):
            x = 1.0 + 0.1 * x
        elif len(shape) >= 2:
            receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
            fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
            x = x * math.sqrt(6.0 / (fan_in + fan_out))
        else:
            x = 0.02 * x
        if name.endswith("lut.weight") or name == "decoder.output_layer.weight":
            x[PAD] = 0.0
        out[name] = x
    return out


def param_shapes(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the module's parameters, every one of them."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameters differ: {sorted(set(params) ^ set(weights))[:4]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
