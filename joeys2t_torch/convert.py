# coding: utf-8
"""
Convert the JAX package's parameter tree into the port's ``state_dict``.

The port's parameter names follow the reference torch implementation, the
naming joeys2t_tpu/convert.py:9-21 documents, so
``joeys2t_tpu.convert.torch_state_dict_to_flax(model.state_dict())`` gives
back the JAX tree. Mapping (JAX tree path -> port name):

  {src,trg}_embed/lut/embedding       -> {src,trg}_embed.lut.weight
  */layer_N/*                         -> *.layers.N.*
  */feed_forward/dense{1,2}           -> *.feed_forward.pwff_layer.{0,3}
  */subsampler/conv_N                 -> *.subsampler.conv_layers.N
  */kernel (Dense (in, out))          -> *.weight (out, in)
  */kernel (Conv (k, in, out))        -> *.weight (out, in, k)
  */scale (LayerNorm)                 -> *.weight
"""
from typing import Dict

import numpy as np
import torch


def _flatten(tree: Dict, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_params_to_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of arrays) -> port ``state_dict``
    of float32 CPU tensors."""
    out = {}
    for path, value in _flatten(params):
        value = np.asarray(value, dtype=np.float32)
        names = []
        for part in path[:-1]:
            if part.startswith("layer_") and part[6:].isdigit():
                names += ["layers", part[6:]]
            elif part in ("dense1", "dense2"):
                names += ["pwff_layer", "0" if part == "dense1" else "3"]
            elif part.startswith("conv_") and part[5:].isdigit():
                names += ["conv_layers", part[5:]]
            else:
                names.append(part)
        leaf = path[-1]
        if leaf == "kernel":
            value = value.T if value.ndim == 2 else np.transpose(value, (2, 1, 0))
            leaf = "weight"
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"no port parameter for {'/'.join(path)}")
        out[".".join(names + [leaf])] = torch.tensor(np.ascontiguousarray(value))
    return out
