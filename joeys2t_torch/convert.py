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
  */pointwise_conv{1,2}/kernel        -> *.pointwise_conv{1,2}.weight (out, in, 1)
  */depthwise_conv/kernel (k, 1, C)   -> *.depthwise_conv.weight (C, 1, k)
  */scale (LayerNorm)                 -> *.weight
  */batch_norm_{scale,bias,mean,var}  -> *.batch_norm.{weight,bias,running_mean,
                                         running_var} (the conformer's frozen BN)
  */ls_{ff1,att,conv,ff2}             -> *.ls_{ff1,att,conv,ff2} (LayerScale)

``jax_checkpoint_to_port`` turns a checkpoint that ``python -m joeys2t_tpu
train`` wrote (a pickle, joeys2t_tpu/checkpoints.py:29) into a port
checkpoint that ``python -m joeys2t_torch test`` reads.
"""
import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree: Dict, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


_BATCH_NORM = {"batch_norm_scale": "weight", "batch_norm_bias": "bias",
               "batch_norm_mean": "running_mean", "batch_norm_var": "running_var"}


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
        if leaf == "kernel" and names[-1].startswith("pointwise_conv"):
            value = value.T[:, :, None]  # Dense (in, out) -> Conv1d (out, in, 1)
            leaf = "weight"
        elif leaf == "kernel":
            value = value.T if value.ndim == 2 else np.transpose(value, (2, 1, 0))
            leaf = "weight"
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        elif leaf in _BATCH_NORM:
            names.append("batch_norm")
            leaf = _BATCH_NORM[leaf]
        elif leaf != "bias" and not leaf.startswith("ls_"):
            raise ValueError(f"no port parameter for {'/'.join(path)}")
        out[".".join(names + [leaf])] = torch.tensor(np.ascontiguousarray(value))
    return out


class _Unread:
    """Stands in for every object of a JAX checkpoint that is neither a
    numpy array nor a builtin (the optax optimizer states): built from any
    arguments and state, and never read."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


_NUMPY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (f"numpy.{core}.{module}", name) for core in ("core", "_core")
    for module, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                         ("numeric", "_frombuffer"))}
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
             "bool", "str", "bytes", "bytearray", "slice", "range"}


class _ArraysOnlyUnpickler(pickle.Unpickler):
    """Builds numpy arrays, numpy dtypes and scalars, and builtin containers
    and values; every other global becomes :class:`_Unread`, so no other
    module (optax, flax, jax) is imported or run."""

    def find_class(self, module: str, name: str):
        if (module, name) in _NUMPY_GLOBALS or module.startswith("numpy.dtypes"):
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if module == "collections" and name == "OrderedDict":
            return super().find_class(module, name)
        return _Unread


def _plain(value: Any) -> Any:
    """``value`` with numpy scalars made Python numbers, or ``_Unread`` when
    it holds anything but builtin values."""
    if isinstance(value, dict):
        items = {k: _plain(v) for k, v in value.items()}
        return _Unread() if any(isinstance(v, _Unread) for v in items.values()) else items
    if isinstance(value, (list, tuple)):
        items = [_plain(v) for v in value]
        return _Unread() if any(isinstance(v, _Unread) for v in items) else type(value)(
            items)
    if isinstance(value, np.generic):
        return value.item()
    if value is None or type(value) in (bool, int, float, str):
        return value
    return _Unread()


def jax_checkpoint_to_port(src: Path, dst: Path) -> Dict:
    """Read a JAX checkpoint with :class:`_ArraysOnlyUnpickler` and write the
    port checkpoint: ``model_state`` through
    :func:`flax_params_to_state_dict`; the scheduler, sampler and statistics
    states where they are plain values; no optimizer state (the optax
    states stay unread), so resuming from it starts a fresh optimizer.
    Returns the written dict."""
    with Path(src).open("rb") as f:
        ckpt = _ArraysOnlyUnpickler(f).load()
    state = {"model_state": flax_params_to_state_dict(ckpt["model_state"]),
             "optimizer_state": None}
    for key in ("scheduler_state", "train_iter_state", "stats_state"):
        value = _plain(ckpt.get(key))
        state[key] = None if isinstance(value, _Unread) else value
    torch.save(state, Path(dst))
    return state
