# coding: utf-8
"""
Tensor parallelism over the model group (counterpart of
joeys2t_tpu/parallel/tp.py ``_spec_for`` :33-52 and ``shard_params_tp``
:64-75, and of the sequence-parallel constraint of
joeys2t_tpu/parallel/mesh.py :164-175).

The Megatron split, over the port's parameter names:
  - ``q_layer``/``k_layer``/``v_layer`` and the feed-forward's first layer
    (``pwff_layer.0``, JAX's ``dense1``): columns, weight and bias;
  - attention ``output_layer`` and the feed-forward's second layer
    (``pwff_layer.3``, ``dense2``): rows, the bias replicated;
  - the mixture-of-experts ``w1``, ``b1``, ``w2``, ``b2``: the expert dim;
  - everything else replicated: embeddings, norms, the conv subsampler, the
    Conformer's convolution module, the vocabulary ``output_layer``, the CTC
    head and the router.

A torch ``Linear`` keeps its weight (out, in), so a column split is dim 0
and a row split dim 1 (flax's kernel is (in, out)). Where JAX lets GSPMD
insert the collectives, the port's modules call the four autograd
collectives below at the places Megatron puts them: ``copy`` (identity
forward, all-reduce backward) before a column-parallel layer, ``reduce``
(all-reduce forward, identity backward) after a row-parallel one; with
sequence parallelism ``gather`` (all-gather along the sequence forward,
reduce-scatter backward) and ``reduce_scatter`` (the reverse) take their
places, and the residual stream between them is this rank's slice of the
sequence, on which LayerNorm, dropout and the residual add run.

``shard_state`` turns a full ``state_dict`` into a rank's shards,
``gather_state`` (a collective) gives the full one back; ``shard_model``
makes the sharded copy of a model that trains under tensor parallelism.
"""
import copy
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

_COLUMN = ("q_layer", "k_layer", "v_layer")
_EXPERTS = ("w1", "b1", "w2", "b2")


def split_dim(name: str) -> Optional[int]:
    """The dim along which the port's parameter ``name`` is split over the
    model group, or None when it is replicated (JAX's ``_spec_for``)."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    parent, leaf = parts[-2], parts[-1]
    if leaf in _EXPERTS and parent == "feed_forward":
        return 0
    if len(parts) >= 3 and parts[-3] == "pwff_layer":
        parent = {"0": "dense1", "3": "dense2"}.get(parent, parent)
    if parent in _COLUMN + ("dense1",):
        return 0 if leaf in ("weight", "bias") else None
    in_attention = any("att" in p for p in parts[:-2])
    if leaf == "weight" and (parent == "dense2" or (parent == "output_layer"
                                                     and in_attention)):
        return 1
    return None


class TPContext:
    """The model group of this rank: its ``group``, ``rank`` and ``world``
    in it, and whether ``sequence_parallel`` splits the residual stream."""

    def __init__(self, group, rank: int, world: int, sequence_parallel: bool = False):
        self.group, self.rank, self.world = group, rank, world
        self.sequence_parallel = sequence_parallel

    # ------------------------------------------------ the region's borders
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Before a column-parallel layer: ``copy`` of the replicated input,
        or under sequence parallelism ``gather`` of this rank's slice."""
        return gather(x, self) if self.sequence_parallel else copy_to(x, self)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """After a row-parallel layer: ``reduce`` of the partial sums, or
        ``reduce_scatter`` to this rank's slice of the sequence."""
        return reduce_scatter(x, self) if self.sequence_parallel else reduce(x, self)

    def seq_shard(self):
        """The Dropout shard of a (B, S, ...) tensor of the residual stream:
        (dim 1, rank, world) under sequence parallelism, else None."""
        return (1, self.rank, self.world) if self.sequence_parallel else None

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's slice of ``x`` along ``dim`` (its backward pads with
        zeros)."""
        n = x.shape[dim] // self.world
        return x.narrow(dim, self.rank * n, n)


# --------------------------------------------------------------- collectives
def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` (gloo sums a bfloat16 tensor in float32)."""
    y = x.float() if _gloo(group) and x.dtype == torch.bfloat16 else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, dim: int, ctx: TPContext) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim``."""
    parts = [torch.empty_like(x) for _ in range(ctx.world)]
    dist.all_gather(parts, x.contiguous(), group=ctx.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, ctx: TPContext) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over the group (gloo has
    no reduce-scatter: an all-reduce, then the slice)."""
    if _gloo(ctx.group):
        return ctx.local(_all_reduce(x, ctx.group), dim).contiguous()
    chunks = list(x.movedim(dim, 0).contiguous().chunk(ctx.world))
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=ctx.group)
    return out.movedim(0, dim).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):  # pylint: disable=arguments-differ
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        return _all_reduce(grad, ctx.tp.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):  # pylint: disable=arguments-differ
        return _all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, partial_grad):  # pylint: disable=arguments-differ
        ctx.tp, ctx.partial_grad = tp, partial_grad
        return _all_gather(x, 1, tp)

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        if ctx.partial_grad:
            return _reduce_scatter(grad, 1, ctx.tp), None, None
        return ctx.tp.local(grad).contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):  # pylint: disable=arguments-differ
        ctx.tp = tp
        return _reduce_scatter(x, 1, tp)

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        return _all_gather(grad, 1, ctx.tp), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):  # pylint: disable=arguments-differ
        ctx.tp = tp
        return tp.local(x).contiguous()

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        return _all_gather(grad, 1, ctx.tp), None


def copy_to(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over the model group."""
    return _Copy.apply(x, tp)


def reduce(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """All-reduce forward over the model group, identity backward."""
    return _Reduce.apply(x, tp)


def gather(x: torch.Tensor, tp: TPContext, partial_grad: bool = True) -> torch.Tensor:
    """(B, S / tp, ...) slices -> (B, S, ...) on every rank; the backward
    reduce-scatters the gradient (it is partial on each rank inside the
    region), or with ``partial_grad`` False takes this rank's slice of it
    (the gradient of a replicated consumer, the same on every rank)."""
    return _Gather.apply(x, tp, partial_grad)


def reduce_scatter(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Partial sums (B, S, ...) -> this rank's slice (B, S / tp, ...) of
    their sum; the backward all-gathers."""
    return _ReduceScatter.apply(x, tp)


def scatter(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """A replicated (B, S, ...) -> this rank's slice; the backward
    all-gathers the slices' gradients."""
    return _Scatter.apply(x, tp)


def seq_enter(x: torch.Tensor, mask: torch.Tensor, tp: TPContext):
    """Into the sequence-parallel region: pad the sequence of ``x`` (B, S,
    H) to a multiple of the group (zeros) and ``mask`` (B, 1, S) with
    masked keys, and take this rank's slice of ``x``. Returns (slice,
    padded mask, S)."""
    s = x.shape[1]
    pad = -s % tp.world
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad), value=False)
    return scatter(x, tp), mask, s


def seq_exit(x: torch.Tensor, s: int, tp: TPContext) -> torch.Tensor:
    """Out of the region: the whole sequence, cut back to ``s``; its
    consumers are replicated, so the backward takes this rank's slice."""
    return gather(x, tp, partial_grad=False)[:, :s]


# ----------------------------------------------------------------- states
def shard_state(state: Dict[str, torch.Tensor], rank: int, world: int
                ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shards of a full ``state_dict`` (replicated tensors
    as they are)."""
    out = {}
    for name, value in state.items():
        dim = split_dim(name)
        if dim is None:
            out[name] = value
            continue
        if value.shape[dim] % world:
            raise ValueError(f"{name} {tuple(value.shape)} does not split {world} ways")
        n = value.shape[dim] // world
        out[name] = value.narrow(dim, rank * n, n).clone()
    return out


def gather_along(x: torch.Tensor, dim: int, tp: TPContext) -> torch.Tensor:
    """The whole tensor of the shards ``x`` along ``dim`` (a collective)."""
    return _all_gather(x.detach(), dim, tp)


def gather_state(state: Dict[str, torch.Tensor], tp: TPContext) -> Dict[str, torch.Tensor]:
    """The full tensors of a rank's shards (every rank of the model group
    calls it at once and gets them all)."""
    out = {}
    for name, value in state.items():
        dim = split_dim(name)
        out[name] = value if dim is None else gather_along(value, dim, tp)
    return out


def shard_model(model: nn.Module, tp: TPContext) -> nn.Module:
    """A copy of ``model`` whose parameters are this rank's shards and whose
    modules run on them (each module with a ``tp`` attribute gets ``tp``;
    attention computes num_heads / tp heads)."""
    from joeys2t_torch.config import ConfigurationError
    from joeys2t_torch.models.modules import MultiHeadedAttention

    for module in model.modules():
        if isinstance(module, MultiHeadedAttention) and module.num_heads % tp.world:
            raise ConfigurationError(
                f"model_parallel={tp.world} does not divide num_heads={module.num_heads}")
    net = copy.deepcopy(model)
    names = dict(net.named_parameters())
    for name, value in shard_state({n: p.detach() for n, p in names.items()}, tp.rank,
                                   tp.world).items():
        if split_dim(name) is not None:
            owner, leaf = net.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
            setattr(owner, leaf, nn.Parameter(value, requires_grad=names[name].requires_grad))
    for module in net.modules():
        if hasattr(module, "tp"):
            module.tp = tp
        if isinstance(module, MultiHeadedAttention):
            module.num_heads //= tp.world
            module.size //= tp.world
    return net
