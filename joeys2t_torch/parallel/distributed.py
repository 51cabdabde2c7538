# coding: utf-8
"""
Data-parallel process groups (counterpart of the ``data`` axis of
joeys2t_tpu/parallel/mesh.py :110-136 and of joeys2t_tpu/__main__.py :45-53,
which starts ``jax.distributed`` from the environment).

One process per card. A process joins a group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
or uses one its caller has already initialised. On the card the group runs
NCCL; with ``use_cuda: False`` it runs gloo. Host-side collectives (counts,
flags, decoded hypotheses) go through gloo in either case: under NCCL a
second, gloo group over the same ranks carries them, so they never wait for
the card.

Outside a process group every helper acts as a world of one: ``rank`` 0,
``world_size`` 1, ``barrier`` a no-op, the gathers and reductions return
this process's own values.

Tensor and pipeline parallelism (:func:`set_layout`; JAX's ``get_mesh``
:110-135) split the world into (data, model) or (data, pipe): an inner
group of ``model_parallel`` (or ``pipeline_parallel``) consecutive ranks,
as JAX's ``reshape(dp, model_parallel)`` lays the devices out, and one data
group per inner index. The ranks of an inner group read the same batches,
so the training set is sharded by :func:`data_rank` over
:func:`data_world`, and host counts are summed over one rank an inner
group (:func:`data_rows`). Without a layout the inner group is each rank
alone.
"""
import contextlib
import datetime
import os
from typing import Any, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

# a rank that raises must not leave the others waiting forever
TIMEOUT = datetime.timedelta(minutes=10)
ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# the gloo group of host collectives under an NCCL world, with the world it
# was made for
_host_group = (None, None)


class Layout:
    """The (data, inner) split of the world: ``kind`` "model" (tensor
    parallel) or "pipe" (pipeline parallel), ``inner`` ranks an inner group,
    this rank's ``data_group``, ``inner_group`` and the global ranks of its
    inner group (``inner_ranks``)."""

    def __init__(self, kind: str, inner: int, data_group, inner_group,
                 inner_ranks: List[int], world):
        self.kind, self.inner = kind, inner
        self.data_group, self.inner_group = data_group, inner_group
        self.inner_ranks = inner_ranks
        self.world = world  # the WORLD group it was made for

    @property
    def inner_rank(self) -> int:
        return rank() % self.inner

    @property
    def data_world(self) -> int:
        return world_size() // self.inner


_layout: Optional[Layout] = None


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def layout() -> Optional[Layout]:
    """The tensor- or pipeline-parallel layout of this world, if one is set."""
    if _layout is not None and in_group() and _layout.world is dist.group.WORLD:
        return _layout
    return None


def data_world() -> int:
    """The data-parallel ranks: the world over the inner group's size."""
    lay = layout()
    return world_size() if lay is None else lay.data_world


def data_rank() -> int:
    lay = layout()
    return rank() if lay is None else rank() // lay.inner


def data_rows(rows: List[Any]) -> List[Any]:
    """Of one entry a rank (in rank order), one an inner group: the ranks
    of an inner group hold the same batch, so each counts once."""
    lay = layout()
    return rows if lay is None else rows[::lay.inner]


def set_layout(model_parallel: int = 1, pipeline_parallel: int = 1) -> Optional[Layout]:
    """Split the world into (data, model) or (data, pipe) groups (every rank
    calls it, with the same arguments) and return the layout; None when
    both are 1. Raises ``ConfigurationError`` by name for a world the inner
    size does not divide, for a process without a group, and for both
    kinds at once (JAX's ``training.py:249-252`` and ``config.py:287-289``)."""
    global _layout
    from joeys2t_torch.config import ConfigurationError

    if model_parallel > 1 and pipeline_parallel > 1:
        raise ConfigurationError(
            "`pipeline_parallel` and `model_parallel` are mutually exclusive.")
    inner = max(model_parallel, pipeline_parallel)
    kind = "model" if model_parallel > 1 else "pipe"
    _layout = None
    if inner == 1:
        return None
    name = "model_parallel" if kind == "model" else "pipeline_parallel"
    if world_size() % inner:
        raise ConfigurationError(
            f"{name}={inner} does not divide the {world_size()} ranks of this run "
            f"(model_parallel * pipeline_parallel must divide the world; run "
            f"`train -d` with a multiple of {inner} processes)")
    world = world_size()
    data_group = inner_group = None
    inner_ranks: List[int] = []
    # every rank makes every group, in one order (new_group's contract)
    for first in range(0, world, inner):
        ranks = list(range(first, first + inner))
        group = dist.new_group(ranks, timeout=TIMEOUT)
        if rank() in ranks:
            inner_group, inner_ranks = group, ranks
    for offset in range(inner):
        ranks = list(range(offset, world, inner))
        group = dist.new_group(ranks, timeout=TIMEOUT)
        if rank() in ranks:
            data_group = group
    _layout = Layout(kind, inner, data_group, inner_group, inner_ranks, dist.group.WORLD)
    return _layout


def env_has_group() -> bool:
    """Whether torchrun's variables describe a group to join."""
    return all(k in os.environ for k in ENV_KEYS)


def _host() -> Optional[Any]:
    """The group of host collectives: the world itself under gloo, a gloo
    group over the same ranks under NCCL (made once, by every rank at the
    same call, as ``new_group`` requires)."""
    global _host_group
    if dist.get_backend() == "gloo":
        return None
    if _host_group[1] is not dist.group.WORLD:
        _host_group = (dist.new_group(backend="gloo", timeout=TIMEOUT), dist.group.WORLD)
    return _host_group[0]


def barrier() -> None:
    if in_group():
        dist.barrier(group=_host())


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order (picklable host objects)."""
    if not in_group():
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj, group=_host())
    return out


def all_gather_counts(values: Sequence[int]) -> List[List[int]]:
    """Every rank's integer vector ``values`` (all of one length), in rank
    order: one small host collective."""
    if not in_group():
        return [list(values)]
    local = torch.tensor(list(values), dtype=torch.int64)
    out = [torch.empty_like(local) for _ in range(world_size())]
    dist.all_gather(out, local, group=_host())
    return [t.tolist() for t in out]


def all_reduce_counts(values: Sequence[float]) -> List[float]:
    """The sum over the data-parallel ranks of the host numbers ``values``
    (one rank an inner group, which all hold the same), in float64."""
    if not in_group():
        return [float(v) for v in values]
    if layout() is not None:
        rows = data_rows(all_gather_objects([float(v) for v in values]))
        return [float(sum(r[i] for r in rows)) for i in range(len(values))]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(t, group=_host())
    return t.tolist()


def _join(use_cuda: bool) -> None:
    """Join the group that torchrun's environment describes, on the card
    ``LOCAL_RANK`` (NCCL) or on the CPU (gloo)."""
    if use_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for a data-parallel run; set "
                               "`use_cuda: False` to run it on the CPU over gloo")
        # before anything is allocated, so this rank's tensors land on its card
        torch.cuda.set_device(local_rank())
    dist.init_process_group("nccl" if use_cuda else "gloo", init_method="env://",
                            timeout=TIMEOUT)


def leave() -> None:
    """Destroy the group and forget the host group and the layout."""
    global _host_group, _layout
    _host_group = (None, None)
    _layout = None
    if in_group():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(use_cuda: bool) -> Iterator[None]:
    """Within the block this process is a rank of a data-parallel group:
    the one its caller initialised, else the one torchrun's environment
    describes, which is joined here and destroyed on every way out of the
    block, exceptions included. Without either, the block runs as a world
    of one."""
    if in_group() or not env_has_group():
        yield
        return
    _join(use_cuda)
    try:
        yield
    finally:
        leave()
