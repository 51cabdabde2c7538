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
    """The sum over ranks of the host numbers ``values``, in float64."""
    if not in_group():
        return [float(v) for v in values]
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
    """Destroy the group and forget the host group."""
    global _host_group
    _host_group = (None, None)
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
