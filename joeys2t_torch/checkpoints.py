# coding: utf-8
"""
Checkpoints (counterpart of joeys2t_tpu/checkpoints.py: ``save_checkpoint``
:29, ``load_checkpoint`` :42, ``delete_ckpt`` :50, ``CheckpointManager`` :59,
``partial_load`` :150).

A checkpoint is ``torch.save`` of a dict with the JAX package's keys
(joeys2t_tpu/training.py:582-592): ``model_state`` (the model's
``state_dict``), ``optimizer_state`` (the torch optimizer's
``state_dict``), ``scheduler_state``, ``train_iter_state`` (the sampler's
bit-generator state) and ``stats_state``. Every value is a tensor or a
plain Python type, so ``torch.load(weights_only=True)`` reads it.

In a data-parallel run every rank keeps the same record of the best
checkpoints, only rank 0 writes, links and deletes files, and the other
ranks wait at each save until it has.

``save_sharded``/``load_sharded`` (JAX's orbax pair, :198-220) write and
read a model's state with ``torch.distributed.checkpoint``: under tensor
parallelism each rank of the model group writes its own shards of the
model that ``parallel/tp.py``'s ``shard_model`` builds, described to the
checkpoint as ``DTensor``s of their whole shape (``Shard`` along the split
dim, ``Replicate`` otherwise; plain per-rank tensors under one name would
be taken for copies of one tensor, and all shards but one lost), and a
restore reads into any layout: the same shards, another
``model_parallel``, or the whole model in one process. As in JAX, no
training path calls them.
"""
import heapq
import math
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Set, Tuple

import torch

from joeys2t_torch.helpers import symlink_update
from joeys2t_torch.parallel import distributed
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)


def save_checkpoint(path: Path, state: Dict[str, Any]) -> None:
    """Write ``state`` to a temporary file and rename it into place, so a
    reader never sees a half-written checkpoint."""
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    torch.save(state, tmp)
    tmp.replace(path)


def load_checkpoint(path: Path, map_location="cpu") -> Dict[str, Any]:
    """Read a checkpoint of tensors and plain Python values."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Checkpoint {path} not found.")
    return torch.load(path, map_location=map_location, weights_only=True)


def _layer_numbers(keys: Iterable[str], prefix: str) -> Set[int]:
    pattern = re.compile(rf"{re.escape(prefix)}\.layers\.(\d+)\.")
    return {int(m.group(1)) for m in map(pattern.match, keys) if m}


def partial_load(state: Dict[str, torch.Tensor], ckpt_state: Dict[str, torch.Tensor],
                 prefix: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """The model state ``state`` with its ``prefix`` part (``encoder`` or
    ``decoder``) taken from another checkpoint's ``ckpt_state``
    (joeynmt/training.py:294-309 ``load_encoder``/``load_decoder``), with the
    JAX package's semantics, name by name: a tensor in both loads from the
    checkpoint, one only in the model keeps its init (missing), one only in
    the checkpoint is ignored (unexpected), and a shape mismatch raises. So a
    16-layer ASR encoder loads into a 12-layer ST encoder: layers 0-11 load,
    12-15 are ignored. Returns the merged state and the counts (tensors
    loaded, missing, unexpected; layers loaded and ignored), which go to the
    log."""
    head = prefix + "."
    source = {k: v for k, v in ckpt_state.items() if k.startswith(head)}
    if not source:
        logger.warning("No `%s` sub-tree found in the checkpoint.", prefix)
        return state, {}
    merged = dict(state)
    stats = {"loaded": 0, "missing": 0}
    for key, value in state.items():
        if not key.startswith(head):
            continue
        if key not in source:
            stats["missing"] += 1
            continue
        if tuple(source[key].shape) != tuple(value.shape):
            raise ValueError(f"partial_load: shape mismatch at {key}: checkpoint "
                             f"{tuple(source[key].shape)} vs model {tuple(value.shape)}")
        merged[key] = source[key]
        stats["loaded"] += 1
    unexpected = [k for k in source if k not in state]
    own_layers = _layer_numbers(state, prefix)
    stats.update(unexpected=len(unexpected),
                 layers_loaded=len(_layer_numbers(source, prefix) & own_layers),
                 layers_ignored=len(_layer_numbers(unexpected, prefix) - own_layers))
    logger.info("partial_load(%s): %d tensors loaded, %d kept at init (missing in ckpt), "
                "%d ckpt tensors ignored (not in model); %d layers loaded, %d layers "
                "ignored", prefix, stats["loaded"], stats["missing"], stats["unexpected"],
                stats["layers_loaded"], stats["layers_ignored"])
    return merged, stats


def delete_ckpt(path: Path) -> None:
    try:
        logger.info("delete %s", path.as_posix())
        path.unlink()
    except FileNotFoundError as e:
        logger.warning("Wanted to delete old checkpoint %s but file does not exist. (%s)",
                       path, e)


class CheckpointManager:
    """The best ``keep_best_ckpts`` checkpoints on disk, and the
    ``latest.ckpt`` / ``best.ckpt`` symlinks (joeynmt/training.py:149-218)."""

    def __init__(self, model_dir: Path, keep_best_ckpts: int = 5,
                 minimize_metric: bool = True):
        self.model_dir = Path(model_dir)
        self.keep_best_ckpts = keep_best_ckpts
        self.minimize_metric = minimize_metric
        # min-heap of (key, path) with key = -score for minimized metrics, so
        # ckpt_queue[0] is the worst checkpoint kept
        self.ckpt_queue: List[Tuple[float, Path]] = []

    def save(self, steps: int, state: Dict[str, Any], new_best: bool,
             score: float) -> Path:
        """Write ``state`` as ``<steps>.ckpt`` (rank 0), update the links and
        the record of the best checkpoints, delete the ones that fell out;
        every rank of a data-parallel run calls it and returns once rank 0
        is done."""
        model_path = self.model_dir / f"{steps}.ckpt"
        main = distributed.is_main()
        best_path = self.model_dir / "best.ckpt"
        prev_path = None
        if main:
            save_checkpoint(model_path, state)
            logger.info("Checkpoint saved in %s.", model_path)
            symlink_target = Path(f"{steps}.ckpt")
            prev_path = symlink_update(symlink_target, self.model_dir / "latest.ckpt")
            if new_best:
                prev_path = symlink_update(symlink_target, best_path)

        if not (isinstance(score, float) and math.isnan(score)) and self.keep_best_ckpts > 0:
            key = -score if self.minimize_metric else score
            to_delete = None
            if len(self.ckpt_queue) < self.keep_best_ckpts:
                heapq.heappush(self.ckpt_queue, (key, model_path))
            else:
                to_delete = heapq.heappushpop(self.ckpt_queue, (key, model_path))
            # a newcomer that is itself the worst stays as latest.ckpt's
            # target until latest moves on; the best checkpoint is never deleted
            if (main and to_delete is not None and to_delete[1] != model_path
                    and to_delete[1].stem != best_path.resolve().stem):
                delete_ckpt(to_delete[1])

        # the previous symlink target goes once it is neither kept nor best;
        # outside the scored branch so the final unscored save cleans up too
        if self.keep_best_ckpts > 0 and prev_path is not None:
            prev = self.model_dir / prev_path.name
            if (prev.stem not in [c[1].stem for c in self.ckpt_queue]
                    and prev.stem != best_path.resolve().stem
                    and prev.stem != str(steps) and prev.exists()):
                delete_ckpt(prev)
        distributed.barrier()
        return model_path


def _described(state: Dict[str, torch.Tensor], tp) -> Dict[str, torch.Tensor]:
    """``state`` as the checkpoint sees it: under tensor parallelism
    (``tp``, a ``parallel.tp.TPContext``) every tensor a ``DTensor`` over
    the model group, a shard placed at its offset in the whole tensor."""
    if tp is None:
        return dict(state)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from joeys2t_torch.parallel.tp import split_dim

    device_type = next(iter(state.values())).device.type
    mesh = DeviceMesh.from_group(tp.group, device_type=device_type)
    out = {}
    for name, value in state.items():
        dim = split_dim(name)
        shape = list(value.shape)
        if dim is not None:
            shape[dim] *= tp.world
        out[name] = DTensor.from_local(value, mesh, [Replicate() if dim is None else Shard(dim)],
                                       run_check=False, shape=torch.Size(shape),
                                       stride=torch.empty(shape, device="meta").stride())
    return out


def save_sharded(directory: Path, model: torch.nn.Module, tp=None) -> None:
    """Write ``model``'s state to ``directory`` with
    ``torch.distributed.checkpoint``; under tensor parallelism every rank
    of the world calls it with its shard of the model (``tp`` its
    ``TPContext``) and writes its own shards."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_described(model.state_dict(), tp), checkpoint_id=Path(directory).absolute())


def load_sharded(directory: Path, model: torch.nn.Module, tp=None) -> None:
    """Read a ``save_sharded`` checkpoint into ``model`` in place: a shard
    of any ``model_parallel`` (``tp`` its ``TPContext``), or with ``tp``
    None the whole model."""
    import torch.distributed.checkpoint as dcp

    state = model.state_dict()
    target = _described(state, tp)
    dcp.load(target, checkpoint_id=Path(directory).absolute())
    with torch.no_grad():
        for name, value in target.items():
            local = value.to_local() if hasattr(value, "to_local") else value
            if local is not state[name]:
                state[name].copy_(local)
