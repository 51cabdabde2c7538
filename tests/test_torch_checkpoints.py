# coding: utf-8
"""Checkpoint averaging and sharded checkpoints on the CPU.

- ``joeys2t_torch.tools.average_checkpoints`` against JAX's
  ``average_checkpoints`` on the same three checkpoints (converted with
  ``torch_state_dict_to_flax``): the same tensors bit for bit (float64 sums
  cast back), no optimizer, scheduler or iterator state; and its command
  line over a model directory's newest checkpoints.
- ``checkpoints.save_sharded``/``load_sharded`` on four gloo ranks (model
  2 x data 2; subprocesses of this file): the shards of
  ``tp.shard_model`` written with ``torch.distributed.checkpoint`` restore
  bit-equal into the same layout, into the whole model on every rank and in
  a process without a group, and into ``model_parallel: 4``, each equal to
  ``tp.gather_state``'s whole tensors.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from joeys2t_torch.checkpoints import load_sharded, save_checkpoint, save_sharded
from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.models import build_model
from joeys2t_torch.parallel import distributed, tp
from joeys2t_torch.tools import average_checkpoints as averaging
from joeys2t_torch.vocabulary import Vocabulary
from test_torch_ddp import launch

SIDE = {"type": "transformer", "num_layers": 1, "num_heads": 4, "hidden_size": 16,
        "ff_size": 32, "dropout": 0.0, "layer_norm": "pre",
        "embeddings": {"embedding_dim": 16, "scale": True}}
CFG = {"encoder": dict(SIDE, num_experts=4), "decoder": dict(SIDE)}
VOCAB = Vocabulary([f"t{i}" for i in range(20)], SpecialSymbols())


def model(seed: int):
    return build_model(CFG, src_vocab=VOCAB, trg_vocab=VOCAB, device="cpu",
                       generator=torch.Generator().manual_seed(seed))[0]


def test_average_checkpoints_matches_jax(tmp_path, capsys):
    from joeys2t_torch.convert import flax_params_to_state_dict
    from joeys2t_tpu.checkpoints import average_checkpoints as jax_average
    from joeys2t_tpu.checkpoints import save_checkpoint as jax_save
    from joeys2t_tpu.convert import torch_state_dict_to_flax

    paths, jax_paths = [], []
    for step in (2, 4, 6):
        state = model(step).state_dict()
        paths.append(tmp_path / f"{step}.ckpt")
        save_checkpoint(paths[-1], {"model_state": state, "optimizer_state": {"x": 1},
                                    "scheduler_state": {"step": step},
                                    "train_iter_state": None, "stats_state": {"steps": step}})
        jax_paths.append(tmp_path / f"jax{step}.ckpt")
        jax_save(jax_paths[-1], {"model_state": torch_state_dict_to_flax(
            {k: v.numpy() for k, v in state.items()})})
    avg = averaging.average_checkpoints(paths)
    want = flax_params_to_state_dict(jax_average(jax_paths)["model_state"])
    for name, value in want.items():
        assert torch.equal(avg["model_state"][name], value), name
    assert all(v.dtype == torch.float32 for v in avg["model_state"].values())
    assert avg["optimizer_state"] is avg["scheduler_state"] is avg["train_iter_state"] is None
    assert avg["stats_state"] == {"steps": 2}
    averaging.main(["--model-dir", str(tmp_path), "--num", "2", "--output",
                    str(tmp_path / "avg2.ckpt")])
    assert "4.ckpt" in capsys.readouterr().out
    two = torch.load(tmp_path / "avg2.ckpt", weights_only=True)["model_state"]
    both = averaging.average_checkpoints(paths[1:])["model_state"]
    assert all(torch.equal(two[k], both[k]) for k in both)


def test_sharded_checkpoint_restores_in_any_layout(tmp_path):
    launch([__file__, tmp_path], tmp_path, world=4)
    whole = model(0).state_dict()
    for r in range(4):
        got = torch.load(tmp_path / f"sharded{r}.pt", weights_only=False)
        assert got["same_layout"] and got["whole"] and got["model4"], r
        assert got["split"] > 0
    # a process without a group reads the whole model
    fresh = model(9)
    load_sharded(tmp_path / "ckpt", fresh)
    for name, value in torch.load(tmp_path / "gathered.pt", weights_only=False).items():
        assert torch.equal(fresh.state_dict()[name], value), name
    assert any(not torch.equal(whole[k], v) for k, v in fresh.state_dict().items())


def worker(out: Path) -> None:
    """Save model 2 x data 2 shards of one trained-looking model, restore
    them into the same layout, the whole model and model_parallel 4."""
    layout = distributed.set_layout(model_parallel=2)
    ctx = tp.TPContext(layout.inner_group, layout.inner_rank, layout.inner)
    src = model(0)
    with torch.no_grad():
        for p in src.parameters():
            p.mul_(1.5)  # not what any fresh model holds
    net = tp.shard_model(src, ctx)
    save_sharded(out / "ckpt", net, ctx)
    gathered = tp.gather_state(net.state_dict(), ctx)
    if distributed.rank() == 0:
        torch.save(gathered, out / "gathered.pt")
    again = tp.shard_model(model(1), ctx)
    load_sharded(out / "ckpt", again, ctx)
    same = all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                 again.state_dict().values()))
    whole = model(2)
    load_sharded(out / "ckpt", whole)
    whole_ok = all(torch.equal(whole.state_dict()[k], v) for k, v in gathered.items())
    ctx4 = tp.TPContext(dist.new_group(list(range(4))), distributed.rank(), 4)
    four = tp.shard_model(model(3), ctx4)
    load_sharded(out / "ckpt", four, ctx4)
    four_whole = tp.gather_state(four.state_dict(), ctx4)
    four_ok = all(torch.equal(four_whole[k], v) for k, v in gathered.items())
    split = sum(1 for n in net.state_dict() if tp.split_dim(n) is not None)
    torch.save(dict(same_layout=same, whole=whole_ok, model4=four_ok, split=split),
               out / f"sharded{distributed.rank()}.pt")


if __name__ == "__main__":
    torch.set_num_threads(1)
    with distributed.process_group(use_cuda=False):
        worker(Path(sys.argv[1]))
