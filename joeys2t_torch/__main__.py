# coding: utf-8
"""
Command line: ``python -m joeys2t_torch {train,test,translate} config.yaml``
(counterpart of joeys2t_tpu/__main__.py:22), with the same flags.

The config's ``use_cuda`` (default True) runs on the card and fails without
one; ``use_cuda: False`` runs on the CPU. ``-d/--use-ddp`` runs ``train``
(or ``test``) data-parallel, one process per card: under torchrun (its
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``LOCAL_RANK`` set) this process joins that group, NCCL on the card and gloo
with ``use_cuda: False``; without torchrun it spawns one process per visible
card, as the reference's ``mp.spawn`` did (joeynmt/__main__.py:72-86). The
CPU has no cards to count, so ``-d`` with ``use_cuda: False`` needs torchrun.
The ranks form data-parallel groups, or with ``training: model_parallel``
or ``pipeline_parallel`` a (data, model) or (data, pipe) layout, whose
inner size must divide the ranks.
``-a/--save-attention`` plots the attention of every hypothesis of ``test``
(greedy decoding, ``beam_size: 1``, for a transformer decoder) to
``<output_path>.{dev,test}.att.<i>.png``.
"""
import argparse
import os
import shutil
import socket
from pathlib import Path
from typing import List, Optional

from joeys2t_torch import __version__
from joeys2t_torch.config import ConfigurationError, load_config
from joeys2t_torch.helpers import make_model_dir
from joeys2t_torch.ops import cuda_build
from joeys2t_torch.parallel import distributed
from joeys2t_torch.prediction import test, translate
from joeys2t_torch.training import train
from joeys2t_torch.utils.logging import add_file_handler, get_logger


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser("joeys2t_torch")
    ap.add_argument("mode", choices=["train", "test", "translate"],
                    help="train a model or test or translate")
    ap.add_argument("config_path", type=str, help="path to YAML config file")
    ap.add_argument("-o", "--output-path", type=str,
                    help="path for saving translation output")
    ap.add_argument("-a", "--save-attention", action="store_true",
                    help="save attention visualizations")
    ap.add_argument("-s", "--save-scores", action="store_true", help="save scores")
    ap.add_argument("-t", "--skip-test", action="store_true",
                    help="skip test after training")
    ap.add_argument("-d", "--use-ddp", action="store_true",
                    help="data-parallel: one process per card (spawned, or torchrun's)")
    ap.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    args = ap.parse_args(argv)

    cfg = load_config(Path(args.config_path))
    if not args.use_ddp:
        run(args, cfg)
        return
    if args.mode == "translate":
        raise ConfigurationError("translate reads its input from stdin and runs in one "
                                 "process; drop -d/--use-ddp")
    use_cuda = bool(cfg.get("use_cuda", cfg["training"].get("use_cuda", True)))
    if distributed.env_has_group() or distributed.in_group():
        ranked_run(args, cfg, use_cuda)
        return
    if not use_cuda:
        raise ConfigurationError("-d/--use-ddp with `use_cuda: False` needs torchrun's "
                                 "environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    spawn(args, cfg)


def run(args: argparse.Namespace, cfg: dict) -> None:
    """One process's run of ``args.mode``; in a data-parallel run rank 0
    makes the model directory and the others wait for it."""
    logger = get_logger()
    handler = None
    try:
        if args.mode == "train":
            model_dir = Path(cfg["model_dir"])
            if distributed.is_main():
                make_model_dir_and_copy_config(cfg, Path(args.config_path))
            distributed.barrier()
            handler = add_file_handler(logger, model_dir / "train.log")
            train(cfg=cfg, skip_test=args.skip_test)
        elif args.mode == "test":
            model_dir = Path(cfg["model_dir"])
            if model_dir.is_dir():
                handler = add_file_handler(logger, model_dir / "test.log")
            test(cfg=cfg, output_path=args.output_path,
                 save_attention=args.save_attention, save_scores=args.save_scores)
        else:
            translate(cfg=cfg, output_path=args.output_path)
    finally:
        if handler is not None:
            logger.removeHandler(handler)
            handler.close()


def ranked_run(args: argparse.Namespace, cfg: dict, use_cuda: bool) -> None:
    """``run`` as a rank of the data-parallel group: rank 0 builds the
    kernels while the others wait (one ``nvcc`` a source, not one a rank)."""
    with distributed.process_group(use_cuda):
        if use_cuda:
            if distributed.is_main():
                cuda_build.build_all()
            distributed.barrier()
        run(args, cfg)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(local: int, world: int, port: int, args: argparse.Namespace,
             cfg: dict) -> None:
    """One spawned rank: torchrun's environment for card ``local``, then the
    run inside its process group."""
    os.environ.update(RANK=str(local), LOCAL_RANK=str(local), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    ranked_run(args, cfg, use_cuda=True)


def spawn(args: argparse.Namespace, cfg: dict) -> None:
    """One process per visible card (torch.multiprocessing's spawn start
    method); returns when all have ended and raises if one failed."""
    import importlib

    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for -d/--use-ddp")
    world = torch.cuda.device_count()
    # under ``python -m`` this module runs as __main__, which a spawned child
    # does not import: hand it the function under the module's own name
    target = importlib.import_module("joeys2t_torch.__main__")._spawned
    mp.spawn(target, args=(world, _free_port(), args, cfg), nprocs=world, join=True)


def make_model_dir_and_copy_config(cfg: dict, config_path: Path) -> Path:
    """Create the model directory and copy the config into it."""
    model_dir = Path(cfg["model_dir"])
    make_model_dir(model_dir, overwrite=cfg["training"].get("overwrite", False))
    shutil.copy2(config_path, (model_dir / "config.yaml").as_posix())
    return model_dir


if __name__ == "__main__":
    main()
