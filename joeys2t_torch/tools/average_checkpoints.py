# coding: utf-8
"""
Uniform parameter averaging over the port's checkpoints (counterpart of
joeys2t_tpu/checkpoints.py ``average_checkpoints`` :121-147 and
scripts/average_checkpoints.py).

    python -m joeys2t_torch.tools.average_checkpoints --inputs m/10.ckpt m/12.ckpt \\
        --output m/avg2.ckpt
    python -m joeys2t_torch.tools.average_checkpoints --model-dir m --num 5 \\
        --output m/avg5.ckpt

Every tensor of ``model_state`` is summed in float64 and cast back to its
own dtype; the averaged checkpoint carries no optimizer, scheduler or
iterator state (a fresh start), and the first checkpoint's statistics.
"""
import argparse
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from joeys2t_torch.checkpoints import load_checkpoint, save_checkpoint


def average_checkpoints(paths: List[Path]) -> Dict[str, Any]:
    """The first checkpoint with its ``model_state`` replaced by the mean of
    all of theirs."""
    if not paths:
        raise ValueError("no checkpoints to average")
    base, total = None, None
    for path in paths:
        ckpt = load_checkpoint(path)
        state = ckpt["model_state"]
        if base is None:
            base, total = ckpt, {k: v.double() for k, v in state.items()}
        else:
            if state.keys() != total.keys():
                raise ValueError(f"{path} holds other tensors than {paths[0]}")
            for k, v in state.items():
                total[k] += v.double()
    n = len(paths)
    base["model_state"] = {k: (total[k] / n).to(v.dtype)
                           for k, v in base["model_state"].items()}
    base.update(optimizer_state=None, scheduler_state=None, train_iter_state=None)
    return base


def newest(model_dir: Path, num: int) -> List[Path]:
    """The ``num`` highest-numbered ``<step>.ckpt`` files of ``model_dir``."""
    ckpts = [p for p in Path(model_dir).glob("*.ckpt")
             if not p.is_symlink() and p.stem.isdigit()]
    return sorted(ckpts, key=lambda p: int(p.stem))[-num:]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser("joeys2t_torch.tools.average_checkpoints")
    ap.add_argument("--inputs", nargs="*", default=None,
                    help="explicit checkpoint paths to average")
    ap.add_argument("--model-dir", type=str, default=None,
                    help="pick the newest --num checkpoints from this dir")
    ap.add_argument("--num", type=int, default=5)
    ap.add_argument("--output", required=True, type=str)
    args = ap.parse_args(argv)
    if args.inputs:
        paths = [Path(p) for p in args.inputs]
    elif args.model_dir:
        paths = newest(Path(args.model_dir), args.num)
    else:
        ap.error("provide --inputs or --model-dir")
    if not paths:
        ap.error("no checkpoints found")
    print(f"Averaging {len(paths)} checkpoints:")
    for p in paths:
        print(f"  {p}")
    save_checkpoint(Path(args.output), average_checkpoints(paths))
    print(f"Saved to {args.output}")


if __name__ == "__main__":
    main()
