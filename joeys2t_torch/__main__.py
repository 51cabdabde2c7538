# coding: utf-8
"""
Command line: ``python -m joeys2t_torch {train,test,translate} config.yaml``
(counterpart of joeys2t_tpu/__main__.py:22), with the same flags.

The config's ``use_cuda`` (default True) runs on the card and fails without
one; ``use_cuda: False`` runs on the CPU. ``-d/--use-ddp`` (multi-process
training) and ``-a/--save-attention`` are not ported yet and raise.
"""
import argparse
import shutil
from pathlib import Path
from typing import List, Optional

from joeys2t_torch import __version__
from joeys2t_torch.config import load_config
from joeys2t_torch.helpers import make_model_dir
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
                    help="save attention visualizations (not ported yet)")
    ap.add_argument("-s", "--save-scores", action="store_true", help="save scores")
    ap.add_argument("-t", "--skip-test", action="store_true",
                    help="skip test after training")
    ap.add_argument("-d", "--use-ddp", action="store_true",
                    help="multi-process training (not ported yet)")
    ap.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    args = ap.parse_args(argv)
    if args.use_ddp:
        raise NotImplementedError("multi-process training (-d/--use-ddp) is not "
                                  "ported yet")

    cfg = load_config(Path(args.config_path))
    logger = get_logger()
    handler = None
    try:
        if args.mode == "train":
            model_dir = make_model_dir_and_copy_config(cfg, Path(args.config_path))
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


def make_model_dir_and_copy_config(cfg: dict, config_path: Path) -> Path:
    """Create the model directory and copy the config into it."""
    model_dir = Path(cfg["model_dir"])
    make_model_dir(model_dir, overwrite=cfg["training"].get("overwrite", False))
    shutil.copy2(config_path, (model_dir / "config.yaml").as_posix())
    return model_dir


if __name__ == "__main__":
    main()
