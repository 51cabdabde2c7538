# coding: utf-8
"""
Small helpers shared by the port's entry points (counterpart of
joeys2t_tpu/helpers.py: ``read_list_from_file`` :29, ``write_list_to_file``
:39, ``make_model_dir`` :48, ``set_seed`` :58, the text helpers :65-88,
``symlink_update`` :101, ``latest_checkpoint_update`` :112,
``resolve_ckpt_path`` :118, ``get_latest_checkpoint`` :131,
``expand_reverse_index`` :141, ``adjust_mask_size`` :171, ``save_hypothese``
:186), and the device an entry point runs on.
"""
import random
import re
import shutil
import unicodedata
from itertools import chain
from pathlib import Path
from typing import Any, List, Optional, Union

import numpy as np
import torch

from joeys2t_torch.parallel import distributed


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no device given and no CUDA device present this raises;
    the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")


def flatten(array: List[List[Any]]) -> List[Any]:
    """Flatten a nested 2D list."""
    return list(chain.from_iterable(array))


def read_list_from_file(input_path: Optional[Path]) -> List[str]:
    """One item per line."""
    if input_path is None:
        return []
    return [line.rstrip("\n")
            for line in Path(input_path).read_text(encoding="utf-8").splitlines()]


def write_list_to_file(output_path: Path, array: List[Any]) -> None:
    """One item per line; numpy rows are written as lists."""
    with Path(output_path).open("w", encoding="utf-8") as opened_file:
        for entry in array:
            if isinstance(entry, np.ndarray):
                entry = entry.tolist()
            opened_file.write(f"{entry}\n")


def make_model_dir(model_dir: Path, overwrite: bool = False) -> None:
    """Create a new directory for the model, replacing an old one only when
    ``overwrite`` is set."""
    model_dir = Path(model_dir).absolute()
    if model_dir.is_dir():
        if not overwrite:
            raise FileExistsError(
                f"Model directory {model_dir} exists and overwriting is disabled.")
        shutil.rmtree(model_dir)
    model_dir.mkdir(parents=True)


def set_seed(seed: int) -> None:
    """Seed Python's ``random``, numpy's global RNG (SpecAugment draws from
    it) and torch's default generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def unicode_normalize(s: str) -> str:
    """NFKC plus quote normalization."""
    s = unicodedata.normalize("NFKC", s)
    return s.replace("’", "'").replace("“", '"').replace("”", '"')


def remove_extra_spaces(s: str) -> str:
    """Drop zero-width spaces, collapse (ideographic) space runs and the space
    before ``? ! , . :``."""
    s = re.sub("​", "", s)
    s = re.sub("[ 　]+", " ", s)
    s = s.replace(" ?", "?").replace(" !", "!")
    s = s.replace(" ,", ",").replace(" .", ".").replace(" :", ":")
    return s.strip()


def remove_punctuation(text: str, space: str = " ") -> str:
    """Drop the tokens made of punctuation only (WER evaluation)."""
    return space.join(
        t for t in text.split(space)
        if not all(unicodedata.category(char)[0] == "P" for char in t)).strip()


def symlink_update(target: Path, link_name: Path) -> Optional[Path]:
    """Point ``link_name`` at ``target``; returns the previous target."""
    if link_name.is_symlink():
        current_last = link_name.resolve()
        link_name.unlink()
        link_name.symlink_to(target)
        return current_last
    link_name.symlink_to(target)
    return None


def latest_checkpoint_update(target: Path, link_name: str) -> Optional[Path]:
    """Update the ``link_name`` symlink beside ``target``."""
    return symlink_update(Path(target.name), target.parent / link_name)


def get_latest_checkpoint(ckpt_dir: Path) -> Optional[Path]:
    """The newest checkpoint in ``ckpt_dir``."""
    if (ckpt_dir / "latest.ckpt").is_file():
        return (ckpt_dir / "latest.ckpt").resolve()
    ckpts = list(ckpt_dir.glob("*.ckpt"))
    if not ckpts:
        return None
    return max(ckpts, key=lambda f: f.stat().st_mtime)


def resolve_ckpt_path(load_model: Optional[Path], model_dir: Path) -> Path:
    """Explicit path, else ``best.ckpt``, else the latest checkpoint."""
    if load_model is None:
        if (model_dir / "best.ckpt").is_file():
            load_model = model_dir / "best.ckpt"
        else:
            load_model = get_latest_checkpoint(model_dir)
    if load_model is None or not Path(load_model).is_file():
        raise FileNotFoundError(f"Checkpoint not found: {load_model}")
    return Path(load_model)


def expand_reverse_index(reverse_index: List[int], n_best: int = 1) -> List[int]:
    """The reverse permutation for ``n_best`` outputs per input."""
    if n_best == 1:
        return reverse_index
    return [ix * n_best + n for ix in reverse_index for n in range(n_best)]


def adjust_mask_size(mask: Optional[np.ndarray], batch_size: int,
                     hyp_len: int) -> Optional[np.ndarray]:
    """A (batch, len) mask cut or zero-padded to (batch_size, hyp_len)
    (joeys2t_tpu/helpers.py:171)."""
    if mask is None:
        return None
    if mask.shape[1] < hyp_len:
        pad = np.zeros((mask.shape[0], hyp_len - mask.shape[1]), dtype=mask.dtype)
        mask = np.concatenate([mask, pad], axis=1)
    elif mask.shape[1] > hyp_len:
        mask = mask[:, :hyp_len]
    if mask.shape != (batch_size, hyp_len):
        raise ValueError(f"mask of shape {mask.shape}, expected {(batch_size, hyp_len)}")
    return mask


def save_hypothese(output_path: Path, hypotheses: List[str], n_best: int = 1) -> None:
    """Hypotheses to a file, or one file per rank for n-best output; in a
    data-parallel run rank 0 writes them."""
    if not distributed.is_main():
        return
    output_path = Path(output_path)
    if n_best > 1:
        for n in range(n_best):
            write_list_to_file(
                output_path.parent / f"{output_path.stem}-{n}.{output_path.suffix}",
                [hypotheses[i] for i in range(n, len(hypotheses), n_best)])
    else:
        write_list_to_file(output_path, hypotheses)
