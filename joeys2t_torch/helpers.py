# coding: utf-8
"""Small helpers shared by the port's entry points."""
from typing import Optional, Union

import torch


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
