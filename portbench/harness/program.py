"""The system under test, as the benchmark builds it: joeys2t_torch's model from
the configuration's ``model`` section, its vocabulary of synthetic entries
at the published size, and its kernels built into the checkout."""
import time
from typing import Dict, Tuple

import torch

from harness.weights import load_into, make_weights, param_shapes


def build_kernels(device: str) -> float:
    """Compile every CUDA library of the port not yet built (the first run
    in a checkout); seconds taken."""
    t0 = time.perf_counter()
    if device == "cuda":
        from joeys2t_torch.ops import cuda_build

        cuda_build.build_all()
    return time.perf_counter() - t0


def vocabulary(size: int):
    """``size`` entries: the four specials (unk 0, pad 1, bos 2, eos 3), then
    ``w4`` ... as the subword pieces."""
    from joeys2t_torch.config import SpecialSymbols
    from joeys2t_torch.vocabulary import Vocabulary

    vocab = Vocabulary([f"w{i}" for i in range(4, size)], SpecialSymbols())
    if len(vocab) != size:
        raise ValueError(f"vocabulary of {len(vocab)} entries, wanted {size}")
    return vocab


def compute_dtype(config: Dict) -> torch.dtype:
    """``fp16: true`` is bfloat16 compute on float32 masters in the port."""
    return torch.bfloat16 if config.get("fp16", False) else torch.float32


def build(config: Dict, seed: int, device: str) -> Tuple[torch.nn.Module, object, object, Dict]:
    """(model with the benchmark's weights for ``seed``, its spec, the
    vocabulary, the parameter shapes)."""
    from joeys2t_torch.models import build_model

    vocab = vocabulary(config["vocab_size"])
    kwargs = {"trg_vocab": vocab}
    if config.get("task", "S2T") == "MT":
        kwargs["src_vocab"] = vocab
    model, spec = build_model(config["model"], compute_dtype=compute_dtype(config),
                              device=device, **kwargs)
    shapes = param_shapes(model)
    load_into(model, make_weights(shapes, seed, device))
    return model, spec, vocab, shapes
