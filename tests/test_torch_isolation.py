# coding: utf-8
"""Guards of the PyTorch port: it imports nothing of JAX or the JAX package,
its entry points refuse to fall back to the CPU on their own, its kernel
wrappers import and run their plain versions without a CUDA toolchain, and
its parameter names convert to and from the JAX parameter tree."""
import copy
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import joeys2t_torch
from joeys2t_torch.config import SpecialSymbols, load_config
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.models import build_model
from joeys2t_torch import prediction
from joeys2t_torch.search import greedy
from joeys2t_torch.serving import Transcriber
from joeys2t_torch.training import train
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.convert import torch_state_dict_to_flax
from test_torch_model import CFG, TOKENS, jax_s2t

REPO = Path(__file__).resolve().parents[1]


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(joeys2t_torch.__path__,
                                                         "joeys2t_torch."))


def test_port_imports_no_jax():
    """Importing every submodule loads neither JAX nor the JAX package, nor
    any package the card's machine lacks (pandas, sacrebleu, PyYAML,
    sentencepiece, tensorboardX, matplotlib)."""
    mods = _submodules()
    assert "joeys2t_torch.ops.flash_attention" in mods and len(mods) >= 15
    assert "joeys2t_torch.__main__" in mods and "joeys2t_torch.prediction" in mods
    code = ("import sys\n"
            f"for m in {mods!r}: __import__(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'joeys2t_tpu', 'pandas', 'sacrebleu', "
            "'yaml', 'sentencepiece', 'tensorboardX', 'matplotlib')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


def test_kernel_wrappers_need_no_toolchain():
    """Without nvcc (or triton) the wrappers import, run their plain version
    on CPU tensors and build nothing."""
    code = (
        "import torch\n"
        "from joeys2t_torch.ops import cuda_build, decode_attention as da, "
        "flash_attention as fa, topk as tk\n"
        "q = torch.randn(2, 5, 128); b = torch.zeros(2, 5)\n"
        "fa.flash_attention_fwd(q, q, q, b, 0.125, 2)\n"
        "da.decode_attention(torch.randn(2, 2, 64), torch.randn(2, 2, 5, 64), "
        "torch.randn(2, 2, 5, 64), b)\n"
        "tk.stable_topk(torch.randn(3, 40), 5)\n"
        "assert not cuda_build._loaded\n"
        "try:\n"
        "    cuda_build._nvcc()\n"
        "    raise SystemExit('nvcc found')\n"
        "except RuntimeError:\n"
        "    pass\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    env.pop("PYTHONPATH", None)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no CUDA device and no device named, every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(CFG, trg_vocab=vocab)
    model, spec = build_model(CFG, trg_vocab=vocab, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transcriber(model, spec, vocab)
    enc = torch.zeros(1, 3, 128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy(model, spec, enc, None, torch.ones(1, 1, 3, dtype=torch.bool), 4)
    # named explicitly, the CPU is fine
    out, _, _ = greedy(model, spec, enc, None, torch.ones(1, 1, 3, dtype=torch.bool), 4,
                       device="cpu")
    assert out.shape == (1, 4)
    # the CLI's modes with `use_cuda` left at its default raise before they
    # read any data
    cfg = load_config(REPO / "configs" / "synthetic_asr.yaml")
    assert "use_cuda" in cfg
    del cfg["use_cuda"]
    for mode in (train, prediction.test, prediction.translate):
        with pytest.raises(RuntimeError, match="use_cuda"):
            mode(copy.deepcopy(cfg))


@pytest.mark.parametrize("heads,dtype", [(4, torch.bfloat16), (1, torch.float16),
                                         (1, torch.float32)])
def test_key_masked_attention_off_the_cpu_takes_the_kernel_wrapper(heads, dtype):
    """Off the CPU, key-masked attention goes to the flash wrapper whatever
    its head size (16 or 64) and dtype, so on a card a head size or dtype
    the kernel does not take raises there instead of running plain PyTorch
    attention. The meta device stands in for the card: the plain path would
    run on it, the wrapper refuses it."""
    from joeys2t_torch.models.modules import MultiHeadedAttention

    mha = MultiHeadedAttention(heads, 64, dtype=dtype, device="meta").eval()
    x = torch.empty(2, 5, 64, device="meta")
    with pytest.raises(ValueError, match="flash attention runs on"):
        mha(x, x, x, torch.ones(2, 1, 5, dtype=torch.bool, device="meta"))
    full_mask = torch.ones(2, 5, 5, dtype=torch.bool, device="meta")
    assert mha(x, x, x, full_mask).shape == (2, 5, 64)  # causal masks stay plain


def test_state_dict_round_trips_through_jax_converter():
    _, _, params, _ = jax_s2t(seed=3)
    state = flax_params_to_state_dict(params)
    model, _ = build_model(CFG, trg_vocab=Vocabulary(TOKENS, SpecialSymbols()),
                           device="cpu")
    assert sorted(state) == sorted(model.state_dict())  # names and count agree
    model.load_state_dict(state, strict=True)
    back = torch_state_dict_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, value in flat_ref:
        np.testing.assert_array_equal(flat_back[path], value, err_msg=str(path))
