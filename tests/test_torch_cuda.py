# coding: utf-8
"""The port's CUDA kernels against their plain versions, and a small model
on the card against the CPU. Needs a CUDA card and nvcc; skipped without
them. Run on a card with (the suite's conftest.py imports JAX, which the
card's machine need not have):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py"""
import numpy as np
import pytest
import torch

from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.models import build_model
from joeys2t_torch.ops import decode_attention as da
from joeys2t_torch.ops import flash_attention as fa
from joeys2t_torch.search import transformer_greedy
from joeys2t_torch.vocabulary import Vocabulary

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,d", [(3, 37, 70, 2, 64), (2, 130, 600, 4, 128),
                                         (2, 40, 33, 1, 256)])
def test_flash_kernel_matches_plain(card, dtype, tol, b, sq, sk, h, d):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, h * d, generator=gen).to(dtype).to(card)
    k, v = (torch.randn(b, sk, h * d, generator=gen).to(dtype).to(card) for _ in range(2))
    valid = torch.arange(sk)[None, :] < torch.randint(1, sk + 1, (b,), generator=gen)[:, None]
    valid[0] = False
    bias = torch.where(valid, 0.0, -1e9).float().to(card)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, bias, d ** -0.5, h)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bias, d ** -0.5, h)
    assert fa.flash_attention_fwd.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_fwd(q, k, v, bias, d ** -0.5, h, dropout_rate=0.1)


@pytest.mark.parametrize("mode", ["f32", "bf16", "channel", "position"])
def test_decode_kernel_matches_plain(card, mode):
    gen = torch.Generator().manual_seed(1)
    b, h, s, d = 5, 2, 41, 128
    qdt = torch.float32 if mode == "f32" else torch.bfloat16
    q = torch.randn(b, h, d, generator=gen).to(qdt).to(card)
    kf, vf = (torch.randn(b, h, s, d, generator=gen).to(card) for _ in range(2))
    valid = torch.arange(s)[None, :] < torch.randint(1, s + 1, (b,), generator=gen)[:, None]
    bias = torch.where(valid, 0.0, -1e9).float().to(card)
    ks = vs = None
    if mode == "channel":
        ks, vs = (t.abs().amax(2) / 127.0 + 1e-8 for t in (kf, vf))
        k, v = (torch.clamp(torch.round(t / sc[:, :, None]), -127, 127).to(torch.int8)
                for t, sc in ((kf, ks), (vf, vs)))
    elif mode == "position":
        (k, ks), (v, vs) = da.quantize_per_position(kf), da.quantize_per_position(vf)
    else:
        k, v = kf.to(qdt), vf.to(qdt)
    layout = mode if mode in ("channel", "position") else None
    out = da.decode_attention(q, k, v, bias, ks, vs, sm_scale=d ** -0.5,
                              scale_layout=layout)
    ref = da.decode_attention_plain(q, k, v, bias, ks, vs, sm_scale=d ** -0.5,
                                    scale_layout=layout)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=1e-5 if qdt == torch.float32 else 1e-2, rtol=0)


@pytest.mark.parametrize("heads,dtype", [(4, torch.bfloat16), (1, torch.float16)])
def test_unsupported_head_size_or_dtype_raises_on_card(card, heads, dtype):
    """Key-masked attention the flash kernel cannot take (head size 16, or
    float16) raises on the card instead of running plain PyTorch."""
    from joeys2t_torch.models.modules import MultiHeadedAttention

    mha = MultiHeadedAttention(heads, 64, dtype=dtype, device=card).eval()
    x = torch.randn(2, 5, 64, device=card)
    before = fa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="flash kernel takes"):
        mha(x, x, x, torch.ones(2, 1, 5, dtype=torch.bool, device=card))
    assert fa.flash_attention_fwd.launches == before


def test_small_model_card_matches_cpu(card):
    cfg = {"encoder": {"num_layers": 2, "num_heads": 2, "embeddings": {},
                       "hidden_size": 256, "ff_size": 512, "subsample": True,
                       "conv_kernel_sizes": [5, 5], "conv_channels": 256,
                       "in_channels": 80},
           "decoder": {"num_layers": 2, "num_heads": 2, "hidden_size": 256,
                       "ff_size": 512, "embeddings": {"embedding_dim": 256, "scale": True},
                       "layer_norm": "pre"}}
    vocab = Vocabulary([f"w{i}" for i in range(60)], SpecialSymbols())
    feats = torch.tensor(np.random.RandomState(2).randn(3, 300, 80).astype(np.float32))
    lengths = torch.tensor([300, 211, 150])
    outs = {}
    with torch.inference_mode():
        for dev in ("cpu", card):
            model, spec = build_model(cfg, trg_vocab=vocab, device=dev,
                                      generator=torch.Generator().manual_seed(3))
            enc, _, mask = model.encode(feats.to(dev), lengths.to(dev))
            outs[str(dev)] = (enc.cpu() * mask.cpu()[:, 0, :, None],
                              transformer_greedy(model, spec, enc, mask, 20, device=dev)[0])
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(outs["cuda"][1], outs["cpu"][1])
