# coding: utf-8
"""The port's CUDA kernels against their plain versions (flash attention
forward and backward, with and without dropout, and the dropout mask bit
for bit; decode attention, also with query rows sharing a cache row), and a
small model on the card against the CPU (greedy and beam search, serving and
one training update). Needs a CUDA card and nvcc; skipped without
them. Run on a card with (the suite's conftest.py imports JAX, which the
card's machine need not have):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py"""
from pathlib import Path

import numpy as np
import pytest
import torch

from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.models import build_model
from joeys2t_torch.ops import decode_attention as da
from joeys2t_torch.ops import flash_attention as fa
from joeys2t_torch.search import beam_search, transformer_greedy
from joeys2t_torch.vocabulary import Vocabulary

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# tile edges of the kernels (64-row q and k tiles, 32 or 16 in places):
# every pair of these query and key lengths at head sizes 64 and 128
EDGES = [(3, sq, sk, 2, d) for d in (64, 128) for sq in (1, 47, 63, 64, 65, 250, 750)
         for sk in (1, 47, 63, 64, 65, 250, 750)]
# the text models' shapes: token-length self-attention (every key tile
# partial, wholly padded rows) and cross-attention at B up to 192
# (synthetic_mt, head size 128), and head size 16 (transformer_reverse,
# transformer_small) at their batch shapes and the tile edges
SHORT = ([(192, s, s, 4, 128) for s in (1, 7, 33, 61)] + [(192, 81, 61, 4, 128)]
         + [(12, 26, 26, 4, 16), (192, 61, 61, 4, 16), (192, 81, 61, 4, 16)]
         + [(3, sq, sk, 2, 16) for sq in (1, 63, 64, 65, 250) for sk in (1, 63, 65, 250)])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,d", [(3, 37, 70, 2, 64), (2, 130, 600, 4, 128),
                                         (2, 40, 33, 1, 256), (2, 70, 90, 2, 192)] + EDGES)
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
    # with dropout the kernel drops the same probabilities as the plain version
    seed = torch.tensor([12345], dtype=torch.int32, device=card)
    out, lse = fa.flash_attention_fwd(q, k, v, bias, d ** -0.5, h, 0.1, seed)
    ref, _ = fa.flash_attention_plain(q, k, v, bias, d ** -0.5, h, 0.1, seed)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,d", SHORT)
def test_flash_kernel_matches_plain_at_token_lengths(card, dtype, tol, b, sq, sk, h, d):
    """The forward at the text models' shapes, with and without dropout, row
    0 with every key masked, two calls bit-identical. With few keys a row's
    output is no average (at Sk = 1 the kept value times 1 / (1 - rate)), so
    the tolerance is in units of the largest reference value where that
    exceeds 1: bf16 rounds an output to its own ulp."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, h * d, generator=gen).to(dtype).to(card)
    k, v = (torch.randn(b, sk, h * d, generator=gen).to(dtype).to(card) for _ in range(2))
    valid = torch.arange(sk)[None, :] < torch.randint(1, sk + 1, (b,), generator=gen)[:, None]
    valid[0] = False
    bias = torch.where(valid, 0.0, -1e9).float().to(card)
    seed = torch.tensor([12345], dtype=torch.int32, device=card)
    for rate in (0.0, 0.1):
        out, lse = fa.flash_attention_fwd(q, k, v, bias, d ** -0.5, h, rate, seed)
        again = fa.flash_attention_fwd(q, k, v, bias, d ** -0.5, h, rate, seed)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, bias, d ** -0.5, h, rate, seed)
        scale = max(1.0, ref.float().abs().max().item())
        torch.testing.assert_close(out.float(), ref.float(), atol=tol * scale, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def _rel_err(a, b, floor=1e-30):
    return ((a.float() - b.float()).abs().max().item()
            / max(b.float().abs().max().item(), floor))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,sq,sk,h,d", [(3, 37, 70, 2, 64), (2, 47, 250, 4, 128),
                                         (2, 130, 600, 4, 128), (2, 40, 33, 1, 256),
                                         (2, 70, 90, 2, 192)] + EDGES + SHORT)
def test_flash_backward_kernel_matches_plain(card, dtype, tol, rate, b, sq, sk, h, d):
    """dQ, dK, dV of the three backward kernels against the plain version,
    row 0 with every key masked; the tolerance is relative to the largest
    gradient (f32: summation order; bf16: bf16 rounding of each output and,
    on the tensor cores, of P_drop and dS before their products). A gradient
    that is zero but for rounding (Sk = 1: one key, so ds = 0 and dQ = dK = 0)
    is held to the largest of the three gradients instead. A second
    call gives the same gradients bit for bit (no atomics)."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(b, sq, h * d, generator=gen).to(dtype).to(card)
    k, v = (torch.randn(b, sk, h * d, generator=gen).to(dtype).to(card) for _ in range(2))
    d_out = torch.randn(b, sq, h * d, generator=gen).to(dtype).to(card)
    valid = torch.arange(sk)[None, :] < torch.randint(1, sk + 1, (b,), generator=gen)[:, None]
    valid[0] = False
    bias = torch.where(valid, 0.0, -1e9).float().to(card)
    seed = torch.tensor([777], dtype=torch.int32, device=card)
    sm = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, sm, h, rate, seed)
    before = fa.flash_attention_bwd.launches
    grads = fa.flash_attention_bwd(q, k, v, bias, out, lse, d_out, sm, h, rate, seed)
    refs = fa.flash_attention_bwd_plain(q, k, v, bias, out, lse, d_out, sm, h, rate, seed)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    again = fa.flash_attention_bwd(q, k, v, bias, out, lse, d_out, sm, h, rate, seed)
    floor = max(r.float().abs().max().item() for r in refs) if sk == 1 else 1e-30
    for name, g, r, g2 in zip(("dq", "dk", "dv"), grads, refs, again):
        assert g.dtype == dtype and bool(torch.isfinite(g.float()).all()), name
        assert _rel_err(g, r, floor) <= tol, (name, _rel_err(g, r, floor))
        assert torch.equal(g, g2), f"{name} differs between two calls"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_mask_bits_match_plain(card, dtype):
    """The kernels' keep mask, read out bit for bit: with V the identity in
    each head band the forward's out is the dropped probability matrix, and
    with dO the identity the backward's dV is its transpose. bf16 takes the
    tensor-core kernels, f32 the SIMT ones."""
    b, h, d = 3, 2, 128
    sq = sk = d
    gen = torch.Generator().manual_seed(5)
    q, k = (torch.randn(b, sq, h * d, generator=gen).to(dtype).to(card) for _ in range(2))
    eye = (torch.eye(d, device=card).repeat(1, h)[None].expand(b, d, h * d).to(dtype)
           .contiguous())
    bias = torch.zeros(b, sk, device=card)
    seed = torch.tensor([2024], dtype=torch.int32, device=card)
    keep = fa.attention_keep(seed, b, h, sq, sk, 0.1, card)  # (B, H, Sq, Sk)
    out, lse = fa.flash_attention_fwd(q, k, eye, bias, 1.0 / d, h, 0.1, seed)
    fwd_keep = out.reshape(b, sq, h, d).permute(0, 2, 1, 3) != 0
    _, _, dv = fa.flash_attention_bwd(q, k, eye, bias, out, lse, eye, 1.0 / d, h, 0.1, seed)
    bwd_keep = dv.reshape(b, sk, h, d).permute(0, 2, 3, 1) != 0
    assert torch.equal(fwd_keep, keep) and torch.equal(bwd_keep, keep)
    assert 0.85 < keep.float().mean().item() < 0.95


@pytest.mark.parametrize("d", [16, 64, 128, 192, 256])
def test_flash_route(card, d):
    """bf16 takes the tensor-core kernels, f32 the exact SIMT ones."""
    assert fa.kernel_info(d, torch.bfloat16)["route"] == "mma.sync"
    assert fa.kernel_info(d, torch.float32)["route"] == "simt"


DECODE_MASKS = ("self_prefix", "cross_tail", "holes", "all_masked_row", "last_key_only")


def decode_valid(kind, b, s, gen):
    """(B, S) bool, the keys each row attends to: the self-attention ring
    buffer at step S // 2, padded source tails, interior holes, or a prefix
    with row 0 fully masked or holding only its last key."""
    pos = torch.arange(s)
    if kind == "self_prefix":
        return (pos <= s // 2)[None].expand(b, s).clone()
    if kind == "cross_tail":
        return pos[None] < torch.randint(1, s + 1, (b,), generator=gen)[:, None]
    if kind == "holes":
        valid = torch.rand(b, s, generator=gen) > 0.4
        valid[:, s // 2] = True
        return valid
    valid = (pos < (s + 1) // 2)[None].expand(b, s).clone()
    valid[0] = False
    if kind == "last_key_only":
        valid[0, -1] = True
    return valid


def decode_caches(mode, kf, vf, qdt):
    """K, V and their scales for a mode: f32 or bf16 caches in q's dtype, or
    int8 with "channel" (B, H, D) or "position" (B, H, S) scales."""
    if mode == "channel":
        ks, vs = (t.abs().amax(2) / 127.0 + 1e-8 for t in (kf, vf))
        k, v = (torch.clamp(torch.round(t / sc[:, :, None]), -127, 127).to(torch.int8)
                for t, sc in ((kf, ks), (vf, vs)))
        return k, v, ks, vs
    if mode == "position":
        (k, ks), (v, vs) = da.quantize_per_position(kf), da.quantize_per_position(vf)
        return k, v, ks, vs
    return kf.to(qdt), vf.to(qdt), None, None


@pytest.mark.parametrize("mode", ["f32", "bf16", "channel", "position"])
@pytest.mark.parametrize("d", [16, 64, 128, 192, 256])
@pytest.mark.parametrize("s", [1, 26, 31, 61, 64, 65, 81, 97, 250, 750, 3000])
@pytest.mark.parametrize("b,h", [(1, 1), (1, 4), (3, 2), (64, 4)])
def test_decode_kernel_matches_plain(card, mode, d, s, b, h):
    """The split-S kernel against the plain version under every mask kind
    (tolerance 1e-5 in f32, 1e-2 with a bf16 q: summation order and the
    output's rounding). Two calls give the same bits, and garbage written
    into the masked rows of rows with a valid key (K and V +-1e4, or +-127 in
    int8 with "position" scales of 1e3) leaves the output bit for bit: the
    kernel does not read those rows."""
    gen = torch.Generator(device=card).manual_seed(1)
    mask_gen = torch.Generator().manual_seed(2)
    qdt = torch.float32 if mode == "f32" else torch.bfloat16
    q = torch.randn(b, h, d, generator=gen, device=card).to(qdt)
    kf, vf = (torch.randn(b, h, s, d, generator=gen, device=card) for _ in range(2))
    k, v, ks, vs = decode_caches(mode, kf, vf, qdt)
    del kf, vf
    kw = dict(sm_scale=d ** -0.5, scale_layout=mode if ks is not None else None)
    tol = 1e-5 if qdt == torch.float32 else 1e-2
    big = 127 if k.dtype == torch.int8 else 1e4
    for kind in DECODE_MASKS:
        valid = decode_valid(kind, b, s, mask_gen).to(card)
        bias = torch.where(valid, 0.0, -1e9).float()
        before = da.decode_attention.launches
        out = da.decode_attention(q, k, v, bias, ks, vs, **kw)
        again = da.decode_attention(q, k, v, bias, ks, vs, **kw)
        ref = da.decode_attention_plain(q, k, v, bias, ks, vs, **kw)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 2
        assert out.dtype == qdt and bool(torch.isfinite(out.float()).all()), kind
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0,
                                   msg=lambda m, kind=kind: f"{kind}: {m}")
        assert torch.equal(out, again), f"{kind}: two calls differ"
        dirty = ~valid & valid.any(1, keepdim=True)  # masked keys of rows with a valid key
        sign = torch.where(torch.rand(b, h, s, d, generator=gen, device=card) > 0.5, big, -big)
        kg, vg = (torch.where(dirty[:, None, :, None], sign.to(t.dtype), t) for t in (k, v))
        ksg, vsg = ks, vs
        if mode == "position":
            ksg, vsg = (torch.where(dirty[:, None, :], 1e3, t) for t in (ks, vs))
        out_g = da.decode_attention(q, kg, vg, bias, ksg, vsg, **kw)
        assert torch.equal(out_g, out), f"{kind}: garbage in masked rows changed the output"
        del kg, vg, sign


@pytest.mark.parametrize("mode", ["f32", "bf16", "channel", "position"])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("s", [1, 61, 65, 250, 750])
@pytest.mark.parametrize("b,h,group", [(1, 4, 5), (3, 2, 2), (32, 4, 5), (128, 4, 5)])
def test_decode_kernel_group_matches_expanded_cache(card, mode, d, s, b, h, group):
    """``group`` G query rows a cache row (the beam-shared cross cache):
    bit for bit the kernel with one query a row over the cache, bias and
    scales repeated G times (the same plan, the same math per row), and
    within the tolerances above of the plain version; group 1 of the
    expanded cache stays the kernel it was."""
    gen = torch.Generator(device=card).manual_seed(5)
    mask_gen = torch.Generator().manual_seed(6)
    qdt = torch.float32 if mode == "f32" else torch.bfloat16
    q = torch.randn(b * group, h, d, generator=gen, device=card).to(qdt)
    kf, vf = (torch.randn(b, h, s, d, generator=gen, device=card) for _ in range(2))
    k, v, ks, vs = decode_caches(mode, kf, vf, qdt)
    kw = dict(sm_scale=d ** -0.5, scale_layout=mode if ks is not None else None)
    tol = 1e-5 if qdt == torch.float32 else 1e-2

    def expand(t):
        return None if t is None else t.repeat_interleave(group, 0).contiguous()

    for kind in DECODE_MASKS:
        bias = torch.where(decode_valid(kind, b, s, mask_gen).to(card), 0.0, -1e9).float()
        out = da.decode_attention(q, k, v, bias, ks, vs, group=group, **kw)
        flat = da.decode_attention(q, *map(expand, (k, v, bias, ks, vs)), **kw)
        ref = da.decode_attention_plain(q, k, v, bias, ks, vs, group=group, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, flat), f"{kind}: group {group} differs from the expanded cache"
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0,
                                   msg=lambda m, kind=kind: f"{kind}: {m}")


def legal_plans(s):
    """Every launch plan (splits, split_rows) the C entry point takes for S
    rows: 1-16 splits of any length, none empty (one split: S rows, and S
    rounded up to 16)."""
    plans = {(1, s), (1, -(-s // 16) * 16)}
    for splits in range(2, min(16, s) + 1):
        plans |= {(splits, rows) for rows in range(-(-s // splits), (s - 1) // (splits - 1) + 1)}
    return sorted(plans)


@pytest.mark.parametrize("mode", ["f32", "bf16", "channel", "position"])
@pytest.mark.parametrize("d", [16, 64, 128, 192, 256])
@pytest.mark.parametrize("s", [1, 17, 97, 250])
def test_decode_kernel_every_plan(card, mode, d, s):
    """Every plan the kernel takes, not only those of decode_plan (splits of
    any length down to one row; at S=97 e.g. 7 splits of 14-16 rows, whole
    splits of masked rows at the self-attention step S // 2), under every
    mask kind, against the plain version with the tolerances above; and the
    C entry point refuses the plans it does not take."""
    gen = torch.Generator(device=card).manual_seed(3)
    mask_gen = torch.Generator().manual_seed(4)
    b, h = 3, 2
    qdt = torch.float32 if mode == "f32" else torch.bfloat16
    q = torch.randn(b, h, d, generator=gen, device=card).to(qdt)
    kf, vf = (torch.randn(b, h, s, d, generator=gen, device=card) for _ in range(2))
    k, v, ks, vs = decode_caches(mode, kf, vf, qdt)
    layout = mode if ks is not None else None
    sm_scale, tol = d ** -0.5, (1e-5 if qdt == torch.float32 else 1e-2)
    for kind in DECODE_MASKS:
        bias = torch.where(decode_valid(kind, b, s, mask_gen).to(card), 0.0, -1e9).float()
        ref = da.decode_attention_plain(q, k, v, bias, ks, vs, sm_scale=sm_scale,
                                        scale_layout=layout)
        for plan in legal_plans(s):
            out = torch.full_like(ref, float("nan"))
            assert da._launch(q, k, v, bias, ks, vs, out, layout, plan, sm_scale) == 0, plan
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0,
                                       msg=lambda m, kind=kind, plan=plan: f"{kind} {plan}: {m}")
    refused = [(0, s), (17, 1), (1, 0), (1, s - 1), (2, s)]  # 0 or > 16 splits, short, empty
    out = torch.empty_like(ref)
    for plan in refused if s > 1 else refused[:3]:
        assert da._launch(q, k, v, bias, ks, vs, out, layout, plan, sm_scale) == 1, plan


def test_train_update_card_matches_cpu(card):
    """One f32 update at dropout 0 (two accumulated micro-batches) on the card
    and on the CPU: loss, gradients and updated weights."""
    from test_torch_train import one_update

    cpu, gpu = one_update("cpu"), one_update(card)
    assert fa.flash_attention_bwd.launches > 0
    assert abs(gpu["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"])
    for name in cpu["grads"]:
        err = (gpu["grads"][name] - cpu["grads"][name]).abs().max().item()
        assert err <= 1e-4 * cpu["grad_norm"], name
        err = (gpu["params"][name] - cpu["params"][name]).abs().max().item()
        assert err <= 2 * cpu["lr"], name


@pytest.mark.parametrize("heads,dtype", [(2, torch.bfloat16), (1, torch.float16)])
def test_unsupported_head_size_or_dtype_raises_on_card(card, heads, dtype):
    """Key-masked attention the flash kernel cannot take (head size 32, or
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
            beam = beam_search(model, spec, enc, None, mask, 5, 20, 1.0, n_best=2,
                               device=dev, return_prob="hyp")
            outs[str(dev)] = (enc.cpu() * mask.cpu()[:, 0, :, None],
                              transformer_greedy(model, spec, enc, mask, 20, device=dev)[0],
                              beam[0], beam[1])
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(outs["cuda"][1], outs["cpu"][1])
    np.testing.assert_array_equal(outs["cuda"][2], outs["cpu"][2])  # beam 5, 2-best
    np.testing.assert_allclose(outs["cuda"][3], outs["cpu"][3], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["rnn_reverse", "rnn_small"])
def test_recurrent_model_card_matches_cpu(card, name):
    """A recurrent config's model (LSTM/Luong or GRU/Bahdanau, float32) on
    the card and on the CPU with the same seeded weights: the encoder's
    outputs and states to 1e-5 with cuDNN's TF32 left at its default (the
    encoder turns it off for float32 itself), the logits, greedy and beam-5
    2-best hypotheses; no attention kernel of the port launches."""
    from joeys2t_torch.config import load_config
    from joeys2t_torch.search import greedy

    repo = Path(__file__).resolve().parents[1]
    cfg = load_config(repo / "configs" / f"{name}.yaml")["model"]
    vocab = Vocabulary([f"w{i}" for i in range(40)], SpecialSymbols())
    rng = np.random.RandomState(4)
    src = torch.tensor(rng.randint(4, 44, size=(4, 12)))
    lengths = torch.tensor([12, 9, 1, 0])
    src[torch.arange(12)[None, :] >= lengths[:, None]] = 1
    trg = torch.tensor(rng.randint(4, 44, size=(4, 7)))
    mask = (src != 1)[:, None, :]
    launches = (fa.flash_attention_fwd.launches, da.decode_attention.launches)
    outs = {}
    with torch.inference_mode():
        for dev in ("cpu", card):
            model, spec = build_model(cfg, src_vocab=vocab, trg_vocab=vocab, device=dev,
                                      generator=torch.Generator().manual_seed(5))
            args = [t.to(dev) for t in (src, lengths, mask)]
            enc, hidden, enc_mask = model.encode(*args)
            logits = model(args[0], trg.to(dev), args[1], args[2],
                           torch.ones(4, 1, 7, dtype=torch.bool, device=dev))[0]
            beam = beam_search(model, spec, enc, hidden, enc_mask, 5, 20, 1.0, n_best=2,
                               device=dev, return_prob="hyp")
            outs[str(dev)] = (enc.cpu(), hidden.cpu(), logits.cpu(),
                              greedy(model, spec, enc, hidden, enc_mask, 20, device=dev)[0],
                              beam[0], beam[1])
    assert (fa.flash_attention_fwd.launches, da.decode_attention.launches) == launches
    for got, want in zip(outs["cuda"][:3], outs["cpu"][:3]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for got, want in zip(outs["cuda"][3:5], outs["cpu"][3:5]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(outs["cuda"][5], outs["cpu"][5], atol=1e-4, rtol=0)


def test_moe_model_card_matches_cpu(card):
    """A float32 text transformer with 4 experts an encoder layer, on the
    card and on the CPU: the logits and the load-balance term, with the
    encoder's self-attention on the flash kernel."""
    from joeys2t_torch.models.modules import MoEFeedForward

    side = {"num_layers": 2, "num_heads": 2, "hidden_size": 128, "ff_size": 256,
            "layer_norm": "pre", "embeddings": {"embedding_dim": 128, "scale": True}}
    cfg = {"encoder": dict(side, num_experts=4), "decoder": dict(side)}
    vocab = Vocabulary([f"w{i}" for i in range(60)], SpecialSymbols())
    rng = np.random.RandomState(6)
    src = torch.tensor(rng.randint(4, 64, size=(3, 15)))
    lengths = torch.tensor([15, 8, 0])
    src[torch.arange(15)[None, :] >= lengths[:, None]] = 1
    trg = torch.tensor(rng.randint(4, 64, size=(3, 9)))
    outs = {}
    with torch.inference_mode():
        for dev in ("cpu", card):
            model, _ = build_model(cfg, src_vocab=vocab, trg_vocab=vocab, device=dev,
                                   generator=torch.Generator().manual_seed(7))
            before = fa.flash_attention_fwd.launches
            logits = model(src.to(dev), trg.to(dev), lengths.to(dev),
                           (src != 1)[:, None, :].to(dev),
                           torch.ones(3, 1, 9, dtype=torch.bool, device=dev))[0]
            aux = sum(m.aux_loss for m in model.modules() if isinstance(m, MoEFeedForward))
            outs[str(dev)] = (logits.cpu(), float(aux), fa.flash_attention_fwd.launches - before)
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], atol=1e-4, rtol=0)
    assert abs(outs["cuda"][1] - outs["cpu"][1]) <= 1e-5
    assert outs["cuda"][2] == 4 and outs["cpu"][2] == 0  # 2 encoder + 2 cross attentions
