# coding: utf-8
"""The port's CUDA kernels against their plain versions (flash attention
forward and backward on each route, wgmma, mma.sync and SIMT, at the
tiles' edges, an utterance alone bit-equal to its row in a padded batch,
over memory poisoned with NaN and inf; with and without dropout, and the
dropout mask bit for bit;
decode attention, also with query rows sharing a cache row and through an
ancestry map; beam search's top-k bit for bit against the stable sort), and a
small model on the card against the CPU (greedy and beam search, serving and
one training update), a one-rank NCCL update and ``remat`` against the plain
update. Needs a CUDA card and nvcc; skipped without them. Run on a card
with (the suite's conftest.py imports JAX, which the card's machine need
not have):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py"""
import ctypes
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


# the wgmma forward's tile edges (one-head tiles of 128 query rows, at head
# size 64 also two-head tiles of 64 rows; 128 keys a tile) at head sizes 128
# (2 heads) and 64 (2, 3 and 8 heads: an odd H leaves the last pair's second
# head idle), the pairs EDGES does not already hold (held at token lengths'
# tolerance: Sk = 1 with dropout gives outputs of ~5)
WGMMA_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 250, 750, 1125)
WGMMA_EDGES = [(3, sq, sk, h, d) for h, d in ((2, 128), (2, 64), (3, 64), (8, 64))
               for sq in WGMMA_LENGTHS for sk in WGMMA_LENGTHS
               if (3, sq, sk, h, d) not in EDGES]
# the wgmma backward's tile edges (blocks and streamed tiles of 64 rows) at
# head sizes 128 and 64 (2 heads; at 64 also 8), the pairs EDGES does not
# already hold
BWD_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 250, 750)
BWD_EDGES = [(3, sq, sk, h, d) for h, d in ((2, 128), (2, 64), (8, 64))
             for sq in BWD_LENGTHS for sk in BWD_LENGTHS
             if (3, sq, sk, h, d) not in EDGES and (h == 2 or sq in (1, 65, 250))]


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


@pytest.mark.parametrize("b,sq,sk,h,d,route,tile", [
    (64, 250, 250, 4, 128, "wgmma", (128, 1)), (64, 47, 250, 4, 128, "wgmma", (128, 1)),
    (3, 250, 250, 4, 128, "wgmma", (128, 1)), (64, 750, 750, 4, 128, "wgmma", (128, 1)),
    (64, 250, 250, 8, 64, "wgmma", (128, 1)), (192, 61, 61, 8, 64, "wgmma", (64, 2)),
    (192, 61, 61, 4, 16, "mma.sync", None)])
def test_flash_forward_writes_every_output_over_poisoned_memory(card, b, sq, sk, h, d,
                                                                route, tile):
    """The bf16 forward at phase 2's shapes (row 0 with every key masked, the
    others of random lengths) into memory the caching allocator hands back
    full of NaN and inf: every out and lse entry written and finite, equal
    to the plain version, ten calls bit-identical. An output the kernel
    left unwritten, or a read of memory it did not write first, shows as a
    non-finite value here (the one-off non-finite lse of PERF.md §7). Every
    bf16 forward route: wgmma at head sizes 128 and 64 in both of its tiles
    (the 8-head models' 10 s utterances and MT sentences), and the mma.sync
    forward that remains (head size 16, the 64-wide MT models)."""
    assert fa.kernel_info(d, torch.bfloat16)["route"] == route
    if tile is not None:
        assert fa.wgmma_tile(d, sq, h) == tile
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(b, sq, h * d, generator=gen).to(torch.bfloat16).to(card)
    k, v = (torch.randn(b, sk, h * d, generator=gen).to(torch.bfloat16).to(card)
            for _ in range(2))
    valid = torch.arange(sk)[None, :] < torch.randint(sk // 2, sk + 1, (b,),
                                                      generator=gen)[:, None]
    valid[0] = False
    bias = torch.where(valid, 0.0, -1e9).float().to(card)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bias, d ** -0.5, h)
    first = None
    for i in range(10):
        poison = torch.full((64 << 20,), float("nan") if i % 2 else float("inf"),
                            device=card)
        del poison  # its blocks go back to the allocator, still poisoned
        out, lse = fa.flash_attention_fwd(q, k, v, bias, d ** -0.5, h)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all(), i
        if first is None:
            first = (out.clone(), lse.clone())
            torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
            torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        assert torch.equal(out, first[0]) and torch.equal(lse, first[1]), i


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,d", SHORT + WGMMA_EDGES)
def test_flash_kernel_matches_plain_at_token_lengths(card, dtype, tol, b, sq, sk, h, d):
    """The forward at the text models' shapes and at the wgmma kernel's
    tile edges, with and without dropout, row 0 with every key masked, two
    calls bit-identical. With few keys a row's output is no average (at Sk =
    1 the kept value times 1 / (1 - rate)), so the tolerance is in units of
    the largest reference value where that exceeds 1: bf16 rounds an output
    to its own ulp (0.03 at the ~5 of Sk = 1 with dropout)."""
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
                                         (2, 70, 90, 2, 192)] + EDGES + SHORT + BWD_EDGES)
def test_flash_backward_kernel_matches_plain(card, dtype, tol, rate, b, sq, sk, h, d):
    """dQ, dK, dV of the three backward kernels against the plain version,
    row 0 with every key masked; the tolerance is relative to the largest
    gradient (f32: summation order; bf16: bf16 rounding of each output and,
    on the tensor cores, of P_drop and dS before their products). A gradient
    that is zero but for rounding (Sk = 1: one key, so ds = 0 and dQ = dK = 0)
    is held to the largest of the three gradients instead. A second
    call gives the same gradients bit for bit (no atomics). bf16 at head
    sizes 64 and 128 takes the wgmma backward, at its tile edges too
    (BWD_EDGES)."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(b, sq, h * d, generator=gen).to(dtype).to(card)
    k, v = (torch.randn(b, sk, h * d, generator=gen).to(dtype).to(card) for _ in range(2))
    d_out = torch.randn(b, sq, h * d, generator=gen).to(dtype).to(card)
    valid = torch.arange(sk)[None, :] < torch.randint(1, sk + 1, (b,), generator=gen)[:, None]
    valid[0] = False
    bias = torch.where(valid, 0.0, -1e9).float().to(card)
    seed = torch.tensor([777], dtype=torch.int32, device=card)
    sm = d ** -0.5
    assert fa.kernel_info(d, dtype)["bwd_route"] == fa.bwd_route(d, dtype)
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
    wgmma kernels at this head size both ways, f32 the SIMT ones."""
    b, h, d = 3, 2, 128
    info = fa.kernel_info(d, dtype)
    assert info["route"] == info["bwd_route"] == ("simt" if dtype == torch.float32
                                                  else "wgmma")
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
    """The bf16 forward and backward take the wgmma kernels at head sizes
    64 and 128 and mma.sync at the others (``bwd_route`` decides the
    backward's); f32 the exact SIMT kernels both ways. The wgmma library is
    built for every tile the plan picks at its head sizes (two heads of 64
    rows at 64, one of 128 rows at both), the wgmma backward's kernels fit
    two blocks an SM, and the mma.sync library builds neither direction
    there."""
    info = fa.kernel_info(d, torch.bfloat16)
    assert info["route"] == ("wgmma" if d in (64, 128) else "mma.sync")
    assert info["bwd_route"] == fa.bwd_route(d, torch.bfloat16)
    assert info["bwd_route"] == ("wgmma" if d in (64, 128) else "mma.sync")
    assert info["smem_fwd"] > 0 and info["smem_dkdv"] > 0 and info["smem_dq"] > 0
    mma = (ctypes.c_int * 3)()
    assert fa._library().flash_attention_info(d, 1, mma) == 0
    if info["route"] == "wgmma":
        assert info["stages"] >= 2 and info["threads"] == 384
        want = {(128, 1), (64, 2)} if d == 64 else {(128, 1)}
        assert set(info["tiles"]) == want and all(0 < b <= 232448
                                                  for b in info["tiles"].values())
        assert mma[0] == 0
    if info["bwd_route"] == "wgmma":
        assert info["bwd_stages"] >= 2 and info["bwd_threads"] == 128
        assert 2 * (max(info["smem_dkdv"], info["smem_dq"]) + 1024) <= 233472
        assert mma[1] == mma[2] == 0
    info = fa.kernel_info(d, torch.float32)
    assert info["route"] == info["bwd_route"] == "simt"


def test_wgmma_launch_with_a_bad_plan_raises(card, monkeypatch):
    """A wgmma launch whose plan the library does not take (a box TMA
    refuses, a map whose strides TMA refuses, a tile the library has no
    kernel for) raises: nothing gives way to the mma.sync forward or the
    plain version, and no launch is counted."""
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(4, 61, 512, generator=gen).to(torch.bfloat16).to(card)
               for _ in range(3))
    bias = torch.zeros(4, 61, device=card)
    good = fa.wgmma_plan

    def refuse(*_a, **_k):
        raise AssertionError("the forward gave way to another kernel")

    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    monkeypatch.setattr(fa, "_library", refuse)
    q_map = lambda bad: lambda p: dict(p, q_map=bad(p["q_map"]))  # noqa: E731
    for bad in (q_map(lambda m: dict(m, box=(m["box"][0], 512) + m["box"][2:])),
                q_map(lambda m: dict(m, strides=(m["strides"][0] + 8,) + m["strides"][1:])),
                lambda p: dict(p, tile=(p["tile"][0], 3))):
        def plan(*args, bad=bad):
            return bad(good(*args))

        monkeypatch.setattr(fa, "wgmma_plan", plan)
        before = fa.flash_attention_fwd.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.flash_attention_fwd(q, k, v, bias, 0.125, 8)
        assert fa.flash_attention_fwd.launches == before


# (H, D, length, padded): the 4-head shapes at head sizes 64 and 128, and at
# the 8-head models' head size 64 an utterance whose wgmma tile differs from
# its padded batch's (alone two heads of 64 rows, in the batch one head of
# 128; and the reverse)
BATCH_INVARIANCE = ([(4, d, length, padded) for d in (64, 128)
                     for length, padded in ((200, 750), (129, 250), (61, 81), (1, 128))]
                    + [(8, 64, 61, 250), (8, 64, 61, 81), (8, 64, 100, 192),
                       (8, 64, 250, 320)])


@pytest.mark.parametrize("row", [0, 37])
@pytest.mark.parametrize("h,d,length,padded", BATCH_INVARIANCE)
def test_flash_utterance_alone_equals_its_row_in_a_padded_batch(card, row, h, d, length,
                                                                 padded):
    """An utterance's out and lse alone equal its row, bit for bit, inside a
    padded batch of 64 (longer Sq and Sk, its keys past its length masked,
    the other rows random): the key tiles start at key 0 and have one width
    for every shape and both wgmma tiles, and masked keys add exact zeros,
    so `translate` of a few utterances gives the bits `test` gives them in
    a full batch, whichever tile each shape takes."""
    if h == 8:
        assert fa.wgmma_tile(d, length, h) != fa.wgmma_tile(d, padded, h)
    gen = torch.Generator().manual_seed(row + length)
    alone_q, alone_k, alone_v = (torch.randn(1, length, h * d, generator=gen)
                                 .to(torch.bfloat16).to(card) for _ in range(3))
    batch = [torch.randn(64, padded, h * d, generator=gen).to(torch.bfloat16).to(card)
             for _ in range(3)]
    for t, a in zip(batch, (alone_q, alone_k, alone_v)):
        t[row, :length] = a[0]
    lengths = torch.randint(1, padded + 1, (64,), generator=gen)
    lengths[row] = length
    bias = torch.where(torch.arange(padded)[None, :] < lengths[:, None], 0.0, -1e9)
    sm = d ** -0.5
    out, lse = fa.flash_attention_fwd(alone_q, alone_k, alone_v,
                                      torch.zeros(1, length, device=card), sm, h)
    b_out, b_lse = fa.flash_attention_fwd(*batch, bias.float().to(card), sm, h)
    assert torch.equal(out[0], b_out[row, :length])
    assert torch.equal(lse[0], b_lse[row, :length])


def test_wgmma_backward_with_a_bad_plan_raises(card, monkeypatch):
    """A wgmma backward whose plan the library does not take (a box TMA
    refuses, a map whose strides TMA refuses) raises: nothing gives way to
    the mma.sync backward or the plain version, and no launch is counted."""
    gen = torch.Generator().manual_seed(6)
    q, k, v, d_out = (torch.randn(4, 61, 512, generator=gen).to(torch.bfloat16).to(card)
                      for _ in range(4))
    bias = torch.zeros(4, 61, device=card)
    out, lse = fa.flash_attention_fwd(q, k, v, bias, 0.125, 8)
    good = fa.wgmma_bwd_plan

    def refuse(*_a, **_k):
        raise AssertionError("the backward gave way to another kernel")

    monkeypatch.setattr(fa, "flash_attention_bwd_plain", refuse)
    monkeypatch.setattr(fa, "_library", refuse)
    k_map = lambda bad: lambda p: dict(p, k_map=bad(p["k_map"]))  # noqa: E731
    for bad in (k_map(lambda m: dict(m, box=(m["box"][0], 512) + m["box"][2:])),
                k_map(lambda m: dict(m, strides=(m["strides"][0] + 8,) + m["strides"][1:]))):
        def plan(*args, bad=bad):
            return bad(good(*args))

        monkeypatch.setattr(fa, "wgmma_bwd_plan", plan)
        before = fa.flash_attention_bwd.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.flash_attention_bwd(q, k, v, bias, out, lse, d_out, 0.125, 8)
        assert fa.flash_attention_bwd.launches == before


# (H, D, length, padded) of the backward's batch invariance: the 4-head
# shapes at head size 128 and the 8-head models' head size 64, an utterance
# a block (64 rows) or several, alone shorter than a tile or not
BWD_BATCH_INVARIANCE = ([(4, 128, length, padded) for length, padded in
                         ((200, 750), (129, 250), (61, 81), (1, 128))]
                        + [(8, 64, 61, 250), (8, 64, 250, 320), (8, 64, 47, 250)])


@pytest.mark.parametrize("row", [0, 37])
@pytest.mark.parametrize("h,d,length,padded", BWD_BATCH_INVARIANCE)
def test_flash_backward_utterance_alone_equals_its_row_in_a_padded_batch(
        card, row, h, d, length, padded):
    """An utterance's dq, dk and dv alone equal its row's, bit for bit,
    inside a padded batch of 64 (longer Sq and Sk, its keys past its length
    masked, the output gradient of its padded queries zero as a masked loss
    gives it, the other rows random): the wgmma backward's key and query
    tiles start at 0 and are 64 wide for every shape, and masked keys and
    padded queries add exact zeros."""
    assert fa.bwd_route(d, torch.bfloat16) == "wgmma"
    gen = torch.Generator().manual_seed(row + length)
    alone = [torch.randn(1, length, h * d, generator=gen).to(torch.bfloat16).to(card)
             for _ in range(4)]  # q, k, v, d_out
    batch = [torch.randn(64, padded, h * d, generator=gen).to(torch.bfloat16).to(card)
             for _ in range(4)]
    for t, a in zip(batch, alone):
        t[row, :length] = a[0]
    batch[3][row, length:] = 0  # no gradient reaches the padded queries
    lengths = torch.randint(1, padded + 1, (64,), generator=gen)
    lengths[row] = length
    bias = torch.where(torch.arange(padded)[None, :] < lengths[:, None], 0.0, -1e9)
    bias = bias.float().to(card)
    sm = d ** -0.5
    q, k, v, d_out = alone
    zero = torch.zeros(1, length, device=card)
    out, lse = fa.flash_attention_fwd(q, k, v, zero, sm, h)
    grads = fa.flash_attention_bwd(q, k, v, zero, out, lse, d_out, sm, h)
    b_out, b_lse = fa.flash_attention_fwd(*batch[:3], bias, sm, h)
    b_grads = fa.flash_attention_bwd(*batch[:3], bias, b_out, b_lse, batch[3], sm, h)
    for name, g, bg in zip(("dq", "dk", "dv"), grads, b_grads):
        assert torch.equal(g[0], bg[row, :length]), name


@pytest.mark.parametrize("b,sq,sk,h,d,rate", [
    (64, 250, 250, 4, 128, 0.1), (64, 47, 250, 4, 128, 0.1), (2, 750, 750, 4, 128, 0.1),
    (192, 61, 61, 4, 128, 0.0), (64, 250, 250, 8, 64, 0.1), (192, 61, 61, 8, 64, 0.1),
    (192, 61, 61, 4, 16, 0.1)])
def test_flash_backward_writes_every_output_over_poisoned_memory(card, b, sq, sk, h, d,
                                                                 rate):
    """The bf16 backward at phase 2's shapes (row 0 with every key masked,
    the others of random lengths) with its outputs and its delta scratch
    allocated from memory the caching allocator hands back full of NaN and
    inf: every dq, dk and dv entry written and finite, within the plain
    version's tolerance, ten calls bit-identical. An output the kernels left
    unwritten, or a read of memory they did not write first, shows as a
    non-finite value here. The wgmma backward at head sizes 128 and 64, and
    the mma.sync backward that remains (head size 16)."""
    assert fa.bwd_route(d, torch.bfloat16) == ("wgmma" if d in (64, 128) else "mma.sync")
    gen = torch.Generator().manual_seed(2)
    q, d_out = (torch.randn(b, sq, h * d, generator=gen).to(torch.bfloat16).to(card)
                for _ in range(2))
    k, v = (torch.randn(b, sk, h * d, generator=gen).to(torch.bfloat16).to(card)
            for _ in range(2))
    valid = torch.arange(sk)[None, :] < torch.randint(sk // 2, sk + 1, (b,),
                                                      generator=gen)[:, None]
    valid[0] = False
    bias = torch.where(valid, 0.0, -1e9).float().to(card)
    seed = torch.tensor([99], dtype=torch.int32, device=card)
    sm = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, sm, h, rate, seed)
    refs = fa.flash_attention_bwd_plain(q, k, v, bias, out, lse, d_out, sm, h, rate, seed)
    first = None
    for i in range(10):
        poison = torch.full((64 << 20,), float("nan") if i % 2 else float("inf"),
                            device=card)
        del poison  # its blocks go back to the allocator, still poisoned
        grads = fa.flash_attention_bwd(q, k, v, bias, out, lse, d_out, sm, h, rate, seed)
        torch.cuda.synchronize()
        for name, g in zip(("dq", "dk", "dv"), grads):
            assert torch.isfinite(g.float()).all(), (i, name)
        if first is None:
            first = [g.clone() for g in grads]
            for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
                assert _rel_err(g, r) <= 2e-2, (name, _rel_err(g, r))
        assert all(torch.equal(g, f) for g, f in zip(grads, first)), i


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


def own_rows(b, k, s, device):
    """The (B, K, S) map of beams that read only their own rows."""
    return torch.arange(k, dtype=torch.int32, device=device)[None, :, None].expand(
        b, k, s).contiguous()


@pytest.mark.parametrize("mode", ["f32", "bf16", "channel", "position"])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("s", [1, 61, 65, 250, 750])
@pytest.mark.parametrize("b,h,group", [(1, 4, 5), (3, 2, 2), (32, 4, 5), (128, 4, 5)])
def test_decode_kernel_group_matches_expanded_cache(card, mode, d, s, b, h, group):
    """``group`` G query rows a cache row (the beam-shared cross cache), on
    the multi-query kernel: bit for bit its ancestry mode over the cache,
    bias and scales repeated G times with each query reading its own row
    (the same grid, plan and arithmetic; only the rows differ) -- except
    with "channel" scales, which the ancestry mode does not take -- within
    the tolerances above of the plain version, and two calls bit-identical."""
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
        before = da.decode_attention.group_launches
        out = da.decode_attention(q, k, v, bias, ks, vs, group=group, **kw)
        again = da.decode_attention(q, k, v, bias, ks, vs, group=group, **kw)
        assert da.decode_attention.group_launches == before + 2
        ref = da.decode_attention_plain(q, k, v, bias, ks, vs, group=group, **kw)
        if mode != "channel":
            flat = da.decode_attention(q, *map(expand, (k, v, bias, ks, vs)),
                                       ancestry=own_rows(b, group, s, card), **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"{kind}: two calls differ"
        if mode != "channel":
            assert torch.equal(out, flat), f"{kind}: group {group} differs from the " \
                "ancestry mode on the expanded cache"
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0,
                                   msg=lambda m, kind=kind: f"{kind}: {m}")


def test_decode_group_1_takes_the_one_query_kernel(card):
    """``group`` 1 without a map, through the wrapper, launches the
    one-query kernel with decode_plan's plan over all S rows: bit for bit a
    direct launch of it, and no group launch counted."""
    gen = torch.Generator(device=card).manual_seed(9)
    for mode in ("f32", "bf16", "channel", "position"):
        qdt = torch.float32 if mode == "f32" else torch.bfloat16
        q = torch.randn(32, 4, 128, generator=gen, device=card).to(qdt)
        kf, vf = (torch.randn(32, 4, 97, 128, generator=gen, device=card) for _ in range(2))
        k, v, ks, vs = decode_caches(mode, kf, vf, qdt)
        layout = mode if ks is not None else None
        bias = torch.where(decode_valid("cross_tail", 32, 97, torch.Generator().manual_seed(10))
                           .to(card), 0.0, -1e9).float()
        grid = da.launch_grid(32, 4, 97, da.num_sms(q.device))
        assert grid["kernel"] == "one-query"
        before = da.decode_attention.group_launches
        out = da.decode_attention(q, k, v, bias, ks, vs, sm_scale=0.1, scale_layout=layout,
                                  group=1)
        assert da.decode_attention.group_launches == before
        direct = torch.empty_like(out)
        assert da._launch(q, k, v, bias, ks, vs, direct, layout,
                          da.decode_plan(32, 4, 97, da.num_sms(q.device)), 0.1) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, direct), mode


def random_ancestry(b, k, s, index, gen, device):
    """A (B, K, S) int32 map as lazy beam search keeps it: entries in
    [0, K) up to ``index``, each row's own index beyond it."""
    anc = torch.randint(0, k, (b, k, s), generator=gen, dtype=torch.int32)
    anc[:, :, index + 1:] = torch.arange(k, dtype=torch.int32)[None, :, None]
    return anc.to(device)


@pytest.mark.parametrize("mode", ["f32", "bf16", "position"])
@pytest.mark.parametrize("d", [16, 64, 128, 192, 256])
@pytest.mark.parametrize("s", [1, 31, 97, 250])
@pytest.mark.parametrize("b,k,h", [(1, 5, 4), (3, 2, 2), (32, 5, 4)])
def test_decode_kernel_ancestry_matches_reordered_cache(card, mode, d, s, b, k, h):
    """The ancestry-map mode (lazy beam search's self-attention): bit for
    bit the ancestry mode over the caches physically reordered as the map
    says (``gather_ancestry``) with each query reading its own row (the
    same grid, plan and arithmetic; only the rows differ), with and without
    ``slots`` at the step, and within the tolerances above of the plain
    version, under each mask kind with the map valid up to step S // 2 (the
    self-attention step) and beyond; a map whose K entries all name one row
    (beams not yet diverged); entries outside [0, K) read as clamped into
    it, so no row of another utterance is read; a launch counts in
    ``ancestry_launches``."""
    gen = torch.Generator(device=card).manual_seed(7)
    cpu_gen = torch.Generator().manual_seed(8)
    qdt = torch.float32 if mode == "f32" else torch.bfloat16
    rows = b * k
    q = torch.randn(rows, h, d, generator=gen, device=card).to(qdt)
    kf, vf = (torch.randn(rows, h, s, d, generator=gen, device=card) for _ in range(2))
    kc, vc, ks, vs = decode_caches(mode, kf, vf, qdt)
    kw = dict(sm_scale=d ** -0.5, scale_layout=mode if ks is not None else None)
    tol = 1e-5 if qdt == torch.float32 else 1e-2
    own = own_rows(b, k, s, card)
    for kind in DECODE_MASKS:
        bias = torch.where(decode_valid(kind, rows, s, cpu_gen).to(card), 0.0, -1e9).float()
        for index in (s // 2, s - 1):
            anc = random_ancestry(b, k, s, index, cpu_gen, card)
            one = anc.clone()
            one[:, :, :index + 1] = torch.randint(0, k, (b, 1, index + 1), generator=cpu_gen,
                                                  dtype=torch.int32).to(card)
            for slots in (None, index + 1):
                for name, m in (("map", anc), ("one row", one)):
                    before = da.decode_attention.ancestry_launches
                    out = da.decode_attention(q, kc, vc, bias, ks, vs, ancestry=m, slots=slots,
                                              **kw)
                    assert da.decode_attention.ancestry_launches == before + 1
                    moved = [None if t is None else da.gather_ancestry(t, m).contiguous()
                             for t in (kc, vc, ks, vs)]
                    flat = da.decode_attention(q, *moved[:2], bias, *moved[2:], ancestry=own,
                                               slots=slots, **kw)
                    ref = da.decode_attention_plain(q, kc, vc, bias, ks, vs, ancestry=m,
                                                    slots=slots, **kw)
                    torch.cuda.synchronize()
                    assert torch.equal(out, flat), \
                        f"{kind} {index} {name} {slots}: differs from the reordered cache"
                    torch.testing.assert_close(
                        out.float(), ref.float(), atol=tol, rtol=0,
                        msg=lambda msg, kind=kind, name=name: f"{kind} {name}: {msg}")
            wild = anc + torch.where(anc % 2 == 0, -7 * k, 9 * k).to(torch.int32)
            clamped = wild.clamp(0, k - 1)
            out_w = da.decode_attention(q, kc, vc, bias, ks, vs, ancestry=wild, **kw)
            out_c = da.decode_attention(q, kc, vc, bias, ks, vs, ancestry=clamped, **kw)
            assert torch.equal(out_w, out_c), f"{kind}: an entry outside [0, K) is not clamped"


@pytest.mark.parametrize("mode", ["f32", "bf16", "channel", "position"])
@pytest.mark.parametrize("d", [16, 128, 256])
@pytest.mark.parametrize("s", [17, 97])
@pytest.mark.parametrize("queries", [5, 10])
def test_decode_multi_query_every_plan(card, mode, d, s, queries):
    """Every plan the multi-query kernel takes (1-16 splits of any length,
    up to 16 blocks of the largest shared-memory rings a cluster), in group
    mode and (but with "channel" scales) through a map, at 5 queries a block
    and at 10 (two chunks), under every mask kind, against the plain
    version with the tolerances above; the C entry point refuses the plans
    it does not take."""
    gen = torch.Generator(device=card).manual_seed(11)
    mask_gen = torch.Generator().manual_seed(12)
    b, h = 2, 2
    qdt = torch.float32 if mode == "f32" else torch.bfloat16
    layout = None if mode in ("f32", "bf16") else mode
    sm_scale, tol = d ** -0.5, (1e-5 if qdt == torch.float32 else 1e-2)
    q = torch.randn(b * queries, h, d, generator=gen, device=card).to(qdt)
    for ancestry in ((False, True) if mode != "channel" else (False,)):
        rows = b * queries if ancestry else b
        kf, vf = (torch.randn(rows, h, s, d, generator=gen, device=card) for _ in range(2))
        k, v, ks, vs = decode_caches(mode, kf, vf, qdt)
        anc = random_ancestry(b, queries, s, s - 1, torch.Generator().manual_seed(13), card) \
            if ancestry else None
        group = 1 if ancestry else queries
        for kind in DECODE_MASKS:
            bias = torch.where(decode_valid(kind, rows, s, mask_gen).to(card), 0.0,
                               -1e9).float()
            ref = da.decode_attention_plain(q, k, v, bias, ks, vs, sm_scale=sm_scale,
                                            scale_layout=layout, group=group, ancestry=anc)
            for plan in legal_plans(s):
                out = torch.full_like(ref, float("nan"))
                assert da._launch(q, k, v, bias, ks, vs, out, layout, plan, sm_scale, group,
                                  anc) == 0, plan
                torch.testing.assert_close(
                    out.float(), ref.float(), atol=tol, rtol=0,
                    msg=lambda m, kind=kind, plan=plan: f"{kind} {plan} {ancestry}: {m}")
        out = torch.empty_like(ref)
        for plan in [(0, s), (17, 1), (1, 0), (1, s - 1), (2, s)]:
            assert da._launch(q, k, v, bias, ks, vs, out, layout, plan, sm_scale, group,
                              anc) == 1, plan


def test_decode_kernel_ancestry_refuses_what_it_does_not_take(card):
    """A map that is not int32, not contiguous, of the wrong shape, beside
    ``group`` > 1 or "channel" scales, or at a head size the kernel is not
    built for, raises before a launch."""
    q = torch.randn(6, 2, 64, device=card)
    c = torch.randn(6, 2, 9, 64, device=card)
    bias = torch.zeros(6, 9, device=card)
    anc = torch.zeros(2, 3, 9, dtype=torch.int32, device=card)
    bad = [dict(ancestry=anc.long()), dict(ancestry=anc.transpose(1, 2).contiguous()),
           dict(ancestry=torch.zeros(2, 3, 9, 2, dtype=torch.int32, device=card)[..., 0]),
           dict(ancestry=anc[:1])]
    for kwargs in bad:
        with pytest.raises(ValueError):
            da.decode_attention(q, c, c, bias, **kwargs)
    with pytest.raises(ValueError):
        da.decode_attention(q.repeat(2, 1, 1), c, c, bias, ancestry=anc, group=2)
    q2 = torch.randn(6, 2, 32, device=card)
    c2 = torch.randn(6, 2, 9, 32, device=card)
    with pytest.raises(ValueError):
        da.decode_attention(q2, c2, c2, bias, ancestry=anc)


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


def _same_update(a, b, grad_tol: float):
    """Loss to 1e-5 relative, gradients to ``grad_tol`` of the global norm,
    weights to 2 lr (Adam's first step moves a weight by lr at most; CTC's
    atomics make the card's backward non-deterministic)."""
    assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    for name in b["grads"]:
        err = (a["grads"][name] - b["grads"][name]).abs().max().item()
        assert err <= grad_tol * b["grad_norm"], name
        err = (a["params"][name] - b["params"][name]).abs().max().item()
        assert err <= 2 * b["lr"], name


def test_one_rank_nccl_update_matches_plain(card):
    """The update of a one-rank NCCL group (DDP, its summing comm hook, the
    ranks' host exchange) equals the plain update on the card."""
    import socket

    import torch.distributed as dist

    from joeys2t_torch.parallel import distributed
    from test_torch_train import one_update

    plain = one_update(card)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        ranked = one_update(card)
    finally:
        distributed.leave()
    _same_update(ranked, plain, 1e-4)


def test_remat_on_the_card_equals_no_remat(card):
    """One update at dropout 0.1 with ``remat`` and without, from the same
    seeds: the recomputation replays the dropout masks and the flash seeds."""
    from test_torch_train import model_cfg, one_update

    before = fa.flash_attention_fwd.launches
    plain = one_update(card, cfg=model_cfg(dropout=0.1))
    between = fa.flash_attention_fwd.launches
    remat = one_update(card, cfg=dict(model_cfg(dropout=0.1), remat=True))
    # 3 layers' flash forward a micro-batch, twice under remat
    assert fa.flash_attention_fwd.launches - between == 2 * (between - before)
    _same_update(remat, plain, 1e-5)


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


# ---------------------------------------------------------------- beam top-k

NEG_INF = -1e9


def _same_bits(got, want):
    """Values bit for bit (NaN payloads and the sign of zero included) and
    indices equal."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[want[0].dtype]
    assert got[0].dtype == want[0].dtype and got[1].dtype == torch.long
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert torch.equal(got[0].contiguous().view(ints).cpu(), want[0].contiguous().view(ints).cpu())
    assert torch.equal(got[1].cpu(), want[1].cpu())


def beam_scores(rows, beams, vocab, dtype, device, seed):
    """A beam step's scores: each beam's log-probabilities plus its score,
    three ids banned at NEG_INF, and in the first half of the rows only beam
    0 alive (the others at NEG_INF, a plateau in float32)."""
    gen = torch.Generator(device).manual_seed(seed)
    lp = torch.log_softmax(torch.randn(rows * beams, vocab, generator=gen, device=device) * 3,
                           dim=-1).to(dtype)
    lp[:, :3] = NEG_INF
    beam = -(torch.rand(rows, beams, generator=gen, device=device).to(dtype) * 4).cumsum(-1)
    beam[: rows // 2, 1:] = NEG_INF
    return (lp.reshape(rows, beams, vocab) + beam[..., None]).reshape(rows, beams * vocab)


def _random_rows(rows, n, dtype, device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    return (torch.randn(rows, n, generator=gen, device=device) * 3).to(dtype)


# (rows, beams, vocab, k): the translation cell's step (3,004 sentences, beam
# 5 over 32,000 ids), the 960h recipe's beam 20 over 10,000 ids, the published
# test batch of 36 sentences (fewer rows than SMs), the finished store's 2k-wide rows
TOPK_BEAM_SHAPES = [(3004, 5, 32000, 5), (256, 20, 10000, 20), (36, 5, 32000, 5),
                    (3004, 2, 5, 5)]
# (rows, n, k): k = 1, k = n, rows shorter than a warp, a row of one entry,
# many rows of one vector, few long rows, rows fewer than the SMs, one long row
TOPK_SHAPES = [(300, 4099, 1), (70, 32, 32), (50, 7, 7), (33, 9, 3), (9, 1, 1), (500, 4, 2),
               (8, 300000, 32), (200, 20000, 5), (1, 1000003, 17)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,beams,vocab,k", TOPK_BEAM_SHAPES)
def test_topk_kernel_matches_stable_sort_on_beam_scores(card, dtype, rows, beams, vocab, k):
    from joeys2t_torch.ops import topk as tk

    x = beam_scores(rows, beams, vocab, dtype, card, seed=rows + k)
    _same_bits(tk.stable_topk(x, k), tk.stable_topk_plain(x, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,n,k", TOPK_SHAPES)
def test_topk_kernel_matches_stable_sort(card, dtype, rows, n, k):
    from joeys2t_torch.ops import topk as tk

    x = _random_rows(rows, n, dtype, card, seed=n + k)
    _same_bits(tk.stable_topk(x, k), tk.stable_topk_plain(x, k))
    _same_bits(tk.stable_topk(x, k), tk.stable_topk_plain(x.cpu(), k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("rows,n,k", [(64, 4099, 5), (36, 160000, 5), (3004, 10, 5)])
def test_topk_kernel_on_misaligned_rows(card, dtype, offset, rows, n, k):
    """A view whose rows start off the 16-byte grid, each row at another
    offset (the row stride is n + offset): scalar heads and tails."""
    from joeys2t_torch.ops import topk as tk

    x = _random_rows(rows, n + offset, dtype, card, seed=offset)[:, offset:]
    assert x.stride(0) == n + offset and x.stride(1) == 1
    _same_bits(tk.stable_topk(x, k), tk.stable_topk_plain(x, k))


def _adversarial(pattern, rows, n, dtype, seed):
    """Rows on the CPU that stress the order: ties, plateaus, infinities,
    signed zeros and NaN."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, n, generator=gen, dtype=torch.float64).to(dtype)
    pick = lambda m: torch.rand(rows, n, generator=gen).argsort(-1)[:, :m]  # noqa: E731
    if pattern == "equal":
        x.fill_(0.5)
    elif pattern == "ties_at_kth":  # 2 entries above a plateau of thousands
        x.scatter_(1, pick(max(3, min(3000, n // 2))), 7.0)
        x.scatter_(1, pick(2), 9.0)
    elif pattern == "neg_inf_plateau":  # fewer finite entries than k
        x.fill_(NEG_INF)
        x.scatter_(1, pick(2), -3.0)
    elif pattern == "minus_inf":
        x.fill_(-np.inf)
        x[: rows // 2].scatter_(1, pick(1)[: rows // 2], -1e30)
    elif pattern == "signed_zeros":  # +0.0 and -0.0 tie, in index order
        x = torch.where(torch.rand(rows, n, generator=gen) < 0.5, 0.0, -0.0).to(dtype)
        x.scatter_(1, pick(2), 1.0)
    elif pattern == "nan":  # more NaN than k, and in short rows fewer
        x.scatter_(1, pick(max(1, n // 50)), float("nan"))
    elif pattern == "negative_nan":  # NaN with the sign bit set ranks first too
        x.scatter_(1, pick(max(1, n // 50)), -float("nan"))
    return x


TOPK_PATTERNS = ["equal", "ties_at_kth", "neg_inf_plateau", "minus_inf", "signed_zeros",
                 "nan", "negative_nan"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pattern", TOPK_PATTERNS)
@pytest.mark.parametrize("rows,n,k", [(3, 100, 5), (300, 4099, 20), (4, 160000, 5),
                                      (280, 20000, 32)])
def test_topk_kernel_on_adversarial_rows(card, dtype, pattern, rows, n, k):
    """Bit for bit the plain version (the stable sort) on the CPU, and the
    card's own stable sort where the input has no NaN with its sign bit set
    (the card's radix sort orders those by their bits)."""
    from joeys2t_torch.ops import topk as tk

    x = _adversarial(pattern, rows, n, dtype, seed=rows + n)
    got = tk.stable_topk(x.to(card), k)
    _same_bits(got, tk.stable_topk_plain(x, k))
    if pattern != "negative_nan":
        _same_bits(got, tk.stable_topk_plain(x.to(card), k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_topk_kernel_writes_every_output_over_poisoned_memory(card, dtype):
    """The outputs are taken from memory just filled with a NaN payload no
    input holds and with index -7."""
    from joeys2t_torch.ops import topk as tk

    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[dtype]
    payload = 0x7FBADBAD if dtype == torch.float32 else 0x7FF0BADBADBADBAD
    for rows, n, k in [(3004, 10, 5), (36, 160000, 5), (5, 33, 32), (2, 300000, 20)]:
        x = _random_rows(rows, n, dtype, card, seed=k)
        want = tk.stable_topk_plain(x, k)
        for _ in range(2):
            poison = [torch.full((rows, k), payload, dtype=ints, device=card),
                      torch.full((rows, k), -7, dtype=torch.long, device=card)]
            del poison
            got = tk.stable_topk(x, k)
            torch.cuda.synchronize()
            _same_bits(got, want)


def test_topk_launch_counter(card):
    """One launch a call on the card, many rows or few, none for a CPU
    tensor."""
    from joeys2t_torch.ops import topk as tk

    many = _random_rows(3004, 640, torch.float32, card, seed=1)
    few = _random_rows(4, 160000, torch.float32, card, seed=2)
    before = tk.stable_topk.launches
    tk.stable_topk(many, 5)
    assert tk.stable_topk.launches == before + 1
    tk.stable_topk(few, 5)
    assert tk.stable_topk.launches == before + 2
    tk.stable_topk(few.cpu(), 5)
    assert tk.stable_topk.launches == before + 2


def test_topk_kernel_refuses_what_it_does_not_take(card):
    from joeys2t_torch.ops import topk as tk

    x = torch.randn(4, 40, device=card)
    bad = [(x, 41), (x, 33), (x, 0), (x.to(torch.int32), 5), (x.to(torch.bfloat16), 5),
           (x.t(), 3), (x[:, ::2], 5)]
    before = tk.stable_topk.launches
    for t, k in bad:
        with pytest.raises(ValueError):
            tk.stable_topk(t, k)
    assert tk.stable_topk.launches == before


def test_beam_search_with_topk_kernel_equals_plain_sort(card, monkeypatch):
    """A small speech transformer's beam search on the card (beam 5, 5-best,
    a vocabulary of 2 words: at the first steps fewer than 5 candidates are
    finite) gives the same hypotheses and scores with the kernel as with
    ``_stable_topk`` on the plain sort, and launches the kernel twice a step
    (the beams' selection and the finished store's merge)."""
    from joeys2t_torch import search
    from joeys2t_torch.ops import topk as tk

    cfg = {"encoder": {"num_layers": 2, "num_heads": 2, "embeddings": {},
                       "hidden_size": 128, "ff_size": 256, "subsample": True,
                       "conv_kernel_sizes": [5, 5], "conv_channels": 128,
                       "in_channels": 80},
           "decoder": {"num_layers": 2, "num_heads": 2, "hidden_size": 128,
                       "ff_size": 256, "embeddings": {"embedding_dim": 128, "scale": True},
                       "layer_norm": "pre"}}
    feats = torch.tensor(np.random.RandomState(8).randn(3, 120, 80).astype(np.float32))
    lengths = torch.tensor([120, 90, 41])
    outs = {}
    with torch.inference_mode():
        for words in (2, 60):
            vocab = Vocabulary([f"w{i}" for i in range(words)], SpecialSymbols())
            model, spec = build_model(cfg, trg_vocab=vocab, device=card,
                                      generator=torch.Generator().manual_seed(9))
            enc, _, mask = model.encode(feats.to(card), lengths.to(card))
            for name in ("kernel", "plain"):
                if name == "plain":
                    monkeypatch.setattr(search, "_stable_topk", tk.stable_topk_plain)
                stats, before = {}, tk.stable_topk.launches
                out = beam_search(model, spec, enc, None, mask, 5, 12, 1.0, n_best=5,
                                  device=card, return_prob="hyp", stats=stats)
                launches = tk.stable_topk.launches - before
                outs[words, name] = out[:2]
                assert launches == (2 * stats["decode_steps"] if name == "kernel" else 0)
                monkeypatch.undo()
            np.testing.assert_array_equal(outs[words, "kernel"][0], outs[words, "plain"][0])
            np.testing.assert_array_equal(outs[words, "kernel"][1], outs[words, "plain"][1])
