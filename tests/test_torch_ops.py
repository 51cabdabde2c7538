# coding: utf-8
"""The port's kernel modules on the CPU against the JAX package: the plain
versions of the flash-attention forward and backward and of decode attention
(what the wrappers run on CPU tensors; the CUDA kernels are held against
them on the card by chip_smoke.py and tests/test_torch_cuda.py), the
attention-dropout bits, and the device front end (fbank + CMVN).

Inputs come from numpy with a fixed seed and go through both packages. The
Pallas kernels run in interpret mode, as the JAX package's own tests run
them."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from joeys2t_torch.ops import decode_attention as port_da
from joeys2t_torch.ops import flash_attention as port_fa
from joeys2t_torch.ops.frontend import device_frontend as port_frontend
from joeys2t_tpu.models.modules import MultiHeadedAttention as JaxMHA
from joeys2t_tpu.ops import decode_attention as jax_da
from joeys2t_tpu.ops import flash_attention as jax_fa
from joeys2t_tpu.ops.frontend import device_frontend as jax_frontend

NEG_INF = -1e9


def _key_bias(rng, b, sk, all_masked_row=True):
    lengths = rng.randint(1, sk + 1, size=(b,))
    valid = np.arange(sk)[None, :] < lengths[:, None]
    if all_masked_row:
        valid[0] = False  # every key of row 0 masked: uniform over its keys
    return np.where(valid, 0.0, NEG_INF).astype(np.float32)


# ------------------------------------------------------------ flash forward
@pytest.mark.parametrize("sq,sk,heads,dim", [(40, 70, 2, 64), (20, 600, 1, 64)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_flash_plain_matches_pallas(sq, sk, heads, dim, dtype, tol):
    """Ragged Sk (not a multiple of any block), the all-masked-keys row, and
    Sk > 512, where the TPU package takes its (B, H, S, D) kernel."""
    rng = np.random.RandomState(0)
    b, e = 2, heads * dim
    # small scores keep the all-masked row exactly uniform in f32 (-1e9 + s
    # rounds to -1e9 for |s| < 32) on both sides
    q, k, v = (0.5 * rng.randn(b, s, e).astype(np.float32) for s in (sq, sk, sk))
    bias = _key_bias(rng, b, sk)
    sm = 1.0 / np.sqrt(dim)
    jdt = jnp.dtype(dtype)
    out_j, res = jax_fa._flash_fwd(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                   jnp.asarray(v, jdt), jnp.asarray(bias), sm, heads,
                                   0.0, None)
    lse_j = np.asarray(res[-1], np.float32)
    lse_j = (lse_j[:, :sq] if lse_j.ndim == 3
             else lse_j[:, :, :sq, 0].transpose(0, 2, 1))  # (B, Sq, H)
    tdt = getattr(torch, dtype)
    out_t, lse_t = port_fa.flash_attention_fwd(
        torch.tensor(q).to(tdt), torch.tensor(k).to(tdt), torch.tensor(v).to(tdt),
        torch.tensor(bias), sm, heads)
    assert out_t.dtype == tdt and lse_t.shape == (b, sq, heads)
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=tol, rtol=tol)
    # the all-masked row averages v uniformly over the keys
    uniform = torch.tensor(v).to(tdt).float()[0].mean(0)
    np.testing.assert_allclose(out_t[0].float().numpy(),
                               np.broadcast_to(uniform.numpy(), (sq, e)),
                               atol=max(tol, 1e-5))


def test_flash_wrapper_on_cpu_runs_plain_version():
    rng = np.random.RandomState(1)
    q, k, v = (torch.tensor(rng.randn(2, 9, 128).astype(np.float32)) for _ in range(3))
    valid = torch.tensor(rng.rand(2, 9) > 0.3)
    valid[:, 0] = True
    before = port_fa.flash_attention_fwd.launches
    out = port_fa.mha_flash_flat(q, k, v, 2, valid, 0.125)
    ref, _ = port_fa.flash_attention_plain(q, k, v, port_fa.key_bias(valid, 2, 9, q.device),
                                           0.125, 2)
    assert torch.equal(out, ref)
    assert port_fa.flash_attention_fwd.launches == before  # no kernel on the CPU


def test_flash_dropout_raises_on_every_device():
    """Dropout needs a seed on every device (it never falls back to torch's
    global generator); with one, the same seed drops the same
    probabilities and another seed others."""
    q = torch.zeros(1, 4, 128)
    with pytest.raises(ValueError, match="seed"):
        port_fa.flash_attention_fwd(q, q, q, torch.zeros(1, 4), 0.125, 2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="generator"):
        port_fa.mha_flash_flat(q, q, q, 2, None, 0.125, dropout_rate=0.1)
    rng = np.random.RandomState(2)
    q, k, v = (torch.tensor(rng.randn(2, 30, 128).astype(np.float32)) for _ in range(3))
    bias = torch.zeros(2, 30)
    seed = torch.tensor([99], dtype=torch.int32)
    out1, lse1 = port_fa.flash_attention_fwd(q, k, v, bias, 0.125, 2, 0.3, seed)
    out2, lse2 = port_fa.flash_attention_fwd(q, k, v, bias, 0.125, 2, 0.3, seed.clone())
    out3, _ = port_fa.flash_attention_fwd(q, k, v, bias, 0.125, 2, 0.3, seed + 1)
    ref, lse0 = port_fa.flash_attention_fwd(q, k, v, bias, 0.125, 2)
    assert torch.equal(out1, out2) and not torch.equal(out1, out3)
    assert torch.equal(lse1, lse0)  # dropout leaves the softmax statistics alone
    assert (out1 - ref).abs().max() > 1e-3
    # mha_flash_flat draws its seed from the caller's generator only
    a = port_fa.mha_flash_flat(q, k, v, 2, None, 0.125, 0.3, torch.Generator().manual_seed(5))
    b = port_fa.mha_flash_flat(q, k, v, 2, None, 0.125, 0.3, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


@pytest.mark.parametrize("d,dtype,want", [
    (16, torch.bfloat16, "mma.sync"), (64, torch.bfloat16, "wgmma"),
    (128, torch.bfloat16, "wgmma"), (192, torch.bfloat16, "mma.sync"),
    (256, torch.bfloat16, "mma.sync")] + [(d, torch.float32, "simt")
                                          for d in (16, 64, 128, 192, 256)])
def test_flash_route(d, dtype, want):
    """The forward's kernel for each (head dim, dtype): the wgmma kernel for
    bf16 at head dims 64 and 128, mma.sync for the other bf16 head dims,
    the exact SIMT kernels for f32; anything else is refused."""
    assert port_fa.route(d, dtype) == want
    with pytest.raises(ValueError, match="head_dim"):
        port_fa.route(d + 8, dtype)
    with pytest.raises(ValueError, match="head_dim"):
        port_fa.route(d, torch.float16)


# (B, Sq, Sk, H, D): the 4-head 128-wide models' speech and MT shapes and
# the tile edges; the 8-head 64-wide models' (mustc_*, wmt17_ende_*) speech
# and MT shapes, and an odd head count whose last head pair has one head
WGMMA_PLANS = [(64, 250, 250, 4, 128), (2, 750, 750, 4, 128), (64, 750, 750, 4, 128),
               (192, 61, 61, 4, 128), (192, 81, 61, 4, 128), (1, 1, 1, 1, 128),
               (3, 129, 1125, 2, 128), (8, 127, 128, 3, 128),
               (192, 61, 61, 8, 64), (192, 81, 61, 8, 64), (64, 250, 250, 8, 64),
               (64, 750, 750, 8, 64), (2, 750, 750, 8, 64), (192, 61, 61, 3, 64),
               (3, 129, 65, 8, 64), (1, 64, 64, 1, 64)]


@pytest.mark.parametrize("b,sq,sk,h,d", WGMMA_PLANS)
def test_wgmma_plan(b, sq, sk, h, d):
    """The wgmma forward's launch held to the tensors' own layout: each map
    (D, S, H, B) with byte strides that address the element a (B, S, H, D)
    view holds, boxes of 64 columns (the 128-byte swizzle row) x the tile's
    rows (q) or 128 key rows (k, v) x the tile's heads x 1 batch row,
    q-tiles that cover Sq and no tile beyond it, one tile a (q-tile, head
    group, batch row), a persistent grid of at most one block an SM; the key
    tiles are 128 rows whatever the shape and tile. The tile is
    :func:`wgmma_tile`'s: two heads of 64 rows at head dim 64 with H >= 2
    and Sq % 128 in 1..64, else one head of 128 rows."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(b, sq, h * d, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(b, sk, h * d, generator=gen).to(torch.bfloat16) for _ in range(2))
    rows, heads = port_fa.wgmma_tile(d, sq, h)
    pair = d == 64 and h >= 2 and 0 < sq % 128 <= 64
    assert (rows, heads) == ((64, 2) if pair else (128, 1))
    for sms in (16, 132):
        plan = port_fa.wgmma_plan(q, k, v, h, sms)
        assert plan["tile"] == (rows, heads)
        for name, t, box_rows in (("q_map", q, rows), ("k_map", k, port_fa.WGMMA_BK),
                                  ("v_map", v, port_fa.WGMMA_BK)):
            m = plan[name]
            assert m["dims"] == (d, t.shape[1], h, b)
            assert m["box"] == (port_fa.WGMMA_BOX_COLS, box_rows, heads, 1)
            assert m["box"][0] * t.element_size() == 128 and m["box"][1] <= 256
            size = t.element_size()
            assert m["strides"] == tuple(size * x for x in (t.stride(1), d, t.stride(0)))
            flat, split = t.reshape(-1), t.reshape(b, t.shape[1], h, d)
            for i in range(8):  # random elements, addressed through the map
                at = [int(torch.randint(n, (1,), generator=gen)) for n in m["dims"]]
                off = at[0] * size + sum(c * st for c, st in zip(at[1:], m["strides"]))
                assert torch.equal(flat[off // size], split[at[3], at[1], at[2], at[0]])
        q_tiles = plan["q_tiles"]
        assert (q_tiles - 1) * rows < sq <= q_tiles * rows
        assert plan["tiles"] == q_tiles * -(-h // heads) * b
        assert plan["grid"] == min(plan["tiles"], sms)
    assert port_fa.WGMMA_BK == 128 and port_fa.WGMMA_BQ == 128
    assert port_fa.WGMMA_BQ_PAIR == 64


@pytest.mark.parametrize("sq", [1, 61, 64, 65, 81, 127, 128, 129, 192, 193, 250, 750])
def test_wgmma_tile_follows_the_shape_not_the_route(sq):
    """The tile is a function of (head dim, Sq, H) alone, never of the
    route, which follows the head dim and dtype alone: bf16 D=64 takes
    wgmma at every Sq, two heads a tile exactly where the last 128-row
    q-tile would be at most half full and there is a second head, one head
    otherwise; D=128 always one head of 128 rows (two heads of 128 columns
    would not fit a K/V stage in shared memory)."""
    assert port_fa.route(64, torch.bfloat16) == "wgmma"
    for h in (1, 2, 3, 8):
        want = (64, 2) if h >= 2 and 0 < sq % 128 <= 64 else (128, 1)
        assert port_fa.wgmma_tile(64, sq, h) == want
        assert port_fa.wgmma_tile(128, sq, h) == (128, 1)
    assert port_fa.wgmma_tile(64, 61, 8) == (64, 2)  # MT self-attention
    assert port_fa.wgmma_tile(64, 81, 8) == (128, 1)  # MT cross-attention queries
    assert port_fa.wgmma_tile(64, 250, 8) == (128, 1)  # 10 s utterances


def test_wgmma_plan_refuses_before_any_card():
    """What TMA does not take is refused on the host, before a launch: a
    non-contiguous operand, a base off a 16-byte boundary, a head dim that
    is not whole 64-column boxes, E not a multiple of the heads."""
    q = torch.randn(2, 70, 512).to(torch.bfloat16)
    plan = port_fa.wgmma_plan(q, q, q, 4, 132)
    assert plan["q_tiles"] == 1 and plan["tiles"] == 8
    with pytest.raises(ValueError, match="contiguous"):
        port_fa.wgmma_plan(q.transpose(0, 1), q, q, 4, 132)
    with pytest.raises(ValueError, match="contiguous"):
        port_fa.tensor_map("k", q[:, :, :256], 2, port_fa.WGMMA_BK)
    shifted = torch.zeros(2 * 70 * 512 + 8, dtype=torch.bfloat16)[1:2 * 70 * 512 + 1]
    with pytest.raises(ValueError, match="16-byte"):
        port_fa.wgmma_plan(q, shifted.view(2, 70, 512), q, 4, 132)
    with pytest.raises(ValueError, match="boxes"):
        port_fa.tensor_map("q", torch.zeros(2, 70, 64, dtype=torch.bfloat16), 4,
                           port_fa.WGMMA_BQ)  # head dim 16
    with pytest.raises(ValueError, match="boxes"):
        port_fa.tensor_map("q", q, 3, port_fa.WGMMA_BQ)


@pytest.mark.parametrize("d,dtype,want", [
    (16, torch.bfloat16, "mma.sync"), (64, torch.bfloat16, "wgmma"),
    (128, torch.bfloat16, "wgmma"), (192, torch.bfloat16, "mma.sync"),
    (256, torch.bfloat16, "mma.sync")] + [(d, torch.float32, "simt")
                                          for d in (16, 64, 128, 192, 256)])
def test_flash_bwd_route(d, dtype, want):
    """The backward's kernels for each (head dim, dtype): the wgmma backward
    for bf16 at head dims 64 and 128, mma.sync for the other bf16 head
    dims, the exact SIMT kernels for f32; anything else is refused."""
    assert port_fa.bwd_route(d, dtype) == want
    with pytest.raises(ValueError, match="head_dim"):
        port_fa.bwd_route(d + 8, dtype)
    with pytest.raises(ValueError, match="head_dim"):
        port_fa.bwd_route(d, torch.float16)


class _FakeLibrary:
    """Stands in for the three flash libraries' info entry points: the
    mma.sync/SIMT library reports no bf16 kernel at the wgmma head dims (as
    flash_attention.cu's kWgmmaFwd and kWgmmaBwd say), the wgmma libraries
    report their boxes and distinct byte counts."""

    def flash_attention_info(self, d, dtype, info):
        wgmma = dtype == 1 and d in (64, 128)
        info[0], info[1], info[2] = (0, 0, 0) if wgmma else (1000 + d, 2000 + d, 3000 + d)
        return 0

    def flash_attention_wgmma_info(self, d, heads, w):
        w[:6] = [4000 + d + heads, 2, 384, 64, 128 if heads == 1 else 64, 128]
        return 0

    def flash_attention_bwd_wgmma_info(self, d, w):
        w[:6] = [5000 + d, 6000 + d, 2, 128, 64, 64]
        return 0


@pytest.mark.parametrize("d", [16, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_info_reports_each_direction_from_its_library(d, dtype, monkeypatch):
    """kernel_info names both routes (route, bwd_route) as the route
    functions give them and takes each kernel's shared memory from the
    library that builds it: a wgmma forward's from the forward library, a
    wgmma backward's (dK/dV, dQ, stages, threads) from the backward's, the
    rest from the mma.sync/SIMT library."""
    lib = _FakeLibrary()
    for name in ("_library", "_wgmma_library", "_wgmma_bwd_library"):
        monkeypatch.setattr(port_fa, name, lambda lib=lib: lib)
    info = port_fa.kernel_info(d, dtype)
    assert info["route"] == port_fa.route(d, dtype)
    assert info["bwd_route"] == port_fa.bwd_route(d, dtype)
    if info["bwd_route"] == "wgmma":
        assert (info["smem_dkdv"], info["smem_dq"]) == (5000 + d, 6000 + d)
        assert info["bwd_stages"] == 2 and info["bwd_threads"] == 128
    else:
        assert (info["smem_dkdv"], info["smem_dq"]) == (2000 + d, 3000 + d)
        assert "bwd_stages" not in info
    assert info["smem_fwd"] == (4001 + d if info["route"] == "wgmma" else 1000 + d)


# (B, Sq, Sk, H, D) of the wgmma backward: the speech shapes at head dims
# 128 (4 heads) and 64 (8 heads), MT self and cross attention, K4's B=2
# 750x750, the tile edges, an odd head count
WGMMA_BWD_PLANS = [(64, 250, 250, 4, 128), (64, 47, 250, 4, 128), (64, 750, 750, 4, 128),
                   (2, 750, 750, 4, 128), (192, 61, 61, 4, 128), (192, 81, 61, 4, 128),
                   (64, 250, 250, 8, 64), (64, 47, 250, 8, 64), (192, 61, 61, 8, 64),
                   (3, 1, 129, 2, 128), (3, 129, 1, 3, 64), (1, 64, 65, 1, 128)]


@pytest.mark.parametrize("b,sq,sk,h,d", WGMMA_BWD_PLANS)
def test_wgmma_bwd_plan(b, sq, sk, h, d):
    """The wgmma backward's launch held to the tensors' own layout: each of
    the four maps (q, k, v, d_out) is (D, S, H, B) with byte strides that
    address the element a (B, S, H, D) view holds and boxes of 64 columns
    (the 128-byte swizzle row) x 64 rows x 1 head x 1 batch row; the dK/dV
    grid has a block for every 64 keys of every (head, batch row) and the dQ
    grid one for every 64 queries, none beyond."""
    gen = torch.Generator().manual_seed(3)
    q, d_out = (torch.randn(b, sq, h * d, generator=gen).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, sk, h * d, generator=gen).to(torch.bfloat16) for _ in range(2))
    plan = port_fa.wgmma_bwd_plan(q, k, v, d_out, h)
    rows = port_fa.WGMMA_BWD_ROWS
    assert rows == 64
    for name, t in (("q_map", q), ("k_map", k), ("v_map", v), ("d_out_map", d_out)):
        m = plan[name]
        size = t.element_size()
        assert m["dims"] == (d, t.shape[1], h, b)
        assert m["box"] == (port_fa.WGMMA_BOX_COLS, rows, 1, 1)
        assert m["box"][0] * size == 128
        assert m["strides"] == tuple(size * x for x in (t.stride(1), d, t.stride(0)))
        flat, split = t.reshape(-1), t.reshape(b, t.shape[1], h, d)
        for _ in range(8):  # random elements, addressed through the map
            at = [int(torch.randint(n, (1,), generator=gen)) for n in m["dims"]]
            off = at[0] * size + sum(c * st for c, st in zip(at[1:], m["strides"]))
            assert torch.equal(flat[off // size], split[at[3], at[1], at[2], at[0]])
    for grid, length in ((plan["dkdv_grid"], sk), (plan["dq_grid"], sq)):
        assert grid[1:] == (h, b)
        assert (grid[0] - 1) * rows < length <= grid[0] * rows
    words = port_fa._map_words(plan, ("q", "k", "v", "d_out"))
    assert len(words) == 4 * 11
    assert list(words[11:15]) == list(plan["k_map"]["dims"])


def test_wgmma_bwd_plan_refuses_before_any_card():
    """What TMA does not take is refused on the host, before a backward
    launch: a non-contiguous operand (d_out included), a base off a 16-byte
    boundary, a head dim that is not whole 64-column boxes."""
    q = torch.randn(2, 70, 512).to(torch.bfloat16)
    plan = port_fa.wgmma_bwd_plan(q, q, q, q, 4)
    assert plan["dkdv_grid"] == plan["dq_grid"] == (2, 4, 2)
    with pytest.raises(ValueError, match="contiguous"):
        port_fa.wgmma_bwd_plan(q, q, q, q.transpose(0, 1), 4)
    with pytest.raises(ValueError, match="contiguous"):
        port_fa.wgmma_bwd_plan(q, q[:, :, :256], q, q, 2)
    shifted = torch.zeros(2 * 70 * 512 + 8, dtype=torch.bfloat16)[1:2 * 70 * 512 + 1]
    with pytest.raises(ValueError, match="16-byte"):
        port_fa.wgmma_bwd_plan(q, q, shifted.view(2, 70, 512), q, 4)
    small = torch.zeros(2, 70, 64, dtype=torch.bfloat16)  # head dim 16
    with pytest.raises(ValueError, match="boxes"):
        port_fa.wgmma_bwd_plan(small, small, small, small, 4)


def test_library_name_follows_its_source_and_the_shared_headers(tmp_path, monkeypatch):
    """A kernel library is named by a hash of its source and of the headers
    the sources share (the flash kernels' dropout bits live in one), so an
    edit of either builds it anew and a stale library is never loaded."""
    from joeys2t_torch.ops import cuda_build

    (tmp_path / "k.cu").write_text("source")
    (tmp_path / "common.cuh").write_text("header")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    first = cuda_build._library_path("k")
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("libk-")
    (tmp_path / "common.cuh").write_text("header, edited")
    assert cuda_build._library_path("k") != first
    (tmp_path / "common.cuh").write_text("header")
    assert cuda_build._library_path("k") == first
    (tmp_path / "k.cu").write_text("source, edited")
    assert cuda_build._library_path("k") != first


def _python_bits(seed, b, h, q, k):
    """The hash with Python's unbounded ints, masked to 32 bits."""
    def mix(x):
        m = 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x7FEB352D) & m
        x ^= x >> 15
        x = (x * 0x846CA68B) & m
        return x ^ (x >> 16)
    return mix(mix(mix(mix(mix(seed ^ 0x9E3779B9) ^ b) ^ h) ^ q) ^ k)


def test_dropout_hash_fixed_values():
    """The plain hash splits its 32-bit products into 16-bit halves, so the
    int64 tensors never overflow; held against fixed values and Python ints."""
    x = torch.tensor([0, 1, 2, 0xFFFFFFFF, 123456789, 0x9E3779B9])
    assert [int(v) for v in port_fa.mix32(x)] == [
        0x0, 0x688990C0, 0xD1132181, 0x6768824A, 0xA8F1DB88, 0x1FCE552]
    cases = {(0, 0, 0, 0, 0): 0x0EAA7511, (12345, 1, 2, 3, 4): 0x11972835,
             (2**31 - 2, 63, 3, 249, 749): 0xAC9807EB, (7, 5, 0, 46, 100): 0xF280E1D8}
    rate = 0.1
    thr = port_fa.dropout_threshold(rate)
    assert thr == 429496730
    for (seed, b, h, q, k), bits in cases.items():
        assert _python_bits(seed, b, h, q, k) == bits
        keep = port_fa.dropout_keep(torch.tensor([seed], dtype=torch.int32), torch.tensor(b),
                                    torch.tensor(h), torch.tensor(q), torch.tensor(k), rate)
        assert bool(keep) == (bits >= thr)
    rng = np.random.RandomState(3)
    for _ in range(200):
        seed, b, h, q, k = (int(rng.randint(0, 2**31 - 1)), int(rng.randint(0, 512)),
                            int(rng.randint(0, 16)), int(rng.randint(0, 3000)),
                            int(rng.randint(0, 3000)))
        keep = port_fa.dropout_keep(torch.tensor([seed], dtype=torch.int32), torch.tensor(b),
                                    torch.tensor(h), torch.tensor(q), torch.tensor(k), 0.5)
        assert bool(keep) == (_python_bits(seed, b, h, q, k) >= 2**31)


def test_dropout_mask_statistics():
    """Keep fraction within 4 sigma of 1 - r over 2**20 draws, and no
    correlation (|r| < 4 / sqrt(n)) between heads, neighbouring rows,
    neighbouring keys, batch rows or seeds."""
    rate = 0.1
    keep = port_fa.attention_keep(torch.tensor([31337], dtype=torch.int32), 4, 4, 256, 256,
                                  rate).float()  # (B, H, Sq, Sk): 2**20 draws
    n = keep.numel()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(keep.mean().item() - (1 - rate)) < 4 * sigma

    def corr(a, b):
        a, b = a.flatten() - a.mean(), b.flatten() - b.mean()
        return ((a * b).mean() / (a.std() * b.std())).item()

    pairs = {"heads": (keep[:, 0], keep[:, 1]), "rows": (keep[:, :, :-1], keep[:, :, 1:]),
             "keys": (keep[..., :-1], keep[..., 1:]), "batch": (keep[0], keep[1])}
    other = port_fa.attention_keep(torch.tensor([31338], dtype=torch.int32), 4, 4, 256, 256,
                                   rate).float()
    pairs["seeds"] = (keep, other)
    for name, (a, b) in pairs.items():
        assert abs(corr(a, b)) < 4 / math.sqrt(a.numel()), name


@pytest.mark.parametrize("sq,sk,heads,dim", [(40, 70, 2, 64), (20, 600, 1, 64),
                                             (47, 250, 4, 128)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_flash_backward_plain_matches_pallas(sq, sk, heads, dim, dtype, tol):
    """dQ, dK, dV of the plain backward against jax.vjp through the Pallas
    kernels (interpret mode): ragged Sk, Sk > 512 (K4's route), the speech
    decoder's cross-attention at head dim 128 (4 heads, 47 target positions
    over 250 frames, the wgmma backward's shape on the card), and row 0
    with every key masked, where both rebuild p = exp(s - lse) = 1."""
    rng = np.random.RandomState(7)
    b, e = 2, heads * dim
    q, k, v = (0.5 * rng.randn(b, s, e).astype(np.float32) for s in (sq, sk, sk))
    d_out = rng.randn(b, sq, e).astype(np.float32)
    bias = _key_bias(rng, b, sk)
    sm = 1.0 / np.sqrt(dim)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_fa.flash_attention_flat(
        q_, k_, v_, jnp.asarray(bias), sm, heads), *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(d_out, jdt))
    tdt = getattr(torch, dtype)
    qt, kt, vt, dot = (torch.tensor(x).to(tdt) for x in (q, k, v, d_out))
    bt = torch.tensor(bias)
    out, lse = port_fa.flash_attention_fwd(qt, kt, vt, bt, sm, heads)
    grads_t = port_fa.flash_attention_bwd(qt, kt, vt, bt, out, lse, dot, sm, heads)
    for name, g_t, g_j in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert g_t.dtype == tdt, name
        np.testing.assert_allclose(g_t.float().numpy(), np.asarray(g_j, np.float32),
                                   atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_autograd_matches_plain_forward(rate):
    """FlashAttention on the CPU (the plain backward) against torch autograd
    through the plain forward, same seed, f32 to 1e-5. Every row has a valid
    key: at an all-masked row the Pallas backward's p = exp(s - lse) = 1 is
    not the gradient of the forward's uniform 1/Sk."""
    rng = np.random.RandomState(8)
    b, sq, sk, heads, e = 3, 21, 45, 2, 128
    q, k, v = (torch.tensor(rng.randn(b, s, e).astype(np.float32), requires_grad=True)
               for s in (sq, sk, sk))
    bias = torch.tensor(_key_bias(rng, b, sk, all_masked_row=False))
    d_out = torch.tensor(rng.randn(b, sq, e).astype(np.float32))
    seed = torch.tensor([4242], dtype=torch.int32)
    out = port_fa.FlashAttention.apply(q, k, v, bias, 0.125, heads, rate, seed)
    grads = torch.autograd.grad(out, (q, k, v), d_out)
    ref = port_fa.flash_attention_plain(q, k, v, bias, 0.125, heads, rate, seed)[0]
    refs = torch.autograd.grad(ref, (q, k, v), d_out)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    for g, r in zip(grads, refs):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------- decode attention
DECODE_MODES = ["f32", "bf16", "channel", "position"]


def _decode_valid(kind, rng, b, s):
    """(B, S) bool, the keys each row attends to: the self-attention ring
    buffer at step S // 2, padded source tails, interior holes, or a prefix
    with row 0 fully masked."""
    pos = np.arange(s)
    if kind == "self_prefix":
        return np.broadcast_to(pos <= s // 2, (b, s)).copy()
    if kind == "cross_tail":
        return pos[None] < rng.randint(1, s + 1, size=(b,))[:, None]
    if kind == "holes":
        valid = rng.rand(b, s) > 0.4
        valid[:, s // 2] = True
        return valid
    assert kind == "all_masked_row", kind
    valid = np.broadcast_to(pos < (s + 1) // 2, (b, s)).copy()
    valid[0] = False
    return valid


def _decode_inputs(mode, seed=0, b=3, h=2, s=33, d=64, mask=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(b, h, s, d).astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    if mask is None:
        bias = _key_bias(rng, b, s, all_masked_row=False)
    else:
        bias = np.where(_decode_valid(mask, rng, b, s), 0.0, NEG_INF).astype(np.float32)
    ks = vs = None
    if mode == "channel":  # cross cache: one scale per (b, h, d)
        ks = np.abs(k).max(axis=2) / 127.0 + 1e-8
        vs = np.abs(v).max(axis=2) / 127.0 + 1e-8
        k = np.clip(np.round(k / ks[:, :, None]), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs[:, :, None]), -127, 127).astype(np.int8)
    elif mode == "position":  # self ring buffer: one scale per (b, h, s)
        ks = np.abs(k).max(axis=3) / 127.0 + 1e-8
        vs = np.abs(v).max(axis=3) / 127.0 + 1e-8
        k = np.clip(np.round(k / ks[..., None]), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs[..., None]), -127, 127).astype(np.int8)
    return q, k, v, bias, ks, vs


def _port_decode(q, k, v, bias, ks, vs, mode, dtype=torch.float32, sm=0.125):
    kv_dtype = torch.int8 if k.dtype == np.int8 else dtype
    return port_da.decode_attention(
        torch.tensor(q).to(dtype), torch.tensor(k).to(kv_dtype),
        torch.tensor(v).to(kv_dtype), torch.tensor(bias),
        None if ks is None else torch.tensor(ks, dtype=torch.float32),
        None if vs is None else torch.tensor(vs, dtype=torch.float32),
        sm_scale=sm, scale_layout=None if mode in ("f32", "bf16") else mode)


@pytest.mark.parametrize("mode", DECODE_MODES)
def test_decode_plain_matches_pallas(mode):
    """Against the Pallas kernel in interpret mode. It rounds the scaled q to
    bf16 even for f32 inputs (decode_attention.py:64); the port does not, so
    the tolerance is that of a bf16 q."""
    _check_decode_against_pallas(mode)


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("mask", ["self_prefix", "cross_tail", "holes", "all_masked_row"])
def test_decode_plain_matches_pallas_on_masks(mode, mask):
    """The masks the decode loop makes, and a row whose keys are all masked
    (a near-uniform softmax over its -1e9 scores), against the Pallas
    kernel: the plain version the CUDA kernel is held to agrees with it on
    them."""
    _check_decode_against_pallas(mode, mask)


def _check_decode_against_pallas(mode, mask=None):
    q, k, v, bias, ks, vs = _decode_inputs(mode, mask=mask)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    kv = (lambda x: jnp.asarray(x)) if k.dtype == np.int8 else (
        lambda x: jnp.asarray(x, jdt))
    out_j = jax_da.decode_attention(
        jnp.asarray(q, jdt), kv(k), kv(v), jnp.asarray(bias),
        None if ks is None else jnp.asarray(ks, jnp.float32),
        None if vs is None else jnp.asarray(vs, jnp.float32),
        sm_scale=0.125, interpret=True,
        scale_layout=None if mode in ("f32", "bf16") else mode)
    out_t = _port_decode(q, k, v, bias, ks, vs, mode, dtype)
    assert out_t.dtype == dtype and out_t.shape == q.shape
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32),
                               atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("mode", ["f32", "channel", "position"])
def test_decode_plain_matches_einsum_path(mode):
    """Against the JAX einsum path (``MultiHeadedAttention._decode_einsum``,
    the default in the JAX decode loop) at float32, output projection
    included."""
    q, k, v, bias, ks, vs = _decode_inputs(mode, seed=3)
    b, h, s, d = k.shape
    mha = JaxMHA(num_heads=h, size=h * d, dropout=0.0)
    params = mha.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, h * d)),
        jnp.zeros((1, 2, h * d)), jnp.zeros((1, 2, h * d)))["params"]
    q_h = q[:, None]  # (B, 1, H, D)
    out_j = mha.apply(
        {"params": params}, jnp.asarray(q_h), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bias), None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs),
        "channel" if mode == "f32" else mode,
        method=lambda m, *a: m._decode_einsum(*a))[0]
    ctx = _port_decode(q, k, v, bias, ks, vs, mode, sm=1.0 / np.sqrt(d))
    w = torch.tensor(np.asarray(params["output_layer"]["kernel"]))
    bo = torch.tensor(np.asarray(params["output_layer"]["bias"]))
    out_t = ctx.reshape(b, 1, h * d) @ w + bo
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", DECODE_MODES)
def test_decode_group_matches_expanded_cache(mode):
    """``group`` G: query row r reads cache row r // G, the same as one
    query a row over the cache repeated G times."""
    g = 3
    q, k, v, bias, ks, vs = _decode_inputs(mode, seed=5, mask="cross_tail")
    q = np.random.RandomState(6).randn(k.shape[0] * g, *q.shape[1:]).astype(np.float32)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    kv_dtype = torch.int8 if k.dtype == np.int8 else dtype
    args = [torch.tensor(x) for x in (k, v, bias)]
    args[:2] = [a.to(kv_dtype) for a in args[:2]]
    scales = [None if x is None else torch.tensor(x) for x in (ks, vs)]
    layout = None if mode in ("f32", "bf16") else mode
    qt = torch.tensor(q).to(dtype)
    out = port_da.decode_attention(qt, *args, *scales, sm_scale=0.125, scale_layout=layout,
                                   group=g)
    expanded = [a.repeat_interleave(g, 0) for a in args]
    ref = port_da.decode_attention(
        qt, *expanded, *[None if x is None else x.repeat_interleave(g, 0) for x in scales],
        sm_scale=0.125, scale_layout=layout)
    assert out.shape == qt.shape and out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), atol=1e-6,
                               rtol=1e-6)
    with pytest.raises(ValueError):
        port_da.decode_attention(qt, *args, *scales, sm_scale=0.125, scale_layout=layout,
                                 group=2)


@pytest.mark.parametrize("mode", ["f32", "channel"])
def test_decode_group_matches_beam_step_cross(mode):
    """The plain version with ``group`` against the JAX beam path of
    ``step_cross`` (``beam_k``: the einsum "bkhd,bhsd->bkhs" over the
    beam-shared cross cache) at float32, projections included."""
    beam_k = 4
    _, k, v, bias, ks, vs = _decode_inputs(mode, seed=7, mask="cross_tail")
    b, h, s, d = k.shape
    x = np.random.RandomState(8).randn(b * beam_k, 1, h * d).astype(np.float32)
    mha = JaxMHA(num_heads=h, size=h * d, dropout=0.0)
    params = mha.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 2, h * d)),
        jnp.zeros((1, 2, h * d)), jnp.zeros((1, 2, h * d)))["params"]
    out_j = mha.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bias > NEG_INF / 2)[:, None, :],
        None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs),
        beam_k=beam_k, method="step_cross")[0]

    def dense(name, t):
        return (t @ torch.tensor(np.asarray(params[name]["kernel"]))
                + torch.tensor(np.asarray(params[name]["bias"])))

    q_h = dense("q_layer", torch.tensor(x)).reshape(b * beam_k, h, d)
    ctx = port_da.decode_attention(
        q_h, torch.tensor(k), torch.tensor(v), torch.tensor(bias),
        None if ks is None else torch.tensor(ks), None if vs is None else torch.tensor(vs),
        sm_scale=1.0 / np.sqrt(d), scale_layout=None if mode == "f32" else mode,
        group=beam_k)
    out_t = dense("output_layer", ctx.reshape(b * beam_k, 1, h * d))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)


def test_quantize_per_position_matches_jax():
    x = np.random.RandomState(4).randn(2, 3, 7, 64).astype(np.float32)
    q_j, s_j = jax_da.quantize_per_position(jnp.asarray(x))
    q_t, s_t = port_da.quantize_per_position(torch.tensor(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-7)


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("mask", ["self_prefix", "cross_tail", "holes"])
def test_decode_masked_positions_ignored(mode, mask):
    """Garbage in the masked slots of K and V (+-1e4, or +-127 in int8) and
    of the "position" scales (1e3) leaves the output bit for bit when the
    row has a valid key: exp(-1e9 + score - max) is exactly 0 in f32. The
    CUDA kernel's skipping of masked rows rests on this."""
    q, k, v, bias, ks, vs = _decode_inputs(mode, seed=5, s=40, mask=mask)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    out1 = _port_decode(q, k, v, bias, ks, vs, mode, dtype)
    masked = bias <= NEG_INF / 2
    rng = np.random.RandomState(6)
    big = 127 if k.dtype == np.int8 else 1e4
    k, v = (np.where(masked[:, None, :, None], rng.choice([-big, big], size=t.shape),
                     t).astype(t.dtype) for t in (k, v))
    if mode == "position":
        ks, vs = (np.where(masked[:, None, :], 1e3, t).astype(np.float32) for t in (ks, vs))
    out2 = _port_decode(q, k, v, bias, ks, vs, mode, dtype)
    np.testing.assert_array_equal(out1.float().numpy(), out2.float().numpy())


@pytest.mark.parametrize("b,h,s", [(64, 4, 250), (64, 4, 97), (66, 4, 97), (33, 4, 250),
                                   (1, 4, 750), (2, 4, 750), (1, 4, 97), (1, 1, 1),
                                   (1, 1, 31), (3, 2, 3000), (7, 3, 65), (1, 1, 20000)])
def test_decode_plan(b, h, s):
    """The kernel's split of S over a cluster: one split once B*H fills the
    card (B=64 H=4 serves 256 (b, h) pairs), at least 8 for the 30 s
    request's B*H = 4 at S = 750, never more than 16 nor more than the
    16-row groups, each split non-empty and the splits covering S (on the
    H100 SXM's 132 SMs)."""
    splits, rows = port_da.decode_plan(b, h, s, 132)
    assert 1 <= splits <= min(16, -(-s // 16))
    assert rows % 16 == 0 and (splits - 1) * rows < s <= splits * rows
    if b * h >= 132:
        assert splits == 1
    if b * h == 4 and s == 750:
        assert splits >= 8


@pytest.mark.parametrize("rows,group,beam_k,s,slots", [
    (32, 5, None, 250, None), (128, 5, None, 61, None), (1, 5, None, 750, None),
    (3, 2, None, 97, None), (160, 1, 5, 97, 49), (640, 1, 5, 81, 41), (160, 1, 5, 97, None),
    (15, 1, 5, 250, 1), (20, 1, 10, 97, 60), (12, 1, 12, 31, 16), (40, 9, None, 26, None),
    (2, 5, None, 3000, None)])
def test_multi_query_launch_grid(rows, group, beam_k, s, slots):
    """The multi-query kernel's launch: one block (cluster) per (utterance,
    head, chunk of 8 queries), never one per query row; the plan covers the
    slots the step can use, so no split starts past them (no split made
    only of padding), in splits of MULTI_SPLIT_SLOTS slots from slot 0, and
    does not depend on the batch (nor on the card)."""
    h = 4
    grid = port_da.launch_grid(rows, h, s, 132, group, beam_k, slots)
    utterances, queries = (rows, group) if beam_k is None else (rows // beam_k, beam_k)
    chunks = -(-queries // port_da.MAX_QUERIES)
    used = s if slots is None else slots
    assert grid["kernel"] == "multi-query"
    assert (grid["utterances"], grid["queries"], grid["chunks"]) == (utterances, queries, chunks)
    assert grid["grid"] == (grid["splits"], h, utterances * chunks)
    step = port_da.MULTI_SPLIT_SLOTS
    rows_a_split = step * -(-used // (step * port_da.MAX_SPLITS))  # 96 up to 1536 slots
    assert grid["split_rows"] == rows_a_split and grid["splits"] == -(-used // rows_a_split)
    assert grid["splits"] <= port_da.MAX_SPLITS
    for other in (1, 3, 1000):  # another batch, another card: the same plan
        again = port_da.launch_grid(rows * other, h, s, 16 * other, group, beam_k, slots)
        assert (again["splits"], again["split_rows"]) == (grid["splits"], grid["split_rows"])
    assert grid["slots"] == used and (grid["splits"] - 1) * grid["split_rows"] < used
    if (rows, s) == (32, 250):  # the beam cross shape: 128 (u, h) pairs, several splits
        assert grid["grid"] == (3, 4, 32)
    if (rows, s, slots) == (160, 97, 49):  # the beam self shape at step 48
        assert grid["grid"] == (1, 4, 32)


@pytest.mark.parametrize("s", [1, 17, 49, 97, 250, 750])
def test_multi_query_plan_covers_only_used_slots(s):
    """Over every step of a ring buffer of S slots, the plan of the
    ancestry launch splits the used slots alone: each split non-empty and
    inside them, together covering them."""
    for used in range(1, s + 1):
        grid = port_da.launch_grid(160, 4, s, 132, beam_k=5, slots=used)
        splits, split_rows = grid["splits"], grid["split_rows"]
        assert (splits - 1) * split_rows < used <= splits * split_rows, used


def test_one_query_launch_grid_is_unchanged():
    """One query a cache row keeps the one-query kernel and its plan over
    all S slots, whatever ``slots`` says."""
    for b, s in ((64, 250), (1, 750), (64, 97)):
        grid = port_da.launch_grid(b, 4, s, 132, slots=1)
        assert grid["kernel"] == "one-query" and grid["slots"] == s
        assert (grid["splits"], grid["split_rows"]) == port_da.decode_plan(b, 4, s, 132)
        assert grid["grid"] == (grid["splits"], 4, b)


def test_decode_wrapper_refuses_before_any_card():
    """What the multi-query launch does not take is refused on tensors that
    need no card: ``group`` not dividing the query rows, a map of the wrong
    shape, beside ``group`` > 1 or beside channel scales, ``slots`` outside
    [1, S]."""
    q, k, v, bias, ks, vs = (torch.tensor(x) for x in _decode_inputs(
        "channel", seed=9, mask="cross_tail"))
    b, h, s, d = k.shape
    qf = torch.randn(b, h, d)
    kf, vf = torch.randn(b, h, s, d), torch.randn(b, h, s, d)
    anc = torch.zeros(1, b, s, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        port_da.decode_attention(torch.randn(b * 3 - 1, h, d), kf, vf, bias, group=3)
    with pytest.raises(ValueError, match="rows"):
        port_da.decode_attention(torch.randn(b * 2, h, d), kf, vf, bias, group=3)
    for bad in (torch.zeros(1, b, s + 1, dtype=torch.int32),
                torch.zeros(2, b, s, dtype=torch.int32), torch.zeros(b, s, dtype=torch.int32)):
        with pytest.raises(ValueError, match="ancestry"):
            port_da.decode_attention(qf, kf, vf, bias, ancestry=bad)
    with pytest.raises(ValueError, match="channel"):
        port_da.decode_attention(q.float(), k, v, bias, ks, vs, scale_layout="channel",
                                 ancestry=anc)
    with pytest.raises(ValueError, match="group 1"):
        port_da.decode_attention(qf.repeat(2, 1, 1), kf, vf, bias, group=2, ancestry=anc)
    for slots in (0, s + 1):
        with pytest.raises(ValueError, match="slots"):
            port_da.decode_attention(qf, kf, vf, bias, ancestry=anc, slots=slots)


def test_decode_slots_mask_the_slots_past_them():
    """``slots`` t: the slots from t on count as masked whatever the bias
    holds, with or without a map, as if their bias were NEG_INF."""
    _, k, v, bias, _, _ = _decode_inputs("f32", seed=10, mask="cross_tail")
    kt, vt = torch.tensor(k), torch.tensor(v)
    b, h, s, d = kt.shape
    open_bias = torch.zeros(b, s)
    anc = torch.randint(0, b, (1, b, s), generator=torch.Generator().manual_seed(11),
                        dtype=torch.int32)
    q = torch.randn(b, h, d)
    for t in (1, s // 2, s):
        masked = open_bias.clone()
        masked[:, t:] = NEG_INF
        for kw in ({}, {"ancestry": anc}):
            got = port_da.decode_attention(q, kt, vt, open_bias, slots=t, **kw)
            want = port_da.decode_attention(q, kt, vt, masked, **kw)
            assert torch.equal(got, want), (t, kw)


@pytest.mark.parametrize("sms", [16, 78, 114, 132])
def test_decode_plan_follows_sm_count(sms):
    """The plan is made for the card's SM count: one split from B*H = SMs
    on, and below that more splits where there are more SMs to fill."""
    assert port_da.decode_plan(sms, 1, 3000, sms) == (1, 3008)
    splits = [port_da.decode_plan(b, 1, 3000, sms)[0] for b in (1, 2, 4, 8, sms - 1)]
    assert splits == sorted(splits, reverse=True) and splits[-1] <= 3
    assert port_da.decode_plan(8, 1, 3000, 2 * sms)[0] >= splits[3]
    if sms == 16:
        assert port_da.decode_plan(8, 1, 3000, 32)[0] > splits[3]


# ---------------------------------------------------------------- front end
def test_frontend_matches_jax():
    """fbank + CMVN of a padded batch of 1-2 s waveforms. The noise is
    loudness-modulated like speech: CMVN divides each mel bin by its spread
    over time, which for a stationary signal is near zero and would magnify
    float32 rounding."""
    rng = np.random.RandomState(6)
    n = 32000
    lengths = np.array([32000, 17000, 24321])
    waves = np.zeros((3, n), np.float32)
    for i, length in enumerate(lengths):
        envelope = np.repeat(np.exp(rng.uniform(3, 9, size=length // 800 + 1)), 800)
        waves[i, :length] = envelope[:length] * rng.randn(length)
    feats_j, fl_j = jax_frontend(jnp.asarray(waves), jnp.asarray(lengths, jnp.int32))
    feats_t, fl_t = port_frontend(torch.tensor(waves), torch.tensor(lengths))
    np.testing.assert_array_equal(fl_t.numpy(), np.asarray(fl_j))
    assert feats_t.shape == feats_j.shape and feats_t.dtype == torch.float32
    # the JAX package takes the power spectrum as a float32 DFT matmul, the
    # port as an rfft: their log-mel values differ by up to ~1e-4, and CMVN
    # scales that by 1/std of each bin
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=5e-4, rtol=1e-4)

