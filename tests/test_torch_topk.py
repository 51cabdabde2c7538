# coding: utf-8
"""Beam search's selection (``ops/topk.py``) on the CPU: the wrapper takes
the plain version and checks its arguments as it does on the card, the
launch plan gives a row's block 1 to 8 warps, and the plain version's order
of ties (signed zeros, NaN, ``NEG_INF`` plateaus) beside ``jax.lax.top_k``'s,
which it equals but for signed zeros and a NaN with its sign bit set. The
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py -k topk``)."""
import inspect

import numpy as np
import pytest
import torch

from joeys2t_torch import search
from joeys2t_torch.ops import topk as tk

NEG_INF = -1e9
H100_SMS = 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,k", [((7, 160), 5), ((3, 10), 5), ((33,), 32), ((2, 3, 50), 20),
                                     ((4, 1), 1)])
def test_wrapper_takes_the_plain_version_on_the_cpu(dtype, shape, k):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(k), dtype=torch.float64)
    x = x.to(dtype)
    before = tk.stable_topk.launches
    got = tk.stable_topk(x, k)
    want = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(got[0], want[0][..., :k]) and torch.equal(got[1], want[1][..., :k])
    assert got[0].dtype == dtype and got[1].dtype == torch.long
    assert tk.stable_topk.launches == before


@pytest.mark.parametrize("case", ["k_above_n", "k_above_limit", "k_zero", "int32", "int64",
                                  "bfloat16", "transposed", "strided_last", "scalar"])
def test_wrapper_refuses_on_the_cpu_what_the_kernel_refuses(case):
    x = torch.randn(4, 40)
    t, k = {"k_above_n": (x, 41), "k_above_limit": (x, tk.MAX_K + 1), "k_zero": (x, 0),
            "int32": (x.to(torch.int32), 5), "int64": (x.to(torch.int64), 5),
            "bfloat16": (x.to(torch.bfloat16), 5), "transposed": (x.t(), 3),
            "strided_last": (x[:, ::2], 5), "scalar": (x[0, 0], 1)}[case]
    with pytest.raises(ValueError):
        tk.stable_topk(t, k)


# (rows, n, k): the translation cell's two calls (beam 5 over 32,000 ids for
# 3,004 sentences, then the store), the published 36-sentence batch, the
# 960h recipe's beam 20 over 10,000 ids at 13 and 256 utterances, the
# recurrent beam's float64 store, one row, a row shorter than a vector, rows
# about twice an H100's SMs, and rows at and about the length of 8 warps'
# loads (4,096 float32, 2,048 float64)
PLAN_CASES = [(3004, 160000, 5), (3004, 10, 5), (36, 160000, 5), (36, 10, 5), (13, 200000, 20),
              (256, 200000, 20), (64, 7, 2), (1, 1000003, 17), (1, 3, 3), (263, 160000, 5),
              (264, 160000, 5), (2, 4096, 32), (2, 2049, 1), (5, 512, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,n,k", PLAN_CASES)
def test_plan_gives_a_row_one_block_of_one_to_eight_warps(dtype, rows, n, k):
    """A warp for every ``UNROLL`` 16-byte loads a thread makes, up to 8: the
    warps' loads of one trip cover a row of up to 8 warps' worth, and no
    warp of a shorter row is left without a load but the first."""
    threads = tk.topk_plan(n, dtype)
    assert 32 <= threads <= tk.THREADS and threads % 32 == 0
    vec = 16 // (torch.finfo(dtype).bits // 8)
    per_warp = vec * tk.UNROLL * 32
    if threads < tk.THREADS:
        assert n <= threads // 32 * per_warp
    assert threads == 32 or n > (threads // 32 - 1) * per_warp


def test_plan_of_the_benchmark_and_published_shapes():
    """The translation cell's beam rows and the published batch's take 8
    warps a row, the finished store's 2k-wide rows one."""
    assert tk.topk_plan(160000, torch.float32) == 256
    assert tk.topk_plan(200000, torch.float32) == 256
    assert tk.topk_plan(10, torch.float32) == 32
    assert tk.topk_plan(10, torch.float64) == 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_ties_signed_zeros_in_index_order(dtype):
    x = torch.tensor([0.0, -0.0, 0.0, -0.0, -1.0, 0.5], dtype=dtype)
    values, indices = tk.stable_topk(x, 5)
    assert indices.tolist() == [5, 0, 1, 2, 3]
    assert [str(v) for v in values.tolist()] == ["0.5", "0.0", "-0.0", "0.0", "-0.0"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_puts_nan_first_in_index_order(dtype):
    nan = float("nan")
    x = torch.tensor([1.0, nan, -np.inf, -nan, 2.0, np.inf], dtype=dtype)
    values, indices = tk.stable_topk(x, 6)
    assert indices.tolist() == [1, 3, 5, 4, 0, 2]
    assert np.isnan(values[:2].numpy()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_keeps_neg_inf_plateaus_in_index_order(dtype):
    """Fewer finite candidates than k: the plateau fills the rest from its
    lowest index, as at a beam search's first step and in its store."""
    x = torch.full((2, 12), NEG_INF, dtype=dtype)
    x[0, 7] = -2.5
    x[0, 9] = -1.5
    x[1, :4] = -np.inf
    values, indices = tk.stable_topk(x, 5)
    assert indices.tolist() == [[9, 7, 0, 1, 2], [4, 5, 6, 7, 8]]
    assert values.tolist()[0] == [-1.5, -2.5, NEG_INF, NEG_INF, NEG_INF]


def test_search_selects_through_the_wrapper():
    """Every beam selection in search.py goes through ``_stable_topk``, which
    is the wrapper: no sort of its own is left on any path."""
    source = inspect.getsource(search)
    assert "torch.sort" not in source and ".sort(" not in source
    assert source.count("_stable_topk(") == 4  # the four calls
    assert search._stable_topk is tk.stable_topk
    values, indices = search._stable_topk(torch.tensor([[1.0, 3.0, 2.0]]), 2)
    assert values.tolist() == [[3.0, 2.0]] and indices.tolist() == [[1, 2]]


def _jax_top_k(x: torch.Tensor, k: int):
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(x.dtype == torch.float64):
        values, indices = jax.lax.top_k(jnp.asarray(x.numpy()), k)
        return np.asarray(values), np.asarray(indices)


def _jax_rows(pattern, dtype):
    """Rows on which the plain version and ``jax.lax.top_k`` agree: equal
    values, a plateau at the k-th value, ``NEG_INF`` plateaus with fewer
    finite entries than k, infinities, NaN (positive), beam scores."""
    gen = torch.Generator().manual_seed(len(pattern))
    x = torch.randn(6, 300, generator=gen, dtype=torch.float64)
    pick = torch.rand(6, 300, generator=gen).argsort(-1)
    if pattern == "equal":
        x.fill_(0.5)
    elif pattern == "ties_at_kth":
        x.scatter_(1, pick[:, :100], 7.0)
        x.scatter_(1, pick[:, 100:102], 9.0)
    elif pattern == "neg_inf_plateau":
        x.fill_(NEG_INF)
        x.scatter_(1, pick[:, :2], -3.0)
    elif pattern == "infinities":
        x.scatter_(1, pick[:, :4], -np.inf)
        x.scatter_(1, pick[:, 4:6], np.inf)
        x[3].fill_(-np.inf)
    elif pattern == "nan":
        x.scatter_(1, pick[:, :7], float("nan"))
    elif pattern == "beam_scores":
        x = torch.log_softmax(x * 3, -1)
        x[:, :3] = NEG_INF
        x[:3, 50:] = NEG_INF
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pattern", ["equal", "ties_at_kth", "neg_inf_plateau", "infinities",
                                     "nan", "beam_scores"])
def test_plain_version_equals_jax_top_k(dtype, pattern):
    x = _jax_rows(pattern, dtype)
    for k in (1, 5, 20, 32):
        values, indices = tk.stable_topk(x, k)
        jax_values, jax_indices = _jax_top_k(x, k)
        np.testing.assert_array_equal(indices.numpy(), jax_indices)
        np.testing.assert_array_equal(values.numpy(), jax_values)
        assert jax_values.dtype == values.numpy().dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_differs_from_jax_top_k_only_on_signed_zeros_and_negative_nan(dtype):
    """XLA ranks by the floats' total order: +0.0 above -0.0 and a NaN with
    its sign bit set below -inf. The stable sort (and the kernel) ties the
    two zeros in index order and puts every NaN first."""
    nan = float("nan")
    x = torch.tensor([[-0.0, 0.0, -0.0, 0.0, -1.0],
                      [1.0, -nan, -np.inf, 2.0, nan]], dtype=dtype)
    _, indices = tk.stable_topk(x, 5)
    _, jax_indices = _jax_top_k(x, 5)
    assert indices.tolist() == [[0, 1, 2, 3, 4], [1, 4, 3, 0, 2]]
    assert jax_indices.tolist() == [[1, 3, 0, 2, 4], [4, 3, 0, 2, 1]]
