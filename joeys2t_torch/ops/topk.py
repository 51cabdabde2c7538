# coding: utf-8
"""
Beam search's selection: the ``k`` largest entries of each row in
descending order, equal values in index order, on the hand-written CUDA
kernel of ``csrc/beam_topk.cu`` and in its plain PyTorch version, a stable
sort.

It replaces no Pallas kernel: JAX's beam loop calls ``jax.lax.top_k``
(joeys2t_tpu/search.py:531, :592). PyTorch has no top-k that returns equal
values in index order (``torch.topk`` on CUDA does not promise it), and the
beam's hypotheses depend on that order, through the finished store's merge
above all, where most scores sit at ``NEG_INF`` and tie. The plain version
sorts each whole row; on the card that sort took over half of a beam-5
translation's device time, to keep 5 of 160,000 scores a sentence.

The kernel is bound by the bytes of the scores it reads, once each. One
block a row streams it with 16-byte loads; each warp keeps its best ``k``
keys (value, then ~index: a strict order, so the result is one set whatever
the order of the scan) and admits a value only if it may beat the warp's
``k``-th, so almost every value costs one compare; the block merges its
warps' lists and writes ``k`` values and int64 indices a row.

Its output is the CPU's ``torch.sort(x, descending=True, stable=True)[...,
:k]`` bit for bit, -inf, ``NEG_INF`` plateaus, the two zeros (equal, so in
index order) and NaN (first, in index order) included. Two orders differ
only where a row holds a signed zero or a NaN with its sign bit set: the
card's stable sort (the port's path before the kernel) ranks a negative NaN
by its bits, below -inf; ``jax.lax.top_k`` ranks +0.0 above -0.0 and a
negative NaN below -inf. A beam's scores hold neither in practice.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. Both check their arguments alike.
"""
import ctypes
from typing import Tuple

import torch

from joeys2t_torch.ops import cuda_build

MAX_K = 32  # the largest k the kernel takes (its kMaxK)
THREADS = 256  # threads of a block at most (its kMaxWarps warps)
UNROLL = 4  # 16-byte loads a thread has in flight (its kUnroll)
DTYPES = (torch.float32, torch.float64)


def topk_plan(n: int, dtype: torch.dtype) -> int:
    """The threads of the block that scans a row of ``n`` entries: a warp
    for every ``UNROLL`` 16-byte loads a thread of the warp makes, 1 to 8
    warps, so a short row (the finished store's) takes one warp."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    warps = -(-n // (vec * UNROLL * 32))
    return 32 * max(1, min(THREADS // 32, warps))


def stable_topk_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: a stable descending sort of
    each row, its first ``k`` entries."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _check(x: torch.Tensor, k: int) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"stable_topk takes float32 or float64, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("stable_topk takes a tensor of one dimension or more")
    n = x.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"stable_topk: k must be in 1..{n} (the last dimension), got {k}")
    if k > MAX_K:
        raise ValueError(f"stable_topk: k = {k} is above the kernel's {MAX_K}")
    if n > 1 and x.stride(-1) != 1:
        raise ValueError(f"stable_topk: the last dimension must be contiguous, got "
                         f"stride {x.stride(-1)}")


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last dimension of ``x`` (float32 or
    float64, last dimension contiguous, ``1 <= k <= min(n, MAX_K)``) in
    descending order, equal values in index order: (values in x's dtype,
    int64 indices), each of x's shape with ``k`` last."""
    _check(x, k)
    if x.device.type == "cpu":
        return stable_topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"stable_topk runs on cpu or cuda, not {x.device}")
    n = x.shape[-1]
    lead = x.shape[:-1]
    # a 2-D view with a row stride; leading dimensions that do not collapse
    # into one stride are copied
    rows2d = x.reshape(-1, n)
    rows = rows2d.shape[0]
    values = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    indices = torch.empty((rows, k), dtype=torch.long, device=x.device)
    if rows == 0:
        return values.reshape(*lead, k), indices.reshape(*lead, k)
    err = _library().beam_topk(
        rows2d.data_ptr(), DTYPES.index(x.dtype), rows,
        rows2d.stride(0) if rows > 1 else n, n, k, topk_plan(n, x.dtype),
        values.data_ptr(), indices.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"beam_topk launch failed: cudaError {err}")
    stable_topk.launches += 1
    return values.reshape(*lead, k), indices.reshape(*lead, k)


stable_topk.launches = 0  # kernel launches, one a call on a CUDA tensor


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("beam_topk")
    fn = lib.beam_topk
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, ll, ll, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib
