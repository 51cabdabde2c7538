# coding: utf-8
"""
Flash attention, forward and backward, with in-kernel dropout: the
hand-written CUDA kernels (``csrc/flash_attention.cu``) and their plain
PyTorch versions, joined in the autograd function :class:`FlashAttention`.

Counterpart of joeys2t_tpu/ops/flash_attention.py. The TPU package splits
both directions into a flat-layout kernel (Sk <= 512) and a (B, H, S, D)
kernel for longer keys, both to fit VMEM; the CUDA kernels take any key
length. Operands keep the TPU package's FLAT layout: q (B, Sq, E), k/v
(B, Sk, E) with E = H * D and heads as column bands of E, exactly what the
Q/K/V projections produce, so no head-split copy is ever made.

Dropout bits come from a counter-based hash of the absolute (batch row,
head, query, key) indices and a per-call seed (:func:`dropout_keep`), so the
forward and the backward regenerate one mask whatever their tiling, and the
plain versions compute the same bits as the kernels. They are not the TPU's
bits, which cannot be reproduced.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernels or raise. The bf16 forward at head dims 64 and 128 runs
on Hopper's wgmma kernel (``csrc/flash_attention_wgmma.cu``: TMA loads over
tensor maps this module plans, :func:`wgmma_plan`, in a tile
:func:`wgmma_tile` picks from the shape), and so does the bf16 backward at
those head dims (``csrc/flash_attention_bwd_wgmma.cu``, planned by
:func:`wgmma_bwd_plan`); the other bf16 kernels run on the tensor cores
(mma.sync), f32 on the SIMT kernels, its exact path. Which kernel a (head
dim, dtype) takes is :func:`route`'s choice alone for the forward and
:func:`bwd_route`'s for the backward.
"""
import ctypes
import functools
from typing import Optional, Tuple

import torch

from joeys2t_torch.ops import cuda_build

NEG_INF = -1e9
_MASK32 = 0xFFFFFFFF

# the wgmma forward (csrc/flash_attention_wgmma.cu): its head dims in bf16,
# the columns of a TMA box (64 bf16: one 128-byte swizzle row), the query
# rows of a one-head tile (two consumer warpgroups of 64) and of a two-head
# tile (head dim 64: a consumer warpgroup a head), and keys a tile (the same
# for every shape and tile, so a row's arithmetic depends on neither its
# batch, its padding nor its tile). The kernel is compiled for these boxes
# (kBoxCols, kBQ, kPairRows, kBK): the library reports its own, and
# _wgmma_library checks them against these when it loads it.
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_BOX_COLS = 64
WGMMA_BQ = 128
WGMMA_BQ_PAIR = 64
WGMMA_BK = 128
# the wgmma backward (csrc/flash_attention_bwd_wgmma.cu): its head dims in
# bf16, and the rows of every box of its tensor maps: a block's 64 keys
# (dK/dV) or queries (dQ), the 64-row q-tiles and key tiles it streams
# (kRows; checked against the library when it loads)
WGMMA_BWD_HEAD_DIMS = (64, 128)
WGMMA_BWD_ROWS = 64


def supported(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take this head size and dtype: 16, 64, 128, 192
    or 256 in f32 or bf16. The TPU gate ``supported`` :613 asks d % 64 ==
    0 and sends head dim 16 to einsum; here it has kernels of its own."""
    return (head_dim in (16, 64, 128, 192, 256)
            and dtype in (torch.float32, torch.bfloat16))


def _route(head_dim: int, dtype: torch.dtype, wgmma_head_dims) -> str:
    if not supported(head_dim, dtype):
        raise ValueError(f"flash kernel takes head_dim in 16/64/128/192/256 and f32/bf16, "
                         f"got {head_dim} and {dtype}")
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if head_dim in wgmma_head_dims else "mma.sync"


def route(head_dim: int, dtype: torch.dtype) -> str:
    """The forward's kernel on the card: "wgmma" (bf16 at
    :data:`WGMMA_HEAD_DIMS`), "mma.sync" (the other bf16 head dims) or "simt"
    (f32); the backward's is :func:`bwd_route`'s."""
    return _route(head_dim, dtype, WGMMA_HEAD_DIMS)


def bwd_route(head_dim: int, dtype: torch.dtype) -> str:
    """The backward's kernels on the card: "wgmma" (bf16 at
    :data:`WGMMA_BWD_HEAD_DIMS`), "mma.sync" (the other bf16 head dims) or
    "simt" (f32)."""
    return _route(head_dim, dtype, WGMMA_BWD_HEAD_DIMS)


# ------------------------------------------------------------ dropout bits
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) without an int64
    overflow: x = hi * 2**16 + lo, and (hi * c * 2**16) mod 2**32 only needs
    (hi * (c mod 2**16)) mod 2**16."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's 32-bit mixer ("lowbias32") on int64 tensors holding
    uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """Keep where the hash bits are >= this: rate * 2**32, rounded."""
    return min(int(round(rate * 4294967296.0)), _MASK32)


def dropout_keep(seed: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                 q_idx: torch.Tensor, k_idx: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep mask of attention dropout, broadcast over the absolute index
    tensors ``b``, ``h``, ``q_idx``, ``k_idx``: bits = mix(row ^ k) with
    row = mix(mix(mix(mix(seed ^ 0x9E3779B9) ^ b) ^ h) ^ q), kept where bits >=
    :func:`dropout_threshold`. ``seed`` is a one-element int tensor whose
    low 32 bits seed the call."""
    s = mix32((seed.reshape(()).long() & _MASK32) ^ 0x9E3779B9)
    row = mix32(mix32(mix32(s ^ b.long()) ^ h.long()) ^ q_idx.long())
    return mix32(row ^ k_idx.long()) >= dropout_threshold(rate)


def attention_keep(seed: torch.Tensor, b: int, h: int, sq: int, sk: int,
                   rate: float, device=None) -> torch.Tensor:
    """The (B, H, Sq, Sk) keep mask of one call."""
    idx = lambda n, dim: torch.arange(n, device=device).reshape(  # noqa: E731
        [n if i == dim else 1 for i in range(4)])
    return dropout_keep(seed.to(device), idx(b, 0), idx(h, 1), idx(sq, 2), idx(sk, 3),
                        rate)


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """A per-call seed (one int32 on ``device``) from the caller's
    generator. On the card it stays there: the kernel reads it from device
    memory, so drawing it costs no host sync."""
    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)
    return seed.to(device)


# ------------------------------------------------------------ plain versions
def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, E) -> (B, S, H, D) in float32."""
    return x.float().reshape(x.shape[0], x.shape[1], num_heads, -1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, sm_scale: float, num_heads: int,
                          dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's math in plain PyTorch: f32 scores with the
    additive key bias, f32 softmax, dropout of the probabilities with
    :func:`dropout_keep`, f32 context. Returns (out like q, lse (B, Sq, H)
    f32). Differentiable by torch autograd."""
    b, sq, e = q.shape
    s = (torch.einsum("bqhd,bkhd->bhqk", _heads(q, num_heads) * sm_scale,
                      _heads(k, num_heads))
         + bias.float()[:, None, None, :])
    # normalize by the row sum, not by exp(s - lse): at a fully masked row
    # (scores near -1e9) lse rounds to the masked value and loses log(Sk)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = attention_keep(seed, b, num_heads, sq, k.shape[1], dropout_rate, q.device)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    lse = torch.logsumexp(s, dim=-1)  # (B, H, Sq)
    out = torch.einsum("bhqk,bkhd->bqhd", p, _heads(v, num_heads)).reshape(b, sq, e)
    return out.to(q.dtype), lse.transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                              d_out: torch.Tensor, sm_scale: float, num_heads: int,
                              dropout_rate: float = 0.0,
                              seed: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's math in plain PyTorch, that of the Pallas
    ``_bwd_kernel`` :104-161: probabilities rebuilt as exp(s - lse) from the
    forward's lse, delta = rowsum(dO * out), the forward's dropout mask
    regenerated, all in f32; returns (dq like q, dk like k, dv like v).

    At a row whose keys are all masked, f32 rounds lse = -1e9 + log(Sk) to
    -1e9, so p is 1 for every key there, not the forward's 1/Sk: kept as
    the Pallas kernel has it."""
    b, sq, e = q.shape
    sk = k.shape[1]
    qh = _heads(q, num_heads) * sm_scale
    kh, vh, doh = _heads(k, num_heads), _heads(v, num_heads), _heads(d_out, num_heads)
    delta = torch.einsum("bqhd,bqhd->bhq", doh, _heads(out, num_heads))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) + bias.float()[:, None, None, :]
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    p_drop = p
    if dropout_rate > 0.0:
        keep = attention_keep(seed, b, num_heads, sq, sk, dropout_rate, q.device)
        dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
        p_drop = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop, doh)
    return (dq.reshape(b, sq, e).to(q.dtype), dk.reshape(b, sk, e).to(k.dtype),
            dv.reshape(b, sk, e).to(v.dtype))


# ----------------------------------------------------------------- wrappers
def _check_operands(q, named, num_heads):
    """Raise unless ``q`` and the named tensors fit the kernels."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    e = q.shape[2]
    if e % num_heads:
        raise ValueError(f"E={e} is not a multiple of num_heads={num_heads}")
    d = e // num_heads
    if not supported(d, q.dtype):
        raise ValueError(f"flash kernel takes head_dim in 16/64/128/192/256 and "
                         f"f32/bf16, got {d} and {q.dtype}")
    for name, t, shape, dtype in (("q", q, tuple(q.shape), q.dtype),) + tuple(named):
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:  # the bf16 kernels copy 16-byte chunks
            raise ValueError(f"{name}: data must start on a 16-byte boundary")
    return d


def tensor_map(name: str, t: torch.Tensor, num_heads: int, box_rows: int,
               box_heads: int = 1) -> dict:
    """The TMA tensor map through which the wgmma kernel reads a (B, S,
    H * D) bf16 operand: 4-D (D, S, H, B), innermost first, with the byte
    strides of dims 1-3 (H * D, D and S * H * D elements: not increasing,
    which TMA takes) and a box of :data:`WGMMA_BOX_COLS` columns x
    ``box_rows`` rows x ``box_heads`` heads x 1 batch row, which lands in
    shared memory as one slab of rows a head, so rows past S and a head past
    H are zero-filled without touching the next batch row. Raises on what
    TMA does not take: a tensor that is not contiguous (B, S, E), a base not
    on a 16-byte boundary, a stride not a multiple of 16 bytes, a head dim
    not a whole number of boxes."""
    if t.dim() != 3 or not t.is_contiguous():
        raise ValueError(f"{name}: the wgmma kernel reads a contiguous (B, S, E) tensor, got "
                         f"shape {tuple(t.shape)}, contiguous={t.is_contiguous()}")
    b, s, e = t.shape
    if e % num_heads or (e // num_heads) % WGMMA_BOX_COLS:
        raise ValueError(f"{name}: E={e} is not num_heads={num_heads} heads of whole "
                         f"{WGMMA_BOX_COLS}-column boxes")
    d, size = e // num_heads, t.element_size()
    strides = (e * size, d * size, s * e * size)
    if t.data_ptr() % 16 or any(x % 16 for x in strides):
        raise ValueError(f"{name}: TMA needs a 16-byte aligned base and strides, got base "
                         f"{t.data_ptr() % 16} past a boundary and strides {strides}")
    return dict(dims=(d, s, num_heads, b), strides=strides,
                box=(WGMMA_BOX_COLS, box_rows, box_heads, 1))


def wgmma_tile(head_dim: int, sq: int, num_heads: int) -> Tuple[int, int]:
    """(query rows, heads) of the wgmma forward's tile for a shape: at head
    dim 64 with two heads or more, two heads of :data:`WGMMA_BQ_PAIR` rows
    when the last :data:`WGMMA_BQ`-row q-tile would be at most half full
    (Sq % 128 in 1..64, as the MT models' 61 tokens), where a one-head tile
    would leave its second consumer warpgroup idle; else one head of
    :data:`WGMMA_BQ` rows (the 10 s and 30 s utterances' 250 and 750
    frames, MT's 81-token cross attention). A function of the shape alone:
    the route never follows Sq, and a row's bits do not follow the tile."""
    if (head_dim == WGMMA_BOX_COLS and num_heads >= 2
            and 0 < sq % WGMMA_BQ <= WGMMA_BQ_PAIR):
        return WGMMA_BQ_PAIR, 2
    return WGMMA_BQ, 1


def wgmma_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
               num_sms: int) -> dict:
    """The wgmma forward's launch: the tile (:func:`wgmma_tile`), the
    tensor maps of q (boxes of the tile's rows and heads), k and v
    (:data:`WGMMA_BK` rows, the key tile, and the tile's heads), the q-tiles
    of a (batch row, head group), the (q-tile, head group, batch row) tiles
    and the persistent grid, one block an SM at most (the kernel's shared
    memory takes the SM)."""
    b, sq, e = q.shape
    rows, heads = wgmma_tile(e // num_heads, sq, num_heads)
    q_tiles = -(-sq // rows)
    tiles = q_tiles * -(-num_heads // heads) * b
    return dict(tile=(rows, heads), q_map=tensor_map("q", q, num_heads, rows, heads),
                k_map=tensor_map("k", k, num_heads, WGMMA_BK, heads),
                v_map=tensor_map("v", v, num_heads, WGMMA_BK, heads),
                q_tiles=q_tiles, tiles=tiles, grid=min(tiles, num_sms))


def wgmma_bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_out: torch.Tensor,
                   num_heads: int) -> dict:
    """The wgmma backward's launch: the tensor maps of q, k, v and d_out
    (boxes of :data:`WGMMA_BWD_ROWS` rows x one head) and the grids of its
    dK/dV and dQ kernels (blocks of 64 keys or queries, heads, batch rows).
    A block is one warpgroup whatever the shape, so a row's bits do not
    follow the batch."""
    b, sq, e = q.shape
    sk = k.shape[1]
    maps = {f"{name}_map": tensor_map(name, t, num_heads, WGMMA_BWD_ROWS)
            for name, t in (("q", q), ("k", k), ("v", v), ("d_out", d_out))}
    return dict(maps, dkdv_grid=(-(-sk // WGMMA_BWD_ROWS), num_heads, b),
                dq_grid=(-(-sq // WGMMA_BWD_ROWS), num_heads, b))


def _map_words(plan: dict, names=("q", "k", "v")):
    """The plan's maps as the C interface takes them: for each of
    ``names`` its dims, strides and box, 11 unsigned 64-bit words."""
    words = [x for name in names
             for part in ("dims", "strides", "box") for x in plan[f"{name}_map"][part]]
    return (ctypes.c_ulonglong * len(words))(*words)


@functools.lru_cache(maxsize=None)
def _num_sms(device: Optional[int]) -> int:
    """The card's SMs: the wgmma forward's persistent grid at most."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dropout_args(dropout_rate: float, seed: Optional[torch.Tensor], device):
    """(flag, seed pointer, threshold, keep scale) of the C interface."""
    if dropout_rate <= 0.0:
        return 0, None, 0, 1.0
    if not 0.0 < dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if (seed is None or seed.numel() != 1 or seed.dtype != torch.int32
            or seed.device != device):
        raise ValueError(f"dropout needs a one-element int32 seed on {device}")
    return 1, seed.data_ptr(), dropout_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, sm_scale: float, num_heads: int,
                        dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over full K/V with an additive key bias, flat head layout.

    :param q: (B, Sq, E), E = num_heads * head_dim, f32 or bf16
    :param k, v: (B, Sk, E), q's dtype
    :param bias: (B, Sk) f32, 0 for a valid key and -1e9 for a masked one
    :param dropout_rate: attention-probability dropout, in [0, 1)
    :param seed: one-element int32 tensor on q's device, needed when
        dropout_rate > 0 (:func:`draw_seed`)
    :return: (out (B, Sq, E) in q's dtype, lse (B, Sq, H) f32)
    """
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, sm_scale, num_heads, dropout_rate,
                                     seed)
    b, sq, e = q.shape
    sk = k.shape[1]
    d = _check_operands(q, (("k", k, (b, sk, e), q.dtype), ("v", v, (b, sk, e), q.dtype),
                            ("bias", bias, (b, sk), torch.float32)), num_heads)
    drop, seed_ptr, threshold, keep_scale = _dropout_args(dropout_rate, seed, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, num_heads), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    wgmma = route(d, q.dtype) == "wgmma"
    if wgmma:
        plan = wgmma_plan(q, k, v, num_heads, _num_sms(q.device.index))
        err = _wgmma_library().flash_attention_fwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, num_heads, d, plan["tile"][1], _map_words(plan),
            plan["q_tiles"], plan["tiles"], plan["grid"], float(sm_scale), drop, seed_ptr,
            threshold, keep_scale, stream)
    else:
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, sq, sk, num_heads, d,
            0 if q.dtype == torch.float32 else 1, float(sm_scale), drop, seed_ptr,
            threshold, keep_scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    if wgmma:
        tiles = flash_attention_fwd.wgmma_tiles
        tiles[plan["tile"]] = tiles.get(plan["tile"], 0) + 1
    return out, lse


flash_attention_fwd.launches = 0  # kernel launches; tests and smoke runs reset it
# the launches of the wgmma kernel among them, by tile (query rows, heads)
flash_attention_fwd.wgmma_tiles = {}


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                        d_out: torch.Tensor, sm_scale: float, num_heads: int,
                        dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd` from its
    (out, lse) and the output gradient ``d_out`` (like q); ``dropout_rate``
    and ``seed`` must be the forward's. On the card one call launches three
    kernels (delta, dK/dV, dQ; :func:`bwd_route` picks them) and counts
    once."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, out, lse, d_out, sm_scale,
                                         num_heads, dropout_rate, seed)
    b, sq, e = q.shape
    sk = k.shape[1]
    d = _check_operands(q, (("k", k, (b, sk, e), q.dtype), ("v", v, (b, sk, e), q.dtype),
                            ("bias", bias, (b, sk), torch.float32),
                            ("out", out, (b, sq, e), q.dtype),
                            ("lse", lse, (b, sq, num_heads), torch.float32),
                            ("d_out", d_out, (b, sq, e), q.dtype)), num_heads)
    drop, seed_ptr, threshold, keep_scale = _dropout_args(dropout_rate, seed, q.device)
    delta = torch.empty((b, sq, num_heads), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            lse.data_ptr(), d_out.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, num_heads, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if bwd_route(d, q.dtype) == "wgmma":
        plan = wgmma_bwd_plan(q, k, v, d_out, num_heads)
        err = _wgmma_bwd_library().flash_attention_bwd_wgmma(
            *ptrs, _map_words(plan, ("q", "k", "v", "d_out")), float(sm_scale), drop,
            seed_ptr, threshold, keep_scale, stream)
    else:
        err = _library().flash_attention_bwd(
            *ptrs, 0 if q.dtype == torch.float32 else 1, float(sm_scale), drop, seed_ptr,
            threshold, keep_scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0  # backward calls on the card (3 kernels each)


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_fwd` with :func:`flash_attention_bwd` as its
    gradient (the TPU package's ``flash_attention_flat.defvjp`` :605). The
    forward keeps (q, k, v, bias, out, lse, seed) for the backward, which
    never re-runs the forward. Both directions launch the kernels on a CUDA
    tensor and run the plain versions on a CPU tensor, or, with ``plain``
    (``attention_impl: xla``), on any tensor."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, num_heads, dropout_rate=0.0, seed=None,
                plain=False):
        fwd = flash_attention_plain if plain else flash_attention_fwd
        out, lse = fwd(q, k, v, bias, sm_scale, num_heads, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse, seed)
        ctx.args = (sm_scale, num_heads, dropout_rate, plain)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias, out, lse, seed = ctx.saved_tensors
        sm_scale, num_heads, dropout_rate, plain = ctx.args
        bwd = flash_attention_bwd_plain if plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, bias, out, lse, d_out.contiguous(), sm_scale, num_heads,
                         dropout_rate, seed)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, sm_scale: float, num_heads: int,
                         dropout_rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None,
                         plain: bool = False) -> torch.Tensor:
    """Differentiable attention output without the lse (the TPU package's
    ``flash_attention_flat`` :356); ``plain`` takes the plain versions."""
    return FlashAttention.apply(q, k, v, bias, sm_scale, num_heads, dropout_rate, seed,
                                plain)


def key_bias(key_valid: Optional[torch.Tensor], b: int, sk: int,
             device: torch.device) -> torch.Tensor:
    """(B, Sk) f32 additive bias from a bool key mask (True = valid)."""
    if key_valid is None:
        return torch.zeros((b, sk), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(key_valid, zero, torch.full_like(zero, NEG_INF))


def mha_flash_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int, key_valid: Optional[torch.Tensor],
                   sm_scale: float, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   plain: bool = False, seed_salt: int = 0) -> torch.Tensor:
    """Adapter from the model's flat (B, T, E) projections and a bool key
    mask (B, Sk) (the TPU package's ``mha_flash_flat`` :644). The kernels
    mask the ragged key edge themselves, so keys are not padded. With
    dropout the per-call seed is drawn from ``generator``, never from
    torch's global generator; a nonzero ``seed_salt`` (a tensor-parallel
    rank's index in its model group) is mixed into it, so the ranks' local
    heads drop independently while every rank draws alike from its
    generator. ``plain`` (``attention_impl: xla``) runs the plain versions
    on any device."""
    seed = None
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout draws its seed from a generator the "
                             "caller passes")
        seed = draw_seed(generator, q.device)
        if seed_salt:
            seed = seed ^ (seed_salt * 0x2545F491 & 0x7FFFFFFF)
    bias = key_bias(key_valid, k.shape[0], k.shape[1], k.device)
    return flash_attention_flat(q, k, v, bias, sm_scale, num_heads, dropout_rate, seed,
                                plain)


def kernel_info(head_dim: int, dtype: torch.dtype) -> dict:
    """Which kernels a (head_dim, dtype) takes on the card: ``route``, the
    forward's (:func:`route`'s choice: "wgmma", "mma.sync" or "simt");
    ``bwd_route``, the backward's (:func:`bwd_route`'s); the dynamic shared
    memory in bytes of the forward, dK/dV and dQ kernels; for the wgmma
    forward the kernel's K/V stages, threads a block and ``tiles``,
    {(query rows, heads): shared memory bytes} of each tile
    :func:`wgmma_tile` may pick at this head dim (``smem_fwd`` is the
    one-head tile's); for the wgmma backward its ring's ``bwd_stages`` and
    ``bwd_threads`` a block. Builds the libraries if needed."""
    want, want_bwd = route(head_dim, dtype), bwd_route(head_dim, dtype)
    info = (ctypes.c_int * 3)()
    err = _library().flash_attention_info(head_dim, 0 if dtype == torch.float32 else 1,
                                          info)
    if err != 0:
        raise RuntimeError(f"flash_attention_info failed: cudaError {err}")
    out = {"route": want, "bwd_route": want_bwd,
           "smem_fwd": info[0], "smem_dkdv": info[1], "smem_dq": info[2]}
    if want == "wgmma":
        lib = _wgmma_library()
        tiles = {tile: _wgmma_info(lib, head_dim, tile[1]) for tile in _wgmma_tiles(head_dim)}
        one = tiles[(WGMMA_BQ, 1)]
        out.update(smem_fwd=one[0], stages=one[1], threads=one[2],
                   tiles={tile: w[0] for tile, w in tiles.items()})
    if want_bwd == "wgmma":
        w = _wgmma_bwd_info(_wgmma_bwd_library(), head_dim)
        out.update(smem_dkdv=w[0], smem_dq=w[1], bwd_stages=w[2], bwd_threads=w[3])
    return out


def _wgmma_tiles(head_dim: int):
    """The (query rows, heads) tiles :func:`wgmma_tile` may pick at a head
    dim of the wgmma route."""
    return [(WGMMA_BQ, 1)] + ([(WGMMA_BQ_PAIR, 2)] if head_dim == WGMMA_BOX_COLS else [])


def _wgmma_info(lib: ctypes.CDLL, head_dim: int, heads: int) -> list:
    """The wgmma library's report on its tile of ``heads`` heads at a head
    dim: shared memory bytes, K/V stages, threads, box columns, query rows,
    keys a tile."""
    w = (ctypes.c_int * 6)()
    err = lib.flash_attention_wgmma_info(head_dim, heads, w)
    if err != 0:
        raise RuntimeError(f"flash_attention_wgmma_info(D={head_dim}, {heads} head(s)) "
                           f"failed: cudaError {err}")
    return list(w)


def _wgmma_bwd_info(lib: ctypes.CDLL, head_dim: int) -> list:
    """The wgmma backward library's report on its kernels at a head dim:
    dK/dV and dQ shared memory bytes, stages, threads, box columns, box
    rows."""
    w = (ctypes.c_int * 6)()
    err = lib.flash_attention_bwd_wgmma_info(head_dim, w)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_wgmma_info(D={head_dim}) failed: "
                           f"cudaError {err}")
    return list(w)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.flash_attention_info.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        lib.flash_attention_info.restype = ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f,
                                            i, p, u, f, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                            i, i, f, i, p, u, f, p]
        lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def _wgmma_library() -> ctypes.CDLL:
    """The wgmma forward's library. When it first loads, the boxes it was
    compiled for must be the plan's (:data:`WGMMA_BOX_COLS`,
    :data:`WGMMA_BQ`, :data:`WGMMA_BQ_PAIR`, :data:`WGMMA_BK`) for every
    tile :func:`wgmma_tile` may pick at every head dim :func:`route` sends
    there, or it raises."""
    lib = cuda_build.load("flash_attention_wgmma")
    if lib.flash_attention_fwd_wgmma.argtypes is None:
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.flash_attention_wgmma_info.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        lib.flash_attention_wgmma_info.restype = ctypes.c_int
        for d in WGMMA_HEAD_DIMS:
            for rows, heads in _wgmma_tiles(d):
                got = tuple(_wgmma_info(lib, d, heads)[3:])
                if got != (WGMMA_BOX_COLS, rows, WGMMA_BK):
                    raise RuntimeError(
                        f"the wgmma library's D={d} {heads}-head tile has boxes (columns, "
                        f"query rows, keys) {got}, the plan {(WGMMA_BOX_COLS, rows, WGMMA_BK)}")
        lib.flash_attention_fwd_wgmma.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_ulonglong), i, i, i,
            f, i, p, u, f, p]
        lib.flash_attention_fwd_wgmma.restype = ctypes.c_int
    return lib


def _wgmma_bwd_library() -> ctypes.CDLL:
    """The wgmma backward's library. When it first loads, the boxes it was
    compiled for must be the plan's (:data:`WGMMA_BOX_COLS` columns x
    :data:`WGMMA_BWD_ROWS` rows) at every head dim :func:`bwd_route` sends
    there, or it raises."""
    lib = cuda_build.load("flash_attention_bwd_wgmma")
    if lib.flash_attention_bwd_wgmma.argtypes is None:
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.flash_attention_bwd_wgmma_info.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        lib.flash_attention_bwd_wgmma_info.restype = ctypes.c_int
        for d in WGMMA_BWD_HEAD_DIMS:
            got = tuple(_wgmma_bwd_info(lib, d)[4:])
            if got != (WGMMA_BOX_COLS, WGMMA_BWD_ROWS):
                raise RuntimeError(
                    f"the wgmma backward library's D={d} kernels have boxes (columns, rows) "
                    f"{got}, the plan {(WGMMA_BOX_COLS, WGMMA_BWD_ROWS)}")
        lib.flash_attention_bwd_wgmma.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_ulonglong), f, i, p, u, f, p]
        lib.flash_attention_bwd_wgmma.restype = ctypes.c_int
    return lib
