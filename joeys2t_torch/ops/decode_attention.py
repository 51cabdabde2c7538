# coding: utf-8
"""
Single-position (autoregressive decode) attention: the hand-written CUDA
kernels (``csrc/decode_attention.cu``) and their plain PyTorch version.

Counterpart of joeys2t_tpu/ops/decode_attention.py. Per (batch row, head) one
query attends over a (B, H, S, D) K/V cache in f32, bf16 or int8; with
``group`` G > 1, G query rows share each cache row (q is (B*G, H, D), query
row r reads cache row r // G), as beam search asks the beam-shared cross
cache (the JAX einsum of models/modules.py ``step_cross`` with ``beam_k``).
int8 caches carry scales in one of two layouts, folded without
materializing a dequantized cache:

  - "channel" (B, H, D): the cross-attention cache; scales fold into q (K)
    and into the context (V);
  - "position" (B, H, S): the self-attention ring buffer; scales fold into
    the scores (K) and into the probabilities (V).

With an ``ancestry`` map (lazy beam reorder) the caches are the B*K beam
rows' own self-attention ring buffers, never permuted: query row
r = b*K + k reads, at position s, cache row b*K + anc[b, k, s] (K, V and
their "position" scales alike), which is the attention of
reorder-then-attend without the reorder (the JAX einsum of
models/modules.py ``step_self_ancestry``, which has no Pallas kernel).

Known divergence from the Pallas kernel: it rounds the scaled q to bf16
even for f32 inputs (decode_attention.py:64); this port does not, and
matches the JAX einsum path (models/modules.py ``_decode_einsum``) instead.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches a kernel or raises. One query a cache row (greedy, the physical
beam reorder) takes the one-query kernel; ``group`` > 1 and the ancestry
map take the multi-query kernel, one block or cluster per (utterance, head)
serving all of the utterance's queries, so that each cache vector they
share is read from device memory once (:func:`launch_grid`). Both split S
over a cluster of blocks as :func:`decode_plan` says, and skip slots whose
bias is at or below ``NEG_INF / 2`` when the query has any other key.
"""
import ctypes
import functools
from typing import Optional, Tuple

import torch

from joeys2t_torch.ops import cuda_build

NEG_INF = -1e9
_LAYOUTS = {None: 0, "channel": 1, "position": 2}
MAX_SPLITS = 16  # the largest thread-block cluster Hopper launches
SPLIT_ALIGN = 16  # a split starts on a multiple of this many rows
MIN_SPLIT_GROUPS = 6  # a split takes at least this many SPLIT_ALIGN-row groups
# slots a split of the multi-query kernel takes, from slot 0: a slot's place
# in its arithmetic depends on its index alone, so an utterance's bits do not
# depend on its batch (nor on the padding the batch's longest source adds)
MULTI_SPLIT_SLOTS = 96
HEAD_DIMS = (16, 64, 128, 192, 256)  # the head sizes the kernel is built for
MAX_QUERIES = 8  # queries a block of the multi-query kernel serves (a chunk)
MAX_BLOCKS_Z = 65535  # the grid's third dimension: (utterances or rows) x chunks


def decode_plan(b: int, h: int, s: int, num_sms: int) -> Tuple[int, int]:
    """How the kernel splits the S rows of each (b, h) over one cluster of
    blocks on a card of ``num_sms`` SMs: ``(splits, split_rows)``, every
    split non-empty and starting on a multiple of ``SPLIT_ALIGN`` rows. One
    split once the B*H blocks alone fill the card; below that, enough splits
    for about two blocks an SM, at most ``MAX_SPLITS`` and with
    ``MIN_SPLIT_GROUPS`` row groups a split or more (a shorter split saves
    less time than its share of the cluster's merge costs)."""
    pairs, groups = b * h, -(-s // SPLIT_ALIGN)
    want = 1 if pairs >= num_sms else -(-2 * num_sms // pairs)
    splits = max(1, min(MAX_SPLITS, -(-groups // MIN_SPLIT_GROUPS), want))
    split_rows = -(-groups // splits) * SPLIT_ALIGN
    return -(-s // split_rows), split_rows


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    """The SM count of a CUDA device, which :func:`decode_plan` plans for."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_grid(rows: int, h: int, s: int, num_sms: int, group: int = 1,
                beam_k: Optional[int] = None, slots: Optional[int] = None) -> dict:
    """The launch of one decode call over ``rows`` cache rows of S slots
    with H heads: ``group`` query rows a cache row, or the ancestry map of
    ``beam_k`` beams an utterance. One query a cache row takes the
    one-query kernel, a block (cluster) per (cache row, head), planned over
    all S slots. Otherwise the multi-query kernel takes one block (cluster)
    per (utterance, head, chunk of ``MAX_QUERIES`` queries) -- the cache row
    in group mode, the beam rows of an utterance with a map -- planned over
    the ``slots`` leading slots the step can use (all S by default), so no
    split holds only padding: splits of ``MULTI_SPLIT_SLOTS`` slots from
    slot 0 (larger multiples of it beyond ``MAX_SPLITS`` splits). A slot's
    split and place in the arithmetic depend on its index alone, and masked
    slots add exact zeros: up to 1536 slots the kernel's bits for an
    utterance are the same in any batch and under any padding, and a beam
    search's hypotheses with them. Returns the kernel's name, the utterances,
    queries an utterance, chunks, ``(splits, split_rows)`` and the grid."""
    multi = group > 1 or beam_k is not None
    used = s if slots is None or not multi else slots
    if not multi:
        splits, split_rows = decode_plan(rows, h, s, num_sms)
        return dict(kernel="one-query", utterances=rows, queries=1, chunks=1, slots=s,
                    splits=splits, split_rows=split_rows, grid=(splits, h, rows))
    utterances, queries = (rows, group) if beam_k is None else (rows // beam_k, beam_k)
    chunks = -(-queries // MAX_QUERIES)
    # beyond MAX_SPLITS splits (over 1536 slots) the splits grow, by whole
    # multiples of MULTI_SPLIT_SLOTS
    split_rows = MULTI_SPLIT_SLOTS * -(-used // (MULTI_SPLIT_SLOTS * MAX_SPLITS))
    splits = -(-used // split_rows)
    return dict(kernel="multi-query", utterances=utterances, queries=queries,
                chunks=chunks, slots=used, splits=splits, split_rows=split_rows,
                grid=(splits, h, utterances * chunks))


def _resolve_layout(k: torch.Tensor, k_scale: Optional[torch.Tensor],
                    scale_layout: Optional[str]) -> Optional[str]:
    b, h, s, d = k.shape
    if k_scale is None:
        return None
    if scale_layout is None:
        if s == d:
            raise ValueError("S == D: pass scale_layout explicitly")
        scale_layout = "channel" if tuple(k_scale.shape) == (b, h, d) else "position"
    if scale_layout not in ("channel", "position"):
        raise ValueError(f"scale_layout must be 'channel' or 'position', "
                         f"got {scale_layout!r}")
    return scale_layout


def _check_slots(k: torch.Tensor, slots: Optional[int]) -> None:
    if slots is not None and not 1 <= slots <= k.shape[2]:
        raise ValueError(f"slots: expected 1 to {k.shape[2]}, got {slots}")


def _check_ancestry(k: torch.Tensor, ancestry: Optional[torch.Tensor], group: int,
                    layout: Optional[str]) -> None:
    if ancestry is None:
        return
    if group != 1 or layout == "channel":
        raise ValueError("an ancestry map reads self-attention ring buffers: group 1, "
                         "no channel scales")
    rows, s = k.shape[0], k.shape[2]
    if ancestry.dim() != 3 or ancestry.shape[0] * ancestry.shape[1] != rows \
            or ancestry.shape[2] != s:
        raise ValueError(f"ancestry: expected (B, K, {s}) with B*K = {rows}, got "
                         f"{tuple(ancestry.shape)}")


def gather_ancestry(x: torch.Tensor, ancestry: torch.Tensor) -> torch.Tensor:
    """The (B*K, H, S, ...) buffer ``x`` reordered as the ancestry map
    (B, K, S) reads it: row b*K + k, position s, is x's row
    b*K + anc[b, k, s] at s (a ring buffer or its "position" scales)."""
    b, kb, s = ancestry.shape
    own = (torch.arange(b, device=x.device) * kb)[:, None, None]
    rows = (own + ancestry.long()).reshape(b * kb, s)
    pos = torch.arange(s, device=x.device)[None, :]
    return x.transpose(1, 2)[rows, pos].transpose(1, 2)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, *,
                           sm_scale: float = 1.0,
                           scale_layout: Optional[str] = None,
                           group: int = 1,
                           ancestry: Optional[torch.Tensor] = None,
                           slots: Optional[int] = None) -> torch.Tensor:
    """The kernel's math in plain PyTorch, all in f32; returns (B*G, H, D) in
    q's dtype. With ``ancestry`` it gathers each beam's history rows
    (:func:`gather_ancestry`) and attends over them. Slots from ``slots`` on
    count as masked (bias ``NEG_INF``)."""
    layout = _resolve_layout(k, k_scale, scale_layout)
    _check_ancestry(k, ancestry, group, layout)
    _check_slots(k, slots)
    if slots is not None and slots < k.shape[2]:
        bias = bias.clone()
        bias[:, slots:] = NEG_INF
    if ancestry is not None:
        k, v = gather_ancestry(k, ancestry), gather_ancestry(v, ancestry)
        if layout == "position":
            k_scale, v_scale = gather_ancestry(k_scale, ancestry), gather_ancestry(
                v_scale, ancestry)
    b, h, _, d = k.shape
    qf = q.float().reshape(b, group, h, d) * sm_scale
    if layout == "channel":
        qf = qf * k_scale.float()[:, None]
    scores = torch.einsum("bghd,bhsd->bghs", qf, k.float())
    if layout == "position":
        scores = scores * k_scale.float()[:, None]
    p = torch.softmax(scores + bias.float()[:, None, None, :], dim=-1)
    if layout == "position":
        p = p * v_scale.float()[:, None]
    ctx = torch.einsum("bghs,bhsd->bghd", p, v.float())
    if layout == "channel":
        ctx = ctx * v_scale.float()[:, None]
    return ctx.reshape(q.shape).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, *,
                     sm_scale: float = 1.0,
                     scale_layout: Optional[str] = None,
                     group: int = 1,
                     ancestry: Optional[torch.Tensor] = None,
                     slots: Optional[int] = None) -> torch.Tensor:
    """Single-step attention context (B*G, H, D) with fused int8 dequant.

    :param q: (B*G, H, D) f32 or bf16; query row r reads cache row r // G
    :param k, v: (B, H, S, D) in q's dtype, or int8 with scales
    :param bias: (B, S) f32 additive mask, 0 or -1e9
    :param k_scale, v_scale: f32 (B, H, D) "channel" or (B, H, S) "position";
        inferred from the shape when ``scale_layout`` is None (ambiguous
        when S == D)
    :param group: G, the query rows that share each cache row
    :param ancestry: (B, K, S) int32 map of the lazy beam reorder, entries in
        [0, K): query row b*K + k reads cache row b*K + anc[b, k, s] at
        position s (group 1, no "channel" scales). On the card it must be
        int32, contiguous and on q's device; an entry outside [0, K) is
        clamped into it, so no utterance reads another's rows.
    :param slots: the leading slots the step can use (a ring buffer at step
        t: t + 1); slots from it on count as masked whatever ``bias`` holds.
        The multi-query kernel (``group`` > 1 or a map) plans its splits
        over them; on the card one query a cache row takes no ``slots``
        below S.
    """
    if group < 1 or q.shape[0] != k.shape[0] * group:
        raise ValueError(f"q has {q.shape[0]} rows, expected {group} for each of the "
                         f"{k.shape[0]} cache rows")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, bias, k_scale, v_scale,
                                      sm_scale=sm_scale, scale_layout=scale_layout,
                                      group=group, ancestry=ancestry, slots=slots)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cpu or cuda, not {q.device}")
    b, h, s, d = k.shape
    layout = _resolve_layout(k, k_scale, scale_layout)
    _check_ancestry(k, ancestry, group, layout)
    _check_slots(k, slots)
    if q.dtype not in (torch.float32, torch.bfloat16) or d not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes f32/bf16 q and head_dim in "
                         f"{'/'.join(map(str, HEAD_DIMS))}, got {q.dtype} and {d}")
    int8 = k.dtype == torch.int8
    if int8 != (layout is not None):
        raise ValueError("int8 caches need scales and scales need int8 caches")
    kv_dtype = torch.int8 if int8 else q.dtype
    checks = [("q", q, (b * group, h, d), q.dtype), ("k", k, (b, h, s, d), kv_dtype),
              ("v", v, (b, h, s, d), kv_dtype), ("bias", bias, (b, s), torch.float32)]
    if int8:
        scale_shape = (b, h, d) if layout == "channel" else (b, h, s)
        checks += [("k_scale", k_scale, scale_shape, torch.float32),
                   ("v_scale", v_scale, scale_shape, torch.float32)]
    if ancestry is not None:
        checks.append(("ancestry", ancestry, tuple(ancestry.shape), torch.int32))
    for name, t, shape, dtype in checks:
        if (t is None or tuple(t.shape) != shape or t.dtype != dtype
                or t.device != q.device or not t.is_contiguous()
                or (name in ("q", "k", "v", "k_scale") and t.data_ptr() % 16)):
            desc = "None" if t is None else f"{tuple(t.shape)} {t.dtype} on {t.device}"
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} on {q.device} "
                             f"(q, caches and k_scale 16-byte aligned), got {desc}")
    grid = launch_grid(b, h, s, num_sms(q.device), group,
                       None if ancestry is None else ancestry.shape[1], slots)
    if grid["kernel"] == "one-query" and slots is not None and slots < s:
        raise ValueError("slots: the one-query kernel reads the bias of all S slots")
    if grid["grid"][2] > MAX_BLOCKS_Z:
        raise ValueError(f"decode kernel: {grid['grid'][2]} blocks in the grid's third "
                         f"dimension, at most {MAX_BLOCKS_Z}")
    out = torch.empty((b * group, h, d), dtype=q.dtype, device=q.device)
    err = _launch(q, k, v, bias, k_scale, v_scale, out, layout,
                  (grid["splits"], grid["split_rows"]), sm_scale, group, ancestry,
                  grid["slots"])
    if err != 0:
        raise RuntimeError(f"decode_attention_fwd launch failed: cudaError {err}")
    decode_attention.launches += 1
    if ancestry is not None:
        decode_attention.ancestry_launches += 1
    if group > 1:
        decode_attention.group_launches += 1
    if layout == "channel":
        decode_attention.channel_launches += 1
    elif layout == "position":
        decode_attention.position_launches += 1
    return out


decode_attention.launches = 0  # kernel launches; tests and smoke runs reset it
decode_attention.group_launches = 0  # the launches among them with group > 1
decode_attention.channel_launches = 0  # ... on int8 caches with channel scales
decode_attention.position_launches = 0  # ... on int8 caches with position scales
decode_attention.ancestry_launches = 0  # ... reading the caches through an ancestry map


def quantize_per_position(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize (..., S, D) with one f32 scale per (..., s) slot (the
    self-attention ring buffer writes each slot once, as it is emitted)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _launch(q, k, v, bias, k_scale, v_scale, out, layout: Optional[str],
            plan: Tuple[int, int], sm_scale: float, group: int = 1,
            ancestry: Optional[torch.Tensor] = None, slots: Optional[int] = None) -> int:
    """One launch of a kernel on checked tensors with the launch plan
    ``(splits, split_rows)`` over ``slots`` (all S by default); returns its
    cudaError_t (0 on success)."""
    b, h, s, d = k.shape
    int8 = layout is not None
    return _library().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None,
        None if ancestry is None else ancestry.data_ptr(),
        1 if ancestry is None else ancestry.shape[1],
        out.data_ptr(), b, group, h, s, s if slots is None else slots, d,
        0 if q.dtype == torch.float32 else 1, int(int8), _LAYOUTS[layout], plan[0],
        plan[1], float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
