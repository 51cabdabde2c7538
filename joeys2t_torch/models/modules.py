# coding: utf-8
"""
Transformer building blocks as PyTorch modules (counterpart of
joeys2t_tpu/models/modules.py).

Parameters are named as in the reference torch implementation, so a state
dict converts to and from the JAX package's parameter tree
(joeys2t_torch/convert.py). Math contracts kept from the JAX package:
q scaled by 1/sqrt(head_dim), masking with the finite NEG_INF = -1e9,
LayerNorm eps 1e-6 with LayerNorm and softmax in float32, matmuls in the
module's compute ``dtype`` (bfloat16 on the card), residual scale ``alpha``.

Attention routing: full-length attention with a key-padding mask goes
through :class:`~joeys2t_torch.ops.flash_attention.FlashAttention`, forward
and backward, with attention dropout inside the kernel in training mode; the
per-step decode attention over the (B, H, S, D) caches goes through the
decode-attention wrapper. Both run the hand-written CUDA kernels on a CUDA
tensor (or raise, for a head size or dtype the kernels do not take) and
their plain versions on a CPU tensor. Attention with a full (B, Tq, Tk)
mask, such as causal decoder self-attention over a whole sequence, stays
plain PyTorch, as the JAX module's einsum path (modules.py:102-123), and so
does key-masked attention on a CPU tensor at a head size the kernel does not
take.

Dropout: in ``train()`` every dropout of the JAX modules fires at the same
places, attention dropout included, and each draws from the generator the
trainer hands the model (:func:`set_dropout_generator`), never from torch's
global generator. The masks are not the JAX package's: the two frameworks'
random bits differ.

``attention_impl`` (:func:`set_attention_impl`, JAX's ``attn_impl``):
``xla`` makes every attention take the plain PyTorch versions of the
kernels (flash forward and backward, decode attention with and without the
ancestry map), on the card too; ``auto``, ``flash`` and ``decode_kernel``
take the kernels on a CUDA tensor. JAX gates its Pallas kernels
by backend; the port's kernels exist on the card only, so the three agree.

Tensor parallelism (``parallel/tp.py``): a module whose ``tp`` is set holds
this rank's shards and calls the model group's collectives where Megatron
puts them; attention computes its local heads, the mixture of experts its
local experts on every token. A dropout of a sharded activation draws the
whole tensor's mask from the generator and keeps this rank's part of it
(:class:`Dropout`'s ``shard``), so every rank of the group draws the same
shapes in the same order, the replicated stream stays identical on them,
and the masks are the unsharded model's. The flash kernel's per-call seed
is decorrelated across the model ranks instead, as JAX's
``mha_flash_sharded`` folds the model index into its key
(joeys2t_tpu/ops/flash_attention.py:732-736).

Unlike the functional JAX modules, ``step_self`` and ``step_self_ancestry``
write the new key/value into the caller's self-attention cache in place,
and the decode steps take additive (B, S) biases that the decoder builds
once per step (self) or once per utterance (cross) instead of masks.
"""
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from joeys2t_torch.ops.decode_attention import (decode_attention, decode_attention_plain,
                                                quantize_per_position)
from joeys2t_torch.ops.flash_attention import mha_flash_flat, supported
from joeys2t_torch.parallel.tp import copy_to as tp_copy
from joeys2t_torch.parallel.tp import reduce as tp_reduce

NEG_INF = -1e9
ATTENTION_IMPLS = ("auto", "xla", "flash", "decode_kernel")


class Dropout(nn.Module):
    """Dropout whose mask comes from ``generator`` (set by
    :func:`set_dropout_generator`); a kept value is divided by the keep
    probability, as flax's ``nn.Dropout`` does. Identity in eval mode or at
    rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def active(self) -> bool:
        """Whether this dropout fires; raises if it would but has no
        generator."""
        if not self.training or self.rate == 0.0:
            return False
        if self.generator is None:
            raise RuntimeError("training-mode dropout needs a generator: call "
                               "set_dropout_generator(model, generator)")
        return True

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """``shard`` (dim, rank, world) says that ``x`` is part ``rank`` of
        ``world`` equal parts along ``dim`` of a larger tensor: the larger
        tensor's mask is drawn and this part of it kept."""
        if not self.active():
            return x
        shape = list(x.shape)
        if shard is not None:
            shape[shard[0]] *= shard[2]
        keep = torch.rand(shape, generator=self.generator,
                          device=self.generator.device).to(x.device) >= self.rate
        if shard is not None:
            dim, rank, _ = shard
            keep = keep.narrow(dim, rank * x.shape[dim], x.shape[dim])
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every :class:`Dropout` of ``model`` the generator it draws from
    in training mode (the trainer's; JAX's ``rngs={"dropout": ...}``)."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator = generator


def set_attention_impl(model: nn.Module, impl: str) -> None:
    """Route every :class:`MultiHeadedAttention` of ``model`` as JAX's
    ``attn_impl`` says: ``xla`` to the plain versions of the kernels, the
    other values to the kernels (on a CUDA tensor)."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {impl!r}")
    for module in model.modules():
        if isinstance(module, MultiHeadedAttention):
            module.plain = impl == "xla"


def rematerialized(layer: nn.Module, *args) -> torch.Tensor:
    """``layer(*args)`` under ``torch.utils.checkpoint`` in training (JAX's
    ``nn.remat`` of a layer, ``remat: True``): the layer keeps only its
    inputs, and the backward runs its forward again. The recomputation
    replays the dropout of the first run: the port's dropout and the flash
    kernel's seed draw from explicit generators, which a checkpoint does not
    restore, so their states from before the first run are set again around
    the recomputation, and put back after it. Outside training the layer
    simply runs."""
    if not (layer.training and torch.is_grad_enabled()):
        return layer(*args)
    generators = list({id(m.generator): m.generator for m in layer.modules()
                       if isinstance(m, Dropout) and m.generator is not None}.values())
    before = [g.get_state() for g in generators]
    runs = []

    def run(*inputs):
        if not runs:  # the forward
            runs.append(1)
            return layer(*inputs)
        now = [g.get_state() for g in generators]
        for g, state in zip(generators, before):
            g.set_state(state)
        try:
            return layer(*inputs)
        finally:
            for g, state in zip(generators, now):
                g.set_state(state)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def build_activation(activation: str = "relu") -> nn.Module:
    """Activation map (joeynmt/builders.py:24-41); gelu is flax's default
    tanh approximation."""
    if activation == "relu":
        return nn.ReLU()
    if activation == "gelu":
        return nn.GELU(approximate="tanh")
    if activation == "tanh":
        return nn.Tanh()
    if activation == "swish":
        return nn.SiLU()
    raise ValueError(
        "Invalid activation function. Valid options: 'relu', 'gelu', 'tanh', 'swish'.")


def sinusoidal_pe(length: int, size: int, device=None) -> torch.Tensor:
    """Sinusoidal positional encoding table (length, size), float32:
    interleaved sin (even dims) / cos (odd dims), wavelengths 10000^(2i/d)."""
    if size % 2 != 0:
        raise ValueError(
            f"Cannot use sin/cos positional encoding with odd dim (got dim={size})")
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, size, 2, dtype=torch.float32, device=device)
                         * -(math.log(10000.0) / size))
    pe = torch.zeros((length, size), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (a flax ``Dense(dtype=...)``); casting
    weights already in ``dtype`` is free."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class _Float32Product(torch.autograd.Function):
    """x @ w.T of bfloat16 operands with a float32 result (the GEMM's own
    accumulator, not rounded to bfloat16; on the CPU, which has no such
    GEMM, the float32 product of the operands); the backward is the
    bfloat16 GEMMs of ``F.linear``'s."""

    @staticmethod
    def forward(ctx, x, w):  # pylint: disable=arguments-differ
        ctx.save_for_backward(x, w)
        flat = x.reshape(-1, x.shape[-1])
        if flat.is_cuda:
            out = torch.mm(flat, w.t(), out_dtype=torch.float32)
        else:
            out = flat.float() @ w.float().t()
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        return g @ w, g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])


def column_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp,
                 region: bool = True) -> torch.Tensor:
    """``layer`` applied in ``dtype``; with ``tp`` a column-parallel shard
    whose input enters the model group's region (``tp.enter``; with
    ``region`` False a replicated input, the encoder memory, which is only
    copied)."""
    if tp is not None:
        x = tp.enter(x) if region else tp_copy(x, tp)
    return dense(layer, x, dtype)


def row_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp) -> torch.Tensor:
    """``layer`` applied in ``dtype``; with ``tp`` a row-parallel shard: the
    partial products leave the region (``tp.exit``) in float32 and the
    replicated bias is added to their sum, which is rounded to ``dtype``
    once, as the unsharded layer's accumulator is."""
    if tp is None:
        return dense(layer, x, dtype)
    x, w = x.to(dtype), layer.weight.to(dtype)
    part = F.linear(x, w) if dtype == torch.float32 else _Float32Product.apply(x, w)
    return (tp.exit(part) + layer.bias.to(dtype).float()).to(dtype)


def seq_shard(tp):
    """The Dropout shard of a residual-stream tensor under ``tp``."""
    return None if tp is None else tp.seq_shard()


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm computed in float32, result cast to ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


def _layer_norm_module(size: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(size, eps=1e-6, device=device)


class MultiHeadedAttention(nn.Module):
    """Multi-head attention (joeynmt/transformer_layers.py:17-115) with the
    decode entry points ``project_kv``, ``step_self``,
    ``step_self_ancestry`` and ``step_cross``. ``plain`` (set by
    :func:`set_attention_impl`) takes the kernels' plain versions."""

    def __init__(self, num_heads: int, size: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if size % num_heads:
            raise ValueError(f"size {size} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.size = size
        self.head_size = size // num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.k_layer = nn.Linear(size, size, device=device)
        self.v_layer = nn.Linear(size, size, device=device)
        self.q_layer = nn.Linear(size, size, device=device)
        self.output_layer = nn.Linear(size, size, device=device)
        self.attn_dropout = Dropout(dropout)
        self.plain = False  # attention_impl: xla
        self.tp = None  # the model group of a tensor-parallel shard

    # decode steps that returned their attention weights on the plain math
    # (``step_cross(return_weights=True)``); tests and smoke runs reset it
    weight_steps = 0

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, size) -> (B, T, H, Dh)"""
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_size)

    def project_kv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-head key/value projections, shape (B, T, H, Dh) each."""
        return (self._split_heads(dense(self.k_layer, x, self.dtype)),
                self._split_heads(dense(self.v_layer, x, self.dtype)))

    def _attend(self, q, k, v, mask):
        """Plain attention on (B, T, H, Dh) heads; mask bool, broadcastable
        to (B, H, Tq, Tk)."""
        q = q / math.sqrt(self.head_size)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if mask is not None:
            scores = scores.masked_fill(~mask, NEG_INF)
        tp = self.tp
        probs = self.attn_dropout(torch.softmax(scores, dim=-1).to(self.dtype),
                                  shard=None if tp is None else (1, tp.rank, tp.world))
        context = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return row_dense(self.output_layer,
                         context.reshape(q.shape[0], q.shape[1], self.size), self.dtype, tp)

    def forward(self, k: torch.Tensor, v: torch.Tensor, q: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence attention; ``mask`` bool, (B, 1, Tk) key mask or
        (B, Tq, Tk) full mask. As in the JAX module, both keys and values
        are projected from ``k``. Under tensor parallelism ``q`` enters the
        model group's region (its slice of the sequence under sequence
        parallelism), and ``k`` with it when it is ``q`` (self-attention),
        else as the replicated memory it is."""
        del v
        tp, region = self.tp, k is q
        q, k, v = (column_dense(layer, x, self.dtype, tp, r) for layer, x, r in (
            (self.q_layer, q, True), (self.k_layer, k, region), (self.v_layer, k, region)))
        key_mask_only = mask is None or (mask.dim() == 3 and mask.shape[1] == 1)
        if key_mask_only and (self.plain or q.device.type != "cpu"
                              or supported(self.head_size, self.dtype)):
            drop = self.attn_dropout.active()
            context = mha_flash_flat(
                q, k, v, self.num_heads,
                None if mask is None else mask[:, 0, :],
                1.0 / math.sqrt(self.head_size),
                dropout_rate=self.dropout if drop else 0.0,
                generator=self.attn_dropout.generator if drop else None, plain=self.plain,
                seed_salt=0 if tp is None else tp.rank)
            return row_dense(self.output_layer, context, self.dtype, tp)
        q_h, k_h, v_h = (self._split_heads(t) for t in (q, k, v))
        if mask is not None:
            mask = mask[:, None, :, :]  # head dim -> (B, 1, 1|Tq, Tk)
        return self._attend(q_h, k_h, v_h, mask)

    def step_self(self, q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                  index: int, bias: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One self-attention decode step (B, 1, size) -> (B, 1, size); writes
        this step's key/value into slot ``index`` of the (B, H, S_max, Dh)
        caches in place. ``bias`` (B, S_max) f32 is 0 at slots 0..index and
        NEG_INF beyond. int8 caches come with (B, H, S_max) f32 scales: the
        new slot is quantized on its own (``quantize_per_position``), its
        values and scale written in place, and the attention folds the
        scales in the "position" layout."""
        self._write_slot(q, cache_k, cache_v, index, k_scale, v_scale)
        return self._step(q, cache_k, cache_v, bias, k_scale=k_scale, v_scale=v_scale,
                          layout=None if k_scale is None else "position")

    def step_self_ancestry(self, q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, index: int, bias: torch.Tensor,
                           ancestry: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Beam self-attention without the physical reorder of the caches
        (joeys2t_tpu/models/modules.py ``step_self_ancestry`` :320-412):
        ``q`` (B*K, 1, size) writes its key/value (int8: with its scale)
        into its own row's slot ``index``, as :meth:`step_self` does, then
        attends over the (B, K, S_max) int32 ``ancestry`` map: position s of
        beam k of utterance b reads row b*K + anc[b, k, s] of the caches
        and of their scales. The same math as reorder-then-attend; slots
        0..index are the ones the step can use."""
        self._write_slot(q, cache_k, cache_v, index, k_scale, v_scale)
        return self._step(q, cache_k, cache_v, bias, k_scale=k_scale, v_scale=v_scale,
                          layout=None if k_scale is None else "position",
                          ancestry=ancestry, slots=index + 1)

    def _write_slot(self, q, cache_k, cache_v, index, k_scale, v_scale) -> None:
        """Write this step's key/value into slot ``index`` of each query
        row's own cache row; int8 slots are quantized on their own."""
        k_h, v_h = self.project_kv(q)  # (B, 1, H, Dh)
        if cache_k.dtype == torch.int8:
            for cache, scale, x in ((cache_k, k_scale, k_h), (cache_v, v_scale, v_h)):
                x_q, x_s = quantize_per_position(x[:, 0])  # (B, H, Dh), (B, H)
                cache[:, :, index] = x_q
                scale[:, :, index] = x_s
            return
        cache_k[:, :, index] = k_h[:, 0].to(cache_k.dtype)
        cache_v[:, :, index] = v_h[:, 0].to(cache_v.dtype)

    def step_cross(self, q: torch.Tensor, k_h: torch.Tensor, v_h: torch.Tensor,
                   bias: torch.Tensor, beam_k: int = 1,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None, return_weights: bool = False):
        """One cross-attention decode step (B*K, 1, size) -> (B*K, 1, size)
        against the precomputed (B, H, S, Dh) K/V; ``bias`` (B, S) f32 is 0
        at valid source frames and NEG_INF at padding. With ``beam_k`` K > 1
        the K beams of each utterance share its cross cache, which is never
        expanded to B*K rows. int8 K/V come with (B, H, Dh) f32 scales, folded
        in the "channel" layout. With ``return_weights`` (greedy only) the
        step takes the plain math instead of the decode-attention kernel,
        as JAX's ``step_cross`` takes its einsum path there
        (joeys2t_tpu/models/modules.py:461-470), and returns (output, the
        heads' mean of the float32 attention probabilities (B, 1, S))."""
        if return_weights:
            return self._step_weights(q, k_h, v_h, bias, k_scale, v_scale)
        return self._step(q, k_h, v_h, bias, beam_k, k_scale, v_scale,
                          None if k_scale is None else "channel")

    def _step_weights(self, q, k_h, v_h, bias, k_scale, v_scale):
        """The decode kernel's plain math (``decode_attention_plain``:
        float32 throughout, the context rounded once to the compute dtype)
        with the probabilities kept; at float32 it is JAX's
        ``_decode_einsum`` (joeys2t_tpu/models/modules.py:234-263), which in
        bfloat16 rounds q and the weights to the compute dtype first."""
        MultiHeadedAttention.weight_steps += 1
        q_h = self._split_heads(dense(self.q_layer, q, self.dtype))[:, 0]  # (B, H, Dh)
        qf = q_h.float() / math.sqrt(self.head_size)
        if k_scale is not None:
            qf = qf * k_scale.float()
        scores = torch.einsum("bhd,bhsd->bhs", qf, k_h.float())
        probs = torch.softmax(scores + bias.float()[:, None, :], dim=-1)
        ctx = torch.einsum("bhs,bhsd->bhd", probs, v_h.float())
        if v_scale is not None:
            ctx = ctx * v_scale.float()
        out = dense(self.output_layer, ctx.to(self.dtype).reshape(q.shape[0], 1, self.size),
                    self.dtype)
        return out, probs.mean(dim=1, keepdim=True)

    def _step(self, q, k_h, v_h, bias, group=1, k_scale=None, v_scale=None, layout=None,
              ancestry=None, slots=None):
        if self.tp is not None:
            raise RuntimeError("a tensor-parallel shard does not decode: decode the "
                               "gathered model")
        q_h = self._split_heads(dense(self.q_layer, q, self.dtype))
        attend = decode_attention_plain if self.plain else decode_attention
        ctx = attend(q_h[:, 0], k_h, v_h, bias, k_scale, v_scale,
                     sm_scale=1.0 / math.sqrt(self.head_size), scale_layout=layout,
                     group=group, ancestry=ancestry, slots=slots)
        return dense(self.output_layer, ctx.reshape(q.shape[0], 1, self.size), self.dtype)


class PositionwiseFeedForward(nn.Module):
    """Position-wise feed-forward layer (joeynmt/transformer_layers.py:118-168)."""

    def __init__(self, input_size: int, ff_size: int, dropout: float = 0.1,
                 alpha: float = 1.0, layer_norm_position: str = "post",
                 activation: str = "relu", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if layer_norm_position not in {"pre", "post"}:
            raise ValueError(f"layer_norm_position {layer_norm_position!r}")
        self.alpha = alpha
        self.layer_norm_position = layer_norm_position
        self.dtype = dtype
        self.layer_norm = _layer_norm_module(input_size, device)
        # indices 0 and 3 are the reference's pwff_layer names
        self.pwff_layer = nn.Sequential(
            nn.Linear(input_size, ff_size, device=device), build_activation(activation),
            Dropout(dropout), nn.Linear(ff_size, input_size, device=device),
            Dropout(dropout))
        self.tp = None  # the model group of a tensor-parallel shard

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.layer_norm_position == "pre":
            x = layer_norm(self.layer_norm, x, self.dtype)
        lin1, act, drop1, lin2, drop2 = self.pwff_layer
        tp = self.tp
        if tp is not None:  # columns, then rows
            h = act(column_dense(lin1, x, self.dtype, tp))
            h = drop1(h, shard=(h.dim() - 1, tp.rank, tp.world))
            x = drop2(row_dense(lin2, h, self.dtype, tp), shard=tp.seq_shard())
        else:
            x = drop2(dense(lin2, drop1(act(dense(lin1, x, self.dtype))), self.dtype))
        x = x + self.alpha * residual
        if self.layer_norm_position == "post":
            x = layer_norm(self.layer_norm, x, self.dtype)
        return x


class MoEFeedForward(nn.Module):
    """Mixture-of-experts feed-forward with switch-style top-1 routing
    (joeys2t_tpu/models/modules.py:508-600): a float32 router picks each
    token's expert, whose output is scaled by the router's probability for
    it. Dispatch is dense, as JAX computes it: every expert runs on every
    token (``einsum``, (B, T, E, F) activations) and the expert axis is
    contracted with the one-hot dispatch weights. The expert tensors keep
    JAX's layout: ``w1`` (E, H, F), ``b1`` (E, F), ``w2`` (E, F, H), ``b2``
    (E, H); the router is ``router.weight`` (E, H).

    Each forward leaves the Switch load-balance term E * sum_e f_e * p_e in
    ``aux_loss`` (f_e the share of tokens routed to expert e, p_e its mean
    router probability, both over the valid tokens of ``token_valid``),
    where the trainer collects it (JAX sows it). With ``global_stats`` (the
    trainer sets it in a data-parallel run) the sums behind f_e and p_e are
    summed over the data-parallel ranks (``stats_group``, the world when
    None) in training mode, differentiably, so the term is the global
    batch's, as JAX computes it over one global array. Under tensor
    parallelism each rank holds E / tp experts, computes them on every
    token and contracts them with its experts' dispatch weights; the partial
    outputs are summed over the model group. The routing runs on every rank
    of the group alike (under sequence parallelism on this rank's slice of
    the sequence, its sums then summed over the group), so its sums go over
    the data ranks only: over the world, every token would count tp
    times."""

    def __init__(self, input_size: int, ff_size: int, num_experts: int,
                 dropout: float = 0.1, alpha: float = 1.0,
                 layer_norm_position: str = "post", activation: str = "relu",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if layer_norm_position not in {"pre", "post"}:
            raise ValueError(f"layer_norm_position {layer_norm_position!r}")
        self.num_experts = num_experts
        self.alpha = alpha
        self.layer_norm_position = layer_norm_position
        self.dtype = dtype
        self.layer_norm = _layer_norm_module(input_size, device)
        self.router = nn.Linear(input_size, num_experts, bias=False, device=device)
        e, h, f = num_experts, input_size, ff_size
        self.w1 = nn.Parameter(torch.empty((e, h, f), device=device))
        self.b1 = nn.Parameter(torch.empty((e, f), device=device))
        self.w2 = nn.Parameter(torch.empty((e, f, h), device=device))
        self.b2 = nn.Parameter(torch.empty((e, h), device=device))
        self.act = build_activation(activation)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.aux_loss: Optional[torch.Tensor] = None
        self.global_stats = False
        self.stats_group = None  # the data-parallel ranks' group (None: the world)
        self.tp = None  # the model group of a tensor-parallel shard

    def forward(self, x: torch.Tensor,
                token_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = x
        if self.layer_norm_position == "pre":
            x = layer_norm(self.layer_norm, x, self.dtype)
        x = x.to(self.dtype)
        if self.tp is not None and self.tp.sequence_parallel and token_valid is not None:
            token_valid = self.tp.local(token_valid)
        gates = torch.softmax(F.linear(x.float(), self.router.weight.float()), dim=-1)
        top_p, top1 = gates.max(dim=-1)  # the first maximum, as jnp.argmax
        one_hot = F.one_hot(top1, self.num_experts).float()
        e = self.num_experts
        w = (torch.ones_like(gates[..., :1]) if token_valid is None
             else token_valid.float()[..., None])
        sums = torch.cat([(one_hot * w).sum(dim=(0, 1)), (gates * w).sum(dim=(0, 1)),
                          w.sum().reshape(1)])
        tp = self.tp
        if tp is not None and tp.sequence_parallel:  # routed on this rank's slice
            sums = tp_reduce(sums, tp)
        if self.training and self.global_stats:
            from torch.distributed.nn.functional import all_reduce

            sums = all_reduce(sums, group=self.stats_group or dist.group.WORLD)
        denom = sums[2 * e].clamp(min=1.0)
        f, p = sums[:e] / denom, sums[e:2 * e] / denom
        self.aux_loss = e * (f * p).sum()
        dispatch = (one_hot * top_p[..., None]).to(self.dtype)  # (B, T, E)
        if tp is not None:  # this rank's experts on every token
            n = self.w1.shape[0]
            if tp.sequence_parallel:
                x, dispatch = tp.enter(x), tp.enter(dispatch)
            else:
                x, dispatch = tp_copy(x, tp), tp_copy(dispatch, tp)
            dispatch = dispatch[..., tp.rank * n:(tp.rank + 1) * n]
        h = torch.einsum("bth,ehf->btef", x, self.w1.to(self.dtype)) + self.b1.to(self.dtype)
        h = self.dropout1(self.act(h), shard=None if tp is None else (2, tp.rank, tp.world))
        y = torch.einsum("btef,efh->bteh", h, self.w2.to(self.dtype)) + self.b2.to(self.dtype)
        if tp is not None:  # the partial sums in float32, rounded once after the sum
            y = tp.exit(torch.einsum("bteh,bte->bth", y.float(), dispatch.float()))
            y = y.to(self.dtype)
        else:
            y = torch.einsum("bteh,bte->bth", y, dispatch)
        y = self.dropout2(y, shard=seq_shard(tp))
        y = y + self.alpha * residual
        if self.layer_norm_position == "post":
            y = layer_norm(self.layer_norm, y, self.dtype)
        return y


class TransformerEncoderLayer(nn.Module):
    """Self-attention + FFN (joeynmt/transformer_layers.py:216-289);
    ``num_experts > 0`` makes the FFN a :class:`MoEFeedForward` whose
    routing statistics count the valid tokens of ``mask`` only."""

    def __init__(self, size: int, ff_size: int, num_heads: int, dropout: float = 0.1,
                 alpha: float = 1.0, layer_norm_position: str = "post",
                 activation: str = "relu", dtype: torch.dtype = torch.float32,
                 device=None, num_experts: int = 0):
        super().__init__()
        self.alpha = alpha
        self.layer_norm_position = layer_norm_position
        self.dtype = dtype
        self.layer_norm = _layer_norm_module(size, device)
        self.src_src_att = MultiHeadedAttention(num_heads, size, dropout, dtype, device)
        if num_experts > 0:
            self.feed_forward = MoEFeedForward(size, ff_size, num_experts, dropout, alpha,
                                               layer_norm_position, activation, dtype,
                                               device)
        else:
            self.feed_forward = PositionwiseFeedForward(
                size, ff_size, dropout, alpha, layer_norm_position, activation, dtype,
                device)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        residual = x
        if self.layer_norm_position == "pre":
            x = layer_norm(self.layer_norm, x, self.dtype)
        x = self.src_src_att(x, x, x, mask)
        x = self.dropout(x, shard=seq_shard(self.src_src_att.tp)) + self.alpha * residual
        if self.layer_norm_position == "post":
            x = layer_norm(self.layer_norm, x, self.dtype)
        if isinstance(self.feed_forward, MoEFeedForward):
            return self.feed_forward(x, None if mask is None else mask[:, 0, :])
        return self.feed_forward(x)


class TransformerDecoderLayer(nn.Module):
    """Masked self-attention + cross-attention + FFN
    (joeynmt/transformer_layers.py:292-407)."""

    def __init__(self, size: int, ff_size: int, num_heads: int, dropout: float = 0.1,
                 alpha: float = 1.0, layer_norm_position: str = "post",
                 activation: str = "relu", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.alpha = alpha
        self.layer_norm_position = layer_norm_position
        self.dtype = dtype
        self.trg_trg_att = MultiHeadedAttention(num_heads, size, dropout, dtype, device)
        self.src_trg_att = MultiHeadedAttention(num_heads, size, dropout, dtype, device)
        self.feed_forward = PositionwiseFeedForward(
            size, ff_size, dropout, alpha, layer_norm_position, activation, dtype, device)
        self.x_layer_norm = _layer_norm_module(size, device)
        self.dec_layer_norm = _layer_norm_module(size, device)
        self.dropout = Dropout(dropout)

    def forward(self, x, memory, src_mask, trg_mask) -> torch.Tensor:
        pre = self.layer_norm_position == "pre"
        residual = x
        if pre:
            x = layer_norm(self.x_layer_norm, x, self.dtype)
        shard = seq_shard(self.trg_trg_att.tp)
        h1 = (self.dropout(self.trg_trg_att(x, x, x, mask=trg_mask), shard=shard)
              + self.alpha * residual)
        if not pre:
            h1 = layer_norm(self.x_layer_norm, h1, self.dtype)

        h1_residual = h1
        if pre:
            h1 = layer_norm(self.dec_layer_norm, h1, self.dtype)
        h2 = self.src_trg_att(memory, memory, h1, mask=src_mask)
        h2 = self.dropout(h2, shard=shard) + self.alpha * h1_residual
        if not pre:
            h2 = layer_norm(self.dec_layer_norm, h2, self.dtype)
        return self.feed_forward(h2)

    def precompute_cross_kv(self, memory: torch.Tensor):
        """Project encoder memory to per-head cross-attention K/V once."""
        return self.src_trg_att.project_kv(memory)

    def decode_step(self, x: torch.Tensor, cache: dict, index: int,
                    self_bias: torch.Tensor, cross_bias: torch.Tensor,
                    beam_k: int = 1, ancestry: Optional[torch.Tensor] = None,
                    return_attention: bool = False):
        """Single decode step (B*K, 1, size) -> (B*K, 1, size) with the
        cached self K/V (B*K rows) and cross K/V (B rows, shared by the K
        beams of an utterance) and their additive biases, int8 with their
        scales where the cache holds ``*_scale`` entries; the self-attention
        cache is updated in place. With the (B, K, S) ``ancestry`` map the
        self-attention reads each beam's history through it
        (``step_self_ancestry``) instead of from a physically reordered
        cache. With ``return_attention`` it returns (output, the
        cross-attention weights (B, 1, S)) (``step_cross``'s
        ``return_weights``)."""
        pre = self.layer_norm_position == "pre"
        residual = x
        if pre:
            x = layer_norm(self.x_layer_norm, x, self.dtype)
        self_args = (x, cache["self_k"], cache["self_v"], index, self_bias)
        scales = (cache.get("self_k_scale"), cache.get("self_v_scale"))
        h1 = (self.trg_trg_att.step_self(*self_args, *scales) if ancestry is None else
              self.trg_trg_att.step_self_ancestry(*self_args, ancestry, *scales))
        h1 = h1 + self.alpha * residual
        if not pre:
            h1 = layer_norm(self.x_layer_norm, h1, self.dtype)

        h1_residual = h1
        if pre:
            h1 = layer_norm(self.dec_layer_norm, h1, self.dtype)
        h2 = self.src_trg_att.step_cross(h1, cache["cross_k"], cache["cross_v"],
                                         cross_bias, beam_k, cache.get("cross_k_scale"),
                                         cache.get("cross_v_scale"), return_attention)
        att = None
        if return_attention:
            h2, att = h2
        h2 = h2 + self.alpha * h1_residual
        if not pre:
            h2 = layer_norm(self.dec_layer_norm, h2, self.dtype)
        out = self.feed_forward(h2)
        return (out, att) if return_attention else out


class _Pointwise(nn.Module):
    """A kernel-size-1 convolution over (B, T, Cin), computed as a matmul;
    the weight keeps torch's Conv1d layout (Cout, Cin, 1), the reference's
    ``pointwise_conv`` naming."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight[:, :, 0].to(dtype), self.bias.to(dtype))


class _FrozenBatchNorm(nn.Module):
    """BatchNorm1d in its inference form, with frozen running statistics
    (buffers, so no optimizer updates or decays them) in training too:
    (x - mean) / sqrt(var + 1e-5) * weight + bias in float32."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean", torch.empty(channels, device=device))
        self.register_buffer("running_var", torch.empty(channels, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + 1e-5)
        return ((x.float() - self.running_mean.float()) * inv * self.weight.float()
                + self.bias.float()).to(dtype)


def _depthwise_conv(conv: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` (groups = channels, "same" padding) over (B, T, C) in
    ``dtype``; a float32 convolution on the card keeps full float32 (cuDNN
    would take TF32 by default)."""
    args = (x.to(dtype).transpose(1, 2), conv.weight.to(dtype), conv.bias.to(dtype), 1,
            conv.padding, 1, conv.groups)
    if dtype == torch.float32 and x.is_cuda:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            return F.conv1d(*args).transpose(1, 2)
    return F.conv1d(*args).transpose(1, 2)


class ConvolutionModule(nn.Module):
    """Conformer convolution block (joeys2t_tpu/models/modules.py:765):
    LayerNorm, pointwise conv to 2C, GLU, depthwise conv ("same" padding),
    ``norm_type`` "layernorm" or "batchnorm" (the inference form with frozen
    running statistics, for converted reference checkpoints), hard-swish,
    pointwise conv, dropout. The depthwise conv is ``F.conv1d`` with
    ``groups`` = C, as the JAX module takes ``nn.Conv`` outside any kernel."""

    def __init__(self, hidden_size: int, channels: int, depthwise_kernel_size: int,
                 dropout: float, dtype: torch.dtype = torch.float32,
                 norm_type: str = "layernorm", device=None):
        super().__init__()
        if (depthwise_kernel_size - 1) % 2:
            raise ValueError("the depthwise kernel size must be odd for 'same' padding")
        if norm_type not in {"layernorm", "batchnorm"}:
            raise ValueError(f"norm_type {norm_type!r}")
        self.dtype = dtype
        self.norm_type = norm_type
        self.layer_norm = _layer_norm_module(hidden_size, device)
        self.pointwise_conv1 = _Pointwise(hidden_size, 2 * channels, device)
        self.depthwise_conv = nn.Conv1d(channels, channels, depthwise_kernel_size,
                                        padding=(depthwise_kernel_size - 1) // 2,
                                        groups=channels, device=device)
        if norm_type == "batchnorm":
            self.batch_norm = _FrozenBatchNorm(channels, device)
        else:
            self.norm = _layer_norm_module(channels, device)
        self.pointwise_conv2 = _Pointwise(channels, hidden_size, device)
        self.dropout = Dropout(dropout)
        self.tp = None  # the model group (replicated; its sequence slice under SP)

    def forward(self, x: torch.Tensor, seq_len: Optional[int] = None) -> torch.Tensor:
        """Under sequence parallelism ``x`` is this rank's slice: the module
        runs on the whole sequence (gathered), its frames from ``seq_len``
        on (the region's padding) zeroed before the depthwise convolution
        as its "same" padding would be, and returns this rank's slice."""
        tp = self.tp
        sp = tp is not None and tp.sequence_parallel
        x = layer_norm(self.layer_norm, x, self.dtype)
        if sp:
            x = tp.enter(x)
        x = self.pointwise_conv1(x, self.dtype)
        a, b = x.chunk(2, dim=-1)
        x = a * torch.sigmoid(b)
        if sp and seq_len is not None and seq_len < x.shape[1]:
            x = F.pad(x[:, :seq_len], (0, 0, 0, x.shape[1] - seq_len))
        x = _depthwise_conv(self.depthwise_conv, x, self.dtype)
        if self.norm_type == "batchnorm":
            x = self.batch_norm(x, self.dtype)
        else:
            x = layer_norm(self.norm, x, self.dtype)
        x = self.pointwise_conv2(F.hardswish(x), self.dtype)
        if sp:
            x = tp.local(x)
        return self.dropout(x, shard=seq_shard(tp))


class ConformerEncoderLayer(nn.Module):
    """Conformer block (joeys2t_tpu/models/modules.py:843): half-step
    feed-forward, self-attention, convolution module, half-step
    feed-forward. ``macaron`` "reference" is the reference implementation's
    form (its feed-forward already holds the residual: x <- 1.5 x + 0.5
    ff(LN(x)), and pre-norm normalizes the last feed-forward's input
    twice); "paper" is arXiv:2005.08100's (x <- x + 0.5 ff(LN(x)), then a
    block-final LayerNorm), which takes pre-norm only. ``layerscale_init`` > 0
    (paper form only) scales each sublayer's delta by a learned per-channel
    vector ``ls_ff1``, ``ls_att``, ``ls_conv``, ``ls_ff2`` starting at that
    constant. Self-attention is the port's ``MultiHeadedAttention``: the
    flash kernels, forward and backward."""

    def __init__(self, size: int = 512, ff_size: int = 2048, num_heads: int = 4,
                 dropout: float = 0.1, depthwise_conv_kernel_size: int = 31,
                 alpha: float = 1.0, layer_norm_position: str = "pre",
                 dtype: torch.dtype = torch.float32, conv_norm_type: str = "layernorm",
                 macaron: str = "reference", layerscale_init: float = 0.0, device=None):
        super().__init__()
        if layer_norm_position not in {"pre", "post"} or macaron not in {"reference",
                                                                          "paper"}:
            raise ValueError(f"layer_norm {layer_norm_position!r}, macaron {macaron!r}")
        if macaron == "paper" and layer_norm_position != "pre":
            raise ValueError("macaron='paper' requires layer_norm='pre'")
        if layerscale_init > 0.0 and macaron != "paper":
            raise ValueError("layerscale needs macaron='paper' (separable sublayer delta)")
        self.alpha = alpha
        self.layer_norm_position = layer_norm_position
        self.macaron = macaron
        self.layerscale_init = layerscale_init
        self.dtype = dtype
        if layerscale_init > 0.0:
            for name in ("ls_ff1", "ls_att", "ls_conv", "ls_ff2"):
                setattr(self, name, nn.Parameter(torch.empty(size, device=device)))
        self.initial_feed_forward, self.final_feed_forward = (
            PositionwiseFeedForward(size, ff_size, dropout, alpha, layer_norm_position,
                                    dtype=dtype, device=device) for _ in range(2))
        self.src_att_layer_norm = _layer_norm_module(size, device)
        self.final_layer_norm = _layer_norm_module(size, device)
        self.src_src_att = MultiHeadedAttention(num_heads, size, dropout, dtype, device)
        self.conv_module = ConvolutionModule(size, size, depthwise_conv_kernel_size, dropout,
                                             dtype, conv_norm_type, device)
        self.src_att_dropout = Dropout(dropout)

    def _scaled(self, name: str, delta: torch.Tensor) -> torch.Tensor:
        return getattr(self, name).to(delta.dtype) * delta if self.layerscale_init > 0 \
            else delta

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                seq_len: Optional[int] = None) -> torch.Tensor:
        """``seq_len``: the sequence's length before the padding of the
        sequence-parallel region (the convolution module's)."""
        pre, paper = self.layer_norm_position == "pre", self.macaron == "paper"
        residual = x
        x = self.initial_feed_forward(x)
        if paper:  # the feed-forward returns core + alpha x: take the core's half step
            x = residual + self._scaled("ls_ff1", 0.5 * (x - self.alpha * residual))
        else:
            x = 0.5 * x + residual

        residual = x
        if pre:
            x = layer_norm(self.src_att_layer_norm, x, self.dtype)
        x = self._scaled("ls_att", self.src_att_dropout(self.src_src_att(x, x, x, mask),
                                                        shard=seq_shard(self.src_src_att.tp)))
        x = x + self.alpha * residual
        if not pre:
            x = layer_norm(self.src_att_layer_norm, x, self.dtype)

        residual = x
        x = self._scaled("ls_conv", self.conv_module(x, seq_len)) + self.alpha * residual

        residual = x
        if pre and not paper:  # the reference normalizes the last FF's input twice
            x = layer_norm(self.final_layer_norm, x, self.dtype)
        x = self.final_feed_forward(x)
        if paper:
            x = residual + self._scaled("ls_ff2", 0.5 * (x - self.alpha * residual))
            return layer_norm(self.final_layer_norm, x, self.dtype)
        x = 0.5 * x + residual
        if not pre:
            x = layer_norm(self.final_layer_norm, x, self.dtype)
        return x


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask, bool (1, size, size)."""
    return torch.tril(torch.ones((1, size, size), dtype=torch.bool, device=device))


class _PatchConv1d(nn.Module):
    """Stride-2 1-D convolution over (B, T, Cin) as patch extraction plus one
    matmul, as the JAX module computes it (a matmul keeps full float32 on the
    card, where a float32 cuDNN convolution would default to TF32). The
    weight keeps torch's Conv1d layout (Cout, Cin, K)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        cout, cin, _ = self.weight.shape
        pad = k // 2
        t_out = (x.shape[1] + 2 * pad - k) // 2 + 1
        xp = F.pad(x.to(self.dtype), (0, 0, pad, pad))
        # tap j of the kernel sees input positions j, j+2, j+4, ...
        patches = torch.cat([xp[:, j:j + 2 * (t_out - 1) + 1:2] for j in range(k)], dim=-1)
        w = self.weight.to(self.dtype).permute(2, 1, 0).reshape(k * cin, cout)
        return patches @ w + self.bias.to(self.dtype)


class Conv1dSubsampler(nn.Module):
    """Stride-2 Conv1d stack with GLU for audio subsampling
    (joeynmt/encoders.py:311-373): (B, T, in_channels) -> (B, T', out_channels)
    with T' = prod over kernels of floor((T + 2*(k//2) - k) / 2 + 1)."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (3, 3), dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        n = len(self.kernel_sizes)
        self.conv_layers = nn.ModuleList(
            _PatchConv1d(in_channels if i == 0 else mid_channels // 2,
                         mid_channels if i < n - 1 else out_channels * 2, k, dtype, device)
            for i, k in enumerate(self.kernel_sizes))

    @staticmethod
    def get_out_seq_lens(in_seq_lens: torch.Tensor,
                         kernel_sizes: Sequence[int]) -> torch.Tensor:
        """Output-length formula (joeynmt/encoders.py:348-352)."""
        out = in_seq_lens.float()
        for k in kernel_sizes:
            out = torch.floor((out + 2 * (k // 2) - (k - 1) - 1) / 2 + 1)
        return out.long()

    def forward(self, x: torch.Tensor, src_length: torch.Tensor):
        for conv in self.conv_layers:
            a, b = conv(x).chunk(2, dim=-1)
            x = a * torch.sigmoid(b)  # GLU over channels
        return x, self.get_out_seq_lens(src_length, self.kernel_sizes)
