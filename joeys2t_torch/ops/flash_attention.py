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
launch the kernels or raise. bf16 runs on the tensor-core kernels
(mma.sync), f32 on the SIMT kernels, its exact path (:func:`kernel_info`).
"""
import ctypes
from typing import Optional, Tuple

import torch

from joeys2t_torch.ops import cuda_build

NEG_INF = -1e9
_MASK32 = 0xFFFFFFFF


def supported(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take this head size and dtype: 16, 64, 128, 192
    or 256 in f32 or bf16. The TPU gate ``supported`` :613 asks d % 64 ==
    0 and sends head dim 16 to einsum; here it has kernels of its own."""
    return (head_dim in (16, 64, 128, 192, 256)
            and dtype in (torch.float32, torch.bfloat16))


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
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, sq, sk, num_heads, d,
        0 if q.dtype == torch.float32 else 1, float(sm_scale), drop, seed_ptr,
        threshold, keep_scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0  # kernel launches; tests and smoke runs reset it


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                        d_out: torch.Tensor, sm_scale: float, num_heads: int,
                        dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd` from its
    (out, lse) and the output gradient ``d_out`` (like q); ``dropout_rate``
    and ``seed`` must be the forward's. On the card one call launches three
    kernels (delta, dK/dV, dQ) and counts once."""
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
    err = _library().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        lse.data_ptr(), d_out.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, num_heads, d,
        0 if q.dtype == torch.float32 else 1, float(sm_scale), drop, seed_ptr,
        threshold, keep_scale, torch.cuda.current_stream(q.device).cuda_stream)
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
    tensor and run the plain versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, num_heads, dropout_rate=0.0, seed=None):
        out, lse = flash_attention_fwd(q, k, v, bias, sm_scale, num_heads, dropout_rate,
                                       seed)
        ctx.save_for_backward(q, k, v, bias, out, lse, seed)
        ctx.args = (sm_scale, num_heads, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias, out, lse, seed = ctx.saved_tensors
        sm_scale, num_heads, dropout_rate = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, lse, d_out.contiguous(),
                                         sm_scale, num_heads, dropout_rate, seed)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, sm_scale: float, num_heads: int,
                         dropout_rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable attention output without the lse (the TPU package's
    ``flash_attention_flat`` :356)."""
    return FlashAttention.apply(q, k, v, bias, sm_scale, num_heads, dropout_rate, seed)


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
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Adapter from the model's flat (B, T, E) projections and a bool key
    mask (B, Sk) (the TPU package's ``mha_flash_flat`` :644). The kernels
    mask the ragged key edge themselves, so keys are not padded. With
    dropout the per-call seed is drawn from ``generator``, never from
    torch's global generator."""
    seed = None
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout draws its seed from a generator the "
                             "caller passes")
        seed = draw_seed(generator, q.device)
    bias = key_bias(key_valid, k.shape[0], k.shape[1], k.device)
    return flash_attention_flat(q, k, v, bias, sm_scale, num_heads, dropout_rate, seed)


def kernel_info(head_dim: int, dtype: torch.dtype) -> dict:
    """Which kernels a (head_dim, dtype) takes on the card: ``route``
    "mma.sync" (bf16, tensor cores) or "simt" (f32, CUDA cores), and the
    dynamic shared memory in bytes of the forward, dK/dV and dQ kernels.
    Builds the library if needed."""
    if not supported(head_dim, dtype):
        raise ValueError(f"flash kernel takes head_dim in 16/64/128/192/256 and f32/bf16, "
                         f"got {head_dim} and {dtype}")
    info = (ctypes.c_int * 4)()
    err = _library().flash_attention_info(head_dim, 0 if dtype == torch.float32 else 1,
                                          info)
    if err != 0:
        raise RuntimeError(f"flash_attention_info failed: cudaError {err}")
    return {"route": "mma.sync" if info[0] else "simt", "smem_fwd": info[1],
            "smem_dkdv": info[2], "smem_dq": info[3]}


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
