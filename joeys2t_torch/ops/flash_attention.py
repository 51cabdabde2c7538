# coding: utf-8
"""
Flash-attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Counterpart of joeys2t_tpu/ops/flash_attention.py. The TPU package splits the
forward into a flat-layout kernel (Sk <= 512) and a (B, H, S, D) kernel for
longer keys, both to fit VMEM; the CUDA kernel is one kernel for any key
length. Operands keep the TPU package's FLAT layout: q (B, Sq, E), k/v
(B, Sk, E) with E = H * D and heads as column bands of E, exactly what the
Q/K/V projections produce, so no head-split copy is ever made.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. The backward kernels and in-kernel dropout
belong to training and are not ported yet.
"""
import ctypes
from typing import Optional, Tuple

import torch

from joeys2t_torch.ops import cuda_build

NEG_INF = -1e9


def supported(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes this head size and dtype (the TPU gate
    ``supported`` :613 asks d % 64 == 0 and d <= 256 too)."""
    return (head_dim % 64 == 0 and 0 < head_dim <= 256
            and dtype in (torch.float32, torch.bfloat16))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, sm_scale: float, num_heads: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in plain PyTorch: f32 scores with the additive key
    bias, f32 softmax, f32 context. Returns (out like q, lse (B, Sq, H) f32)."""
    b, sq, e = q.shape
    d = e // num_heads
    qh = q.float().reshape(b, sq, num_heads, d) * sm_scale
    kh = k.float().reshape(b, k.shape[1], num_heads, d)
    vh = v.float().reshape(b, v.shape[1], num_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) + bias.float()[:, None, None, :]
    # normalize by the row sum, not by exp(s - lse): at a fully masked row
    # (scores near -1e9) lse rounds to the masked value and loses log(Sk)
    p = torch.softmax(s, dim=-1)
    lse = torch.logsumexp(s, dim=-1)  # (B, H, Sq)
    out =torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, sq, e)
    return out.to(q.dtype), lse.transpose(1, 2).contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, sm_scale: float, num_heads: int,
                        dropout_rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over full K/V with an additive key bias, flat head layout.

    :param q: (B, Sq, E), E = num_heads * head_dim, f32 or bf16
    :param k, v: (B, Sk, E), q's dtype
    :param bias: (B, Sk) f32, 0 for a valid key and -1e9 for a masked one
    :param dropout_rate: must be 0 on every device until the kernel has
        in-kernel dropout (training)
    :return: (out (B, Sq, E) in q's dtype, lse (B, Sq, H) f32)
    """
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout is not in the flash kernel yet")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, sm_scale, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    b, sq, e = q.shape
    sk = k.shape[1]
    if e % num_heads:
        raise ValueError(f"E={e} is not a multiple of num_heads={num_heads}")
    d = e // num_heads
    if not supported(d, q.dtype):
        raise ValueError(f"flash kernel takes head_dim in 64/128/192/256 and "
                         f"f32/bf16, got {d} and {q.dtype}")
    for name, t, shape, dtype in (("q", q, (b, sq, e), q.dtype),
                                  ("k", k, (b, sk, e), q.dtype),
                                  ("v", v, (b, sk, e), q.dtype),
                                  ("bias", bias, (b, sk), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, contiguous={t.is_contiguous()}")
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, num_heads), dtype=torch.float32, device=q.device)
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, sq, sk, num_heads, d,
        0 if q.dtype == torch.float32 else 1, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0  # kernel launches; tests and smoke runs reset it


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, sm_scale: float, num_heads: int,
                         dropout_rate: float = 0.0) -> torch.Tensor:
    """:func:`flash_attention_fwd` without the lse (the TPU package's
    ``flash_attention_flat`` :356)."""
    return flash_attention_fwd(q, k, v, bias, sm_scale, num_heads,
                               dropout_rate)[0]


def key_bias(key_valid: Optional[torch.Tensor], b: int, sk: int,
             device: torch.device) -> torch.Tensor:
    """(B, Sk) f32 additive bias from a bool key mask (True = valid)."""
    if key_valid is None:
        return torch.zeros((b, sk), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(key_valid, zero, torch.full_like(zero, NEG_INF))


def mha_flash_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int, key_valid: Optional[torch.Tensor],
                   sm_scale: float, dropout_rate: float = 0.0) -> torch.Tensor:
    """Adapter from the model's flat (B, T, E) projections and a bool key
    mask (B, Sk) (the TPU package's ``mha_flash_flat`` :644). The kernel
    masks the ragged key edge itself, so keys are not padded."""
    bias = key_bias(key_valid, k.shape[0], k.shape[1], k.device)
    return flash_attention_flat(q, k, v, bias, sm_scale, num_heads,
                                dropout_rate)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib

