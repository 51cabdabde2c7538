# coding: utf-8
"""
Single-position (autoregressive decode) attention: the hand-written CUDA
kernel (``csrc/decode_attention.cu``) and its plain PyTorch version.

Counterpart of joeys2t_tpu/ops/decode_attention.py. Per (batch row, head) one
query attends over a (B, H, S, D) K/V cache in f32, bf16 or int8; int8 caches
carry scales in one of two layouts, folded without materializing a
dequantized cache:

  - "channel" (B, H, D): the cross-attention cache; scales fold into q (K)
    and into the context (V);
  - "position" (B, H, S): the self-attention ring buffer; scales fold into
    the scores (K) and into the probabilities (V).

Known divergence from the Pallas kernel: it rounds the scaled q to bf16
even for f32 inputs (decode_attention.py:64); this port does not, and
matches the JAX einsum path (models/modules.py ``_decode_einsum``) instead.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
import ctypes
from typing import Optional, Tuple

import torch

from joeys2t_torch.ops import cuda_build

NEG_INF = -1e9
_LAYOUTS = {None: 0, "channel": 1, "position": 2}


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


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, *,
                           sm_scale: float = 1.0,
                           scale_layout: Optional[str] = None) -> torch.Tensor:
    """The kernel's math in plain PyTorch, all in f32; returns (B, H, D) in
    q's dtype."""
    layout = _resolve_layout(k, k_scale, scale_layout)
    qf = q.float() * sm_scale
    if layout == "channel":
        qf = qf * k_scale.float()
    scores = torch.einsum("bhd,bhsd->bhs", qf, k.float())
    if layout == "position":
        scores = scores * k_scale.float()
    p = torch.softmax(scores + bias.float()[:, None, :], dim=-1)
    if layout == "position":
        p = p * v_scale.float()
    ctx = torch.einsum("bhs,bhsd->bhd", p, v.float())
    if layout == "channel":
        ctx = ctx * v_scale.float()
    return ctx.to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, *,
                     sm_scale: float = 1.0,
                     scale_layout: Optional[str] = None) -> torch.Tensor:
    """Single-step attention context (B, H, D) with fused int8 dequant.

    :param q: (B, H, D) f32 or bf16
    :param k, v: (B, H, S, D) in q's dtype, or int8 with scales
    :param bias: (B, S) f32 additive mask, 0 or -1e9
    :param k_scale, v_scale: f32 (B, H, D) "channel" or (B, H, S) "position";
        inferred from the shape when ``scale_layout`` is None (ambiguous
        when S == D)
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, bias, k_scale, v_scale,
                                      sm_scale=sm_scale,
                                      scale_layout=scale_layout)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cpu or cuda, not {q.device}")
    b, h, s, d = k.shape
    layout = _resolve_layout(k, k_scale, scale_layout)
    if q.dtype not in (torch.float32, torch.bfloat16) or d not in (64, 128, 192, 256):
        raise ValueError(f"decode kernel takes f32/bf16 q and head_dim in "
                         f"64/128/192/256, got {q.dtype} and {d}")
    int8 = k.dtype == torch.int8
    if int8 != (layout is not None):
        raise ValueError("int8 caches need scales and scales need int8 caches")
    kv_dtype = torch.int8 if int8 else q.dtype
    checks = [("q", q, (b, h, d), q.dtype), ("k", k, (b, h, s, d), kv_dtype),
              ("v", v, (b, h, s, d), kv_dtype), ("bias", bias, (b, s), torch.float32)]
    if int8:
        scale_shape = (b, h, d) if layout == "channel" else (b, h, s)
        checks += [("k_scale", k_scale, scale_shape, torch.float32),
                   ("v_scale", v_scale, scale_shape, torch.float32)]
    for name, t, shape, dtype in checks:
        if (t is None or tuple(t.shape) != shape or t.dtype != dtype
                or t.device != q.device or not t.is_contiguous()):
            desc = "None" if t is None else f"{tuple(t.shape)} {t.dtype} on {t.device}"
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} on "
                             f"{q.device}, got {desc}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    err = _library().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None,
        out.data_ptr(), b, h, s, d, 0 if q.dtype == torch.float32 else 1,
        int(int8), _LAYOUTS[layout], float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_fwd launch failed: cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches; tests and smoke runs reset it


def quantize_per_position(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize (..., S, D) with one f32 scale per (..., s) slot (the
    self-attention ring buffer writes each slot once, as it is emitted)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
