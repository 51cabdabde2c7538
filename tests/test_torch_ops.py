# coding: utf-8
"""The port's kernel modules on the CPU against the JAX package: the plain
versions of the flash-attention forward and of decode attention (what the
wrappers run on CPU tensors; the CUDA kernels are held against them on the
card by chip_smoke.py), and the device front end (fbank + CMVN).

Inputs come from numpy with a fixed seed and go through both packages. The
Pallas kernels run in interpret mode, as the JAX package's own tests run
them."""
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
    """Dropout waits for the kernel's training slice; the CPU refuses it as
    the card does, instead of dropping with torch's global generator."""
    q = torch.zeros(1, 4, 128)
    with pytest.raises(NotImplementedError):
        port_fa.flash_attention_fwd(q, q, q, torch.zeros(1, 4), 0.125, 2, dropout_rate=0.1)


# --------------------------------------------------------- decode attention
def _decode_inputs(mode, seed=0, b=3, h=2, s=33, d=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(b, h, s, d).astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    bias = _key_bias(rng, b, s, all_masked_row=False)
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


@pytest.mark.parametrize("mode", ["f32", "bf16", "channel", "position"])
def test_decode_plain_matches_pallas(mode):
    """Against the Pallas kernel in interpret mode. It rounds the scaled q to
    bf16 even for f32 inputs (decode_attention.py:64); the port does not, so
    the tolerance is that of a bf16 q."""
    q, k, v, bias, ks, vs = _decode_inputs(mode)
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


def test_quantize_per_position_matches_jax():
    x = np.random.RandomState(4).randn(2, 3, 7, 64).astype(np.float32)
    q_j, s_j = jax_da.quantize_per_position(jnp.asarray(x))
    q_t, s_t = port_da.quantize_per_position(torch.tensor(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-7)


def test_decode_masked_positions_ignored():
    q, k, v, bias, _, _ = _decode_inputs("f32", seed=5, s=16)
    bias[:, 8:] = NEG_INF
    out1 = _port_decode(q, k, v, bias, None, None, "f32")
    k[:, :, 8:], v[:, :, 8:] = 99.0, -99.0
    out2 = _port_decode(q, k, v, bias, None, None, "f32")
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


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

