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


@pytest.mark.parametrize("sq,sk,heads,dim", [(40, 70, 2, 64), (20, 600, 1, 64)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_flash_backward_plain_matches_pallas(sq, sk, heads, dim, dtype, tol):
    """dQ, dK, dV of the plain backward against jax.vjp through the Pallas
    kernels (interpret mode): ragged Sk, Sk > 512 (K4's route), and row 0
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

