# coding: utf-8
"""The port's losses against the JAX package on the CPU: label-smoothed
cross entropy, the CTC sum from raw logits and the joint XentCTCLoss.

Inputs come from numpy with a fixed seed. Tolerance: 1e-5 relative in f32
(the JAX CTC is a log-space scan of its own, the port's PyTorch's
``F.ctc_loss``; summation order differs), stated beside each check."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch.losses import XentCTCLoss, XentLoss, smoothed_xent_loss
from joeys2t_torch.ops.ctc import ctc_loss_sum_from_logits
from joeys2t_tpu.losses import XentCTCLoss as JaxXentCTCLoss
from joeys2t_tpu.losses import XentLoss as JaxXentLoss
from joeys2t_tpu.losses import smoothed_xent_loss as jax_smoothed_xent_loss
from joeys2t_tpu.ops.ctc import ctc_loss_sum_from_logits as jax_ctc_sum

PAD, BLANK = 1, 2


def _log_probs(rng, b, t, v):
    x = rng.randn(b, t, v).astype(np.float32) * 2
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_smoothed_xent_matches_jax(smoothing):
    """Sum-reduced, pad ignored, smoothing in closed form with the entropy
    term: 1e-5 relative."""
    rng = np.random.RandomState(0)
    lp = _log_probs(rng, 3, 11, 50)
    trg = rng.randint(2, 50, size=(3, 11))
    trg[1, 7:] = PAD
    ref = float(jax_smoothed_xent_loss(jnp.asarray(lp), jnp.asarray(trg), PAD, smoothing))
    out = smoothed_xent_loss(torch.tensor(lp), torch.tensor(trg), PAD, smoothing)
    assert out.dtype == torch.float32
    assert abs(out.item() - ref) <= 1e-5 * abs(ref)
    ref_cls = float(JaxXentLoss(PAD, smoothing)(jnp.asarray(lp), jnp.asarray(trg))[0])
    assert abs(XentLoss(PAD, smoothing)(torch.tensor(lp), torch.tensor(trg))[0].item()
               - ref_cls) <= 1e-5 * abs(ref_cls)


def _ctc_case(rng, dtype=np.float32):
    """Rows: feasible; feasible with repeated labels (needs blanks between);
    infeasible (5 labels in 4 frames); target_length 0 (a padding row of
    Batch.pad_to_shape, src_length 1)."""
    b, t, v, l_max = 4, 12, 9, 5
    logits = rng.randn(b, t, v).astype(np.float32) * 1.5
    targets = np.full((b, l_max), PAD)
    targets[0, :4] = [3, 5, 7, 4]
    targets[1, :5] = [4, 4, 6, 6, 6]
    targets[2, :5] = [3, 4, 5, 6, 7]
    input_lengths = np.array([12, 11, 4, 1])
    target_lengths = np.array([4, 5, 5, 0])
    return logits.astype(dtype), targets, input_lengths, target_lengths


@pytest.mark.parametrize("zero_infinity", [True, False])
def test_ctc_sum_matches_jax(zero_infinity):
    """Feasible rows, repeated labels, an infeasible row (0 with
    zero_infinity; the JAX package counts anything above 1e8 as infeasible)
    and a target_length-0 row (0, where F.ctc_loss alone would give the
    all-blank cost): 1e-5 relative on the sum."""
    logits, targets, il, tl = _ctc_case(np.random.RandomState(1))
    args = (targets, il, tl)
    port = ctc_loss_sum_from_logits(torch.tensor(logits), *map(torch.tensor, args),
                                    blank_id=BLANK, zero_infinity=zero_infinity)
    ref = float(jax_ctc_sum(jnp.asarray(logits), *map(jnp.asarray, args), blank_id=BLANK,
                            zero_infinity=zero_infinity))
    if not zero_infinity:  # the infeasible row dominates: inf here, ~1e9 in JAX
        assert port.item() > 1e8 and ref > 1e8
        return
    assert abs(port.item() - ref) <= 1e-5 * abs(ref)
    # the zeroed rows add nothing: the sum equals the two feasible rows alone
    two = ctc_loss_sum_from_logits(torch.tensor(logits[:2]), *(torch.tensor(a[:2]) for a in args),
                                   blank_id=BLANK)
    assert abs(two.item() - port.item()) <= 1e-6 * abs(port.item())


def test_ctc_bf16_logits_and_gradients_match_jax():
    """bf16 logits take an f32 log-softmax on both sides (1e-5 relative on
    the loss); the gradient with respect to the logits agrees to 1e-5 and
    is zero on the infeasible and empty rows."""
    import jax

    logits, targets, il, tl = _ctc_case(np.random.RandomState(2))
    lb = torch.tensor(logits).to(torch.bfloat16)
    ref = float(jax_ctc_sum(jnp.asarray(lb.float().numpy(), jnp.bfloat16),
                            jnp.asarray(targets), jnp.asarray(il), jnp.asarray(tl),
                            blank_id=BLANK))
    port = ctc_loss_sum_from_logits(lb, torch.tensor(targets), torch.tensor(il),
                                    torch.tensor(tl), blank_id=BLANK)
    assert abs(port.item() - ref) <= 1e-5 * abs(ref)
    x = torch.tensor(logits, requires_grad=True)
    ctc_loss_sum_from_logits(x, *map(torch.tensor, (targets, il, tl)), blank_id=BLANK).backward()
    g_ref = jax.grad(lambda z: jax_ctc_sum(z, jnp.asarray(targets), jnp.asarray(il),
                                           jnp.asarray(tl), blank_id=BLANK))(
        jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), atol=1e-5, rtol=1e-5)
    assert bool(torch.isfinite(x.grad).all())
    assert float(x.grad[2:].abs().max()) == 0.0


def test_xent_ctc_loss_matches_jax():
    """(1 - w) * xent + w * ctc with blank = bos and input lengths from the
    subsampled source mask: each of the three terms to 1e-5 relative."""
    rng = np.random.RandomState(3)
    b, s, t, v = 4, 12, 5, 9
    ctc_logits = rng.randn(b, s, v).astype(np.float32)
    lp = _log_probs(rng, b, t, v)
    trg = rng.randint(3, v, size=(b, t))
    trg[2, 3:] = PAD
    trg[3] = PAD  # a padding row
    trg_length = (trg != PAD).sum(1)
    src_mask = np.arange(s)[None, None, :] < np.array([12, 9, 7, 1])[:, None, None]
    ref = JaxXentCTCLoss(PAD, BLANK, smoothing=0.1, ctc_weight=0.3)(
        jnp.asarray(lp), jnp.asarray(trg), trg_length=jnp.asarray(trg_length),
        src_mask=jnp.asarray(src_mask), ctc_logits=jnp.asarray(ctc_logits))
    out = XentCTCLoss(PAD, BLANK, smoothing=0.1, ctc_weight=0.3)(
        torch.tensor(lp), torch.tensor(trg), trg_length=torch.tensor(trg_length),
        src_mask=torch.tensor(src_mask), ctc_logits=torch.tensor(ctc_logits))
    for o, r in zip(out, ref):
        assert abs(o.item() - float(r)) <= 1e-5 * abs(float(r))
