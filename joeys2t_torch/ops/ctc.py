# coding: utf-8
"""
Sum-reduced CTC loss from raw logits (counterpart of
joeys2t_tpu/ops/ctc.py ``ctc_loss_sum_from_logits`` :186).

Semantics kept from the JAX package: f32 log-softmax of the raw logits;
per-example negative log likelihood, summed, without length normalization;
``zero_infinity`` treats any loss above ``INFEASIBLE`` as infeasible and
gives it 0 loss and 0 gradient (:21, :170-175); rows with
``target_length == 0``, the padding rows of ``Batch.pad_to_shape``,
contribute 0 (:173-174). The per-example NLL is PyTorch's ``F.ctc_loss``
(the JAX package runs its own log-space DP because XLA has no CTC; CTC is
no Pallas kernel). ``F.ctc_loss`` gives an empty target the all-blank path's
cost, not 0, so those rows are masked here; its CUDA backward sums with
atomics and is not bit-reproducible from run to run.
"""
import torch
import torch.nn.functional as F

INFEASIBLE = 1e8  # losses above this count as infeasible (joeys2t_tpu :21)


def ctc_loss_sum_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                             input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                             blank_id: int = 0, zero_infinity: bool = True) -> torch.Tensor:
    """Sum over the batch of the CTC loss of ``logits`` (B, T, V), any float
    dtype, against ``targets`` (B, L) padded arbitrarily past
    ``target_lengths`` (B,), with ``input_lengths`` (B,) valid frames."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    losses = F.ctc_loss(log_probs.transpose(0, 1), targets.long(), input_lengths.long(),
                        target_lengths.long(), blank=blank_id, reduction="none",
                        zero_infinity=zero_infinity)
    if zero_infinity:
        losses = torch.where(losses > INFEASIBLE, 0.0, losses)
    return torch.where(target_lengths == 0, 0.0, losses).sum()
