# coding: utf-8
"""
Loss functions (counterpart of joeys2t_tpu/losses.py and of
``build_loss_function`` in joeys2t_tpu/prediction.py:50).

XentLoss keeps the reference numerics: NLL with sum reduction and pad
ignored at smoothing 0; at smoothing > 0 the KL divergence against the
smoothed target distribution, including the target-entropy term that
torch's KLDivLoss adds, in closed form over three gathered values per
position, so no (B, T, V) smoothed distribution is built. XentCTCLoss
interpolates (1 - w) * xent + w * ctc with blank = bos.
"""
import math
from typing import Optional, Tuple

import torch

from joeys2t_torch.ops.ctc import ctc_loss_sum_from_logits


def smoothed_xent_loss(log_probs: torch.Tensor, targets: torch.Tensor, pad_index: int,
                       smoothing: float = 0.0) -> torch.Tensor:
    """Sum-reduced cross entropy of ``log_probs`` (B, T, V) against
    ``targets`` (B, T), with optional label smoothing (joeys2t_tpu :22)."""
    log_probs = log_probs.float()
    vocab_size = log_probs.shape[-1]
    non_pad = targets != pad_index
    lq_target = torch.gather(log_probs, -1, targets.long()[..., None])[..., 0]
    if smoothing <= 0.0:
        return -torch.where(non_pad, lq_target, 0.0).sum()
    confidence = 1.0 - smoothing
    uniform = smoothing / (vocab_size - 2)  # over non-target, non-pad tokens
    cross = confidence * lq_target + uniform * (
        log_probs.sum(-1) - lq_target - log_probs[..., pad_index])
    entropy = (confidence * math.log(confidence)
               + (vocab_size - 2) * uniform * math.log(uniform))
    return torch.where(non_pad, entropy - cross, 0.0).sum()


class XentLoss:
    """Cross entropy with optional label smoothing (joeys2t_tpu :55)."""

    def __init__(self, pad_index: int, smoothing: float = 0.0):
        self.pad_index = pad_index
        self.smoothing = smoothing
        self.require_ctc_layer = False

    def __call__(self, log_probs: torch.Tensor, trg: torch.Tensor,
                 **kwargs) -> Tuple[torch.Tensor]:
        return (smoothed_xent_loss(log_probs, trg, self.pad_index, self.smoothing),)

    def __repr__(self):
        return f"{self.__class__.__name__}(smoothing={self.smoothing})"


class XentCTCLoss(XentLoss):
    """(1 - w) * xent + w * ctc (joeys2t_tpu :71); the CTC blank is bos."""

    def __init__(self, pad_index: int, bos_index: int, smoothing: float = 0.0,
                 zero_infinity: bool = True, ctc_weight: float = 0.3):
        super().__init__(pad_index=pad_index, smoothing=smoothing)
        self.require_ctc_layer = True
        self.bos_index = bos_index
        self.zero_infinity = zero_infinity
        self.ctc_weight = ctc_weight

    def __call__(self, log_probs: torch.Tensor, trg: torch.Tensor,
                 trg_length: Optional[torch.Tensor] = None,
                 src_mask: Optional[torch.Tensor] = None,
                 ctc_logits: Optional[torch.Tensor] = None,
                 **kwargs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Takes the RAW ``ctc_logits`` (B, S, V) of the CTC head; the input
        lengths are the row sums of the subsampled ``src_mask`` (B, 1, S)."""
        if trg_length is None or src_mask is None or ctc_logits is None:
            raise ValueError("XentCTCLoss needs trg_length, src_mask and ctc_logits")
        xent = smoothed_xent_loss(log_probs, trg, self.pad_index, self.smoothing)
        input_lengths = src_mask[:, 0, :].sum(dim=1)
        ctc = ctc_loss_sum_from_logits(ctc_logits, trg, input_lengths, trg_length,
                                       blank_id=self.bos_index,
                                       zero_infinity=self.zero_infinity)
        return (1.0 - self.ctc_weight) * xent + self.ctc_weight * ctc, xent, ctc

    def __repr__(self):
        return (f"{self.__class__.__name__}(smoothing={self.smoothing}, "
                f"ctc_weight={self.ctc_weight})")


def loss_terms(loss_fn: XentLoss, logits: torch.Tensor, ctc_logits: Optional[torch.Tensor],
               out_mask: torch.Tensor, trg: torch.Tensor, trg_length: torch.Tensor,
               trg_mask: torch.Tensor):
    """The sum-reduced (total, nll, ctc) losses of one batch, its count of
    correct argmax tokens and its log-probabilities (the train step,
    joeys2t_tpu/training.py:510, and the eval step,
    joeys2t_tpu/prediction.py:145)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    kwargs = dict(trg=trg)
    if loss_fn.require_ctc_layer and ctc_logits is not None:
        kwargs.update(trg_length=trg_length, src_mask=out_mask, ctc_logits=ctc_logits)
    losses = loss_fn(log_probs, **kwargs)
    total = losses[0]
    nll = losses[1] if len(losses) > 1 else total
    ctc = losses[2] if len(losses) > 2 else torch.zeros((), device=total.device)
    n_correct = torch.sum(trg_mask[:, 0, :] & (log_probs.argmax(-1) == trg))
    return total, nll, ctc, n_correct, log_probs


def build_loss_function(train_args, spec) -> XentLoss:
    """The loss of the `training` section (joeys2t_tpu/prediction.py:50)."""
    if train_args.loss == "crossentropy-ctc":
        return XentCTCLoss(pad_index=spec.pad_index, bos_index=spec.bos_index,
                           smoothing=train_args.label_smoothing,
                           ctc_weight=train_args.ctc_weight)
    return XentLoss(pad_index=spec.pad_index, smoothing=train_args.label_smoothing)
