# coding: utf-8
"""
Utterance-level CMVN on the device (counterpart of
joeys2t_tpu/data/augmentation.py ``cmvn_jax`` :98). SpecAugment belongs to
training and is not ported yet.
"""
import torch


def cmvn(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Cepstral mean and variance normalization of padded (B, T, F) features
    over each utterance's valid frames; padded frames come out zero."""
    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
            < lengths[:, None]).to(x.dtype)[..., None]  # (B, T, 1)
    n = lengths.to(x.dtype)[:, None, None]
    mean = torch.sum(x * mask, dim=1, keepdim=True) / n
    var = torch.sum(x**2 * mask, dim=1, keepdim=True) / n - mean**2
    return (x - mean) / torch.sqrt(torch.clamp(var, min=1e-10)) * mask
