# coding: utf-8
"""
Data augmentation (counterpart of joeys2t_tpu/data/augmentation.py):
SpecAugment (:18) and CMVN (:69) on the host in numpy, as the data pipeline
applies them to each utterance, and utterance-level CMVN on the device for
the serving front end (``cmvn_jax`` :98).

SpecAugment draws from numpy's global RNG, as the JAX package's does, so
the same seed and the same order of calls give the same masks.
"""
import math
from typing import Optional

import numpy as np
import torch


class SpecAugment:
    """SpecAugment: ``freq_mask_n`` frequency masks of width < ``freq_mask_f``
    and ``time_mask_n`` time masks of width < min(``time_mask_t``,
    ``time_mask_p`` * frames); the mask value is the spectrogram's mean."""

    def __init__(self, freq_mask_n: int = 2, freq_mask_f: int = 27,
                 time_mask_n: int = 2, time_mask_t: int = 40,
                 time_mask_p: float = 1.0, mask_value: Optional[float] = None):
        self.freq_mask_n = freq_mask_n
        self.freq_mask_f = freq_mask_f
        self.time_mask_n = time_mask_n
        self.time_mask_t = time_mask_t
        self.time_mask_p = time_mask_p
        self.mask_value = mask_value

    def __call__(self, spectrogram: np.ndarray) -> np.ndarray:
        if spectrogram.ndim != 2:
            raise ValueError("spectrogram must be a 2-D array.")
        distorted = spectrogram.copy()
        num_frames, num_freqs = spectrogram.shape
        mask_value = self.mask_value
        if mask_value is None:
            mask_value = spectrogram.mean()
        if num_frames == 0 or num_freqs < self.freq_mask_f:
            return spectrogram

        for _ in range(self.freq_mask_n):
            f = np.random.randint(0, self.freq_mask_f)
            f0 = np.random.randint(0, num_freqs - f)
            if f != 0:
                distorted[:, f0:f0 + f] = mask_value

        max_time_mask_t = min(self.time_mask_t, math.floor(num_frames * self.time_mask_p))
        if max_time_mask_t < 1:
            return distorted

        for _ in range(self.time_mask_n):
            t = np.random.randint(0, max_time_mask_t)
            t0 = np.random.randint(0, num_frames - t)
            if t != 0:
                distorted[t0:t0 + t, :] = mask_value
        return distorted

    def __repr__(self):
        return (f"{self.__class__.__name__}(freq_mask_n={self.freq_mask_n}, "
                f"freq_mask_f={self.freq_mask_f}, time_mask_n={self.time_mask_n}, "
                f"time_mask_t={self.time_mask_t}, time_mask_p={self.time_mask_p})")


class CMVN:
    """Utterance-level cepstral mean and variance normalization of one
    (frames, freqs) array; ``before`` says whether it runs before
    SpecAugment."""

    def __init__(self, norm_means: bool = True, norm_vars: bool = True,
                 before: bool = True):
        self.norm_means = norm_means
        self.norm_vars = norm_vars
        self.before = before

    def __call__(self, x: np.ndarray) -> np.ndarray:
        mean = x.mean(axis=0)
        square_sums = (x**2).sum(axis=0)
        if self.norm_means:
            x = np.subtract(x, mean)
        if self.norm_vars:
            var = square_sums / x.shape[0] - mean**2
            x = np.divide(x, np.sqrt(np.maximum(var, 1e-10)))
        return x

    def __repr__(self):
        return (f"{self.__class__.__name__}(norm_means={self.norm_means}, "
                f"norm_vars={self.norm_vars}, before={self.before})")


def cmvn(x: torch.Tensor, lengths: torch.Tensor, norm_means: bool = True,
         norm_vars: bool = True) -> torch.Tensor:
    """Cepstral mean (``norm_means``) and variance (``norm_vars``)
    normalization of padded (B, T, F) features over each utterance's valid
    frames; padded frames come out zero."""
    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
            < lengths[:, None]).to(x.dtype)[..., None]  # (B, T, 1)
    n = lengths.to(x.dtype)[:, None, None]
    mean = torch.sum(x * mask, dim=1, keepdim=True) / n
    var = torch.sum(x**2 * mask, dim=1, keepdim=True) / n - mean**2
    if norm_means:
        x = x - mean
    if norm_vars:
        x = x / torch.sqrt(torch.clamp(var, min=1e-10))
    return x * mask
