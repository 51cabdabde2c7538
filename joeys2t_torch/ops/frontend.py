# coding: utf-8
"""
On-device audio front end (counterpart of joeys2t_tpu/ops/frontend.py
``device_frontend`` :23): batched waveform -> kaldi fbank -> utterance mean
and variance normalization, with padded frames zeroed, and in training
SpecAugment on the device (``specaugment_device``, JAX's
``specaugment_jax``, joeys2t_tpu/data/augmentation.py:118).

SpecAugment draws from the caller's ``torch.Generator`` (on the features'
device), so its masks are not JAX's ``jax.random`` draws; their laws are
JAX's: each of ``freq_mask_n`` frequency masks has a width uniform in
[0, ``freq_mask_f``) and a start uniform in [0, F - ``freq_mask_f``]
(none when F < ``freq_mask_f``), each of ``time_mask_n`` time masks a
width uniform in [0, max_t) with max_t = min(``time_mask_t``,
floor(length * ``time_mask_p``)) and a start uniform in [0, length -
width); a masked value is the utterance's mean over its valid frames, and
frames past the length stay 0.
"""
from typing import Optional, Tuple

import torch

from joeys2t_torch.data.augmentation import cmvn
from joeys2t_torch.ops.fbank import _frame_params, fbank


def _uniform_ints(high: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One integer uniform in [0, high) for each entry of ``high`` (>= 1)."""
    u = torch.rand(high.shape, generator=generator, device=high.device)
    return torch.minimum(torch.floor(u * high), high - 1)


def specaugment_device(x: torch.Tensor, lengths: torch.Tensor, freq_mask_n: int = 2,
                       freq_mask_f: int = 27, time_mask_n: int = 2, time_mask_t: int = 40,
                       time_mask_p: float = 1.0,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SpecAugment of padded (B, T, F) features with (B,) valid frame counts
    (JAX's ``specaugment_jax`` per utterance, batched)."""
    b, t_pad, num_freqs = x.shape
    rows = torch.arange(t_pad, device=x.device)[None, :]
    cols = torch.arange(num_freqs, device=x.device)[None, :]
    valid = rows < lengths[:, None]  # (B, T)
    length = lengths.to(torch.float32)
    mask_value = (torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                                device=x.device)).sum((1, 2))
                  / (length * num_freqs))[:, None, None].to(x.dtype)
    ones = torch.ones((b,), device=x.device)
    for _ in range(freq_mask_n):
        f = _uniform_ints(ones * max(freq_mask_f, 1), generator)
        f0 = _uniform_ints(ones * max(num_freqs - freq_mask_f + 1, 1), generator)
        hit = (cols >= f0[:, None]) & (cols < (f0 + f)[:, None]) & (num_freqs >= freq_mask_f)
        x = torch.where(hit[:, None, :], mask_value, x)
    max_t = torch.clamp(torch.floor(length * time_mask_p), max=time_mask_t)
    for _ in range(time_mask_n):
        t = _uniform_ints(torch.clamp(max_t, min=1), generator)
        t0 = _uniform_ints(torch.clamp(length - t, min=1), generator)
        hit = (rows >= t0[:, None]) & (rows < (t0 + t)[:, None]) & (max_t >= 1)[:, None]
        x = torch.where(hit[..., None], mask_value, x)
    return torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def device_frontend(waveforms: torch.Tensor, wave_lengths: torch.Tensor,
                    sample_rate: float = 16000.0, num_mel_bins: int = 80,
                    norm_means: bool = True, norm_vars: bool = True, training: bool = False,
                    specaugment: Optional[Tuple[int, int, int, int, float]] = (2, 27, 2, 100,
                                                                               1.0),
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) float32 int16-scaled zero-padded waveforms and (B,) valid
    sample counts -> (features (B, T, num_mel_bins), frame_lengths (B,)).
    A frame counts when it lies wholly inside the valid samples; CMVN
    normalizes means and variances as ``norm_means``/``norm_vars`` say. With
    ``training`` the ``specaugment`` masks (freq_mask_n, freq_mask_f,
    time_mask_n, time_mask_t, time_mask_p) follow, drawn from
    ``generator``."""
    window_size, window_shift, _ = _frame_params(sample_rate, 25.0, 10.0)
    t_max = max(1 + (waveforms.shape[1] - window_size) // window_shift, 0)
    feats = fbank(waveforms, sample_rate=sample_rate, num_mel_bins=num_mel_bins)
    frame_lengths = torch.clamp(
        1 + torch.div(wave_lengths - window_size, window_shift, rounding_mode="floor"),
        0, t_max)
    feats = cmvn(feats, frame_lengths, norm_means, norm_vars)
    if training and specaugment is not None:
        feats = specaugment_device(feats, frame_lengths, *specaugment, generator=generator)
    return feats, frame_lengths
