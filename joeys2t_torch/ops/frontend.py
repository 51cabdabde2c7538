# coding: utf-8
"""
On-device audio front end for inference (counterpart of
joeys2t_tpu/ops/frontend.py ``device_frontend`` :23): batched waveform ->
kaldi fbank -> utterance mean and variance normalization, with padded
frames zeroed. SpecAugment is training-only and not ported yet.
"""
from typing import Tuple

import torch

from joeys2t_torch.data.augmentation import cmvn
from joeys2t_torch.ops.fbank import _frame_params, fbank


def device_frontend(waveforms: torch.Tensor, wave_lengths: torch.Tensor,
                    sample_rate: float = 16000.0, num_mel_bins: int = 80,
                    norm_means: bool = True,
                    norm_vars: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) float32 int16-scaled zero-padded waveforms and (B,) valid
    sample counts -> (features (B, T, num_mel_bins), frame_lengths (B,)).
    A frame counts when it lies wholly inside the valid samples; CMVN
    normalizes means and variances as ``norm_means``/``norm_vars`` say."""
    window_size, window_shift, _ = _frame_params(sample_rate, 25.0, 10.0)
    t_max = max(1 + (waveforms.shape[1] - window_size) // window_shift, 0)
    feats = fbank(waveforms, sample_rate=sample_rate, num_mel_bins=num_mel_bins)
    frame_lengths = torch.clamp(
        1 + torch.div(wave_lengths - window_size, window_shift, rounding_mode="floor"),
        0, t_max)
    return cmvn(feats, frame_lengths, norm_means, norm_vars), frame_lengths
