# coding: utf-8
"""
Kaldi-compliant log-mel filterbank features on the device (counterpart of
joeys2t_tpu/ops/fbank.py: ``povey_window``, ``mel_banks``, ``_frame_params``
and ``fbank_jax`` :143).

Defaults mirror ``torchaudio.compliance.kaldi.fbank(num_mel_bins=80)``:
25 ms / 10 ms framing with snip_edges, no dither, DC removal, 0.97
pre-emphasis, povey window, 512-point power spectrum, kaldi mel banks (low
20 Hz, high Nyquist), log with a float32-eps floor. ``fbank`` is batched
over a (B, N) waveform array and computes in float32; the power spectrum is
``torch.fft.rfft`` (the TPU package uses a DFT matmul because the TPU has no
FFT unit).
"""
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07  # torch.finfo(torch.float).eps
MILLISECONDS_TO_SECONDS = 0.001


def _next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2**(x - 1).bit_length()


def povey_window(window_size: int) -> np.ndarray:
    """(0.5 - 0.5 cos(2 pi n / (N-1)))^0.85, kaldi's default window."""
    n = np.arange(window_size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2 * math.pi * n / (window_size - 1)))**0.85


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@lru_cache(maxsize=8)
def mel_banks(num_bins: int, window_length_padded: int, sample_freq: float) -> np.ndarray:
    """Kaldi triangular mel filterbank from 20 Hz to Nyquist,
    (num_bins, padded // 2 + 1) float32, the Nyquist column zero
    (torchaudio's kaldi.py pads (0, 1))."""
    num_fft_bins = window_length_padded // 2
    fft_bin_width = sample_freq / window_length_padded
    mel_low, mel_high = mel_scale(20.0), mel_scale(0.5 * sample_freq)
    mel_freq_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_bins, num_fft_bins + 1), dtype=np.float64)
    mel = mel_scale(fft_bin_width * np.arange(num_fft_bins))
    for j in range(num_bins):
        left = mel_low + j * mel_freq_delta
        center = mel_low + (j + 1) * mel_freq_delta
        right = mel_low + (j + 2) * mel_freq_delta
        up = (mel - left) / (center - left)
        down = (right - mel) / (right - center)
        bins[j, :num_fft_bins] = np.maximum(0.0, np.minimum(up, down))
    return bins.astype(np.float32)


def _frame_params(sample_rate: float, frame_length_ms: float,
                  frame_shift_ms: float) -> Tuple[int, int, int]:
    window_size = int(sample_rate * frame_length_ms * MILLISECONDS_TO_SECONDS)
    window_shift = int(sample_rate * frame_shift_ms * MILLISECONDS_TO_SECONDS)
    return window_size, window_shift, _next_power_of_2(window_size)


def fbank(waveforms: torch.Tensor, sample_rate: float = 16000.0,
          num_mel_bins: int = 80) -> torch.Tensor:
    """(B, N) int16-scaled waveforms -> (B, m, num_mel_bins) float32 log-mel
    features, m = 1 + (N - window) // shift (all frames of the padded
    length; the caller masks frames past each waveform's end)."""
    window_size, window_shift, padded = _frame_params(sample_rate, 25.0, 10.0)
    device = waveforms.device
    frames = waveforms.float().unfold(1, window_size, window_shift)  # (B, m, W)
    frames = frames - frames.mean(dim=2, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=2)
    frames = frames - 0.97 * prev
    window = torch.as_tensor(povey_window(window_size), dtype=torch.float32,
                             device=device)
    spectrum = torch.fft.rfft(frames * window, n=padded, dim=2).abs().square()
    banks = torch.as_tensor(mel_banks(num_mel_bins, padded, float(sample_rate)),
                            device=device)
    return torch.log(torch.clamp(spectrum @ banks.T, min=EPSILON))
