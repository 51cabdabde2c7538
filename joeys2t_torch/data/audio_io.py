# coding: utf-8
"""
Host-side audio IO (counterpart of joeys2t_tpu/data/audio_io.py): wav
reading (``read_wav`` :21), feature lookup from ``.npy``, ``.wav`` and
``zip:offset:size`` entries (``get_features`` :189,
``_get_features_from_zip`` :171), ``get_n_frames`` :183 and batch collation
(``pad_features`` :219).

A ``.wav`` entry goes through the port's own fbank (``ops/fbank.fbank``) on
a CPU tensor. ``.mp3`` entries raise ``NotImplementedError``.
"""
import io
import wave
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np
import torch

from joeys2t_torch.ops.fbank import fbank


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """A PCM wav file -> (float32 waveform in int16 scale, sample rate);
    multi-channel audio is averaged to one channel."""
    with wave.open(str(path), "rb") as w:
        n_channels, sampwidth = w.getnchannels(), w.getsampwidth()
        framerate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    else:
        raise ValueError(f"Unsupported wav sample width: {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, framerate


def extract_fbank_features(waveform: np.ndarray, sample_rate: int,
                           n_mel_bins: int = 80) -> np.ndarray:
    """(frames, n_mel_bins) float32 log-mel features of an int16-scaled
    waveform, computed by ``ops/fbank.fbank`` on the CPU."""
    wave_t = torch.from_numpy(np.ascontiguousarray(waveform, np.float32))[None]
    return fbank(wave_t, float(sample_rate), n_mel_bins)[0].numpy()


def _get_features_from_zip(path: Path, byte_offset: int, byte_size: int) -> np.ndarray:
    """One ``.npy`` blob stored uncompressed in a zip, read by byte offset."""
    with path.open("rb") as f:
        f.seek(byte_offset)
        data = f.read(byte_size)
    if len(data) > 1 and data[0] == 147 and data[1] == 78:  # the .npy magic
        return np.load(io.BytesIO(data))
    raise ValueError(f'Unknown file format for "{path}" [{byte_offset}:{byte_size}]')


def get_n_frames(wave_length: int, sample_rate: int) -> int:
    """Frames of 25 ms every 10 ms in ``wave_length`` samples."""
    duration_ms = int(wave_length / sample_rate * 1000)
    return int(1 + (duration_ms - 25) / 10)


def get_features(root_path, fbank_path: str) -> np.ndarray:
    """Features of one entry: ``file.npy``, ``audio.wav`` or
    ``feats.zip:offset:size``, relative to ``root_path``."""
    _path, *extra = fbank_path.split(":")
    _path = Path(root_path) / _path
    if not _path.is_file():
        raise FileNotFoundError(f"File not found: {_path}")
    if len(extra) == 0:
        if _path.suffix == ".npy":
            features = np.load(_path.as_posix())
        elif _path.suffix == ".wav":
            waveform, sample_rate = read_wav(_path)
            features = extract_fbank_features(waveform, sample_rate)
        elif _path.suffix == ".mp3":
            raise NotImplementedError(f"mp3 input is not ported yet: {_path}")
        else:
            raise ValueError(f"Invalid file type: {_path}")
    elif len(extra) == 2 and _path.suffix == ".zip":
        features = _get_features_from_zip(_path, int(extra[0]), int(extra[1]))
    else:
        raise ValueError(f"Invalid path: {Path(root_path) / fbank_path}")
    if features.ndim != 2:
        raise ValueError(f"{fbank_path}: spectrogram must be a 2-D array.")
    return features


def pad_features(feat_list: List[np.ndarray], embed_size: int = 80,
                 pad_index: int = 1) -> Tuple[np.ndarray, List[int], None]:
    """Collate (frames, embed_size) features into (B, T, embed_size) float32
    padded with ``float(pad_index)``, as the reference does; returns
    (features, lengths, None)."""
    max_len = max(int(f.shape[0]) for f in feat_list)
    features = np.full((len(feat_list), max_len, embed_size), float(pad_index),
                       dtype=np.float32)
    lengths = []
    for i, f in enumerate(feat_list):
        if f.shape[0] == 0:
            raise ValueError("empty feature!")
        if f.shape[1] != embed_size:
            raise ValueError(f"feature width {f.shape[1]}, expected {embed_size}")
        features[i, :f.shape[0], :] = f
        lengths.append(int(f.shape[0]))
    return features, lengths, None
