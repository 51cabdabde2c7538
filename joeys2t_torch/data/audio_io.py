# coding: utf-8
"""
Host-side audio IO (counterpart of joeys2t_tpu/data/audio_io.py): wav
reading (``read_wav`` :21), mp3 decoding (``read_mp3`` :82), feature lookup
from ``.npy``, ``.wav``, ``.mp3`` and ``zip:offset:size`` entries
(``get_features`` :189, ``_get_features_from_zip`` :171), ``get_n_frames``
:183 and batch collation (``pad_features`` :219).

A ``.wav`` or ``.mp3`` entry goes through the port's own fbank
(``ops/fbank.fbank``) on a CPU tensor. mp3 is decoded by the system
libmpg123 through ``ctypes``, as JAX decodes it (no Python package); a
host without the library raises when an mp3 is read.
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


_MPG123 = None


def _load_mpg123():
    """The system libmpg123 through ctypes, bound once; None without it."""
    global _MPG123  # pylint: disable=global-statement
    if _MPG123 is not None:
        return _MPG123 or None
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        _MPG123 = False
        return None
    c = ctypes
    lib.mpg123_new.restype = c.c_void_p
    lib.mpg123_new.argtypes = [c.c_char_p, c.POINTER(c.c_int)]
    lib.mpg123_open.argtypes = [c.c_void_p, c.c_char_p]
    lib.mpg123_getformat.argtypes = [c.c_void_p, c.POINTER(c.c_long), c.POINTER(c.c_int),
                                     c.POINTER(c.c_int)]
    lib.mpg123_format_none.argtypes = [c.c_void_p]
    lib.mpg123_format.argtypes = [c.c_void_p, c.c_long, c.c_int, c.c_int]
    lib.mpg123_read.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t, c.POINTER(c.c_size_t)]
    lib.mpg123_close.argtypes = [c.c_void_p]
    lib.mpg123_delete.argtypes = [c.c_void_p]
    if hasattr(lib, "mpg123_init"):  # a no-op in modern mpg123
        lib.mpg123_init()
    _MPG123 = lib
    return lib


def read_mp3(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """An mp3 file -> (float32 waveform in int16 scale, sample rate), decoded
    to signed 16-bit at the file's rate by libmpg123; several channels are
    averaged to one, as ``read_wav`` does."""
    import ctypes as c

    lib = _load_mpg123()
    if lib is None:
        raise RuntimeError("mp3 decoding needs the system libmpg123, which was not found; "
                           "convert the file to .wav or precompute .npy features.")
    mpg123_ok, mpg123_done, mpg123_new_format = 0, -12, -11
    enc_signed_16 = 0xD0
    err = c.c_int(0)
    handle = lib.mpg123_new(None, c.byref(err))
    if not handle:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        if lib.mpg123_open(handle, str(path).encode()) != mpg123_ok:
            raise RuntimeError(f"mpg123_open({path}) failed")
        rate, channels, encoding = c.c_long(0), c.c_int(0), c.c_int(0)
        rc = lib.mpg123_getformat(handle, c.byref(rate), c.byref(channels),
                                  c.byref(encoding))
        if rc != mpg123_ok:
            raise RuntimeError(f"mpg123_getformat failed: {rc}")
        lib.mpg123_format_none(handle)  # signed 16-bit at the native rate and channels
        lib.mpg123_format(handle, rate.value, channels.value, enc_signed_16)
        chunks, buf, done = [], c.create_string_buffer(65536), c.c_size_t(0)
        while True:
            rc = lib.mpg123_read(handle, buf, len(buf), c.byref(done))
            if done.value:
                chunks.append(bytes(buf.raw[:done.value]))
            if rc == mpg123_done:
                break
            if rc not in (mpg123_ok, mpg123_new_format):
                raise RuntimeError(f"mpg123_read failed: {rc}")
    finally:
        lib.mpg123_close(handle)
        lib.mpg123_delete(handle)
    data = np.frombuffer(b"".join(chunks), dtype="<i2").astype(np.float32)
    if channels.value > 1:
        data = data.reshape(-1, channels.value).mean(axis=1)
    return data, int(rate.value)


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
        elif _path.suffix in (".wav", ".mp3"):
            read = read_wav if _path.suffix == ".wav" else read_mp3
            waveform, sample_rate = read(_path)
            features = extract_fbank_features(waveform, sample_rate)
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
