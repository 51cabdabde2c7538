# coding: utf-8
"""
Mini-batch container (counterpart of joeys2t_tpu/data/batch.py ``Batch``
:32), plain numpy on the host: the teacher-forcing shift, the target mask,
``nseqs``/``ntokens``, ``pad_to_shape`` (:98), ``normalize`` (:164),
``sort_by_src_length`` (:186) and ``score`` (:212). Prompts are not ported
yet.
"""
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_BUCKETS = (8, 16, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
                   1536, 2048, 3072, 4096, 6144, 8192)


def round_up_to_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """The smallest bucket that holds ``n``, or ``n`` beyond the last one."""
    for b in buckets:
        if n <= b:
            return b
    return n


class Batch:
    """src/trg arrays and masks with the teacher-forcing shift applied
    (joeynmt/batch.py:79-96)."""

    # pylint: disable=too-many-instance-attributes

    def __init__(self, src: np.ndarray, src_length: np.ndarray,
                 src_prompt_mask: Optional[np.ndarray], trg: Optional[np.ndarray],
                 trg_length: Optional[np.ndarray], trg_prompt_mask: Optional[np.ndarray],
                 indices: np.ndarray, pad_index: int, eos_index: int,
                 is_train: bool = True, task: str = "MT"):
        if src_prompt_mask is not None or trg_prompt_mask is not None:
            raise NotImplementedError("prompts are not ported yet")
        self.src = src
        self.src_length = np.asarray(src_length)
        self.src_mask: Optional[np.ndarray] = None
        self.src_prompt_mask = None
        self.trg_input: Optional[np.ndarray] = None
        self.trg: Optional[np.ndarray] = None
        self.trg_length: Optional[np.ndarray] = None
        self.trg_mask: Optional[np.ndarray] = None
        self.trg_prompt_mask = None
        self.indices = np.asarray(indices)
        self.nseqs = src.shape[0]
        self.ntokens: Optional[int] = None
        self.has_trg = trg is not None
        self.is_train = is_train
        if self.is_train and not self.has_trg:
            raise ValueError("a training batch needs targets")
        self.pad_index = pad_index
        self.eos_index = eos_index

        if self.has_trg:
            trg = np.asarray(trg)
            if trg_length is None:
                raise ValueError("targets need their lengths")
            # teacher forcing input: eos becomes pad, the last column is cut
            has_eos = bool((trg == eos_index).any())
            trg_input = np.where(trg == eos_index, pad_index, trg)
            self.trg_input = trg_input[:, :-1] if has_eos else trg_input
            self.trg = trg[:, 1:]  # the loss's targets start after bos
            self.trg_length = np.asarray(trg_length) - 1
            self.trg_mask = (self.trg != pad_index)[:, None, :]  # (B, 1, T)
            self.ntokens = int(self.trg_mask.sum())

        self.task = task
        if self.task == "MT":
            self.src_mask = (self.src != pad_index)[:, None, :]
        # S2T: the encoder builds src_mask after subsampling
        if self.nseqs <= 0:
            raise ValueError("empty batch")

    def pad_to_shape(self, batch_size: Optional[int] = None,
                     buckets: Sequence[int] = DEFAULT_BUCKETS,
                     src_len: Optional[int] = None,
                     trg_len: Optional[int] = None) -> "Batch":
        """Pad the sequence dims up to bucket boundaries and the batch dim up
        to ``batch_size``. Padding rows carry pad tokens, zero masks, index
        -1, and for S2T ``src_length`` 1 and ``trg_length`` 0, so they add
        nothing to the loss. ``src_len``/``trg_len`` override the bucket."""
        b = self.nseqs
        target_b = batch_size if batch_size is not None else b
        if target_b < b:
            raise ValueError(f"cannot pad {b} rows to {target_b}")

        def pad_arr(arr, length, axis, value):
            if arr is None:
                return None
            widths = [(0, 0)] * arr.ndim
            widths[axis] = (0, length - arr.shape[axis])
            return np.pad(arr, widths, constant_values=value)

        if src_len is None:
            src_len = round_up_to_bucket(self.src.shape[1], buckets)
        if src_len < self.src.shape[1]:
            raise ValueError(f"src_len {src_len} < {self.src.shape[1]}")
        fill = self.pad_index if self.task == "MT" else float(self.pad_index)
        src = pad_arr(pad_arr(self.src, src_len, 1, fill), target_b, 0, fill)
        src_length = pad_arr(self.src_length, target_b, 0, 1 if self.task == "S2T" else 0)
        src_mask = None
        if self.src_mask is not None:
            src_mask = pad_arr(pad_arr(self.src_mask, src_len, 2, False), target_b, 0,
                               False)

        new = Batch.__new__(Batch)
        new.__dict__.update(self.__dict__)
        new.src, new.src_length, new.src_mask = src, src_length, src_mask
        new.indices = pad_arr(self.indices, target_b, 0, -1)
        new.nseqs = target_b

        if self.has_trg:
            if trg_len is None:
                trg_len = round_up_to_bucket(self.trg.shape[1], buckets)
            if trg_len < self.trg.shape[1]:
                raise ValueError(f"trg_len {trg_len} < {self.trg.shape[1]}")
            new.trg = pad_arr(pad_arr(self.trg, trg_len, 1, self.pad_index), target_b, 0,
                              self.pad_index)
            new.trg_input = pad_arr(pad_arr(self.trg_input, trg_len, 1, self.pad_index),
                                    target_b, 0, self.pad_index)
            new.trg_length = pad_arr(self.trg_length, target_b, 0, 0)
            new.trg_mask = pad_arr(pad_arr(self.trg_mask, trg_len, 2, False), target_b,
                                   0, False)
        return new

    def normalize(self, tensor, normalization: str = "none", n_gpu: int = 1,
                  n_accumulation: int = 1):
        """Normalize a batch loss (joeynmt/batch.py:135-175)."""
        if tensor is None:
            return None
        if normalization == "sum":
            return tensor
        if normalization == "batch":
            normalizer = self.nseqs
        elif normalization == "tokens":
            normalizer = self.ntokens
        elif normalization == "none":
            normalizer = 1
        else:
            raise ValueError(f"unknown normalization {normalization!r}")
        norm_tensor = tensor / normalizer
        if n_gpu > 1:
            norm_tensor = norm_tensor / n_gpu
        if n_accumulation > 1:
            norm_tensor = norm_tensor / n_accumulation
        return norm_tensor

    def sort_by_src_length(self) -> List[int]:
        """Sort the rows by source length, longest first (stable); returns
        the reverse index that restores the original order."""
        perm_index = np.argsort(-self.src_length, kind="stable")
        rev_index = [0] * len(perm_index)
        for new_pos, old_pos in enumerate(perm_index):
            rev_index[int(old_pos)] = new_pos
        for name in ("src", "src_length", "src_mask", "indices", "trg_input", "trg_mask",
                     "trg_length", "trg"):
            arr = getattr(self, name)
            if arr is not None:
                setattr(self, name, arr[perm_index])
        return rev_index

    @staticmethod
    def score(log_probs: np.ndarray, trg: np.ndarray, pad_index: int) -> np.ndarray:
        """The log-probabilities of the reference tokens, one array per row
        (pads skipped)."""
        if log_probs.shape[0] != trg.shape[0]:
            raise ValueError("log_probs and trg differ in rows")
        scores = [np.array([log_probs[i, j, ind] for j, ind in enumerate(trg[i])
                            if ind != pad_index]) for i in range(log_probs.shape[0])]
        out = np.empty(len(scores), dtype=object)
        out[:] = scores
        return out

    def __repr__(self) -> str:
        return (f"{self.__class__.__name__}(nseqs={self.nseqs}, "
                f"ntokens={self.ntokens}, has_trg={self.has_trg}, "
                f"is_train={self.is_train})")
