# coding: utf-8
"""
Samplers and batch samplers (counterpart of joeys2t_tpu/data/samplers.py:
``RandomSubsetSampler`` :23, ``SentenceBatchSampler`` :103,
``TokenBatchSampler`` :158, ``ShardedSubsetSampler`` :70).

Randomness comes from a numpy ``Generator`` whose bit-generator state goes
into the checkpoint, so a resumed run continues the same order. The batch
samplers read every item once to drop the filtered ones, as the JAX
package's do; with SpecAugment on, that read draws from numpy's global RNG
too, so the port reads the items in the same order and the same number of
times. In a data-parallel run the training set goes through
``ShardedSubsetSampler``: every rank draws the same permutation from the
same seed and keeps its rank-strided share of it.
"""
from typing import Iterator, List, Optional

import numpy as np

from joeys2t_torch.parallel import distributed
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)


class RandomSubsetSampler:
    """Seeded subset sampling and shuffling; subset indices stay sorted and
    the permutation happens at iteration time."""

    def __init__(self, data_source, shuffle: bool, seed: int = 42):
        self.data_source = data_source
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    @property
    def num_samples(self) -> int:
        return len(self.data_source.indices)

    def __iter__(self) -> Iterator[int]:
        indices = self.data_source.indices
        if self.shuffle:
            return iter([indices[i] for i in self.rng.permutation(len(indices))])
        return iter(indices)

    def __len__(self) -> int:
        return self.num_samples

    def _subsample(self) -> None:
        orig_len = len(self.data_source)
        subset_len = self.data_source.random_subset
        if 0 < subset_len < orig_len:
            subset = self.rng.permutation(orig_len)[:subset_len].tolist()
            self.data_source.indices = sorted(subset)

    def reset(self) -> None:
        self.data_source.reset_indices()

    def set_seed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self._subsample()

    def get_state(self):
        return self.rng.bit_generator.state

    def set_state(self, state) -> None:
        self.rng.bit_generator.state = state


class ShardedSubsetSampler(RandomSubsetSampler):
    """Rank-strided sharding of a data-parallel run: the (shuffled) indices
    cut to a multiple of the world size, then every ``num_replicas``-th one
    from ``rank`` (joeynmt/helpers_for_ddp.py:244-343). As in the JAX
    package, the cut list becomes the data source's indices, so the next
    epoch permutes it in turn."""

    def __init__(self, data_source, shuffle: bool, seed: int = 42,
                 num_replicas: Optional[int] = None, rank: Optional[int] = None,
                 drop_last: bool = True):
        super().__init__(data_source, shuffle, seed)
        if num_replicas is None or rank is None:
            num_replicas, rank = distributed.data_world(), distributed.data_rank()
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} outside a world of {num_replicas}")
        self.num_replicas = num_replicas
        self.rank = rank
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[int]:
        indices = self.data_source.indices
        if self.shuffle:
            indices = [indices[i] for i in self.rng.permutation(len(indices))]
        if len(indices) % self.num_replicas != 0 and not self.drop_last:
            raise RuntimeError("`len(dataset)` must be divisible by `world_size`.")
        total = (len(indices) // self.num_replicas) * self.num_replicas
        indices = indices[:total]
        self.data_source.indices = indices
        return iter(indices[self.rank:total:self.num_replicas])


class SentenceBatchSampler:
    """Batches of ``batch_size`` sentences; filtered items are dropped."""

    def __init__(self, sampler, batch_size: int, drop_last: bool, seed: int):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed

    @property
    def num_samples(self) -> int:
        return len(self.sampler.data_source.indices)

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        d = self.sampler.data_source
        for idx in self.sampler:
            _, src, _ = d[idx]
            if src is not None:  # otherwise drop the instance
                batch.append(idx)
                if len(batch) >= self.batch_size:
                    yield batch
                    batch = []
        yield from self._tail(batch)

    def _tail(self, batch: List[int]) -> Iterator[List[int]]:
        if batch:
            if not self.drop_last:
                yield batch
            else:
                logger.warning("Drop indices %s.", batch)

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_seed(self, seed: int) -> None:
        self.sampler.data_source.seed = seed
        self.sampler.set_seed(seed)
        if self.num_samples < len(self.sampler.data_source):
            logger.info("Sample random subset from %s data: n=%d, seed=%d",
                        self.sampler.data_source.split, self.num_samples, seed)

    def reset(self) -> None:
        self.sampler.reset()

    def get_state(self):
        return self.sampler.get_state()

    def set_state(self, state) -> None:
        if state is not None:
            self.sampler.set_state(state)


class TokenBatchSampler(SentenceBatchSampler):
    """Batches whose padded token count (longest side + 1, times rows)
    reaches ``batch_size``."""

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        max_tokens = 0
        d = self.sampler.data_source
        for idx in self.sampler:
            _, src, trg = d[idx]
            if src is not None:
                src_len = len(src)
                trg_len = 0 if trg is None else len(trg)
                n_tokens = 0 if src_len == 0 else max(src_len + 1, trg_len + 1)
                batch.append(idx)
                max_tokens = max(max_tokens, n_tokens)
                if max_tokens * len(batch) >= self.batch_size:
                    yield batch
                    batch = []
                    max_tokens = 0
        yield from self._tail(batch)

    def __len__(self):
        raise NotImplementedError
