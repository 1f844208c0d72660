"""Samplers: the shard of the global index space one process reads (the
port's own copy of ``llava_reward_tpu/data/sampler.py``).

GroupSampler is the numpy equivalent of the reference's
GroupDistributedSampler (custom_distributed_sampler.py:13-62): shuffle at
GROUP granularity (groups of ``group_size`` consecutive samples stay
together), pad to an even split, round-robin shard across replicas, and
optionally subsample ``sample_group_num`` groups.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np


class DistributedSampler:
    """Plain shuffled, padded, strided shard (torch DistributedSampler
    semantics: pad then take rank::num_replicas)."""

    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _base_indices(self) -> List[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            return list(rng.permutation(self.dataset_len))
        return list(range(self.dataset_len))

    def _pad(self, indices: List[int]) -> List[int]:
        if self.drop_last:
            return indices[: self.total_size]
        padding = self.total_size - len(indices)
        if padding <= 0:
            return indices[: self.total_size]
        if padding <= len(indices):
            return indices + indices[:padding]
        reps = math.ceil(padding / len(indices))
        return indices + (indices * reps)[:padding]

    def __iter__(self) -> Iterator[int]:
        indices = self._pad(self._base_indices())
        return iter(indices[self.rank :: self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples


class GroupSampler(DistributedSampler):
    """Group-granular shuffle + optional group subsampling
    (custom_distributed_sampler.py:22-56)."""

    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        group_size: int = 1,
        sample_group_num: Optional[int] = None,
    ):
        super().__init__(dataset_len, num_replicas, rank, shuffle, seed, drop_last)
        self.group_size = group_size
        self.num_groups = math.ceil(dataset_len / group_size)
        self.sample_group_num = (
            sample_group_num
            if sample_group_num and sample_group_num <= self.num_groups
            else self.num_groups
        )

    def _base_indices(self) -> List[int]:
        if not self.shuffle:
            return list(range(self.dataset_len))
        rng = np.random.default_rng(self.seed + self.epoch)
        indices: List[int] = []
        for g in rng.permutation(self.num_groups):
            start = int(g) * self.group_size
            indices.extend(range(start, min(start + self.group_size, self.dataset_len)))
        return indices

    def __iter__(self) -> Iterator[int]:
        indices = self._pad(self._base_indices())
        if self.sample_group_num < self.num_groups:
            total = self.sample_group_num * self.group_size
            return iter(indices[self.rank : total : self.num_replicas])
        return iter(indices[self.rank : self.total_size : self.num_replicas])

    def __len__(self) -> int:
        if self.sample_group_num < self.num_groups:
            return math.ceil(self.sample_group_num * self.group_size / self.num_replicas)
        return self.num_samples
