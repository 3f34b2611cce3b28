"""Batch samplers (port of `fscl_tpu/data/samplers.py`).

Re-provides lightning/sampler.py:7-86's GroupBatchSampler: shuffle within
length-sorted groups to minimize padding waste, which serves the static-shape
bucketing. One process feeds one card, so `maybe_distribute` is the
identity; the per-process split over `torch.distributed` waits for the
parallel layer (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import random
from typing import Iterator, List, Sequence


class GroupBatchSampler:
    """Shuffle within length-sorted groups, yield batches of near-equal
    lengths (lightning/sampler.py GroupBatchSampler). The same index lists
    as fscl_tpu's for the same arguments."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 group_size_multiplier: int = 8, seed: int = 43,
                 drop_last: bool = False):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.group_size = batch_size * group_size_multiplier
        self.rng = random.Random(seed)
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        order = list(range(len(self.lengths)))
        self.rng.shuffle(order)
        batches = []
        for g in range(0, len(order), self.group_size):
            group = sorted(order[g: g + self.group_size],
                           key=lambda i: self.lengths[i])
            for b in range(0, len(group), self.batch_size):
                batch = group[b: b + self.batch_size]
                if len(batch) == self.batch_size or not self.drop_last:
                    batches.append(batch)
        self.rng.shuffle(batches)
        return iter(batches)

    def __len__(self):
        if self.drop_last:
            return len(self.lengths) // self.batch_size
        return (len(self.lengths) + self.batch_size - 1) // self.batch_size


def maybe_distribute(sampler):
    """The sampler unchanged: one process, one card (fscl_tpu shards it
    over `jax.process_count()` hosts when there are several)."""
    return sampler
