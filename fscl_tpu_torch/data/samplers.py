"""Batch samplers (port of `fscl_tpu/data/samplers.py`).

Re-provides lightning/sampler.py:7-86's GroupBatchSampler: shuffle within
length-sorted groups to minimize padding waste, which serves the static-shape
bucketing. `maybe_distribute` splits a sampler's batches over the
processes that read streams of their own (`--distributed`), as fscl_tpu
splits them over its hosts.
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
    """Shard a batch sampler over the processes when each reads a stream of
    its own (`parallel.multihost.maybe_initialize`; split over the mesh's
    data axis once there is a mesh); the sampler unchanged otherwise: one
    process, or ranks that all read the one global stream (`--n_devices`).
    Datamodules route every train sampler through this (the reference's DDP
    per-process split, lightning/sampler.py:50-86)."""
    from fscl_tpu_torch.parallel.multihost import stream_shard
    shard = stream_shard()
    if shard is not None and shard[0] > 1:
        return DistributedBatchSampler(sampler, *shard)
    return sampler


class DistributedBatchSampler:
    """Shard a batch sampler over processes (lightning/sampler.py:50-86):
    process `rank` takes every num_replicas-th batch, a disjoint stream."""

    def __init__(self, sampler, num_replicas: int, rank: int):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} outside 0..{num_replicas - 1}")
        self.sampler = sampler
        self.num_replicas = num_replicas
        self.rank = rank

    def __iter__(self):
        for i, batch in enumerate(self.sampler):
            if i % self.num_replicas == self.rank:
                yield batch

    def __len__(self):
        return len(self.sampler) // self.num_replicas
