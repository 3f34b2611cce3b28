"""PRNG discipline (port of `fscl_tpu/core/prng.py`).

Seeds are explicit. `RngStream` hands out fresh `torch.Generator`s (or the
seeds for them) on an explicit device, in a fixed order from one seed, where
the JAX package splits `jax.random` keys; `py_rng(seed)` gives a
deterministic `random.Random` and `np_rng(seed)` a numpy Generator for
host-side sampling (episodic tasks), so replays are reproducible.

The streams are not JAX's: a torch generator seeded from this stream draws
other numbers than a JAX key split from `PRNGKey(seed)`. What carries over
is the discipline (one seed, an ordered stream of independent sub-streams).
"""
from __future__ import annotations

import random
from typing import List, Optional, Union

import numpy as np
import torch

_SEED_BOUND = 2 ** 63 - 1


class RngStream:
    """A stream of independent `torch.Generator`s from one seed. The seeds
    come from a numpy `SeedSequence`-backed generator, so the n-th generator
    of a stream is the same on every device and every host."""

    def __init__(self, seed: int = 43, device: Union[str, torch.device] = "cpu"):
        self._seeds = np.random.default_rng(seed)
        self.device = torch.device(device)

    def next_seed(self) -> int:
        return int(self._seeds.integers(0, _SEED_BOUND))

    def next(self, device: Optional[Union[str, torch.device]] = None) -> torch.Generator:
        g = torch.Generator(device=torch.device(device) if device is not None else self.device)
        g.manual_seed(self.next_seed())
        return g

    def next_n(self, n: int, device: Optional[Union[str, torch.device]] = None
               ) -> List[torch.Generator]:
        return [self.next(device) for _ in range(n)]


def py_rng(seed: int = 43) -> random.Random:
    return random.Random(seed)


def np_rng(seed: int = 43) -> np.random.Generator:
    return np.random.default_rng(seed)
