"""Lloyd's k-means (port of `fscl_tpu/nn/phoneme_embedding.py:kmeans`,
`:23`); the module's codebook variants wait for ROADMAP item 10.

fscl_tpu iterates in XLA (`lax.scan`); here it is a loop of torch ops on the
data's device. The squared distances are |x|^2 - 2 x c^T + |c|^2, one
product per iteration, where fscl_tpu sums (x - c)^2 over a broadcast
(N, k, D) array: the same distances up to rounding, so an assignment may
differ only where two centroids are within rounding of a tie.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def sq_distances(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N, k) squared Euclidean distances, clamped at 0."""
    d = (x * x).sum(-1, keepdim=True) - 2.0 * x @ centroids.T + (centroids * centroids).sum(-1)
    return d.clamp(min=0.0)


def kmeans(x: torch.Tensor, k: int, iters: int = 20, seed: int = 0,
           init_idx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centroids (k, D), assignments (N,)) of `iters` Lloyd iterations over
    (N, D) `x`, seeded from k distinct rows: `init_idx`, or drawn without
    replacement from a generator on x's device seeded with `seed` (fscl_tpu
    draws them with `jax.random.choice`). A centroid with no points keeps
    its place."""
    N, D = x.shape
    if init_idx is None:
        gen = torch.Generator(device=x.device).manual_seed(seed)
        init_idx = torch.randperm(N, generator=gen, device=x.device)[:k]
    centroids = x[init_idx.to(x.device)]
    ones = x.new_ones(N)
    for _ in range(iters):
        assign = sq_distances(x, centroids).argmin(dim=-1)
        sums = x.new_zeros(k, D).index_add_(0, assign, x)
        counts = x.new_zeros(k).index_add_(0, assign, ones)
        centroids = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None],
                                centroids)
    return centroids, sq_distances(x, centroids).argmin(dim=-1)
