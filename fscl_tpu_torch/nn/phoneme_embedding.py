"""The phoneme-embedding hub: Lloyd's k-means, the codebook variants and
the mode registry (port of `fscl_tpu/nn/phoneme_embedding.py`: `kmeans`
`:23`, `HardAttCodebook` `:49`, `SoftAttCodebook` `:81`,
`PhonemeEmbeddingHub` `:102`).

fscl_tpu iterates k-means in XLA (`lax.scan`); here it is a loop of torch ops
on the data's device. The squared distances are |x|^2 - 2 x c^T + |c|^2, one
product per iteration, where fscl_tpu sums (x - c)^2 over a broadcast
(N, k, D) array: the same distances up to rounding, so an assignment may
differ only where two centroids are within rounding of a tie.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fscl_tpu_torch.nn.embeddings import SoftMultiAttCodebook, SoftMultiAttCodebook2


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


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class HardAttCodebook(nn.Module):
    """Cosine-argmax matching against centroid banks (phoneme_embedding.py
    HardAttCodebook): each phoneme query (n_symbols, upstream_dim) takes the
    learned embedding of its nearest centroid; a symbol whose query is all
    zero gets a zero row. The banks are `centroids` when given (k-means
    output), else the learned `att_banks`."""

    def __init__(self, codebook_size: int = 128, dim: int = 256, upstream_dim: int = 1024):
        super().__init__()
        self.emb_banks = nn.Parameter(torch.randn(codebook_size, dim))
        self.att_banks = nn.Parameter(torch.randn(codebook_size, upstream_dim))

    def forward(self, queries, centroids=None, need_weights: bool = False):
        banks = self.att_banks if centroids is None else centroids
        idx = (_unit_rows(queries) @ _unit_rows(banks).T).argmax(dim=-1)
        has_signal = (queries != 0).any(dim=-1, keepdim=True)
        table = torch.where(has_signal, self.emb_banks[idx], 0.0)
        if need_weights:
            return table, F.one_hot(idx, self.emb_banks.shape[0]).to(table.dtype)
        return table, None


class SoftAttCodebook(nn.Module):
    """Single-head soft attention of the queries (n, upstream_dim) over the
    attention banks, then the weighted embedding banks; temperature sqrt(dim)
    unless given (phoneme_embedding.py SoftAttCodebook)."""

    def __init__(self, codebook_size: int = 128, dim: int = 256, upstream_dim: int = 1024,
                 temperature: Optional[float] = None):
        super().__init__()
        self.temperature = temperature if temperature is not None else dim ** 0.5
        self.emb_banks = nn.Parameter(torch.randn(codebook_size, dim))
        self.att_banks = nn.Parameter(torch.randn(codebook_size, upstream_dim))

    def forward(self, queries, need_weights: bool = False):
        attn = torch.softmax(queries @ self.att_banks.T / self.temperature, dim=-1)
        table = attn @ self.emb_banks
        return table, (attn if need_weights else None)


class PhonemeEmbeddingHub:
    """Mode registry (phoneme_embedding.py PhonemeEmbedding.get_new_embedding):
    "table" / "table-sep" -> None (MultilingualEmbedding's plain tables);
    "hard" -> HardAttCodebook; "soft" -> SoftAttCodebook; "soft-m" /
    "soft-m2" -> SoftMultiAttCodebook(2)."""

    MODES = ("table", "table-sep", "hard", "soft", "soft-m", "soft-m2")

    @staticmethod
    def build(mode: str, codebook_size: int = 128, dim: int = 256, upstream_dim: int = 1024,
              n_layers: int = 25):
        if mode in ("table", "table-sep"):
            return None
        if mode == "hard":
            return HardAttCodebook(codebook_size, dim, upstream_dim)
        if mode == "soft":
            return SoftAttCodebook(codebook_size, dim, upstream_dim)
        if mode == "soft-m":
            return SoftMultiAttCodebook(codebook_size, dim)
        if mode == "soft-m2":
            return SoftMultiAttCodebook2(codebook_size=codebook_size, dim=dim,
                                         upstream_dim=upstream_dim, n_layers=n_layers)
        raise NotImplementedError(mode)
