"""Phoneme embedding tables and codebook attention (port of
`fscl_tpu/nn/embeddings.py:30-144`).

`MultilingualEmbedding`: one table per symbol set, looked up by symbol_id or
over the concatenation of all tables, with the PAD row zeroed at lookup.
`SoftMultiAttCodebook` and `SoftMultiAttCodebook2`: multi-head attention of
queries against learned key and value banks of `codebook_size` rows (the
FSCL system's per-episode phoneme table). Their attention is Lq queries
against 128 bank rows, which the JAX package computes with `einsum` outside
any Pallas call; here it is `torch.matmul` and `softmax` in f32, not `attend`
(whose kernel takes only Lq == Lk). Parameter names are the reference torch
module's (`emb_banks`, `att_banks`, `weight_raw`, `q_linear`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


class MultilingualEmbedding(nn.Module):
    """Tables named `table-<symbol_id>` under `tables`, as the reference's
    `nn.ParameterDict` (embeddings.py:8-31)."""

    def __init__(self, id2symbols: Tuple[Tuple[str, int], ...], dim: int = 256,
                 padding_idx: int = 0):
        super().__init__()
        self.padding_idx = padding_idx
        self.tables = nn.ParameterDict()
        for symbol_id, n in id2symbols:
            if n > 0:
                # Xavier-uniform with the PAD row zeroed (embeddings.py:17-22)
                bound = math.sqrt(3.0) * math.sqrt(2.0 / (n + dim))
                w = torch.empty(n, dim).uniform_(-bound, bound)
                w[padding_idx] = 0.0
                self.tables[f"table-{symbol_id}"] = nn.Parameter(w)

    def forward(self, x: torch.Tensor, symbol_id: Optional[str] = None) -> torch.Tensor:
        if symbol_id is None:
            table = torch.cat(list(self.tables.values()), dim=0)
        else:
            table = self.tables[f"table-{symbol_id}"]
        emb = nn.functional.embedding(x, table)
        return emb.masked_fill((x == self.padding_idx)[..., None], 0.0)


def _bank(codebook_size: int, dim: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(codebook_size, dim))    # flax normal(1.0)


def _bank_attention(q, att_banks, emb_banks, num_heads: int, temperature: float):
    """(B, L, dim) queries against (C, dim) key and value banks split into
    heads: softmax(q k^T / temperature) v, in f32. Returns (out (B, L, dim),
    weights (B, H, L, C))."""
    B, L, dim = q.shape
    C, d_head = att_banks.shape[0], dim // num_heads
    qh = q.reshape(B, L, num_heads, d_head).transpose(1, 2)
    k = att_banks.reshape(C, num_heads, d_head).transpose(0, 1)
    v = emb_banks.reshape(C, num_heads, d_head).transpose(0, 1)
    attn = torch.softmax(torch.matmul(qh, k.transpose(-1, -2)) / temperature, dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B, L, dim)
    return out, attn


class SoftMultiAttCodebook(nn.Module):
    """Codebook attention without layer weighting or query projection
    (`:57-86`): the query is already in model space."""

    def __init__(self, codebook_size: int = 128, dim: int = 256, num_heads: int = 4,
                 temperature: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = (temperature if temperature is not None
                            else (dim // num_heads) ** 0.5)
        self.emb_banks = _bank(codebook_size, dim)
        self.att_banks = _bank(codebook_size, dim)

    def forward(self, query: torch.Tensor, need_weights: bool = False):
        out, attn = _bank_attention(query, self.att_banks, self.emb_banks,
                                    self.num_heads, self.temperature)
        return out, (attn if need_weights else None)


class SoftMultiAttCodebook2(nn.Module):
    """Layer-weighted codebook attention (`:89-144`). `ref` is
    (B, L, n_layers, upstream_dim) SSL features, or the phoneme-query table
    with B = 1, L = n_symbols; returns (B, L, dim) embeddings.

    The n_layers features are mixed by softmax(weight_raw) over the layers;
    with `layer_idx` set, by a fixed one-hot instead (raw weights -1e9 but
    10.0 at the pinned layer, no gradient; `weight_raw` stays a parameter
    the loss does not reach, as in flax). With `use_layer_weights=False`
    (the `mel` upstream) the layers are concatenated. NaNs in `ref` are
    zeroed on entry; the temperature is sqrt(dim / num_heads)."""

    def __init__(self, codebook_size: int = 128, dim: int = 256, num_heads: int = 4,
                 upstream_dim: int = 1024, n_layers: int = 25,
                 layer_idx: Optional[int] = None, use_layer_weights: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = (dim // num_heads) ** 0.5
        self.use_layer_weights = use_layer_weights
        in_dim = upstream_dim
        if use_layer_weights:
            self.weight_raw = nn.Parameter(torch.zeros(1, n_layers, 1))
            pinned = None
            if layer_idx is not None:
                pinned = torch.full((1, n_layers, 1), -1e9)
                pinned[0, layer_idx, 0] = 10.0
            self.register_buffer("pinned_weight_raw", pinned, persistent=False)
        else:
            in_dim = n_layers * upstream_dim
        self.q_linear = nn.Linear(in_dim, dim)
        self.emb_banks = _bank(codebook_size, dim)
        self.att_banks = _bank(codebook_size, dim)

    def forward(self, ref: torch.Tensor, need_weights: bool = False):
        ref = torch.nan_to_num(ref)
        if self.use_layer_weights:
            raw = (self.pinned_weight_raw if self.pinned_weight_raw is not None
                   else self.weight_raw)
            layer_w = torch.softmax(raw[None], dim=2)            # (1, 1, n_layers, 1)
            ref = (layer_w * ref).sum(dim=2)                    # (B, L, upstream_dim)
        else:
            ref = ref.reshape(ref.shape[0], ref.shape[1], -1)
        out, attn = _bank_attention(self.q_linear(ref), self.att_banks, self.emb_banks,
                                    self.num_heads, self.temperature)
        return out, (attn if need_weights else None)

    def layer_weights(self) -> Optional[torch.Tensor]:
        """softmax(weight_raw) over the layers, (1, n_layers), for logging;
        None without layer weights."""
        if not self.use_layer_weights:
            return None
        return torch.softmax(self.weight_raw.detach(), dim=1)[..., 0]
