"""Phoneme embedding tables (port of `fscl_tpu/nn/embeddings.py:30-54`).

One table per symbol set, looked up by symbol_id or over the concatenation
of all tables, with the PAD row zeroed at lookup. The codebook attention of
the FSCL slice comes with that slice.
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
