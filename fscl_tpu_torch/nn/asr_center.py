"""ASR codebook-matching components (port of `fscl_tpu/nn/asr_center.py`,
lightning/model/asr_model.py:15-234): `MatchingCodebook`, the layer-weighted
multi-head attention map (not output) between SSL features and learned banks,
for codebook-matching analysis; `ASRCenterHead`, per-language phoneme centres
classifying frames by negative squared distance, with a centre loss.
Nothing in fscl_tpu calls them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from fscl_tpu_torch.ops.global_reduce import global_mean


class MatchingCodebook(nn.Module):
    """ref (B, L, n_layers, d_in) -> attention map (B, num_heads, L, size)
    (asr_model.py Codebook). NaNs in ref are zeroed; the layer weights start
    at 0 (uniform)."""

    def __init__(self, size: int = 128, d_in: int = 1024, dim: int = 256, num_heads: int = 4,
                 n_layers: int = 25, temperature: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = temperature if temperature is not None else (dim // num_heads) ** 0.5
        self.weight_raw = nn.Parameter(torch.zeros(1, 1, n_layers, 1))
        self.banks = nn.Parameter(torch.randn(size, dim))
        self.q_linear = nn.Linear(d_in, dim)

    def forward(self, ref):
        ref = torch.nan_to_num(ref)
        ref = (torch.softmax(self.weight_raw, dim=2) * ref).sum(dim=2)
        B, L, _ = ref.shape
        size, dim = self.banks.shape
        dh = dim // self.num_heads
        q = self.q_linear(ref).view(B, L, self.num_heads, dh).transpose(1, 2)
        k = self.banks.view(size, self.num_heads, dh).transpose(0, 1)
        return torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / self.temperature, dim=-1)


class ASRCenterHead(nn.Module):
    """Per-language phoneme centres `centers-<symbol_id>`: logits
    -||x - c||^2 and, given targets, the centre loss (the mean squared
    distance to the target's centre) (asr_model.py ASRCenterHead)."""

    def __init__(self, id2symbols: Tuple[Tuple[str, int], ...], dim: int = 256):
        super().__init__()
        self.centers = nn.ParameterDict(
            {f"centers-{sid}": nn.Parameter(torch.randn(n, dim)) for sid, n in id2symbols})

    def forward(self, x, symbol_id: str, targets=None):
        centers = self.centers[f"centers-{symbol_id}"]
        d = x[..., None, :] - centers
        logits = -(d * d).sum(dim=-1)
        if targets is None:
            return logits, None
        return logits, global_mean(((x - centers[targets.long()]) ** 2).sum(dim=-1))
