"""Length-mask utilities (port of `fscl_tpu/ops/masking.py:13-43`).

Convention: `True` = VALID position, as in the JAX package.
"""
from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool, True where index < length."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def _expand_to(valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    while valid.dim() < x.dim():
        valid = valid[..., None]
    return valid


def mask_fill(x: torch.Tensor, valid: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Zero (or fill) invalid positions; valid broadcast over trailing dims."""
    return torch.where(_expand_to(valid, x), x, torch.tensor(fill, dtype=x.dtype, device=x.device))


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of x over valid positions (at least one position in the count)."""
    valid = _expand_to(valid, x).expand(x.shape)
    total = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum()
    count = valid.sum().clamp(min=1)
    return total / count
