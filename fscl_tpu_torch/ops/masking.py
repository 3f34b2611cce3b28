"""Length-mask utilities (port of `fscl_tpu/ops/masking.py:13-43`).

Convention: `True` = VALID position, as in the JAX package.

Under `parallel.mesh.data_parallel` the sums and counts of `masked_mean` are
those of the global batch (`global_sum`), as in fscl_tpu's sharded step.
"""
from __future__ import annotations

import torch

from fscl_tpu_torch.ops.global_reduce import global_sum


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool, True where index < length."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def attn_mask_from_valid(valid: torch.Tensor) -> torch.Tensor:
    """(B, L) valid mask -> (B, L, L) attention mask, True where the key is
    valid (a broadcast view; the reference masks keys only)."""
    return valid[:, None, :].expand(valid.shape[0], valid.shape[1], valid.shape[1])


def _expand_to(valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    while valid.dim() < x.dim():
        valid = valid[..., None]
    return valid


def mask_fill(x: torch.Tensor, valid: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Zero (or fill) invalid positions; valid broadcast over trailing dims.
    The fill goes in as a Python number: a tensor made from it on the card
    is a copy from pageable host memory, which waits for the device."""
    return torch.where(_expand_to(valid, x), x, fill)


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of x over valid positions (at least one position in the count)."""
    valid = _expand_to(valid, x).expand(x.shape)
    total = global_sum(torch.where(valid, x, 0.0).sum())
    count = global_sum(valid.sum()).clamp(min=1)
    return total / count
