"""Length regulator as a gather (port of `fscl_tpu/ops/length_regulator.py:28-79`),
and `gather_frame_labels` (`:82`), the same expansion of per-phoneme labels.

Frame t of sample b copies phoneme j(t) = #{l : cumsum(durations)[l] <= t};
frames past the total duration are zero. The gradient is the autograd of
`torch.gather` + `masked_fill`: a scatter-add of the valid frames' gradients
onto their phonemes, which is what the JAX package's one-hot VJP
(`_gather_expand_bwd`, `:39-49`) computes as a matmul to suit the TPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from fscl_tpu_torch.ops.bucketize import searchsorted_right


def regulate_lengths(
    x: torch.Tensor,            # (B, L, D) phoneme-level features
    durations: torch.Tensor,    # (B, L) int frame counts (>= 0)
    max_mel_len: int,           # output length
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, max_mel_len, D), mel_len (B,)). `mel_len` is the raw
    total duration; the caller clips it to `max_mel_len`."""
    B, L, D = x.shape
    csum = torch.cumsum(durations.long(), dim=-1)          # (B, L)
    mel_len = csum[:, -1]
    t = torch.arange(max_mel_len, device=x.device, dtype=csum.dtype)
    idx = searchsorted_right(csum, t[None, :])              # (B, T)
    valid = t[None, :] < mel_len[:, None]
    idx = idx.clamp(0, L - 1)
    out = torch.gather(x, 1, idx[..., None].expand(B, max_mel_len, D))
    return out.masked_fill(~valid[..., None], 0.0), mel_len


def gather_frame_labels(labels: torch.Tensor, durations: torch.Tensor, max_mel_len: int,
                        pad_value: int = 0) -> torch.Tensor:
    """Per-phoneme labels (B, L) expanded by their frame counts (B, L) to
    per-frame labels (B, max_mel_len); frames past the total duration take
    `pad_value` (the PR systems' frame targets, PRDataset.py)."""
    csum = torch.cumsum(durations.long(), dim=-1)
    t = torch.arange(max_mel_len, device=labels.device, dtype=csum.dtype)
    idx = searchsorted_right(csum, t[None, :]).clamp(0, labels.shape[1] - 1)
    out = torch.gather(labels, 1, idx)
    return torch.where(t[None, :] < csum[:, -1:], out, torch.full_like(out, pad_value))
