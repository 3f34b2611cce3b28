"""Length regulator as a gather, forward only
(port of `fscl_tpu/ops/length_regulator.py:55-79`).

Frame t of sample b copies phoneme j(t) = #{l : cumsum(durations)[l] <= t};
frames past the total duration are zero. The one-hot VJP of the JAX package
(`:39-49`) comes with the training slice.
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
