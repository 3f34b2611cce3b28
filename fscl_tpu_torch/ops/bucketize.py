"""searchsorted / digitize (port of `fscl_tpu/ops/bucketize.py`).

The JAX package writes both as a broadcast compare-reduce (`:30-37`) only to
avoid a serial `while` loop on the TPU. The counts are the same as PyTorch's
own binary searches, which run as one kernel each on the GPU.
"""
from __future__ import annotations

import torch


def searchsorted_right(sorted_ref: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """`#{l : sorted_ref[..., l] <= queries[..., t]}` for a sorted last axis.

    sorted_ref: (..., L); queries: (..., T), leading dims broadcast.
    """
    lead = torch.broadcast_shapes(sorted_ref.shape[:-1], queries.shape[:-1])
    ref = sorted_ref.expand(lead + sorted_ref.shape[-1:]).contiguous()
    q = queries.to(ref.dtype).expand(lead + queries.shape[-1:]).contiguous()
    return torch.searchsorted(ref, q, right=True)


def digitize(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """`numpy.digitize(x, edges)` for ascending 1-D edges: `#{e : edges[e] <= x}`."""
    return torch.bucketize(x, edges.to(x.dtype), right=True)
