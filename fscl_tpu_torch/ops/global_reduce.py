"""Batch-wide reductions over the ranks that split a batch.

fscl_tpu's data-parallel step is the single-device step jitted with the batch
sharded, so every batch-wide mean is the global batch's. The port runs one
process per rank: within `reduce_over(group)` (entered by
`parallel.mesh.data_parallel`), `global_sum` sums over that group, so the
layers' means (the losses, the PostNet's BatchNorm statistics, the speaker
average, the FSCL table) are those of the global batch and every rank holds
the global loss. Outside it every function here is the one-process one.

Gradients: each rank's loss is the global one, so autograd over all ranks
together takes the gradient of their sum, W times the loss for W ranks.
`_Sum`'s backward is the adjoint of the sum (it adds every rank's
gradient) and is itself a `_Sum`, so second derivatives (MAML's inner loop,
iMAML's Hessian-vector products) cross the ranks too. A rank's
`torch.autograd.grad` of the global loss is then its rows' part of W times
the gradient; `grad_of_global_loss` adds the ranks' parts and divides by W.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_GROUP = None


@contextlib.contextmanager
def reduce_over(group):
    """Within: `global_sum` sums over `group` (None: no reduction)."""
    global _GROUP
    before = _GROUP
    _GROUP = group
    try:
        yield
    finally:
        _GROUP = before


def data_parallel_active() -> bool:
    return _GROUP is not None


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


class _Sum(torch.autograd.Function):
    """A sum over the group whose backward sums the ranks' gradients, by
    itself, so that it can be differentiated again."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.group), None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the active group, differentiably; `t` itself
    outside `reduce_over`."""
    if _GROUP is None:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _Sum.apply(t, _GROUP)
    return _all_reduce(t.clone(), _GROUP)


def global_mean(x: torch.Tensor, dim: int = None, keepdim: bool = False) -> torch.Tensor:
    """`x.mean()` (over `dim` when given, the batch's rows for dim 0) of the
    global batch within `reduce_over`; `x.mean()` itself outside."""
    if _GROUP is None:
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    total = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    count = x.numel() if dim is None else x.shape[dim]
    n = global_sum(torch.tensor(float(count), device=x.device))
    return global_sum(total) / n


def grad_of_global_loss(g: torch.Tensor) -> torch.Tensor:
    """The gradient of the global loss from this rank's autograd gradient
    of it (the ranks' parts added, over W), differentiably; `g` itself
    outside `reduce_over`."""
    if _GROUP is None:
        return g
    return global_sum(g) / dist.get_world_size(_GROUP)
