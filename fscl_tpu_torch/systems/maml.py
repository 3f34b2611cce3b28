"""Test-time adaptation loops (port of `fscl_tpu/systems/maml.py:247-323`).

`fast_adaptation_scan` (SGD) and `adam_carry`, `adam_scan_carry` and
`fast_adaptation_scan_adam` (the tune flows' Adam) over a
`loss_fn(params, batch)`, where `params` maps parameter names to tensors
(`torch.func.functional_call` takes such a dict) and `batch` is one step's
slice of `batches`: any pytree of tensors with a leading step axis (a
stacked `Batch`, or an index array that the loss gathers rows with).

A JAX scan becomes a Python loop that never waits for the device: each
step's loss stays a device tensor and the losses are stacked at the end, the
clip's global norm is computed on the device, and Adam's bias corrections
are host numbers in float32 (the step count t is counted on the host, as
`train/optim.py:lr_schedule` evaluates its rate). The update runs on one flat
vector of all parameters (and of Adam's moments), a handful of launches per
step whatever the number of tensors; the loss sees the parameters as views
of it. `torch._foreach_*` ops would do the same per tensor but have no
batching rule, and `systems/tune.py:adapt_many_on_chip` runs these very
loops under `torch.func.vmap` over a task axis: there the gradients come
from `torch.func.grad_and_value`, elsewhere from `torch.autograd`.

`inner_adapt`, `MAMLTransEmbSystem` and iMAML are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.func import grad_and_value
from torch.utils._pytree import tree_leaves, tree_map

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Any], torch.Tensor]
AdamCarry = Tuple[Params, Params, Params, float]


class _Layout(NamedTuple):
    names: Tuple[str, ...]
    shapes: Tuple[torch.Size, ...]
    numels: Tuple[int, ...]


def _layout(params: Params) -> _Layout:
    dtypes = {p.dtype for p in params.values()}
    if len(dtypes) != 1:
        raise ValueError(f"parameters of one dtype expected, got {dtypes}")
    return _Layout(tuple(params), tuple(p.shape for p in params.values()),
                   tuple(p.numel() for p in params.values()))


def _flatten(tree: Params, layout: _Layout) -> torch.Tensor:
    return torch.cat([tree[n].reshape(-1) for n in layout.names])


def _unflatten(flat: torch.Tensor, layout: _Layout) -> Params:
    return {n: t.view(shape) for n, t, shape in
            zip(layout.names, flat.split(layout.numels), layout.shapes)}


def _steps(batches):
    """Each step's slice of a pytree with a leading step axis."""
    for i in range(tree_leaves(batches)[0].shape[0]):
        yield tree_map(lambda x: x[i], batches)


def _value_and_flat_grad(loss_fn: LossFn, flat: torch.Tensor, layout: _Layout, batch):
    """(loss, flat gradient) at the flat parameters: by `torch.func` under a
    `torch.func` transform (vmap wraps the batch's tensors), which autograd
    cannot run under, else by `torch.autograd` on fresh leaves, which lets
    cuDNN's LSTM run (it refuses the transforms' wrapped tensors). A
    parameter the loss does not reach gets a zero gradient, as under
    `torch.func.grad`."""
    params = _unflatten(flat, layout)
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t)
           for t in (flat, *tree_leaves(batch))):
        grads, loss = grad_and_value(loss_fn)(params, batch)
        return loss, _flatten(grads, layout)
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), torch.cat([torch.zeros(p.numel(), dtype=p.dtype, device=p.device)
                                     if g is None else g.reshape(-1)
                                     for g, p in zip(grads, leaves.values())])


def sgd_step(loss_fn: LossFn, flat: torch.Tensor, layout: _Layout, batch, lr: float):
    """One SGD step on the flat parameters: p - lr * g. Returns (new flat
    parameters, loss at the old ones)."""
    loss, g = _value_and_flat_grad(loss_fn, flat, layout, batch)
    return flat - lr * g, loss


def adam_step(loss_fn: LossFn, state, layout: _Layout, batch, lr: float, t: float,
              betas=(0.9, 0.98), eps: float = 1e-9, clip: float = 1.0):
    """One step of the tune Adam (`maml.py:286-307`) on flat (params, mu, nu)
    at step count t (this step's, from 1): the gradient scaled by
    min(1, clip / max(||g||, 1e-12)) over every parameter, the moments,
    bias corrections 1 - b**t in float32, eps outside the root, a constant
    rate. Returns (new (params, mu, nu), loss at the old parameters)."""
    p, mu, nu = state
    b1, b2 = betas
    loss, g = _value_and_flat_grad(loss_fn, p, layout, batch)
    # sqrt of a summed square, as JAX: torch's CPU vector_norm of a float32
    # vector this long is 1e-4 off (it was the test's gap to fscl_tpu)
    gnorm = torch.sqrt(torch.sum(torch.square(g)))
    g = g * torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * torch.square(g)
    tf = np.float32(t)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** tf)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** tf)
    p = p - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    return (p, mu, nu), loss


def fast_adaptation_scan(loss_fn: LossFn, params: Params, batches, lr: float = 1e-3):
    """SGD over the steps of `batches`. Returns (adapted params, per-step
    losses (n_steps,)), both on the device."""
    layout = _layout(params)
    flat = _flatten(params, layout)
    losses = []
    for batch in _steps(batches):
        flat, loss = sgd_step(loss_fn, flat, layout, batch, lr)
        losses.append(loss)
    return _unflatten(flat, layout), torch.stack(losses)


def adam_carry(params: Params) -> AdamCarry:
    """A fresh Adam carry (params, mu, nu, t) for `adam_scan_carry`."""
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    return dict(params), zeros, dict(zeros), 0.0


def adam_scan_carry(loss_fn: LossFn, carry: AdamCarry, batches, lr: float = 1e-3,
                    betas=(0.9, 0.98), eps: float = 1e-9, clip: float = 1.0):
    """Adam over the steps of `batches` from `carry` (from `adam_carry` or a
    previous call), so that a run split into chunks is step-exact with one
    long run. Returns (new carry, per-step losses (n_steps,))."""
    params, mu, nu, t = carry
    layout = _layout(params)
    state = tuple(_flatten(x, layout) for x in (params, mu, nu))
    losses = []
    for batch in _steps(batches):
        t = float(np.float32(t) + np.float32(1.0))
        state, loss = adam_step(loss_fn, state, layout, batch, lr, t, betas, eps, clip)
        losses.append(loss)
    params, mu, nu = (_unflatten(x, layout) for x in state)
    return (params, mu, nu, t), torch.stack(losses)


def fast_adaptation_scan_adam(loss_fn: LossFn, params: Params, batches, lr: float = 1e-3,
                              betas=(0.9, 0.98), eps: float = 1e-9, clip: float = 1.0):
    """`fast_adaptation_scan` with the tune Adam from fresh moments. Returns
    (adapted params, per-step losses)."""
    carry, losses = adam_scan_carry(loss_fn, adam_carry(params), batches, lr, betas, eps, clip)
    return carry[0], losses
