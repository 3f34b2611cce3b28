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

The meta-learning half (`:29-244`): `inner_adapt` takes K SGD steps on a
dict of tensors with `torch.autograd.grad`, keeping the graph of each
gradient (`create_graph`) unless `first_order`, so that the outer loss
differentiates through them (second-order MAML). `MAMLTransEmbSystem`
adapts the episode's table and the trunk on the support set's own TTS
batch, then takes the query loss through the adapted tensors;
`IMAMLTransEmbSystem` runs a proximal inner loop that is not
differentiated, then solves (I + H / lambda) v = g_qry with `cg_solve`,
taking each Hessian-vector product as the gradient of <grad L_sup, v>
(reverse over reverse: the attention Function has no forward-mode rule, as
fscl_tpu's custom VJPs have none), and trains through the surrogate
<v, theta>. `torch.autograd`, not `torch.func`: cuDNN's LSTM cannot run
under the transforms on the card. As in fscl_tpu, the inner loops run in
eval mode (GE2E runs `lstm_unrolled` where the graph is kept for a second
derivative: cuDNN's RNN has no double backward), and the train-mode query pass
updates copies of the BatchNorm statistics, which are thrown away (fscl_tpu
returns no new `batch_stats`).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value
from torch.utils._pytree import tree_leaves, tree_map

from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.data.batch import Batch
from fscl_tpu_torch.nn.losses import FastSpeech2LossOutput
from fscl_tpu_torch.nn.speaker_encoder import unrolled_lstms
from fscl_tpu_torch.ops.global_reduce import grad_of_global_loss
from fscl_tpu_torch.systems.base import adaptation_mode, module_mode
from fscl_tpu_torch.systems.fscl import Episode, TransEmbSystem

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


# -- meta-learning (fscl_tpu's `:29-244`) -------------------------------------------

def _grads(loss: torch.Tensor, params: Params, create_graph: bool = False,
           retain_graph: Optional[bool] = None) -> Params:
    """d loss / d params, a zero tensor where the loss does not reach (as
    `jax.grad` gives); under data parallelism the global loss's gradient,
    the same on every rank (`ops/global_reduce.py`)."""
    grads = torch.autograd.grad(loss, list(params.values()), create_graph=create_graph,
                                retain_graph=retain_graph, allow_unused=True)
    return {n: grad_of_global_loss(torch.zeros_like(p) if g is None else g)
            for (n, p), g in zip(params.items(), grads)}


def inner_adapt(loss_fn: Callable[[Params], torch.Tensor], params: Params, inner_lr: float,
                inner_steps: int, first_order: bool = False) -> Params:
    """K SGD steps p - lr * grad(loss_fn)(p) on a dict of tensors;
    differentiable through the gradients (second-order MAML) unless
    `first_order`, where the outer gradient reaches `params` through the
    identity only (fscl_tpu's stop_gradient). Runs with grad enabled, also
    under `no_grad` (an eval step adapts too)."""
    if inner_steps <= 0:
        return params
    with torch.enable_grad():
        p = {n: t if t.requires_grad else t.detach().requires_grad_() for n, t in params.items()}
        for _ in range(inner_steps):
            g = _grads(loss_fn(p), p, create_graph=not first_order)
            p = {n: p[n] - inner_lr * g[n] for n in p}
    return p


def _tree_dot(a: Params, b: Params) -> torch.Tensor:
    return sum((a[n] * b[n]).sum() for n in a)


def _tree_axpy(alpha, x: Params, y: Params) -> Params:
    return {n: alpha * x[n] + y[n] for n in x}


def cg_solve(matvec: Callable[[Params], Params], b: Params, n_steps: int) -> Params:
    """Fixed-step conjugate gradients for a symmetric positive definite
    matvec x = b (fscl_tpu's `:137-159`: iMAML's `imaml.K` steps), every
    scalar on the device."""
    x = {n: torch.zeros_like(t) for n, t in b.items()}
    r, p = b, b
    rs = _tree_dot(r, r)
    for _ in range(n_steps):
        Ap = matvec(p)
        alpha = rs / (_tree_dot(p, Ap) + 1e-12)
        x = _tree_axpy(alpha, p, x)
        r = _tree_axpy(-alpha, Ap, r)
        rs_new = _tree_dot(r, r)
        p = _tree_axpy(rs_new / (rs + 1e-12), p, r)
        rs = rs_new
    return x


@SYSTEMS.register("fscl-orig2", "maml", "meta")
class MAMLTransEmbSystem(TransEmbSystem):
    """The FSCL episode with an inner loop on the support set's TTS batch
    (`Episode.sup_batch`, `collate_episode(with_sup_batch=True)`): the
    episode's table and the trunk's trainable tensors take
    `adaptation_steps` SGD steps at `adaptation_lr` in eval mode, then the
    query loss runs through the adapted tensors in the module's mode."""

    def __init__(self, *args, adaptation_lr: float = 1e-3, adaptation_steps: int = 2,
                 first_order: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.adaptation_lr = adaptation_lr
        self.adaptation_steps = adaptation_steps
        self.first_order = first_order

    def model_params(self) -> Params:
        """The trunk's trainable tensors by their names in `self.model`
        (GE2E's constant `bias_ih` left out: flax's one bias per gate is its
        `bias_hh`)."""
        return {n: p for n, p in self.model.named_parameters() if p.requires_grad}

    def episode_loss(self, p: Params, batch: Batch) -> FastSpeech2LossOutput:
        """fastspeech2_loss of `batch` through the table `p["table"]` and the
        trunk with `p`'s tensors. In train mode the BatchNorm statistics
        are copies, whose updates are thrown away."""
        state = {n: t for n, t in p.items() if n != "table"}
        if self.model.training:
            state.update((n, b.clone()) for n, b in self.model.named_buffers())
        return self.query_loss(self.forward_query(p["table"], batch, state), batch)

    def inner_mode(self, create_graph: bool):
        """The inner loops' mode: the trunk in eval mode; GE2E unrolled when
        the gradient keeps its graph (cuDNN's RNN has no double backward),
        else its LSTM in train mode (cuDNN's RNN refuses a backward in eval
        mode; without dropout the same function)."""
        if not create_graph:
            return adaptation_mode(self.model)
        stack = contextlib.ExitStack()
        stack.enter_context(module_mode(self.model, False))
        stack.enter_context(unrolled_lstms(self.model))
        return stack

    def _table(self, episode: Episode) -> torch.Tensor:
        if episode.sup_batch is None:
            raise ValueError(f"{type(self).__name__} needs collate_episode(with_sup_batch=True)")
        ssl_hidden, _ = self.extract_ssl(episode.sup.wavs, episode.sup.wav_lens)
        return self.build_embedding_table(ssl_hidden, episode.sup)

    def loss_and_metrics(self, episode: Episode):
        inner = {"table": self._table(episode), **self.model_params()}
        with self.inner_mode(create_graph=not self.first_order):
            adapted = inner_adapt(lambda p: self.episode_loss(p, episode.sup_batch).total,
                                  inner, self.adaptation_lr, self.adaptation_steps,
                                  self.first_order)
        losses = self.episode_loss(adapted, episode.qry)
        return losses.total, {k: v.detach() for k, v in losses.as_dict().items()}


@SYSTEMS.register("imaml")
class IMAMLTransEmbSystem(MAMLTransEmbSystem):
    """iMAML: p* ~ argmin L_sup(p) + (lambda / 2) ||p - theta||^2 by
    `adaptation_steps` SGD steps that are not differentiated; then
    (I + H / lambda) v = g_qry with H the support loss's Hessian at p*, by
    `cg_steps` steps of CG; the meta-gradient reaches theta (the table, so
    the codebook, and the trunk) through the surrogate <v, theta>. The
    support loss's gradient at p* is taken once with its graph, and each
    Hessian-vector product is a backward of <that gradient, v> through it
    (fscl_tpu recomputes the gradient in each product: the same numbers)."""

    def __init__(self, *args, cg_steps: int = 5, reg_param: float = 1.0, **kwargs):
        kwargs.setdefault("adaptation_steps", 5)
        super().__init__(*args, **kwargs)
        self.cg_steps = cg_steps
        self.reg_param = reg_param

    def loss_and_metrics(self, episode: Episode):
        theta = {"table": self._table(episode), **self.model_params()}
        anchor = {n: t.detach() for n, t in theta.items()}
        lam = self.reg_param

        def sup_loss(p):
            return self.episode_loss(p, episode.sup_batch).total

        def prox_loss(p):
            return sup_loss(p) + 0.5 * lam * sum(((p[n] - anchor[n]) ** 2).sum() for n in p)

        with self.inner_mode(create_graph=False):
            adapted = inner_adapt(prox_loss, anchor, self.adaptation_lr, self.adaptation_steps,
                                  first_order=True)
        adapted = {n: t.detach().requires_grad_() for n, t in adapted.items()}
        with torch.enable_grad():
            q_val = self.episode_loss(adapted, episode.qry).total
            g_qry = _grads(q_val, adapted)
            with self.inner_mode(create_graph=True):
                g_sup = _grads(sup_loss(adapted), adapted, create_graph=True)

                def matvec(v):
                    hv = _grads(_tree_dot(g_sup, v), adapted, retain_graph=True)
                    return {n: v[n] + hv[n] / lam for n in v}

                v = cg_solve(matvec, g_qry, self.cg_steps)
        del g_sup
        v = {n: t.detach() for n, t in v.items()}
        surrogate = _tree_dot(v, theta)
        meta_loss = surrogate - surrogate.detach() + q_val.detach()
        with torch.no_grad(), module_mode(self.model, False):
            metrics = {k: t.detach() for k, t in
                       self.episode_loss(adapted, episode.qry).as_dict().items()}
        metrics["Total Loss"] = q_val.detach()
        return meta_loss, metrics
