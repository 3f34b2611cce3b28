"""Optimizer and learning-rate schedule (port of `fscl_tpu/train/optim.py:19-74`).

The JAX package chains optax transforms; `Adam` below does the same update
by hand on tensors (`torch._foreach_*`), in optax's order:

1. `optax.MultiSteps(every_k_schedule=grad_acc_step)`: the gradients of k
   steps are averaged (optax's running mean, acc + (g - acc) / (n + 1)) and
   the steps in between change nothing;
2. `clip_by_global_norm(grad_clip_thresh)`: over the trainable parameters
   only (the whole chain sits inside `optax.masked`), scaled by
   max_norm / g_norm with no epsilon when g_norm >= max_norm, where torch's
   `clip_grad_norm_` takes max_norm / (g_norm + 1e-6);
3. `scale_by_adam(b1, b2, eps)`: eps outside the square root, both moments
   bias-corrected;
4. `add_decayed_weights(weight_decay)` when it is non-zero (decay added to
   the Adam direction, not AdamW's decoupled product with the rate);
5. the learning rate `lr_schedule(cfg)` at the count of updates applied
   before this one.

Frozen parameters are left out of the optimizer (optax's `set_to_zero` on
the complement mask). Parameters are updated in place. `torch.optim.AdamW`
with `LambdaLR` differs in (2), (4) and the schedule's step, so it is not
used.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from fscl_tpu_torch.core.config import OptimConfig


def lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Learning rate after `step` updates: warmup (sqrt: linear then
    inverse square root; const: linear then flat), times anneal_rate for
    each anneal step passed. Computed in float32 as the JAX schedule is; the
    +1 is inside, so step 0 is the first update's rate."""
    f32 = np.float32
    warmup = cfg.warmup_step
    anneal_steps = np.asarray(cfg.anneal_steps or (0,), dtype=f32)
    has_anneal = bool(cfg.anneal_steps)

    def schedule(step: int) -> float:
        current = f32(step) + f32(1.0)
        if warmup > 0:
            if cfg.scheduler == "sqrt":
                factor = (current / f32(warmup) if current <= warmup
                          else np.sqrt(f32(warmup) / current))
            else:  # const
                factor = min(current / f32(warmup), f32(1.0))
        else:
            factor = f32(1.0)
        if has_anneal:
            n_annealed = int(np.sum(current > anneal_steps))
            factor = f32(factor) * f32(cfg.anneal_rate) ** f32(n_annealed)
        return float(f32(cfg.lr) * f32(factor))

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all entries of `tensors` together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@dataclass
class AdamState:
    """count: updates applied (the schedule's step; optax's inner count,
    which trails the train step under gradient accumulation); mini_step:
    gradients accumulated towards the next update; mu, nu: the moments;
    acc: the running mean of the accumulated gradients (empty when
    grad_acc_step is 1); work: scratch for the bias-corrected first
    moment, so that an update allocates no parameter-sized tensor."""
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    work: List[torch.Tensor]
    acc: List[torch.Tensor] = field(default_factory=list)
    count: int = 0
    mini_step: int = 0


class Adam:
    """optax's chain of `fscl_tpu/train/optim.py:make_optimizer` over
    `params` (the trainable ones)."""

    def __init__(self, cfg: OptimConfig, params: Sequence[torch.Tensor]):
        self.cfg = cfg
        self.params = list(params)
        self.schedule = lr_schedule(cfg)
        # gradients -> their global norm; tensor parallelism puts in one
        # that adds the other ranks' shards (`parallel/tensor_parallel.py`)
        self.grad_norm: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm
        # YAML 1.1 reads `1e-09` as a string (config/train/*.yaml); the
        # loaders keep it as the JAX loader does, and it is a number here
        self.eps = float(cfg.eps)

    def init(self) -> AdamState:
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        return AdamState(mu=zeros(), nu=zeros(), work=zeros(),
                         acc=zeros() if self.cfg.grad_acc_step > 1 else [])

    @torch.no_grad()
    def update(self, state: AdamState, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Take one step's gradients (None for a parameter the loss did not
        reach, counted as zero as JAX counts it); update the parameters in
        place when an update is due. The gradient tensors serve as scratch
        and are overwritten. Issues no host synchronisation: the clip's test
        stays on the device."""
        cfg = self.cfg
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        if cfg.grad_acc_step > 1:
            diff = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(diff, float(state.mini_step + 1))
            torch._foreach_add_(state.acc, diff)
            state.mini_step += 1
            if state.mini_step < cfg.grad_acc_step:
                return
            state.mini_step = 0
            grads = state.acc

        # optax's (g / g_norm) * max_norm; unclipped, a division and a
        # product by 1
        max_norm = float(cfg.grad_clip_thresh)
        g_norm = self.grad_norm(grads)
        keep = g_norm < max_norm
        one = torch.ones_like(g_norm)
        torch._foreach_div_(grads, torch.where(keep, one, g_norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))

        b1, b2 = (float(b) for b in cfg.betas)
        lr = self.schedule(state.count)
        state.count += 1
        f32 = np.float32
        c1 = float(f32(1.0) - f32(b1) ** f32(state.count))
        c2 = float(f32(1.0) - f32(b2) ** f32(state.count))
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        # mu_hat / (sqrt(nu_hat) + eps), with the denominator in the
        # gradients' buffers (done with) and mu_hat in the work buffers
        den = grads
        torch._foreach_copy_(den, state.nu)
        torch._foreach_div_(den, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        direction = state.work
        torch._foreach_copy_(direction, state.mu)
        torch._foreach_div_(direction, c1)
        torch._foreach_div_(direction, den)
        if cfg.weight_decay:
            torch._foreach_add_(direction, self.params, alpha=float(cfg.weight_decay))
        torch._foreach_add_(self.params, direction, alpha=-lr)
        if cfg.grad_acc_step > 1:
            torch._foreach_zero_(state.acc)

