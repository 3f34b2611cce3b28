"""System base: train and eval steps over a `TrainState`
(port of `fscl_tpu/systems/base.py:24-142`).

A System is an `nn.Module` that computes its own loss
(`loss_and_metrics(batch)`, in the module's current mode) and says which
parameters train (`trainable_mask`). `init_state` builds the optimizer over
the trainable parameters; `train_step` and `eval_step` come for free.

Where the JAX state is a pytree that each step replaces, here the module's
parameters, BatchNorm buffers and the optimizer's moments are updated in
place and the same `TrainState` is returned. Dropout draws from the torch
generator of the module's device, which the trainer seeds once: torch cannot
reproduce JAX's `fold_in(rng, step)` draws, so no rng is passed per step.
Non-optimized collections (`TrainState.frozen` in JAX) come with the slices
that have them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from fscl_tpu_torch.core.config import OptimConfig
from fscl_tpu_torch.train.optim import Adam, AdamState


@dataclass
class TrainState:
    step: int               # train steps taken (mini steps included)
    opt_state: AdamState


class System(nn.Module):
    """Base class. Subclasses build their modules in __init__ and implement
    `loss_and_metrics`; `optim_cfg` is the optimizer's configuration."""

    def __init__(self, optim_cfg: Optional[OptimConfig] = None):
        super().__init__()
        self.optim_cfg = optim_cfg if optim_cfg is not None else OptimConfig()
        self._optimizer: Optional[Adam] = None

    # --- to implement -----------------------------------------------------
    def loss_and_metrics(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) on a batch already on the module's device, in the
        module's current mode (train: dropout on, BatchNorm on the batch's
        statistics). Metrics are detached tensors: reading them waits for the
        device, so the caller decides when."""
        raise NotImplementedError

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name -> trains; default: every parameter that requires
        grad trains."""
        return {name: p.requires_grad for name, p in self.named_parameters()}

    # --- provided ----------------------------------------------------------
    def init_state(self) -> TrainState:
        mask = self.trainable_mask()
        params = [p for name, p in self.named_parameters() if mask[name]]
        self._optimizer = Adam(self.optim_cfg, params)
        return TrainState(step=0, opt_state=self._optimizer.init())

    @property
    def optimizer(self) -> Adam:
        if self._optimizer is None:
            raise RuntimeError("call init_state first")
        return self._optimizer

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step in train mode (the module goes back to eval mode after
        it): forward, backward, and the optimizer's update when one is due
        (every grad_acc_step steps)."""
        self.train()
        try:
            loss, metrics = self.loss_and_metrics(batch)
            grads = torch.autograd.grad(loss, self.optimizer.params, allow_unused=True)
        finally:
            self.eval()
        self.optimizer.update(state.opt_state, grads)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        self.eval()
        _, metrics = self.loss_and_metrics(batch)
        return metrics
