"""Checkpointing with surgery: partial restore, key remap, submodule strip
(port of `fscl_tpu/core/checkpoint.py`).

The semantics are fscl_tpu's (SURVEY §5):
- frozen submodules stripped on save (`upstream.*` for the FSCL systems, so
  the frozen HuBERT is not saved; TransEmbOrig.py:156-166),
- a shape-tolerant load that drops unknown keys and keeps the fresh init of
  keys whose shape changed (system.py:100-129), with regex key remap,
- warm start (`full=False`: parameters only, the step and the optimizer's
  moments stay fresh) and resume (`full=True`: the step, the moments and the
  buffers too, so the schedule and the Adam trajectory continue exactly),
- `max_to_keep`.

fscl_tpu writes orbax trees, which cannot be read without JAX, so the format
is the port's own: one `step_%08d/` directory per save holding `state.pt`, a
`torch.save` of plain CPU tensors that loads with `weights_only=True`:

    {"step": int,
     "params": {state_dict name: tensor},      # the reference torch names
     "buffers": {state_dict name: tensor},     # e.g. the PostNet's BatchNorm
     "opt_state": {"count": int, "mini_step": int,
                   "mu": {name: tensor}, "nu": {name: tensor},
                   "acc": {name: tensor}}}     # train/optim.py:AdamState

The trees here are flat dicts of dotted names where fscl_tpu's are nested
dicts of the same paths. Restore copies into the system's own tensors, on
its device.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Iterable, List, Optional

import torch
from torch import nn

from fscl_tpu_torch.systems.base import TrainState

STATE_FILE = "state.pt"
Flat = Dict[str, Any]


def strip_submodules(params: Flat, prefixes: Iterable[str]) -> Flat:
    """Remove entries whose dotted name starts with any prefix (the
    on_save_checkpoint upstream-stripping semantics)."""
    prefixes = tuple(prefixes)
    return {k: v for k, v in params.items() if not k.startswith(prefixes)}


def remap_keys(params: Flat, rules: Dict[str, str]) -> Flat:
    """Rename dotted names by regex rules {pattern: replacement}, applied in
    order (legacy-checkpoint key remap, TransEmbOrig.py:168-213)."""
    out = {}
    for k, v in params.items():
        for pat, repl in rules.items():
            k = re.sub(pat, repl, k)
        out[k] = v
    return out


def merge_shape_tolerant(target: Flat, restored: Flat, verbose: bool = True) -> Flat:
    """`target` with the restored values where the name exists in it AND the
    shape matches; target's (fresh init) values elsewhere (the reference's
    shape-tolerant on_load_checkpoint, system.py:100-129)."""
    merged = dict(target)
    for k, v in restored.items():
        if k not in target:
            if verbose:
                print(f"[ckpt] dropped unknown key: {k}")
            continue
        tv = target[k]
        if hasattr(tv, "shape") and hasattr(v, "shape") and tuple(tv.shape) != tuple(v.shape):
            if verbose:
                print(f"[ckpt] shape mismatch at {k}: {tuple(v.shape)} -> keeping init "
                      f"{tuple(tv.shape)}")
            continue
        merged[k] = v
    return merged


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: t.detach().cpu() for k, t in tensors.items()}


def optimizer_names(system: nn.Module) -> List[str]:
    """The state_dict names of the parameters the system's optimizer
    updates, in its order (the order of `AdamState`'s lists)."""
    names = {id(p): n for n, p in system.named_parameters()}
    return [names[id(p)] for p in system.optimizer.params]


class CheckpointManager:
    """Save and restore of a system and its `TrainState` under `directory`,
    with optional strip prefixes (ModelCheckpoint every_n_train_steps +
    on_save_checkpoint surgery)."""

    def __init__(self, directory: str, strip_prefixes: Iterable[str] = (),
                 max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.strip_prefixes = tuple(strip_prefixes)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, system: nn.Module, state: TrainState) -> str:
        """Write `step_<step>/state.pt` (replacing one of the same step) and
        drop the oldest beyond `max_to_keep`. Returns the directory."""
        names = optimizer_names(system)
        opt = state.opt_state
        tree = {
            "step": int(state.step),
            "params": strip_submodules(_cpu(dict(system.named_parameters())),
                                       self.strip_prefixes),
            "buffers": strip_submodules(_cpu(dict(system.named_buffers())),
                                        self.strip_prefixes),
            "opt_state": {
                "count": int(opt.count), "mini_step": int(opt.mini_step),
                "mu": _cpu(dict(zip(names, opt.mu))), "nu": _cpu(dict(zip(names, opt.nu))),
                "acc": _cpu(dict(zip(names, opt.acc)))},
        }
        path = self._path(step)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        self._gc()
        return path

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved tree of `step` (default: the latest), on the CPU."""
        if step is None:
            steps = self.all_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
            step = steps[-1]
        return torch.load(os.path.join(self._path(step), STATE_FILE), map_location="cpu",
                          weights_only=True)

    @torch.no_grad()
    def restore_into(self, system: nn.Module, state: Optional[TrainState] = None,
                     step: Optional[int] = None, remap: Optional[Dict[str, str]] = None,
                     full: bool = False) -> Optional[TrainState]:
        """Shape-tolerant restore into a live system, in place: stripped or
        missing parameters keep their fresh init.

        `full=False` (warm start, the reference's
        `load_from_checkpoint(pretrain_ckpt)`, main.py:186-192): parameters
        only; `state` (None for a system without an optimizer) is returned as
        it is (its step, fresh moments), and the buffers keep their init.
        `full=True` (resume, main.py:104-110): also
        the step, the buffers and the optimizer's state, so that the
        learning-rate schedule and the Adam trajectory continue where they
        stopped. A saved optimizer state or set of buffers whose names or
        shapes do not match the live ones (another model or optimizer)
        leaves that part fresh."""
        restored = self.restore(step)
        params = restored["params"]
        if remap:
            params = remap_keys(params, remap)
        live = dict(system.named_parameters())
        for k, v in merge_shape_tolerant(live, params).items():
            if v is not live[k]:
                live[k].copy_(v)
        if not full:
            return state
        if state is None:
            raise ValueError("a full restore needs the TrainState to restore into")
        state.step = int(restored["step"])
        buffers = strip_submodules(dict(system.named_buffers()), self.strip_prefixes)
        if _same_layout(buffers, restored["buffers"]):
            for k, b in buffers.items():
                b.copy_(restored["buffers"][k])
        saved = restored["opt_state"]
        names = optimizer_names(system)
        mu = remap_keys(saved["mu"], remap) if remap else saved["mu"]
        opt = state.opt_state
        if list(mu) == names and _same_layout(dict(zip(names, opt.mu)), mu) \
                and len(saved["acc"]) == len(opt.acc):
            nu = remap_keys(saved["nu"], remap) if remap else saved["nu"]
            acc = remap_keys(saved["acc"], remap) if remap else saved["acc"]
            for live_list, got in ((opt.mu, mu), (opt.nu, nu), (opt.acc, acc)):
                for t, n in zip(live_list, names):
                    t.copy_(got[n])
            opt.count, opt.mini_step = int(saved["count"]), int(saved["mini_step"])
        return state

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.match(r"step_(\d+)$", name)
            if m and os.path.isfile(os.path.join(self.directory, name, STATE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _gc(self) -> None:
        if self.max_to_keep is None:
            return
        for s in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)


def _same_layout(live: Dict[str, torch.Tensor], saved: Dict[str, torch.Tensor]) -> bool:
    return set(live) == set(saved) and all(
        tuple(live[k].shape) == tuple(saved[k].shape) for k in live)
