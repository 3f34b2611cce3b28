"""Host training loop, on one device or a mesh of ranks (port of
`fscl_tpu/train/trainer.py`).

`Trainer.fit` keeps the JAX loop's step-based cadence: metrics to `on_log`
every log_step steps (and once at the end when the last step is not on
one), validation every val_step, `on_save` every save_step. Batches are
copied to the device by `prefetch_batches` on a background thread,
`TrainConfig.prefetch` batches ahead of the step. `steps_per_dispatch` k
runs k single steps, the same math as the JAX package's scan of k steps,
and keeps its check that the cadences are multiples of k.

Data parallelism (`make_parallel_train_step`, `:23-40`): each rank runs the
step on its rows of the global batch under `parallel.mesh.data_parallel`,
so that every batch-wide mean and the PostNet's BatchNorm statistics are
the global batch's and every rank holds the global loss; the gradients are
then averaged over the data axis (one all-reduce of them all) and each rank
applies the same update. That is fscl_tpu's sharded jit: the single-device
step on the global batch. With a mesh, `Trainer` places each rank's rows
(`place_batch`, or the process's whole batch when it reads a stream of
its own), and only rank 0 logs, validates through
its callbacks and saves.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from fscl_tpu_torch.core.config import TrainConfig
from fscl_tpu_torch.data.batch import to_device
from fscl_tpu_torch.obs.profiling import PhaseTimer
from fscl_tpu_torch.parallel import multihost
from fscl_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, data_parallel, shard_batch
from fscl_tpu_torch.systems.base import System, TrainState
from fscl_tpu_torch.train.optim import lr_schedule


def place_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch, on its device."""
    return to_device(shard_batch(batch, mesh), mesh.device)


def reduce_gradients(grads, params, mesh: Mesh) -> list:
    """The gradients averaged over the data axis, in one all-reduce of them
    all (None, a parameter the loss did not reach, counts as zero)."""
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    group = mesh.group(DATA_AXIS)
    if group is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    flat /= mesh.size(DATA_AXIS)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


def make_parallel_train_step(system: System, mesh: Mesh) -> Callable:
    """(state, this rank's rows) -> (state, metrics of the global batch):
    the step fscl_tpu jits with the batch sharded over `data`."""
    def step(state: TrainState, batch):
        with data_parallel(mesh):
            grads, metrics = system.grads_and_metrics(batch)
        system.optimizer.update(state.opt_state,
                                reduce_gradients(grads, system.optimizer.params, mesh))
        state.step += 1
        return state, metrics
    return step


def make_parallel_eval_step(system: System, mesh: Mesh) -> Callable:
    def step(state: TrainState, batch):
        with data_parallel(mesh):
            return system.eval_step(state, batch)
    return step


def make_multi_train_step(system: System, k: int, mesh: Optional[Mesh] = None) -> Callable:
    """(state, k batches) -> (state, the last step's metrics): k steps per
    call, each the single (or, with a mesh, the data-parallel) step; the
    port runs them one after another where fscl_tpu scans them in one
    program."""
    step = make_parallel_train_step(system, mesh) if mesh is not None else system.train_step

    def multi(state: TrainState, batches):
        if len(batches) != k:
            raise ValueError(f"expected {k} batches, got {len(batches)}")
        metrics = None
        for b in batches:
            state, metrics = step(state, b)
        return state, metrics
    return multi


def stack_batches(batches):
    """Identically-shaped batches (NamedTuples of numpy arrays) stacked on a
    new leading axis (fscl_tpu's `stack_batches`, the scan axis of its
    `make_multi_train_step`; the port's takes the list itself). None fields
    stay None."""
    return tree_map(lambda *xs: None if xs[0] is None else np.stack(xs), *batches)


def prefetch_batches(iterator: Iterable, size: int = 2,
                     place: Optional[Callable] = None):
    """Yield the items of `iterator`, each passed through `place`, prepared
    by a background thread up to `size` items ahead. An exception in the
    producer re-raises at the consumer's next pull. Closing the generator
    stops the producer and waits for it to let go of `iterator` (the items
    it prepared ahead are dropped), so that the next `fit` can pull from the
    same iterator."""
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in iterator:
                if not put(place(b) if place is not None else b):
                    return
            put(end)
        except Exception as e:  # handed to the training loop
            put(e)

    producer = threading.Thread(target=worker, daemon=True)
    producer.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        producer.join()


class Trainer:
    """Step-based host loop (log/val/save cadence from TrainConfig)."""

    def __init__(self, system: System, train_cfg: TrainConfig,
                 callbacks: Iterable = (), profile: bool = False,
                 mesh: Optional[Mesh] = None):
        """`profile=True` accumulates per-phase wall times, each train step
        ended by a synchronize of the device; `trainer.timer.report()`.
        With `mesh`, the data-parallel step (over a system
        `tensor_parallel.shard_state` has sharded, the tensor-parallel one)
        on each rank's part of every batch; the callbacks run on rank 0
        only."""
        self.system = system
        self.cfg = train_cfg
        self.mesh = mesh
        self._train_step = self._eval_step = None
        if mesh is not None:
            self._train_step = make_parallel_train_step(system, mesh)
            self._eval_step = make_parallel_eval_step(system, mesh)
        lead = mesh is None or mesh.rank == 0
        self.callbacks = list(callbacks) if lead else []
        self.profile = profile
        self.timer = PhaseTimer()
        self._seeded = False

    def fit(
        self,
        state: TrainState,
        train_iter: Iterable,
        val_loader: Optional[Callable[[], Iterable]] = None,
        max_steps: Optional[int] = None,
    ) -> TrainState:
        """Train on numpy `Batch`es from `train_iter` until `max_steps`
        (default `total_step`) steps have been taken in all; returns the
        state, updated in place."""
        max_steps = max_steps or self.cfg.total_step
        anchor = next(self.system.parameters())
        device = anchor.device
        if not self._seeded:     # the generator dropout on `device` draws from
            if device.type == "cuda":
                torch.cuda.manual_seed(self.cfg.seed)
            else:
                torch.manual_seed(self.cfg.seed)
            self._seeded = True

        step = state.step
        k = self.cfg.steps_per_dispatch
        if k > 1:
            for name in ("log_step", "val_step", "synth_step", "save_step"):
                cadence = getattr(self.cfg, name, 10 ** 9)
                if not (cadence % k == 0 or cadence >= 10 ** 9):
                    raise ValueError(
                        f"steps_per_dispatch={k} requires {name}={cadence} "
                        f"to be a multiple of k (cadence fires at dispatch "
                        f"boundaries)")

        def place(batch):
            # a process that reads a stream of its own keeps its whole batch
            if self.mesh is None or multihost.stream_shard() is not None:
                return to_device(batch, device)
            return place_batch(batch, self.mesh)

        prefetch = self.cfg.prefetch
        batches = (prefetch_batches(train_iter, size=prefetch, place=place)
                   if prefetch > 0 else iter(train_iter))
        phase = (self.timer.phase if self.profile
                 else lambda name, block_on=None: contextlib.nullcontext())
        metrics = None
        t_log = time.time()
        try:
            for batch in batches:
                if step >= max_steps:
                    break
                with phase("place_batch"):
                    if prefetch == 0:
                        batch = place(batch)
                with phase("train_step", block_on=anchor):
                    state, metrics = (self._train_step or self.system.train_step)(state, batch)
                step += 1

                if step % self.cfg.log_step == 0:
                    now = time.time()
                    self._log(step, metrics, self.cfg.log_step, now - t_log)
                    t_log = now

                if val_loader is not None and step % self.cfg.val_step == 0:
                    self._validate(state, step, val_loader, place)

                if step % self.cfg.save_step == 0:
                    for cb in self.callbacks:
                        cb.on_save(step, state)
        finally:
            if hasattr(batches, "close"):
                batches.close()
        # the final step's metrics, so that runs shorter than log_step
        # still give a loss line
        if step % self.cfg.log_step != 0 and metrics is not None:
            self._log(step, metrics, step % self.cfg.log_step, time.time() - t_log)
        return state

    def _log(self, step: int, metrics, steps: int, seconds: float) -> None:
        """Read the step's metrics (a wait for the device) and hand them,
        with the learning rate at `step`, to every `on_log`."""
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["lr"] = lr_schedule(self.system.optim_cfg)(step)
        for cb in self.callbacks:
            cb.on_log(step, metrics, steps_per_sec=steps / max(seconds, 1e-9))

    def _validate(self, state: TrainState, step: int, val_loader, place) -> None:
        agg: Dict[str, list] = {}
        first_vb = None
        for vb in val_loader():
            if first_vb is None:
                first_vb = vb
            m = (self._eval_step or self.system.eval_step)(state, place(vb))
            for k, v in m.items():
                agg.setdefault(k, []).append(float(v))
        val_metrics = {k: float(np.mean(v)) for k, v in agg.items()}
        for cb in self.callbacks:
            cb.on_validation(step, val_metrics)
            # synth-artifact savers (baseline_saver synth_step path)
            hook = getattr(cb, "on_validation_sample", None)
            if hook is not None and first_vb is not None:
                hook(step, state, first_vb)
