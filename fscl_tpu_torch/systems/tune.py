"""Few-shot transfer ("tune") flows (port of `fscl_tpu/systems/tune.py`).

The flow a new language goes through:

1. `build_reference_table`: the few-shot split's support wavs stream in
   `SupInfo` batches through the FSCL system's frozen upstream; per-symbol
   sums of segment means accumulate on the device, then one codebook
   attention gives the (n_symbols, d) table, PAD row 0, NaNs zeroed.
2. `tune_init`: that table is transplanted into a `BaselineSystem`'s table
   for the language (`systems/fscl.py:transplant_embedding`, in place).
3. `adapt_on_chip` (and its long-budget forms `adapt_on_chip_chunked` and
   `adapt_on_chip_resident`, and the task-parallel `adapt_many_on_chip`):
   the test-time adaptation loop, SGD or the tune Adam, on a dict of the
   system's trainable parameters, returned adapted with the per-step
   losses, all on the device.
4. `load_adapted` copies them into the system, whose `synthesize_bucketed`
   then speaks the language.

The adaptation loss is the JAX package's `train=False` forward: the system
in eval mode (BatchNorm on its running statistics, no dropout) under
`torch.func.functional_call`, differentiated with respect to every
parameter that requires grad. That includes the GE2E speaker encoder under
`speaker_emb: dvec`, as the JAX loops differentiate the whole param tree
with no trainable mask (ROADMAP Queue 3). One exception to eval mode:
GE2E's LSTM stays in train mode, because cuDNN's RNN backward refuses eval
mode; the LSTM has no dropout, so both modes compute the same function.

Where JAX jits and caches a scan per (symbol_id, optimizer), the port runs
the loops of `systems/maml.py` eagerly: nothing to cache.
`adapt_many_sharded` splits the task axis over the ranks of a mesh's data
axis (`parallel/mesh.py`).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, vmap
from torch.utils._pytree import tree_map

from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.data.batch import Batch, SupInfo
from fscl_tpu_torch.nn.losses import fastspeech2_loss
from fscl_tpu_torch.ops.segment_ops import phoneme_query_sums, queries_from_sums
from fscl_tpu_torch.parallel.mesh import DATA_AXIS, all_gather, shard_batch
from fscl_tpu_torch.systems.base import adaptation_mode
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.systems.fscl import TransEmbSystem, transplant_embedding
from fscl_tpu_torch.systems.maml import (Params, adam_carry, adam_scan_carry,
                                         fast_adaptation_scan, fast_adaptation_scan_adam)

OPTIMIZERS = ("sgd", "adam")


@SYSTEMS.register("fscl-orig-tune", "fscl-tune")
class TransEmbTuneSystem(BaselineSystem):
    """Few-shot transfer (`fscl_tpu/systems/tune.py:35-40`): after
    `tune_init` transplants the generated table, training is ordinary
    supervised FastSpeech2 with every parameter optimized."""


@torch.no_grad()
def build_reference_table(fscl: TransEmbSystem, sup_batches: Iterable[SupInfo]) -> torch.Tensor:
    """The (n_symbols, d) embedding table from all few-shot reference
    utterances, streamed in `SupInfo` batches (numpy or tensors) through
    the frozen upstream on the FSCL system's device."""
    total_sums = total_counts = None
    for sup in sup_batches:
        wavs, wav_lens, avg_frames, phonemes = (torch.as_tensor(x, device=fscl.device)
                                                for x in sup[:4])
        hidden, _ = fscl.extract_ssl(wavs, wav_lens)
        sums, counts = phoneme_query_sums(hidden, avg_frames, phonemes, fscl.n_symbols)
        if total_sums is None:
            total_sums, total_counts = sums, counts
        else:
            total_sums, total_counts = total_sums + sums, total_counts + counts
    table, _ = fscl.codebook(queries_from_sums(total_sums, total_counts))
    table = table[0]
    return torch.nan_to_num(torch.cat((table.new_zeros(1, table.shape[1]), table[1:])))


def tune_init(fscl: TransEmbSystem, baseline: BaselineSystem,
              sup_batches: Iterable[SupInfo], symbol_id: str) -> torch.Tensor:
    """The embedding transplant: the reference table written into the
    baseline's table for `symbol_id`, in place (the JAX package returns new
    params). Returns the table."""
    table = build_reference_table(fscl, sup_batches)
    transplant_embedding(baseline, table.to(baseline.device), symbol_id)
    return table


def _stack(xs, device) -> torch.Tensor:
    """xs stacked on a new leading axis, each zero-padded at the end of its
    axes to the largest shape among them."""
    shape = tuple(max(dims) for dims in zip(*(np.shape(x) for x in xs)))
    if all(isinstance(x, np.ndarray) for x in xs):
        return torch.from_numpy(np.stack([
            np.pad(x, [(0, n - d) for d, n in zip(x.shape, shape)]) for x in xs])).to(device)
    xs = [torch.as_tensor(x, device=device) for x in xs]
    return torch.stack([
        nn.functional.pad(x, [p for d, n in zip(reversed(x.shape), reversed(shape))
                              for p in (0, n - d)]) for x in xs])


def stack_batches(batches: List[Batch], device) -> Batch:
    """Batches (numpy or tensors, a `DvecRefs` speaker included) stacked
    along a new leading step axis, on `device`. Batches of one size from
    different buckets stack: each field is zero-padded to the largest L and
    T among them, a padding that each batch's lengths mask. fscl_tpu's
    `stack_batches` takes equal shapes only and raises on a chunk that
    spans buckets (ROADMAP Queue 3)."""
    sizes = {len(b.src_lens) for b in batches}
    if len(sizes) > 1:
        raise ValueError(f"batches of different sizes {sorted(sizes)} cannot be stacked")
    return tree_map(lambda *xs: _stack(xs, device), *batches)


def stack_tasks(task_batches: List[List[Batch]], device) -> Batch:
    """Per-task batch sequences stacked with leading axes (n_tasks,
    n_steps), padded as `stack_batches` pads."""
    if len({len(b) for b in task_batches}) > 1:
        raise ValueError("every task needs the same number of steps")
    return tree_map(lambda *xs: _stack(xs, device),
                    *[stack_batches(b, device) for b in task_batches])


def adaptable_params(baseline: BaselineSystem) -> Params:
    """The parameters the adaptation moves: every one that requires grad,
    the GE2E encoder's included (the JAX loops apply no trainable mask),
    detached from the module."""
    return {n: p.detach() for n, p in baseline.named_parameters() if p.requires_grad}


@torch.no_grad()
def load_adapted(baseline: BaselineSystem, adapted: Params, task: Optional[int] = None) -> None:
    """Copy adapted parameters (task `task` of `adapt_many_on_chip`'s stacked
    ones) into the system in place, for `synthesize_bucketed`."""
    params = dict(baseline.named_parameters())
    for name, value in adapted.items():
        params[name].copy_(value if task is None else value[task])


def _make_task_loss_fn(baseline: BaselineSystem, symbol_id: Optional[str]):
    """loss(params, batch): the total FastSpeech2 loss of the system's
    forward with `params` in place of its parameters of those names (the
    rest, GE2E's constant `bias_ih` among them, and the buffers stay the
    module's), through table `symbol_id`."""
    var = baseline.model_cfg.variance

    def loss_fn(params: Params, batch: Batch) -> torch.Tensor:
        out = functional_call(baseline, params, (batch,), {"symbol_id": symbol_id})
        return fastspeech2_loss(
            out.mel, out.postnet_mel, out.pitch_prediction, out.energy_prediction,
            out.log_duration_prediction, batch.mels, batch.pitches, batch.energies,
            batch.durations, out.src_valid, out.mel_valid,
            var.pitch_feature, var.energy_feature).total

    return loss_fn


def _scan(optimizer: str):
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer {optimizer!r} not in {OPTIMIZERS}")
    return fast_adaptation_scan_adam if optimizer == "adam" else fast_adaptation_scan


def adapt_on_chip(baseline: BaselineSystem, params: Params, batches: List[Batch],
                  lr: float = 1e-3, symbol_id: Optional[str] = None, optimizer: str = "sgd"):
    """Test-time adaptation over a list of batches, one step each, with no
    wait for the device between steps. Returns (adapted params, per-step
    losses (n_steps,)) on the system's device."""
    scan = _scan(optimizer)
    stacked = stack_batches(batches, baseline.device)
    with adaptation_mode(baseline):
        return scan(_make_task_loss_fn(baseline, symbol_id), params, stacked, lr)


def adapt_on_chip_chunked(baseline: BaselineSystem, params: Params, batch_iter,
                          n_steps: int, chunk: int = 500, lr: float = 1e-3,
                          symbol_id: Optional[str] = None, optimizer: str = "sgd"):
    """`adapt_on_chip` for long budgets: n_steps in ceil(n_steps / chunk)
    runs of `chunk` batches drawn from `batch_iter` one chunk at a time, so
    that only one chunk sits on the device. SGD carries the parameters
    across chunks and Adam its moments and step count too, so the result is
    step-exact with one long run. Returns (adapted params, all per-step
    losses), on the device."""
    scan = _scan(optimizer)
    loss_fn = _make_task_loss_fn(baseline, symbol_id)
    carry = adam_carry(params) if optimizer == "adam" else None
    losses, done = [], 0
    with adaptation_mode(baseline):
        while done < n_steps:
            n = min(chunk, n_steps - done)
            stacked = stack_batches([next(batch_iter) for _ in range(n)], baseline.device)
            if carry is not None:
                carry, chunk_losses = adam_scan_carry(loss_fn, carry, stacked, lr)
            else:
                params, chunk_losses = scan(loss_fn, params, stacked, lr)
            losses.append(chunk_losses)
            done += n
    return (carry[0] if carry is not None else params), torch.cat(losses)


def _gather_rows(tree, i: torch.Tensor):
    """Every leaf of a pytree with a leading K axis, at rows i (B,)."""
    return tree_map(lambda x: x.index_select(0, i), tree)


def resident_indices(K: int, n_steps: int, batch_size: Optional[int] = None,
                     seed: int = 0) -> np.ndarray:
    """(n_steps, B) rows drawn per step without replacement, as the JAX
    package draws them (`tune.py:275-279`), so both draw the same rows."""
    B = min(batch_size or K, K)
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(K, size=B, replace=False)
                     for _ in range(n_steps)]).astype(np.int32)


def adapt_on_chip_resident(baseline: BaselineSystem, params: Params, support: Batch,
                           n_steps: int, batch_size: Optional[int] = None, lr: float = 1e-3,
                           symbol_id: Optional[str] = None, optimizer: str = "sgd",
                           seed: int = 0):
    """Adaptation with the few-shot split resident on the device: the K-row
    support `Batch` is uploaded once, with the (n_steps, B) row indices of
    `resident_indices`, and each step gathers its batch on the device. The
    same math as `adapt_on_chip` over the gathered batches. Returns (adapted
    params, per-step losses)."""
    scan = _scan(optimizer)
    device = baseline.device
    support = tree_map(lambda x: torch.as_tensor(x, device=device), support)
    K = support.texts.shape[0]
    idx = torch.from_numpy(resident_indices(K, n_steps, batch_size, seed)).long()
    if device.type == "cuda":      # a copy from pageable memory would wait for the card
        idx = idx.pin_memory()
    idx = idx.to(device, non_blocking=True)
    loss_fn = _make_task_loss_fn(baseline, symbol_id)

    def idx_loss(p: Params, i: torch.Tensor) -> torch.Tensor:
        return loss_fn(p, _gather_rows(support, i))

    with adaptation_mode(baseline):
        return scan(idx_loss, params, idx, lr)


def adapt_many_on_chip(baseline: BaselineSystem, params: Params,
                       task_batches: List[List[Batch]], lr: float = 1e-3,
                       symbol_id: Optional[str] = None, optimizer: str = "sgd"):
    """N independent few-shot tasks adapted at once: the adaptation loop
    under `torch.func.vmap` over a task axis, each task with its own copy
    of the parameters. The attention Function's vmap rule folds the tasks
    into the kernel's batch (one launch for all of them, at any N B H).
    Returns (adapted params stacked on a leading task axis, losses
    (n_tasks, n_steps))."""
    return _adapt_stacked(baseline, params, stack_tasks(task_batches, baseline.device), lr,
                          symbol_id, optimizer)


def _adapt_stacked(baseline: BaselineSystem, params: Params, stacked: Batch, lr: float,
                   symbol_id: Optional[str], optimizer: str):
    scan = _scan(optimizer)
    loss_fn = _make_task_loss_fn(baseline, symbol_id)
    with adaptation_mode(baseline):
        return vmap(lambda b: scan(loss_fn, params, b, lr))(stacked)


def adapt_many_sharded(baseline: BaselineSystem, params: Params,
                       task_batches: List[List[Batch]], mesh, lr: float = 1e-3,
                       symbol_id: Optional[str] = None):
    """`adapt_many_on_chip` (SGD, as fscl_tpu's) with the task axis split
    over the mesh's data axis: each rank adapts its n_tasks / n_data tasks
    (stacked and padded with all the others, so each task sees what it sees
    in `adapt_many_on_chip`), then the adapted parameters and the losses are
    gathered to every rank. Tasks are independent: nothing else crosses
    ranks. Raises when n_tasks does not divide by the data axis."""
    n_tasks, n_data = len(task_batches), mesh.size(DATA_AXIS)
    if n_tasks % n_data != 0:
        raise ValueError(f"n_tasks={n_tasks} must be divisible by the data axis ({n_data}) "
                         f"so every rank adapts the same number of tasks")
    local = shard_batch(stack_tasks(task_batches, baseline.device), mesh)
    adapted, losses = _adapt_stacked(baseline, params, local, lr, symbol_id, "sgd")
    group = mesh.group(DATA_AXIS)
    return ({k: all_gather(v, group, 0) for k, v in adapted.items()},
            all_gather(losses, group, 0))
