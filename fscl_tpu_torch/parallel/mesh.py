"""The rank grid and its collectives (port of `fscl_tpu/parallel/mesh.py`).

fscl_tpu runs one process over a `jax.sharding.Mesh` of devices with axes
`data` and `model`; shardings say where each array lives and XLA inserts the
collectives. The port runs one process per rank over `torch.distributed`:
`Mesh` lays the world's ranks out as (n_data, n_model), rank r at
(r // n_model, r % n_model), and holds one process group per axis (this
rank's row and column of the grid) and this rank's device. The collectives
are explicit, written once here for the CPU (gloo) and the card (NCCL, or
gloo where ranks share a card).

`batch_sharding` and `replicated` return JAX sharding objects, which torch
has no counterpart of and no caller of the port needs: `shard_batch` and
`replicate` do their work directly.

Backend rule (`choose_backend`, printed by the launchers): NCCL when the
ranks run on CUDA and every rank on the host has a card of its own; gloo
otherwise (the CPU, or several ranks sharing one card, which NCCL refuses).
torch's backend table lists gloo on CUDA tensors for `broadcast` and
`all_reduce` only, so `all_gather`, `send` and `recv` stage a CUDA tensor
through host memory on gloo (`_staged`); torch 2.11 took `all_gather` of
CUDA tensors on gloo as well (chip_smoke.py phase 18). No collective falls
back to another backend on failure.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from fscl_tpu_torch.ops.global_reduce import reduce_over

DATA_AXIS = "data"
MODEL_AXIS = "model"


def choose_backend(device: torch.device, ranks_on_host: int) -> str:
    """NCCL when each of the host's ranks has a card of its own, else gloo."""
    if device.type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def world() -> tuple:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """(n_data, n_model) over every rank of the process group. `shape` maps
    the axis names to their sizes, as a JAX mesh's does."""

    def __init__(self, n_data: int, n_model: int, device: torch.device):
        rank, size = world()
        if n_data * n_model != size:
            raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, "
                             f"the world has {size}")
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.rank = rank
        self.coords = {DATA_AXIS: rank // n_model, MODEL_AXIS: rank % n_model}
        self.device = torch.device(device)
        self.groups = {DATA_AXIS: None, MODEL_AXIS: None}
        if size == 1:
            return
        # every rank creates every group, in one order (new_group's contract)
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if self.coords[MODEL_AXIS] == m:
                self.groups[DATA_AXIS] = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if self.coords[DATA_AXIS] == d:
                self.groups[MODEL_AXIS] = g

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """A mesh over the world's ranks; n_data defaults to world // n_model.
    Calls `torch.distributed` collectively: every rank makes the same mesh."""
    _, size = world()
    if n_data is None:
        n_data = size // n_model
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    mesh = Mesh(n_data, n_model, device)
    from fscl_tpu_torch.parallel import multihost
    if multihost.stream_shard() is not None:
        # processes that read streams of their own split them over the data
        # axis: a data row's model ranks read the same batches
        multihost.set_stream_shard(n_data, mesh.index(DATA_AXIS))
    return mesh


def _rows(x, n: int, i: int):
    if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim > 0:
        if x.shape[0] % n:
            raise ValueError(f"batch dimension {x.shape[0]} is not divisible by the "
                             f"{n} shards of the data axis")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]
    return x


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """This rank's rows of a global batch (a pytree of arrays or tensors whose
    leaves lead with the batch dimension; other leaves pass through). Raises
    when B is not divisible by the axis, as a JAX batch sharding does."""
    n, i = mesh.size(axis), mesh.index(axis)
    return tree_map(lambda x: _rows(x, n, i), batch)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers, or the tensors of a pytree (returned)."""
    if mesh.shape[DATA_AXIS] * mesh.shape[MODEL_AXIS] == 1:
        return tree
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, torch.nn.Module) else
               [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)])
    for t in tensors:
        dist.broadcast(t.data, src=0)
    return tree


# -- collectives ----------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    """gloo takes CUDA tensors in broadcast and all_reduce only (torch's
    backend table); other collectives on gloo go through a host copy."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in place (no-op without a group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in rank order (JAX's
    `all_gather(..., tiled=True)`)."""
    if group is None:
        return t
    src = t.contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def send(t: torch.Tensor, dst_in_group: int, group) -> None:
    src = t.contiguous()
    dist.send(src.cpu() if _staged(src, group) else src,
              dst=dist.get_global_rank(group, dst_in_group), group=group)


def recv(like: torch.Tensor, src_in_group: int, group) -> torch.Tensor:
    buf = torch.empty_like(like, device="cpu" if _staged(like, group) else like.device)
    dist.recv(buf, src=dist.get_global_rank(group, src_in_group), group=group)
    return buf.to(like.device)


# -- global reductions of the data-parallel step ----------------------------------

def data_parallel(mesh: Optional[Mesh]):
    """Within: `global_sum` sums over the mesh's data axis, so that the
    batch-wide means of the losses, the PostNet's BatchNorm statistics, the
    speaker average and the FSCL table are those of the global batch, as in
    fscl_tpu's sharded step; every rank then holds the global loss
    (`ops/global_reduce.py`)."""
    return reduce_over(mesh.group(DATA_AXIS) if mesh is not None else None)
