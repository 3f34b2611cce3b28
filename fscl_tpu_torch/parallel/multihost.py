"""Multi-process runtime (port of `fscl_tpu/parallel/multihost.py`).

fscl_tpu runs one JAX process per host and forms the global runtime with
`jax.distributed.initialize`. The port runs one process per rank and forms
it with `torch.distributed.init_process_group`. Two ways in:

- `--distributed` (`maybe_initialize`): the processes are started from
  outside, one per rank, and find each other through the FSCL_* environment
  fscl_tpu reads, or through torchrun's (MASTER_ADDR / MASTER_PORT /
  WORLD_SIZE / RANK / LOCAL_RANK), the counterpart of fscl_tpu's TPU-pod
  discovery. Each process reads a batch stream of its own
  (`data.samplers.maybe_distribute`); the global batch is the processes'
  batches together. One process is a strict no-op: nothing is initialised.

      FSCL_COORDINATOR=host0:8476 FSCL_NUM_PROCESSES=2 FSCL_PROCESS_ID=$i \\
          python -m fscl_tpu_torch.cli train ... --distributed
      torchrun --nproc_per_node 4 -m fscl_tpu_torch.cli train ... --distributed

- `--n_devices N` (`launch`): fscl_tpu's one process over N devices. One
  command spawns the ranks on this host (`torch.multiprocessing`, rendezvous
  through a `FileStore`); every rank draws the same batch stream from the
  same seed and keeps its rows of each batch (`mesh.shard_batch`).

Rank r takes `cuda:r` when the host has a card for every rank; ranks that
share a card all take `cuda:0` and talk over gloo (`mesh.choose_backend`).
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist

from fscl_tpu_torch.parallel.mesh import choose_backend, world

# (number of streams, this process's stream) of the batch stream split, set
# when the processes read streams of their own (`maybe_initialize`); None
# when every rank reads the one global stream
_STREAM = None


def stream_shard() -> Optional[tuple]:
    return _STREAM


def set_stream_shard(n: int, index: int) -> None:
    global _STREAM
    _STREAM = (n, index)


def rank_device(local_rank: int, ranks_on_host: int, device_type: str) -> torch.device:
    """This rank's device: its own card when the host has one per rank,
    else the first card (shared), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    if ranks_on_host <= torch.cuda.device_count():
        return torch.device("cuda", local_rank)
    return torch.device("cuda", 0)


def maybe_initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> bool:
    """Initialise the process group if a multi-process run is configured.

    Resolution order: explicit args > FSCL_* env vars > torchrun's env.
    Returns True if a multi-process runtime was started; False for the
    single-process path (nothing touched)."""
    env = os.environ
    coordinator = coordinator or env.get("FSCL_COORDINATOR")
    if num_processes is None and "FSCL_NUM_PROCESSES" in env:
        num_processes = int(env["FSCL_NUM_PROCESSES"])
    if process_id is None and "FSCL_PROCESS_ID" in env:
        process_id = int(env["FSCL_PROCESS_ID"])
    local_rank = process_id
    if coordinator is None and num_processes is None:
        if int(env.get("WORLD_SIZE", "1")) <= 1 or "MASTER_ADDR" not in env:
            return False
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        local_rank = int(env.get("LOCAL_RANK", process_id))
    if num_processes is None or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("a multi-process run needs FSCL_PROCESS_ID (or RANK)")
    ranks_on_host = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    device = rank_device(local_rank, ranks_on_host, device_type)
    backend = choose_backend(device, ranks_on_host)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    set_stream_shard(num_processes, process_id)
    return True


def process_info() -> tuple:
    """(process_id, process_count): (0, 1) when not distributed."""
    return world()


def host_local_batch(local_batch, mesh):
    """This process's batch as its part of the global one. fscl_tpu
    assembles a global array from the processes' local rows; here each rank
    computes on its own rows, so the local batch is kept as it is."""
    del mesh
    return local_batch


def shard_stream(batches: Iterator, mesh) -> Iterator:
    """Per-process batch stream -> this rank's parts of the global batches.
    Pair with `data.samplers.DistributedBatchSampler` (via
    `maybe_distribute`) so each process reads a disjoint subset."""
    for b in batches:
        yield host_local_batch(b, mesh)


# -- one host, N ranks --------------------------------------------------------------

def _rank_main(rank: int, n_ranks: int, workdir: str, device_type: str, fn: Callable, args):
    if device_type == "cpu":
        # N ranks share the host's cores: one thread each
        torch.set_num_threads(1)
    device = rank_device(rank, n_ranks, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(workdir, "store"), n_ranks)
    dist.init_process_group(choose_backend(device, n_ranks), store=store,
                            world_size=n_ranks, rank=rank)
    try:
        out = fn(rank, device, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_ranks: int, *args, device_type: str = "cpu",
           workdir: Optional[str] = None) -> list:
    """Run `fn(rank, device, *args)` on `n_ranks` spawned processes of this
    host, joined in one process group; return each rank's result (saved with
    `torch.save`), in rank order. `fn` must be importable by its module name
    and its module must not import JAX. A rank that raises makes this raise."""
    import torch.multiprocessing as mp

    workdir = workdir or tempfile.mkdtemp(prefix="fscl_ranks_")
    os.makedirs(workdir, exist_ok=True)
    for name in ["store"] + [f"rank{r}.pt" for r in range(n_ranks)]:
        if os.path.exists(os.path.join(workdir, name)):   # a FileStore must start empty
            os.remove(os.path.join(workdir, name))
    env_threads = os.environ.get("OMP_NUM_THREADS")
    if device_type == "cpu":
        os.environ["OMP_NUM_THREADS"] = "1"
    try:
        mp.spawn(_rank_main, args=(n_ranks, workdir, device_type, fn, args),
                 nprocs=n_ranks, join=True)
    finally:
        if device_type == "cpu":
            if env_threads is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = env_threads
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(n_ranks)]
