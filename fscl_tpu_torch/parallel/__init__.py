"""Parallel layer: the rank mesh and its collectives, the multi-process
runtime, data-parallel serving, tensor parallelism, and the pipeline- and
sequence-parallel frozen upstream (port of `fscl_tpu/parallel/`)."""
from fscl_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, replicate, shard_batch,
)
