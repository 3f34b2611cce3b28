"""Pipeline-parallel frozen SSL upstream (port of `fscl_tpu/parallel/pipeline.py`).

The frozen upstream's forward is the dominant work of FSCL meta-training.
Here its identical transformer layers are split into S contiguous stages over
the mesh's model axis, and microbatches stream through the stages (the GPipe
forward): stage s runs microbatch m once stage s - 1 has handed it over, so
M microbatches take M + S - 1 stage times, with one (Bm, T', D) handoff
(`send` / `recv`) per microbatch and stage boundary. fscl_tpu writes the
same schedule as one `lax.scan` over the M + S - 1 ticks of a `shard_map`
program; each rank here simply loops over its microbatches and blocks on
its neighbour. Frozen, so forward only: no backward schedule, no bubble
bookkeeping. A rank uses only its stage's layers (`convert.stage_state_dict`
cuts a state dict to them); the pre-transformer part (conv extractor,
projection, positional conv) is cheap and runs on every rank. The stages'
hidden states are gathered to every rank, in f32 as in fscl_tpu.
"""
from __future__ import annotations

from typing import Optional

import torch

from fscl_tpu_torch.models.hubert import dequant_and_cast_inputs, pre_transformer_features
from fscl_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_gather, recv, send


@torch.no_grad()
def pipeline_upstream_features(upstream, wavs: torch.Tensor, wav_valid: Optional[torch.Tensor],
                               mesh: Mesh, axis: str = MODEL_AXIS,
                               n_micro: Optional[int] = None):
    """Drop-in parallel of `models.hubert.frozen_upstream_features`: the same
    (hidden (B, T', n_layers + 1, D) f32, frame_valid (B, T')) on every rank
    of the axis, with the layer stack pipelined over `mesh[axis]`.
    Requires `upstream.n_layers % S == 0` and `B % n_micro == 0` (n_micro
    defaults to S)."""
    S, s = mesh.size(axis), mesh.index(axis)
    group = mesh.group(axis)
    if upstream.n_layers % S != 0:
        raise ValueError(f"n_layers={upstream.n_layers} not divisible by {S} pipeline stages")
    dtype = next(upstream.parameters()).dtype
    x, frame_valid = pre_transformer_features(
        upstream, dequant_and_cast_inputs(wavs, dtype), wav_valid)
    B, T, D = x.shape
    M = n_micro or S
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    Bm = B // M
    l_loc = upstream.n_layers // S
    layers = upstream.encoder.layers[s * l_loc:(s + 1) * l_loc]
    outputs = x.new_empty(B, T, l_loc, D)
    for m in range(M):
        rows = slice(m * Bm, (m + 1) * Bm)
        h = x[rows] if s == 0 else recv(x[rows], s - 1, group)
        for j, layer in enumerate(layers):
            h = layer(h, frame_valid[rows])
            outputs[rows, :, j] = h
        if s < S - 1:
            send(h, s + 1, group)
    ys = all_gather(outputs.float(), group, dim=2)          # (B, T', n_layers, D)
    return torch.cat([x.float()[:, :, None], ys], dim=2), frame_valid


def attach_parallel_upstream(system, mode: str, mesh: Mesh, axis: str = MODEL_AXIS,
                             n_micro: Optional[int] = None):
    """Install a parallel schedule for a system's frozen-upstream forward.
    Every SSL system's `extract_ssl` dispatches through the optional
    `system.upstream_forward` hook (`systems/fscl.py:FrozenUpstream`,
    falling back to `frozen_upstream_features`); this binds it to the
    pipeline- ("pp") or sequence-parallel ("sp") schedule over `mesh[axis]`,
    so that the training steps run their dominant work sharded with no
    change to their code. "none" removes the hook."""
    if mode == "none":
        system.upstream_forward = None
        return system
    if mode == "pp":
        def fwd(upstream, wavs, valid):
            return pipeline_upstream_features(upstream, wavs, valid, mesh, axis=axis,
                                              n_micro=n_micro)
    elif mode == "sp":
        from fscl_tpu_torch.parallel.sequence_parallel import (
            sequence_parallel_upstream_features)

        def fwd(upstream, wavs, valid):
            return sequence_parallel_upstream_features(upstream, wavs, valid, mesh, axis=axis)
    else:
        raise ValueError(f"unknown upstream parallel mode: {mode!r}")
    system.upstream_forward = fwd
    return system
