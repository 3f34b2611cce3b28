"""Ragged segmental reductions (port of `fscl_tpu/ops/segment_ops.py:23-131`).

SSL frame features reduce to per-phoneme queries in two scatter-adds over
static shapes, as in the JAX package: frame t belongs to segment
j(t) = searchsorted_right(cumsum durations, t), summed by `index_add`; then
segment means are summed into the symbol table by phoneme id. The JAX
package's conventions are kept exactly:

- NaN frames are zeroed on entry (`nan_to_num`);
- frames at or past `cumsum(durations)[-1]` go to a trash segment L, which
  is dropped;
- a segment's mean divides by max(duration, 1), not by the frames actually
  present, so a segment whose frames fall past T still counts at its full
  duration;
- `phoneme_query_sums` counts every segment with duration > 0, one whose
  frames all fell past T included (it adds a zero mean);
- symbols never observed give zeros; ids outside [0, n_symbols) are dropped,
  as `jax.ops.segment_sum` drops them.
"""
from __future__ import annotations

import torch

from fscl_tpu_torch.ops.bucketize import searchsorted_right
from fscl_tpu_torch.ops.global_reduce import global_sum


def _frame_segments(durations: torch.Tensor, T: int):
    """(segment id of each frame, clipped to [0, L - 1]; True where the
    frame lies before the durations' total). Both (B, T)."""
    L = durations.shape[1]
    csum = durations.cumsum(dim=-1)
    t = torch.arange(T, device=durations.device, dtype=csum.dtype)
    seg_id = searchsorted_right(csum, t[None, :])
    in_range = t[None, :] < csum[:, -1:]
    return seg_id.clamp(0, L - 1), in_range


def _scatter_sum(src: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.ops.segment_sum(src, ids, n)` for ids in [0, n)."""
    out = src.new_zeros((n,) + src.shape[1:])
    return out.index_add(0, ids, src)


def _symbol_ids(ids: torch.Tensor, keep: torch.Tensor, n_symbols: int) -> torch.Tensor:
    """ids where `keep` and in [0, n_symbols), else the trash id n_symbols."""
    keep = keep & (ids >= 0) & (ids < n_symbols)
    return torch.where(keep, ids, n_symbols).reshape(-1)


def segment_mean(
    reprs: torch.Tensor,       # (B, T, ...) frame features
    durations: torch.Tensor,   # (B, L) int frames per segment
) -> torch.Tensor:
    """Per-segment mean, (B, L, ...); zero for empty segments."""
    B, T = reprs.shape[:2]
    L = durations.shape[1]
    durations = durations.long()
    reprs = torch.nan_to_num(reprs)
    seg_id, in_range = _frame_segments(durations, T)
    seg_id = torch.where(in_range, seg_id, L)           # trash segment L
    offset = torch.arange(B, device=reprs.device)[:, None] * (L + 1)
    feat = reprs.shape[2:]
    sums = _scatter_sum(reprs.reshape((B * T,) + feat), (seg_id + offset).reshape(-1),
                        B * (L + 1))
    sums = sums.reshape((B, L + 1) + feat)[:, :L]
    shape = (B, L) + (1,) * len(feat)
    out = sums / durations.clamp(min=1).to(sums.dtype).reshape(shape)
    return torch.where((durations > 0).reshape(shape), out, 0.0)


def phoneme_query_sums(
    reprs: torch.Tensor,        # (B, T, n_layers, D) SSL frame features
    durations: torch.Tensor,    # (B, L) avg_frames
    phonemes: torch.Tensor,     # (B, L) int phoneme ids
    n_symbols: int,
):
    """Per-symbol (sum, count) of segment means: (n_symbols, ...) and
    (n_symbols,) float32. The accumulable form, so that a flow can stream
    batches and combine them with `queries_from_sums`."""
    seg_means = segment_mean(reprs, durations)
    B, L = seg_means.shape[:2]
    present = durations > 0
    ids = _symbol_ids(phonemes.long(), present, n_symbols)
    flat = seg_means.reshape((B * L,) + seg_means.shape[2:])
    sums = _scatter_sum(flat, ids, n_symbols + 1)[:n_symbols]
    counts = _scatter_sum(present.float().reshape(-1), ids, n_symbols + 1)[:n_symbols]
    return sums, counts


def queries_from_sums(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Per-symbol means, zero where a symbol has no segment; (1, n_symbols, ...)."""
    shape = (sums.shape[0],) + (1,) * (sums.dim() - 1)
    out = sums / counts.clamp(min=1.0).reshape(shape)
    return torch.where((counts > 0).reshape(shape), out, 0.0)[None]


def phoneme_query_extract(
    reprs: torch.Tensor,        # (B, T, n_layers, D)
    durations: torch.Tensor,    # (B, L)
    phonemes: torch.Tensor,     # (B, L)
    n_symbols: int,
) -> torch.Tensor:
    """Two-stage phoneme query extraction ("average" mode): per-segment
    mean, then per-symbol mean over the batch's segments. Output
    (1, n_symbols, n_layers, D)."""
    sums, counts = phoneme_query_sums(reprs, durations, phonemes, n_symbols)
    return queries_from_sums(global_sum(sums), global_sum(counts))


def frame_phoneme_query_extract(
    reprs: torch.Tensor,
    durations: torch.Tensor,
    phonemes: torch.Tensor,
    n_symbols: int,
) -> torch.Tensor:
    """Single-stage variant: the class mean over raw frames, a
    duration-weighted mean of each symbol's frames."""
    B, T = reprs.shape[:2]
    reprs = torch.nan_to_num(reprs)
    seg_id, in_range = _frame_segments(durations.long(), T)
    phn = torch.gather(phonemes.long(), 1, seg_id)
    ids = _symbol_ids(phn, in_range, n_symbols)
    flat = reprs.reshape((B * T,) + reprs.shape[2:])
    sums = _scatter_sum(flat, ids, n_symbols + 1)[:n_symbols]
    counts = _scatter_sum(in_range.float().reshape(-1), ids, n_symbols + 1)[:n_symbols]
    return queries_from_sums(global_sum(sums), global_sum(counts))
