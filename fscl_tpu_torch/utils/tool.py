"""Misc utilities (port of `fscl_tpu/utils/tool.py`; numpy only)."""
from __future__ import annotations

import contextlib
import random
from typing import List, Sequence

import numpy as np


@contextlib.contextmanager
def seed_all(seed: int = 43):
    """Deterministic python/numpy RNG scope (the reference's seed_all context
    manager used for task prefetching, FSCLDataModule.py:92-93)."""
    py_state = random.getstate()
    np_state = np.random.get_state()
    random.seed(seed)
    np.random.seed(seed)
    try:
        yield
    finally:
        random.setstate(py_state)
        np.random.set_state(np_state)


def expand(seq: Sequence, durations: Sequence[int]) -> List:
    """Repeat each element by its duration (utils/tool.py expand)."""
    out: List = []
    for x, d in zip(seq, durations):
        if d > 0:
            out.extend([x] * int(d))
    return out


def ssl_match_length(reprs: np.ndarray, target_len: int) -> np.ndarray:
    """Pad/truncate SSL frame features (B, T, ...) to target_len on axis 1
    (utils/tool.py ssl_match_length)."""
    T = reprs.shape[1]
    if T == target_len:
        return reprs
    if T > target_len:
        return reprs[:, :target_len]
    pad = [(0, 0)] * reprs.ndim
    pad[1] = (0, target_len - T)
    return np.pad(reprs, pad)


def pad_1d_list(seqs: Sequence[Sequence], value=0) -> np.ndarray:
    max_len = max(len(s) for s in seqs)
    out = np.full((len(seqs), max_len), value,
                  dtype=np.asarray(seqs[0]).dtype)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out
