"""Duration-penalized dynamic-programming (DPDP) decoding (port of
`fscl_tpu/eval/dpdp.py`, numpy on the host as there).

Jointly segment a frame sequence and label each segment, minimising the
per-frame negative log-probability plus a per-segment penalty `lam` (longer
segments amortise it: a coarser segmentation). DP over (frame, segment
length): O(T * max_len * C) with cumulative sums.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dpdp_decode(
    logprobs: np.ndarray,       # (T, C) log-probabilities (or -distances)
    lam: float = 0.0,           # per-segment penalty
    max_segment_len: int = 50,
) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Returns (segments [(start, end) frame-exclusive], labels)."""
    T, C = logprobs.shape
    cum = np.concatenate([np.zeros((1, C)), np.cumsum(logprobs, axis=0)], axis=0)
    best = np.full(T + 1, np.inf)
    best[0] = 0.0
    back = np.zeros(T + 1, dtype=np.int64)
    label = np.zeros(T + 1, dtype=np.int64)
    for t in range(1, T + 1):
        starts = np.arange(max(0, t - max_segment_len), t)
        seg_scores = cum[t][None, :] - cum[starts]          # (n_starts, C)
        seg_best_c = np.argmax(seg_scores, axis=1)
        seg_best = seg_scores[np.arange(len(starts)), seg_best_c]
        total = best[starts] - seg_best + lam
        k = int(np.argmin(total))
        best[t] = total[k]
        back[t] = starts[k]
        label[t] = seg_best_c[k]

    segments: List[Tuple[int, int]] = []
    labels: List[int] = []
    t = T
    while t > 0:
        s = int(back[t])
        segments.append((s, t))
        labels.append(int(label[t]))
        t = s
    return segments[::-1], labels[::-1]


def dpdp_segment_to_time(segments: List[Tuple[int, int]],
                         fp: float = 0.02) -> List[Tuple[float, float]]:
    return [(s * fp, e * fp) for s, e in segments]


def merge_repeats(segments, labels):
    """Merge adjacent segments with identical labels."""
    if not segments:
        return segments, labels
    out_s, out_l = [segments[0]], [labels[0]]
    for seg, lab in zip(segments[1:], labels[1:]):
        if lab == out_l[-1] and seg[0] == out_s[-1][1]:
            out_s[-1] = (out_s[-1][0], seg[1])
        else:
            out_s.append(seg)
            out_l.append(lab)
    return out_s, out_l
