"""PER / FER metrics (port of `fscl_tpu/eval/metrics.py`, numpy on the host as
there; evaluation/fs_error_rate.py:10-53 equivalents).

PER = word-error-rate over space-separated phoneme strings (the reference
uses jiwer.wer; here a dependency-free Levenshtein on token lists).
FER = frame error at 20 ms: expand phoneme sequences by their segment
durations, truncate/pad the prediction to the reference length, compare
framewise.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def levenshtein(ref: Sequence, hyp: Sequence) -> int:
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def wer(ref: str, hyp: str) -> float:
    """Token error rate over whitespace-split strings (jiwer.wer semantics)."""
    ref_t = ref.split()
    hyp_t = hyp.split()
    if not ref_t:
        return 0.0 if not hyp_t else 1.0
    return levenshtein(ref_t, hyp_t) / len(ref_t)


def segment2duration(segment, fp: float) -> List[int]:
    res = []
    for s, e in segment:
        res.append(int(round(round(e / fp, 4)) - round(round(s / fp, 4))))
    return res


def expand(seq: Sequence, dur: Sequence[int]) -> List:
    out: List = []
    for x, d in zip(seq, dur):
        if d > 0:
            out.extend([x] * d)
    return out


def frame_error_rate(
    gt: str, pred: str,
    gt_segment, pred_segment,
    fp: float = 0.02,
) -> float:
    """Single-utterance FER (fs_error_rate.py:11-36)."""
    ref_phoneme = gt.strip().split(" ")
    pred_phoneme = pred.strip().split(" ")
    ref_seq = expand(ref_phoneme, segment2duration(gt_segment, fp))
    pred_seq = expand(pred_phoneme, segment2duration(pred_segment, fp))
    if not ref_seq:
        return 0.0
    if len(pred_seq) >= len(ref_seq):
        pred_seq = pred_seq[: len(ref_seq)]
    else:
        pred_seq = pred_seq + [pred_seq[-1] if pred_seq else ""] * (
            len(ref_seq) - len(pred_seq))
    correct = sum(1 for a, b in zip(ref_seq, pred_seq) if a == b)
    return 1.0 - correct / len(ref_seq)


def fer_over_infos(infos: List[Dict]) -> float:
    """Mean FER over a task's utterance infos (each with gt/pred/
    gt_segment/pred_segment keys, the reference's task-json layout)."""
    errs = [
        frame_error_rate(i["gt"], i["pred"], i["gt_segment"],
                         i["pred_segment"])
        for i in infos
    ]
    return float(np.mean(errs)) if errs else 0.0


def per_over_infos(infos: List[Dict]) -> float:
    errs = [wer(i["gt"], i["pred"]) for i in infos]
    return float(np.mean(errs)) if errs else 0.0


def mel_cepstral_distortion(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """MCD over log-mel frames (BASELINE.md quality-parity metric):
    mean_t sqrt(2 * sum_d (a-b)^2) * 10/ln(10)."""
    n = min(len(mel_a), len(mel_b))
    diff = np.asarray(mel_a[:n], np.float64) - np.asarray(mel_b[:n], np.float64)
    return float(np.mean(np.sqrt(2.0 * np.sum(diff ** 2, axis=-1)))
                 * 10.0 / np.log(10.0))


def segmentation_boundary_metrics(
    gt_segments, pred_segments, tolerance: float = 0.02,
):
    """Boundary precision/recall/F1 at +-tolerance seconds
    (compare_unit.py:109-119 seg_evaluator role — the reference reports
    recall of its SegmentationEvaluator over mfa_segment vs ssl_units
    segment). A ground-truth boundary counts as recalled if a predicted
    boundary lies within the tolerance; each predicted boundary can match
    at most one reference boundary (each reference boundary greedily
    takes its nearest unused prediction)."""
    gt = sorted({round(float(t), 6) for seg in gt_segments for t in seg})
    pred = sorted({round(float(t), 6) for seg in pred_segments for t in seg})
    matched = 0
    used = [False] * len(pred)
    for t in gt:
        best, best_d = -1, tolerance + 1e-9
        for k in range(len(pred)):
            if used[k]:
                continue
            d = abs(pred[k] - t)
            if d < best_d:
                best, best_d = k, d
        if best >= 0 and best_d <= tolerance:
            used[best] = True
            matched += 1
    recall = matched / len(gt) if gt else 0.0
    precision = matched / len(pred) if pred else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {"recall": recall, "precision": precision, "f1": f1,
            "n_gt": len(gt), "n_pred": len(pred), "matched": matched}


def segmentation_recall_over_infos(infos, tolerance: float = 0.02) -> dict:
    """Aggregate boundary metrics over {gt_segment, pred_segment} infos
    (micro-averaged over all boundaries)."""
    tot_gt = tot_pred = tot_match = 0
    for info in infos:
        m = segmentation_boundary_metrics(
            info["gt_segment"], info["pred_segment"], tolerance)
        tot_gt += m["n_gt"]
        tot_pred += m["n_pred"]
        tot_match += m["matched"]
    recall = tot_match / tot_gt if tot_gt else 0.0
    precision = tot_match / tot_pred if tot_pred else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {"recall": recall, "precision": precision, "f1": f1}
