"""Offline evaluation drivers (port of `fscl_tpu/eval/drivers.py`, numpy on
the host as there).

Re-provides evaluation/protonet.py:28-217 / baseline.py / linear.py: load a
PR system, run each few-shot task, decode frame logits (argmax-merge or
DPDP), and dump per-task transcription infos
[{gt, pred, gt_segment, pred_segment}, ...] consumable by PER/FER
(eval/metrics.py) and the `fscl_tpu evaluate` CLI. Also the pseudo-label
quality evaluator from compare_unit.py (FER/PER of ssl_units vs. MFA
ground truth).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.eval.dpdp import dpdp_decode, dpdp_segment_to_time, merge_repeats
from fscl_tpu_torch.eval.metrics import fer_over_infos, per_over_infos


def logits_to_transcription(
    logits: np.ndarray,            # (T, C) frame logits
    id2symbol: Dict[int, str],
    fp: float = 0.02,
    lam: float = 0.0,
    use_dpdp: bool = True,
):
    """Frame logits -> (phoneme string, segments). DPDP (default) or
    argmax+merge decoding."""
    if use_dpdp:
        logp = logits - np.max(logits, axis=-1, keepdims=True)
        logp = logp - np.log(np.sum(np.exp(logp), axis=-1, keepdims=True))
        segments, labels = dpdp_decode(logp, lam=lam)
    else:
        ids = np.argmax(logits, axis=-1)
        segments, labels = [], []
        start = 0
        for t in range(1, len(ids) + 1):
            if t == len(ids) or ids[t] != ids[start]:
                segments.append((start, t))
                labels.append(int(ids[start]))
                start = t
    segments, labels = merge_repeats(segments, labels)
    phones = [id2symbol.get(l, str(l)) for l in labels]
    return " ".join(phones), dpdp_segment_to_time(segments, fp)


def evaluate_pr_task(
    predict_logits,                 # callable(sample) -> (T, C) np logits
    samples: Sequence[dict],
    id2symbol: Dict[int, str],
    fp: float = 0.02,
    use_dpdp: bool = True,
    lam: float = 0.0,
) -> List[Dict]:
    """Build the per-task transcription infos the reference dumps
    (evaluation/protonet.py decision loop)."""
    infos = []
    for sample in samples:
        logits = np.asarray(predict_logits(sample))
        pred, pred_segment = logits_to_transcription(
            logits, id2symbol, fp, lam, use_dpdp)
        gt_phones = [id2symbol.get(int(p), str(int(p)))
                     for p, d in zip(sample["phonemes"],
                                     sample["avg_frames"]) if d > 0]
        gt_segment = []
        pos = 0.0
        for p, d in zip(sample["phonemes"], sample["avg_frames"]):
            if d > 0:
                gt_segment.append((pos, pos + d * fp))
                pos += d * fp
        infos.append({
            "gt": " ".join(gt_phones),
            "pred": pred,
            "gt_segment": gt_segment,
            "pred_segment": pred_segment,
        })
    return infos


def dump_task_results(infos: List[Dict], output_dir: str, task_name: str):
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{task_name}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(infos, f, ensure_ascii=False, indent=2)
    return path


def evaluate_pseudo_labels(
    store: FeatureStore,
    unit_name: str,
    queries: Optional[Sequence[dict]] = None,
    fp: float = 0.02,
) -> Dict[str, float]:
    """Pseudo-label quality vs MFA ground truth (compare_unit.py:1-244):
    FER/PER of ssl_units/<unit_name> segmentations against mfa_segment +
    phoneme."""
    unit_store = store.get_ssl_unit_store(unit_name)
    queries = queries if queries is not None else store.load_metadata()
    infos = []
    for q in queries:
        if not (unit_store.phoneme.exists(q) and store.phoneme.exists(q)):
            continue
        infos.append({
            "gt": store.phoneme.read_from_query(q),
            "pred": unit_store.phoneme.read_from_query(q),
            "gt_segment": store.mfa_segment.read_from_query(q),
            "pred_segment": unit_store.segment.read_from_query(q),
        })
    from fscl_tpu_torch.eval.metrics import segmentation_recall_over_infos
    seg = segmentation_recall_over_infos(infos)
    return {
        "per": per_over_infos(infos),
        "fer": fer_over_infos(infos),
        "seg_recall": seg["recall"],
        "seg_precision": seg["precision"],
        "seg_f1": seg["f1"],
        "n": len(infos),
    }


def evaluate_pl_filter(
    store: FeatureStore,
    unit_name: str,
    symbol_ref2unify: Optional[Dict[str, str]] = None,
    symbol_pred2unify: Optional[Dict[str, str]] = None,
    thresholds: Sequence[float] = (0.01, 0.2, 0.9, 0.95),
    queries: Optional[Sequence[dict]] = None,
    fp: float = 0.02,
    matrix: str = "lp_matrix",
) -> Dict[str, object]:
    """Pseudo-label confidence filtering via the label-propagation matrices
    (evaluation/compare_unit.py:38-92): per frame, the
    predicted class is argmax(1 - mat) with confidence max(1 - mat); for
    each threshold count how many frames are activated (confidence >
    threshold) and how many of those match the MFA ground-truth frame
    label, both as fractions of ALL frames — the reference's exact
    accounting (activated/n_frames, matched/n_frames).

    `symbol_*2unify` map reference phonemes / predicted class indices (as
    strings) into one shared inventory. When a map is provided it is
    STRICT, like the reference's `symbol_ref2unify[x1]` indexing: an
    unmapped symbol skips the whole utterance (counted in n_skipped), it
    does not silently compare raw-vs-unified names. Identity when
    omitted."""
    from fscl_tpu_torch.eval.metrics import expand, segment2duration

    unit_store = store.get_ssl_unit_store(unit_name)
    mat_feature = getattr(unit_store, matrix)
    queries = queries if queries is not None else store.load_metadata()

    def _map(m, key):
        return m[key] if m is not None else key

    correct: List[int] = []
    values: List[float] = []
    n_skipped = 0
    for q in queries:
        # IO and shape failures RAISE: a store-wide misconfiguration
        # (wrong unit name, matrix feature never written, length
        # mismatch) must not read as a high n_skipped. Only the strict
        # unify-map KeyError — the reference's intended skip semantics
        # (symbol_ref2unify[x1] on an unmapped symbol) — skips.
        mat = np.asarray(mat_feature.read_from_query(q))
        ref_phoneme = store.phoneme.read_from_query(q).strip().split(" ")
        ref_segment = store.mfa_segment.read_from_query(q)
        ref_seq = expand(ref_phoneme, segment2duration(ref_segment, fp))
        if mat.shape[0] > len(ref_seq):
            raise ValueError(
                f"{matrix} for {q.get('basename', q)} has {mat.shape[0]} "
                f"frames but the MFA reference expands to {len(ref_seq)}")
        pred_seq = np.argmax(1.0 - mat, axis=1)
        pred_value = np.max(1.0 - mat, axis=1)
        try:
            # compute the whole utterance before extending the global
            # accumulators, so a mid-utterance KeyError skips it atomically
            utt_correct = [
                1 if _map(symbol_ref2unify, x1)
                == _map(symbol_pred2unify, str(x2)) else 0
                for x1, x2 in zip(ref_seq, pred_seq)]
        except KeyError:
            n_skipped += 1
            continue
        correct.extend(utt_correct)
        values.extend(pred_value[: len(ref_seq)].tolist())

    n_frames = len(correct)
    correct_arr = np.asarray(correct)
    values_arr = np.asarray(values)
    sweep = []
    for threshold in thresholds:
        active = values_arr > threshold
        activated = int(np.sum(active))
        matched = int(np.sum(correct_arr[active]))
        sweep.append({
            "threshold": float(threshold),
            "activated": activated,
            "matched": matched,
            "activated_rate": activated / n_frames if n_frames else 0.0,
            "accuracy": matched / n_frames if n_frames else 0.0,
        })
    return {"n_frames": n_frames, "n_skipped": n_skipped, "sweep": sweep}
