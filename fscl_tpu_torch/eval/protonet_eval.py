"""Protonet / TransHead few-shot evaluation (port of
`fscl_tpu/eval/protonet_eval.py`; evaluation/protonet.py:28-217 and the
baseline.py / linear.py harnesses).

Walk the generated few-shot task directories (`<N>-shot/task-<i>/`), build
each task's prototypes (or TransHead classifier) from its whole support split,
transcribe its query split (DPDP or argmax decoding on the host) and dump
per-task transcription JSONs for `evaluate` (PER / FER).

fscl_tpu caches one jitted function per shape; here each chunk is a
`torch.no_grad` forward of the system on its device. The chunking is
fscl_tpu's, so the outputs are the same: queries sorted by wav length, in
chunks of `batch_size`, a short last chunk padded by repeating its first
sample and the padded rows discarded; each utterance's logits cut to its
frame count. Prototype and query sums accumulate on the host in float64, as
fscl_tpu's numpy does.
"""
from __future__ import annotations

import glob
import os
from typing import List

import numpy as np
import torch

from fscl_tpu_torch.core.config import read_data_config
from fscl_tpu_torch.data.batch import to_device
from fscl_tpu_torch.data.datamodules import collate_pr
from fscl_tpu_torch.data.datasets import PRDataset
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.eval.drivers import dump_task_results, evaluate_pr_task
from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS


def _chunked_logits(forward, samples, symbol_id: str, n_symbols: int, batch_size: int):
    """Per-sample (n_frames, C) numpy logits of `forward(PRBatch on device)`
    over length-sorted chunks (the last one padded by repeating its first
    sample)."""
    order = sorted(range(len(samples)), key=lambda i: len(samples[i]["wav"]))
    out = [None] * len(samples)
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        group = [samples[i] for i in idx]
        group += [group[0]] * (batch_size - len(group))
        with torch.no_grad():
            logits = forward(collate_pr(group, symbol_id, n_symbols)).float().cpu().numpy()
        for k, i in enumerate(idx):
            out[i] = logits[k, :int(np.sum(samples[i]["avg_frames"]))]
    return out


def batched_pr_logits(system, samples, symbol_id: str, n_symbols: int,
                      batch_size: int = 8) -> List[np.ndarray]:
    """Frame logits of every sample through `system.logits` (the linear,
    baseline and cluster PR systems), in fscl_tpu's chunks."""
    return _chunked_logits(lambda b: system.logits(to_device(b, system.device)), samples,
                           symbol_id, n_symbols, batch_size)


def _task_data(task_dir: str):
    dc = read_data_config(os.path.join(task_dir, "config.yaml"))
    store = FeatureStore(dc.data_dir)
    id2symbol = {i: s.lstrip("@") for i, s in enumerate(LANG_ID2SYMBOLS[dc.symbol_id])}
    sup_ds = PRDataset(os.path.join(task_dir, "train.txt"), store, dc)
    qry_ds = PRDataset(os.path.join(task_dir, "val.txt"), store, dc)
    return dc, id2symbol, len(LANG_ID2SYMBOLS[dc.symbol_id]), sup_ds, qry_ds


def _support_chunks(sup_ds, batch_size: int, n_symbols: int):
    """(samples, per-symbol frame counts) of the support split in order."""
    for start in range(0, len(sup_ds), batch_size):
        samples = [sup_ds[i] for i in range(start, min(start + batch_size, len(sup_ds)))]
        counts = np.zeros(n_symbols)
        for s in samples:
            for p, d in zip(s["phonemes"], s["avg_frames"]):
                if d > 0:
                    counts[int(p)] += d
        yield samples, counts


def _dump(task_dir, qry_samples, logits, id2symbol, output_dir, use_dpdp, lam) -> str:
    by_id = {id(s): lg for s, lg in zip(qry_samples, logits)}
    infos = evaluate_pr_task(lambda sample: by_id[id(sample)], qry_samples, id2symbol,
                             use_dpdp=use_dpdp, lam=lam)
    return dump_task_results(infos, output_dir, os.path.basename(task_dir))


def run_trans_head_eval(system, task_root: str, output_dir: str, use_dpdp: bool = True,
                        lam: float = 0.0, batch_size: int = 4) -> List[str]:
    """TransHead few-shot transcription over every task dir under
    `task_root` (a `<N>-shot` directory): the classifier generated from the
    task's whole support split (streamed, frame-count-weighted single-stage
    queries), then the query split transcribed. Returns the JSON paths."""
    out_paths = []
    for task_dir in sorted(glob.glob(os.path.join(task_root, "task-*"))):
        dc, id2symbol, n_symbols, sup_ds, qry_ds = _task_data(task_dir)
        q_sums = q_counts = None
        for samples, counts in _support_chunks(sup_ds, batch_size, n_symbols):
            batch = to_device(collate_pr(samples, dc.symbol_id, n_symbols), system.device)
            with torch.no_grad():
                queries = system.support_frame_queries(batch).cpu().numpy()
            w = queries[0] * counts[:, None, None]
            q_sums = w if q_sums is None else q_sums + w
            q_counts = counts if q_counts is None else q_counts + counts
        queries = (q_sums / np.maximum(q_counts, 1.0)[:, None, None])[None]
        with torch.no_grad():
            head, _ = system.head_from_queries(
                torch.as_tensor(queries, dtype=torch.float32, device=system.device))
        qry_samples = [qry_ds[i] for i in range(len(qry_ds))]
        logits = _chunked_logits(
            lambda b: system.head_logits(head, to_device(b, system.device)), qry_samples,
            dc.symbol_id, n_symbols, batch_size)
        out_paths.append(_dump(task_dir, qry_samples, logits, id2symbol, output_dir, use_dpdp,
                               lam))
    return out_paths


def run_protonet_eval(system, task_root: str, output_dir: str, use_dpdp: bool = True,
                      lam: float = 0.0, batch_size: int = 4) -> List[str]:
    """Zero-shot protonet transcription over every task dir under
    `task_root`: prototypes from the task's whole support split (the
    downstream's frame-level class means, frame-count weighted across
    chunks), then the query split classified. Returns the JSON paths."""
    out_paths = []
    for task_dir in sorted(glob.glob(os.path.join(task_root, "task-*"))):
        dc, id2symbol, n_symbols, sup_ds, qry_ds = _task_data(task_dir)
        proto_sums = proto_counts = None
        for samples, counts in _support_chunks(sup_ds, batch_size, n_symbols):
            batch = to_device(collate_pr(samples, dc.symbol_id, n_symbols), system.device)
            with torch.no_grad():
                protos = system.build_prototypes(batch).cpu().numpy()
            w = protos * counts[:, None]
            proto_sums = w if proto_sums is None else proto_sums + w
            proto_counts = counts if proto_counts is None else proto_counts + counts
        protos = torch.as_tensor(proto_sums / np.maximum(proto_counts, 1.0)[:, None],
                                 dtype=torch.float32, device=system.device)
        qry_samples = [qry_ds[i] for i in range(len(qry_ds))]
        logits = _chunked_logits(
            lambda b: system.classify(protos, to_device(b, system.device)), qry_samples,
            dc.symbol_id, n_symbols, batch_size)
        out_paths.append(_dump(task_dir, qry_samples, logits, id2symbol, output_dir, use_dpdp,
                               lam))
    return out_paths
