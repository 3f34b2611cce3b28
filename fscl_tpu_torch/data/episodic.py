"""Episodic meta-task engine (port of `fscl_tpu/data/episodic.py`).

Re-provides the learn2learn-based pipeline (SURVEY §2.4) in plain Python:
- label-grouped K+Q sampling (FusedNWaysKShots, 1-way, FewShotTaskDataset.py
  :13-65) with labels = language (or corpus+speaker),
- the phoneme-coverage-constrained support/query split
  (FSCLCollate.split_sup_qry, FSCLCollate.py:94-126) — greedy: a sample
  whose phoneme set contains a phoneme seen in no other remaining sample is
  forced into the support set,
- deterministic task replay: sampled val/test episode indices persist to
  descriptions.json and reload bit-identically (datamodules/utils.py:12-76),
- infinite weighted resampling for step-based epochs
  (EpisodicInfiniteWrapper, datamodules/utils.py:102-117).

Episodes are numpy, equal to fscl_tpu's, with the support set's own TTS
batch (`with_sup_batch`, the MAML inner loops) or the query set's speech
(`with_qry_wavs`, the SSL-ADA systems) when asked.
"""
from __future__ import annotations

import json
import os
import random
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fscl_tpu_torch.data.batch import (
    TEXT_BUCKETS, SupInfo, bucket_len, collate_batch, pad_1d,
)
from fscl_tpu_torch.systems.fscl import Episode


def split_sup_qry(samples: List[dict], shots: int, queries: int,
                  text_key: str = "phonemes") -> Tuple[List[int], List[int]]:
    """Greedy coverage split; exact semantics of FSCLCollate.py:94-126."""
    n = len(samples)
    if n != shots + queries:
        raise ValueError(f"{n} samples for {shots} shots + {queries} queries")
    phn2idxs = defaultdict(list)
    for idx in range(n):
        for phn in set(int(p) for p in samples[idx][text_key]):
            phn2idxs[phn].append(idx)

    sup_ids: List[int] = []
    qry_ids: List[int] = []
    for idx in range(n):
        if len(qry_ids) < queries:
            phn_set = set(int(p) for p in samples[idx][text_key])
            forced = any(len(phn2idxs[phn]) == 1 for phn in phn_set)
            if forced:
                sup_ids.append(idx)
            else:
                qry_ids.append(idx)
                for phn in phn_set:
                    phn2idxs[phn].remove(idx)
        else:
            sup_ids.append(idx)

    if not (len(sup_ids) == shots and len(qry_ids) == queries):
        ids = sup_ids + qry_ids   # force redistribution (ref fallback)
        sup_ids, qry_ids = ids[:shots], ids[shots:]
    return sup_ids, qry_ids


class EpisodicSampler:
    """Label-grouped episode index sampler with deterministic replay."""

    def __init__(self, labels: Sequence, shots: int, queries: int,
                 seed: int = 43):
        self.shots = shots
        self.queries = queries
        self.label2idxs: Dict = defaultdict(list)
        for i, lab in enumerate(labels):
            self.label2idxs[lab].append(i)
        self.labels = sorted(self.label2idxs, key=str)
        self.rng = random.Random(seed)

    def sample_task(self, label=None) -> List[int]:
        label = label if label is not None else self.rng.choice(self.labels)
        pool = self.label2idxs[label]
        k = self.shots + self.queries
        if len(pool) >= k:
            return self.rng.sample(pool, k)
        return [self.rng.choice(pool) for _ in range(k)]

    def infinite(self) -> Iterator[List[int]]:
        while True:
            yield self.sample_task()

    def fixed_tasks(self, n_tasks_per_label: int) -> List[List[int]]:
        """Fixed val/test tasks (FewShotTaskDataset val/test path)."""
        tasks = []
        for label in self.labels:
            for _ in range(n_tasks_per_label):
                tasks.append(self.sample_task(label))
        return tasks


def write_descriptions(tasks: List[List[int]], path: str) -> None:
    """Persist sampled task indices ({val,test}_descriptions.json replay,
    datamodules/utils.py:38-56)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(tasks, f)


def load_descriptions(path: str) -> Optional[List[List[int]]]:
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def get_or_create_tasks(sampler: EpisodicSampler, n_tasks_per_label: int,
                        path: str) -> List[List[int]]:
    tasks = load_descriptions(path)
    if tasks is None:
        tasks = sampler.fixed_tasks(n_tasks_per_label)
        write_descriptions(tasks, path)
    return tasks


def build_sqids(tasks: List[List[int]], sample_ids: Sequence[str],
                path: Optional[str] = None):
    """SQids2Tid mapping: "<sample ids joined>" -> task id, used to key
    per-task CSV artifacts (datamodules/utils.py:12-76 get_SQids2Tid /
    SQids.json). Persisted for reproducible few-shot eval bookkeeping."""
    sqids = []
    sqids2tid: Dict[str, str] = {}
    for t, idxs in enumerate(tasks):
        ids = [sample_ids[i] for i in idxs]
        sqids.append(ids)
        sqids2tid[",".join(ids)] = f"tid-{t}"
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"SQids": sqids, "SQids2Tid": sqids2tid}, f,
                      ensure_ascii=False, indent=2)
    return sqids2tid


WAV_BUCKETS = (16000 * 4, 16000 * 8, 16000 * 12, 16000 * 16)


def collate_sup_info(samples: List[dict], bucket: bool = True,
                     wav_dtype: str = "float32") -> SupInfo:
    """Support-set raw SSL inputs (FSCLCollate sup_info).

    wav_dtype="int16" ships the support wavs as 16-bit PCM (4x less
    host->device transfer; `frozen_upstream_features` dequantizes on
    device — lossless at bf16 upstream precision). Same wire contract as
    `data/shards.py:collate_episode`."""
    wav_lens = np.array([len(s["raw_feat"]) for s in samples], dtype=np.int32)
    L = max(len(s["phonemes"]) for s in samples)
    T = int(wav_lens.max())
    if bucket:
        L = bucket_len(L, TEXT_BUCKETS)
        T = bucket_len(T, WAV_BUCKETS)
    wavs = pad_1d([s["raw_feat"] for s in samples], T, dtype=np.float32)
    if wav_dtype == "int16":
        wavs = np.clip(np.rint(wavs * 32768.0), -32768, 32767) \
            .astype(np.int16)
    return SupInfo(
        wavs=wavs,
        wav_lens=np.minimum(wav_lens, T),
        avg_frames=pad_1d([s["avg_frames"] for s in samples], L,
                          dtype=np.int32),
        phonemes=pad_1d([s["phonemes"] for s in samples], L, dtype=np.int32),
        n_symbols=samples[0]["n_symbols"],
    )


def collate_episode(samples: List[dict], shots: int, queries: int,
                    bucket: bool = True, with_sup_batch: bool = False,
                    with_qry_wavs: bool = False,
                    var_kw: Optional[dict] = None,
                    wav_dtype: str = "float32"):
    """Episode collate (FSCLCollate._collate_fn): coverage split, then
    Episode(sup_info, qry TTS batch[, sup TTS batch for the MAML inner
    loops with `with_sup_batch`]). `with_qry_wavs` also attaches the query
    set's raw speech, padded to its wav bucket (the SSL-ADA systems), and
    returns an `systems.ada.SSLEpisode`. `var_kw` forwards the variance
    feature levels (pitch_feature/energy_feature) and `dvec_slices` to
    collate_batch; `wav_dtype` the support-wav wire format to
    collate_sup_info (int16 = 4x less upload for bf16 upstreams)."""
    var_kw = var_kw or {}
    sup_ids, qry_ids = split_sup_qry(samples, shots, queries)
    sup = collate_sup_info([samples[i] for i in sup_ids], bucket,
                           wav_dtype=wav_dtype)
    _, qry = collate_batch([samples[i] for i in qry_ids], bucket=bucket,
                           **var_kw)
    sup_batch = None
    if with_sup_batch:
        _, sup_batch = collate_batch([samples[i] for i in sup_ids],
                                     bucket=bucket, **var_kw)
    if with_qry_wavs:
        from fscl_tpu_torch.systems.ada import SSLEpisode
        qry_samples = [samples[i] for i in qry_ids]
        wav_lens = np.array([len(s["raw_feat"]) for s in qry_samples], np.int32)
        T = int(wav_lens.max())
        if bucket:
            T = bucket_len(T, WAV_BUCKETS)
        return SSLEpisode(
            sup=sup, qry=qry, sup_batch=sup_batch,
            qry_wavs=pad_1d([s["raw_feat"] for s in qry_samples], T, dtype=np.float32),
            qry_wav_lens=np.minimum(wav_lens, T))
    return Episode(sup=sup, qry=qry, sup_batch=sup_batch)


class ReIdMapper:
    """Phoneme re-id into concatenated-table space (FSCLCollate re_id /
    T2UCollate.py:38-44): offset per symbol_id in registration order."""

    def __init__(self, id2symbols: Sequence[Tuple[str, int]]):
        self.increment: Dict[str, int] = {}
        total = 0
        for sid, n in id2symbols:
            self.increment[sid] = total
            total += n
        self.n_symbols = total

    def __call__(self, phonemes: np.ndarray, symbol_id: str) -> np.ndarray:
        return phonemes + self.increment[symbol_id]


class InfiniteEpisodes:
    """Step-based infinite episode stream (EpisodicInfiniteWrapper).
    `var_kw` goes to `collate_batch` through `collate_episode`: the CLI
    passes `dvec_slices` for d-vector models, where fscl_tpu passes none and
    its query batches carry speaker ids instead of the reference slices."""

    def __init__(self, dataset, sampler: EpisodicSampler, shots: int,
                 queries: int, bucket: bool = True, var_kw: Optional[dict] = None):
        self.dataset = dataset
        self.sampler = sampler
        self.shots = shots
        self.queries = queries
        self.bucket = bucket
        self.var_kw = var_kw

    def __iter__(self) -> Iterator[Episode]:
        for idxs in self.sampler.infinite():
            samples = [self.dataset[i] for i in idxs]
            yield collate_episode(samples, self.shots, self.queries,
                                  self.bucket, var_kw=self.var_kw)
