"""Datamodules: algorithm type -> train/val iterator factories (port of
`fscl_tpu/data/datamodules.py`).

Re-provides lightning/datamodules/ (§2.4): each datamodule owns its
datasets, samplers and collates and exposes `setup()`, `train_batches()`
(infinite iterator) and `val_batches()` (fixed list, deterministic replay
for episodic modules). Registered in DATAMODULES keyed by the same
algorithm types as the systems (lightning/datamodules/__init__.py:6-50).

Batches and episodes are numpy, equal to fscl_tpu's; the trainer copies them
to the card. With `native_io=True` (the default, as fscl_tpu's) the readers
of `data/native_loader.py` and `data/shards.py` go through the host C++ of
`cpp/` (built with g++ at first use, or the read raises): the supervised
loader prefers a fresh packed `<train.txt>.shard` beside the split, else
reads a single corpus with `NativeCollate`; the PR and T2U episodic loaders
read a fresh `<train.txt>.fscl.shard`. `native_io=False` asks for numpy: the
Python collate path, or the shard's numpy reader for the episodic loaders.
The PR family's loaders (`PRDataModule`, `PREpisodicDataModule`) and
ContiAE's (`ContiAEDataModule`) are here. The T2U family's are `T2UDataModule` here
and the four of `data/mix_datamodules.py`, which this module imports so that
every registered key resolves.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from fscl_tpu_torch.core.config import DataConfig, ModelConfig, TrainConfig
from fscl_tpu_torch.core.registry import DATAMODULES
from fscl_tpu_torch.data.batch import TEXT_BUCKETS, Batch, bucket_len, collate_batch, pad_1d
from fscl_tpu_torch.data.datasets import (
    ConcatDataset, ContiAEDataset, FSCLDataset, FastSpeech2Dataset, PRDataset, UnitDataset,
    collate_conti_ae,
)
from fscl_tpu_torch.data.episodic import (
    WAV_BUCKETS, EpisodicSampler, collate_episode, get_or_create_tasks, split_sup_qry,
)
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.data.samplers import GroupBatchSampler, maybe_distribute
from fscl_tpu_torch.data.native_loader import NativeCollate
from fscl_tpu_torch.data.shards import MultiShardCollate, PackedShard, shard_compatible
from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS, n_symbols as n_symbols_of


def build_id2symbols(data_configs: Sequence[DataConfig]):
    """Ordered (symbol_id, n_symbols) tuple over the data configs
    (lightning/build.py:12-29 build_id2symbols) — the canonical order for
    both MultilingualEmbedding construction and re-id offsets."""
    seen = []
    for dc in data_configs:
        if dc.symbol_id not in [s for s, _ in seen]:
            seen.append((dc.symbol_id, len(LANG_ID2SYMBOLS[dc.symbol_id])))
    return tuple(seen)


def symbol_offsets(id2symbols) -> dict:
    """symbol_id -> offset into the concatenated table (re-id increments,
    FSCLCollate.py:23-30)."""
    offsets, total = {}, 0
    for sid, n in id2symbols:
        offsets[sid] = total
        total += n
    return offsets


class BaseDataModule:
    def __init__(self, data_configs: Sequence[DataConfig],
                 model_cfg: ModelConfig, train_cfg: TrainConfig,
                 exp_dir: str = "output/exp"):
        self.data_configs = list(data_configs)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.exp_dir = exp_dir
        self.stores = {dc.name: FeatureStore(dc.data_dir)
                       for dc in self.data_configs}
        self.id2symbols = build_id2symbols(self.data_configs)
        self.offsets = symbol_offsets(self.id2symbols)

    @property
    def _var_kw(self) -> dict:
        """Variance feature levels for collate_batch: pad pitch/energy to
        the text or mel bucket per the model config, never by per-batch
        length inference (ADVICE r2)."""
        v = self.model_cfg.variance
        return {"pitch_feature": v.pitch_feature,
                "energy_feature": v.energy_feature}

    def _datasets(self, split: str, cls, re_id: bool = False, **kw):
        out = []
        spk_offset = 0
        for dc in self.data_configs:
            path = dc.subset_path(split)
            if path and os.path.isfile(path):
                extra = {}
                if re_id:
                    extra = {"id_offset": self.offsets[dc.symbol_id],
                             "speaker_offset": spk_offset}
                ds = cls(path, self.stores[dc.name], dc, self.model_cfg,
                         **extra, **kw)
                spk_offset += len(ds.speakers)
                out.append(ds)
        return out


@DATAMODULES.register("baseline", "baseline-tune", "fscl-orig-tune",
                      "fscl-tune")
class FastSpeech2DataModule(BaseDataModule):
    """Plain multilingual supervised loader
    (FastSpeech2DataModule.py:12-136). `re_id=True` maps phoneme ids into
    concatenated-table space for multilingual joint training; tune flows
    pass re_id=False (FastSpeech2DataModule.py:136 — single-language table
    addressed by symbol_id with raw ids)."""

    def __init__(self, *args, re_id: bool = True, native_io: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.re_id = re_id
        self.native_io = native_io
        # d-vector speaker paths consume per-utterance reference mel slices
        # instead of speaker ids (speaker_encoder.py:115-136); the dataset
        # then loads spk_ref_mel_slices and the collate pads them to a
        # static slice count
        spk = self.model_cfg.speaker
        self.dvec_slices = spk.n_ref_slices if spk.uses_dvec else None

    def setup(self):
        kw = {"spk_refer_wav": True} if self.dvec_slices else {}
        self.train_set = ConcatDataset(
            self._datasets("train", FastSpeech2Dataset, re_id=self.re_id, **kw))
        val = self._datasets("val", FastSpeech2Dataset, re_id=self.re_id, **kw)
        self.val_set = ConcatDataset(val) if val else None
        # the native readers (fscl_tpu's `:130-170`): packed shards beside
        # every corpus's split (one shard used directly, several stitched
        # with collate-time re-id offsets), else NativeCollate for a single
        # corpus; none with d-vector slices
        self._native = None
        self._shard = None
        if not self.native_io or self.dvec_slices is not None:
            return
        shards = self._fresh_shards()
        if shards:
            ds0 = self.train_set.datasets[0]
            if len(shards) == 1 and ds0.id_offset == 0 and ds0.speaker_offset == 0:
                self._shard = shards[0]
            else:
                self._shard = MultiShardCollate(
                    shards, [d.id_offset for d in self.train_set.datasets],
                    [d.speaker_offset for d in self.train_set.datasets])
        elif len(self.train_set.datasets) == 1:
            ds = self.train_set.datasets[0]
            self._native = NativeCollate(ds.store, ds.config, self.model_cfg, ds.stats,
                                         id_offset=ds.id_offset,
                                         speaker_offset=ds.speaker_offset)

    def _fresh_shards(self) -> Optional[List[PackedShard]]:
        """A compatible `<train.txt>.shard` for every train dataset, or None:
        one stale by count or packed under another variance or normalisation
        config, or one missing, and the store is read instead."""
        shards = []
        for ds in self.train_set.datasets:
            dc = next(dc for dc in self.data_configs if dc.name == ds.config.name)
            sp = (dc.subset_path("train") or "") + ".shard"
            if not os.path.isfile(sp):
                return None
            sh = PackedShard(sp)
            if len(sh) != len(ds) or not shard_compatible(sh, self.model_cfg, ds.stats):
                return None
            shards.append(sh)
        return shards

    def _collate(self, idxs) -> Batch:
        if self._shard is not None:
            return self._shard.collate(idxs, **self._var_kw)[1]
        if self._native is not None:
            ds = self.train_set.datasets[0]
            return self._native.collate([ds.queries[int(i)] for i in idxs])[1]
        return collate_batch([self.train_set[int(i)] for i in idxs],
                             dvec_slices=self.dvec_slices, **self._var_kw)[1]

    def train_batches(self) -> Iterator[Batch]:
        """Infinite epochs of length-grouped batches (GroupBatchSampler,
        lightning/sampler.py semantics — near-equal lengths per batch so
        bucketed padding wastes little)."""
        bs = self.train_cfg.optim.batch_size
        # approximate lengths from split-txt phoneme strings (no feature IO)
        lengths = []
        for ds in self.train_set.datasets:
            lengths.extend(
                len(q["phonemes"].strip("{}").split()) for q in ds.queries)
        epoch = 0
        while True:
            sampler = maybe_distribute(GroupBatchSampler(
                lengths, bs, seed=self.train_cfg.seed + epoch))
            for idxs in sampler:
                yield self._collate(idxs)
            epoch += 1

    def full_train_batch(self, max_utts: int = 128) -> Optional[Batch]:
        """The whole train split collated as ONE bucket-padded K-row Batch,
        for device-resident adaptation (tune.adapt_on_chip_resident): the
        few-shot tune splits are 4-64 utterances, so the 20k-step scan can
        gather each step's batch on device instead of streaming host
        batches. Returns None when the split exceeds `max_utts` (resident
        padding would waste memory) or carries d-vector reference slices
        (ragged extras the row-gather does not model)."""
        n = len(self.train_set)
        if n == 0 or n > max_utts or self.dvec_slices is not None:
            return None
        return self._collate(np.arange(n))

    def val_batches(self) -> List[Batch]:
        if self.val_set is None:
            return []
        bs = self.train_cfg.optim.batch_size
        out = []
        for start in range(0, min(len(self.val_set), 8 * bs), bs):
            samples = [self.val_set[i]
                       for i in range(start, min(start + bs, len(self.val_set)))]
            if samples:
                out.append(collate_batch(
                    samples, dvec_slices=self.dvec_slices,
                    **self._var_kw)[1])
        return out


@DATAMODULES.register("fscl", "fscl-orig", "fscl-orig2", "maml", "meta",
                      "imaml",
                      "semi-fscl", "semi-fscl-tune", "fscl-ada",
                      "fscl-ada1", "fscl-ada2", "fscl-ssl_ada",
                      "fscl-ssl_ada1", "fscl-ssl_ada2", "fscl-tune-src")
class FSCLDataModule(BaseDataModule):
    """Meta-episodic loader (FSCLDataModule.py:13-364): labels = language;
    train = infinite episode sampling; val = fixed tasks with deterministic
    replay (prefetch under the global seed, descriptions persisted).

    With a d-vector model the datasets also read the reference mel slices
    and the query batches carry them (`DvecRefs`), as FastSpeech2DataModule's
    batches do; fscl_tpu's carry speaker ids there, which its FSCL system
    cannot embed (it raises)."""

    def __init__(self, *args, shots: int = 32, queries: int = 8,
                 n_tasks_per_label: int = 8, with_sup_batch: bool = False,
                 with_qry_wavs: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.shots = shots
        self.queries = queries
        self.n_tasks_per_label = n_tasks_per_label
        self.with_sup_batch = with_sup_batch   # MAML inner loops
        self.with_qry_wavs = with_qry_wavs     # SSL-ADA query speech
        spk = self.model_cfg.speaker
        self.dvec_slices = spk.n_ref_slices if spk.uses_dvec else None

    @property
    def _episode_kw(self) -> dict:
        kw = dict(self._var_kw)
        if self.dvec_slices:
            kw["dvec_slices"] = self.dvec_slices
        return kw

    def setup(self):
        kw = {"upstream": self.model_cfg.upstream.name}
        if self.dvec_slices:
            kw["spk_refer_wav"] = True
        datasets = self._datasets("train", FSCLDataset, **kw)
        self.train_set = ConcatDataset(datasets)
        labels = []
        for d in datasets:
            labels.extend([d.config.lang_id] * len(d))
        self.sampler = EpisodicSampler(
            labels, self.shots, self.queries, seed=self.train_cfg.seed)
        val_datasets = self._datasets("val", FSCLDataset, **kw)
        self.val_set = ConcatDataset(val_datasets) if val_datasets else None
        if self.val_set is not None:
            val_labels = []
            for d in val_datasets:
                val_labels.extend([d.config.lang_id] * len(d))
            self.val_sampler = EpisodicSampler(
                val_labels, self.shots, self.queries,
                seed=self.train_cfg.seed)

    def train_batches(self):
        for idxs in maybe_distribute(self.sampler.infinite()):
            samples = [self.train_set[i] for i in idxs]
            yield collate_episode(samples, self.shots, self.queries,
                                  with_sup_batch=self.with_sup_batch,
                                  with_qry_wavs=self.with_qry_wavs,
                                  var_kw=self._episode_kw)

    def val_batches(self):
        if self.val_set is None:
            return []
        path = os.path.join(self.exp_dir, "val_descriptions.json")
        tasks = get_or_create_tasks(self.val_sampler,
                                    self.n_tasks_per_label, path)
        out = []
        for idxs in tasks:
            samples = [self.val_set[i] for i in idxs]
            out.append(collate_episode(samples, self.shots, self.queries,
                                       with_sup_batch=self.with_sup_batch,
                                       with_qry_wavs=self.with_qry_wavs,
                                       var_kw=self._episode_kw))
        return out


def collate_t2u(samples):
    """T2UBatch of UnitDataset samples: texts and units padded to their
    text buckets (fscl_tpu's `_collate_t2u` and T2UDataModule's collate)."""
    from fscl_tpu_torch.systems.t2u import T2UBatch
    L = bucket_len(max(len(s["phonemes"]) for s in samples), TEXT_BUCKETS)
    TU = bucket_len(max(len(s["units"]) for s in samples), TEXT_BUCKETS)
    return T2UBatch(
        speaker_args=np.array([s["speaker"] for s in samples], np.int32),
        texts=pad_1d([s["phonemes"] for s in samples], L, dtype=np.int32),
        src_lens=np.array([min(len(s["phonemes"]), L) for s in samples], np.int32),
        units=pad_1d([s["units"] for s in samples], TU, dtype=np.int32),
        unit_lens=np.array([min(len(s["units"]), TU) for s in samples], np.int32),
        lang_ids=np.array([s["lang_id"] for s in samples], np.int32))


@DATAMODULES.register("tacot2u", "fscl-t2u-tune", "fscl-t2u-orig-tune")
class T2UDataModule(BaseDataModule):
    """Text -> unit loader (t2u/T2UDataModule.py:13-126): batch_size
    utterances drawn uniformly with replacement from `seed`."""

    def setup(self):
        datasets = []
        for dc in self.data_configs:
            path = dc.subset_path("train")
            if path and os.path.isfile(path):
                datasets.append(UnitDataset(path, self.stores[dc.name], dc))
        self.train_set = ConcatDataset(datasets)

    def train_batches(self):
        rng = np.random.default_rng(self.train_cfg.seed)
        bs = self.train_cfg.optim.batch_size
        n = len(self.train_set)
        while True:
            yield collate_t2u([self.train_set[int(i)] for i in rng.integers(0, n, bs)])


def collate_pr(samples, symbol_id: str, n_symbols: int):
    """PRBatch of PRDataset samples: wavs padded to their wav bucket, the
    phonemes and their 20 ms frame counts to their text bucket (fscl_tpu's
    PR collates, `datamodules.py:378-386`, `:417-434`,
    `eval/protonet_eval.py:_pr_batch_from_samples`)."""
    from fscl_tpu_torch.systems.pr import PRBatch
    L = bucket_len(max(len(s["phonemes"]) for s in samples), TEXT_BUCKETS)
    W = bucket_len(max(len(s["wav"]) for s in samples), WAV_BUCKETS)
    return PRBatch(
        wavs=pad_1d([s["wav"] for s in samples], W, dtype=np.float32),
        wav_lens=np.array([min(len(s["wav"]), W) for s in samples], np.int32),
        avg_frames=pad_1d([s["avg_frames"] for s in samples], L, dtype=np.int32),
        phonemes=pad_1d([s["phonemes"] for s in samples], L, dtype=np.int32),
        lang_ids=np.array([s["lang_id"] for s in samples], np.int32),
        n_symbols=n_symbols, symbol_id=symbol_id)


@DATAMODULES.register("pr-ssl-linear", "pr-ssl-linear-tune", "pr-ssl-baseline",
                      "pr-ssl-baseline-tune", "pr-ssl-cluster", "pr-ssl-cluster-tune")
class PRDataModule(BaseDataModule):
    """SSL PR loader whose every batch comes from one dataset, so that the
    per-language head is consistent (MultiTaskSampler semantics): a dataset,
    then batch_size utterances, drawn uniformly with replacement from
    `seed`."""

    def setup(self):
        self.datasets = []
        for dc in self.data_configs:
            path = dc.subset_path("train")
            if path and os.path.isfile(path):
                self.datasets.append((dc, PRDataset(path, self.stores[dc.name], dc)))

    def train_batches(self):
        rng = np.random.default_rng(self.train_cfg.seed)
        bs = self.train_cfg.optim.batch_size
        while True:
            dc, ds = self.datasets[int(rng.integers(0, len(self.datasets)))]
            samples = [ds[int(i)] for i in rng.integers(0, len(ds), bs)]
            yield collate_pr(samples, dc.symbol_id, n_symbols_of(dc.symbol_id))


@DATAMODULES.register("pr-ssl-protonet", "pr-fscl", "pr-fscl-tune", "pr-trans-head",
                      "pr-trans-head-tune")
class PREpisodicDataModule(BaseDataModule):
    """Episodic PR loader for the protonet and TransHead systems: shots +
    queries utterances of one dataset drawn with replacement, split by
    phoneme coverage into support and query PRBatches. A fresh
    `<train.txt>.fscl.shard` beside the split (as many records as the
    split) serves the episode through `PackedShard.collate_pr_episode`:
    wavs, phonemes and 20 ms frame counts in one native read a side (numpy
    with `native_io=False`)."""

    def __init__(self, *args, shots: int = 4, queries: int = 2, native_io: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.shots = shots
        self.queries = queries
        self.native_io = native_io

    def setup(self):
        self.datasets = []
        for dc in self.data_configs:
            path = dc.subset_path("train")
            if not (path and os.path.isfile(path)):
                continue
            ds = PRDataset(path, self.stores[dc.name], dc)
            shard = None
            if os.path.isfile(path + ".fscl.shard"):
                sh = PackedShard(path + ".fscl.shard", native=self.native_io)
                if len(sh) == len(ds):
                    shard = sh
            self.datasets.append((dc, ds, shard))

    def train_batches(self):
        from fscl_tpu_torch.systems.pr import PREpisode
        rng = np.random.default_rng(self.train_cfg.seed)
        k = self.shots + self.queries
        while True:
            dc, ds, shard = self.datasets[int(rng.integers(0, len(self.datasets)))]
            idxs = rng.integers(0, len(ds), k)
            n_sym = n_symbols_of(dc.symbol_id)
            if shard is not None:
                yield shard.collate_pr_episode(idxs, self.shots, self.queries,
                                               symbol_id=dc.symbol_id, n_symbols=n_sym)
                continue
            samples = [ds[int(i)] for i in idxs]
            sup_ids, qry_ids = split_sup_qry(samples, self.shots, self.queries)
            yield PREpisode(sup=collate_pr([samples[i] for i in sup_ids], dc.symbol_id, n_sym),
                            qry=collate_pr([samples[i] for i in qry_ids], dc.symbol_id, n_sym))


@DATAMODULES.register("conti-ae")
class ContiAEDataModule(BaseDataModule):
    """Speech-reconstruction loader for ContiAE (language
    ContiAEDataModule): batch_size utterances drawn uniformly with
    replacement from `seed`, as `collate_conti_ae` batches."""

    def setup(self):
        datasets = []
        for dc in self.data_configs:
            path = dc.subset_path("train")
            if path and os.path.isfile(path):
                datasets.append(ContiAEDataset(path, self.stores[dc.name], dc))
        self.train_set = ConcatDataset(datasets)

    def train_batches(self):
        rng = np.random.default_rng(self.train_cfg.seed)
        bs = self.train_cfg.optim.batch_size
        n = len(self.train_set)
        while True:
            yield collate_conti_ae([self.train_set[int(i)] for i in rng.integers(0, n, bs)])


def get_datamodule(algorithm_type: str):
    """(lightning/datamodules/__init__.py:49-50)."""
    return DATAMODULES.get(algorithm_type)


_EPISODIC_KEYS = ("fscl", "fscl-orig", "fscl-orig2", "maml", "semi-fscl",
                  "semi-fscl-tune", "fscl-ada", "fscl-ada1", "fscl-ada2",
                  "fscl-ssl_ada", "fscl-ssl_ada1", "fscl-ssl_ada2",
                  "fscl-tune-src")


def datamodule_kwargs_for(algorithm: str, algo_cfg=None) -> dict:
    """Per-algorithm constructor kwargs for the generic datamodule path:
    MAML-style systems need the support set as a full batch for inner-loop
    losses (collate_episode with_sup_batch), the SSL-ADA unsupervised
    stages need the query set's raw speech (with_qry_wavs), and episodic
    modules take shots/queries from the algorithm config. The reference
    encodes this inside per-system collates (FSCLCollate variants) +
    few_shot_task_dataset args."""
    kw = {}
    if algorithm in ("fscl-orig2", "maml", "meta", "imaml",
                     "semi-fscl", "semi-fscl-tune"):
        kw["with_sup_batch"] = True
    if "ssl_ada" in algorithm:
        kw["with_qry_wavs"] = True
    if algo_cfg is not None and algorithm in _EPISODIC_KEYS:
        kw["shots"] = algo_cfg.adapt.shots
        kw["queries"] = algo_cfg.adapt.queries
    return kw


from fscl_tpu_torch.data import mix_datamodules  # noqa: E402,F401 (registers the T2U keys)
