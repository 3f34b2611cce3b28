"""Mix / DA datamodules of the T2U tune flows (port of
`fscl_tpu/data/mix_datamodules.py`: `T2U2SDataModule` `:41`,
`T2UEpisodicDataModule` `:104`, `T2UDADataModule` `:160`,
`T2U2SDADataModule` `:195`).

The episodic T2U loader reads the wav-heavy support side from a fresh packed
`<train.txt>.fscl.shard` beside the split when one is there
(`PackedShard.collate_fscl_sup`, fscl_tpu's `:126-153`; the C++ reader, or
numpy with `native_io=False`); the query side's unit batches are collated in
Python.
"""
from __future__ import annotations

import os

import numpy as np

from fscl_tpu_torch.core.config import DataConfig
from fscl_tpu_torch.core.registry import DATAMODULES
from fscl_tpu_torch.core.stats import DEFAULT_STATS
from fscl_tpu_torch.data.batch import collate_batch, pad_1d
from fscl_tpu_torch.data.datamodules import BaseDataModule, collate_t2u
from fscl_tpu_torch.data.datasets import ConcatDataset, FSCLDataset, UnitDataset
from fscl_tpu_torch.data.episodic import collate_sup_info, split_sup_qry
from fscl_tpu_torch.data.shards import PackedShard


def _unit_splits(dm: BaseDataModule):
    """(data config, train split path) of each config with a unit target and
    a train split on disk."""
    for dc in dm.data_configs:
        path = dc.subset_path("train")
        if path and os.path.isfile(path) and dc.unit_name:
            yield dc, path


def _real_units(real, TU: int):
    return (pad_1d([r["units"] for r in real], TU, dtype=np.int32),
            np.array([min(len(r["units"]), TU) for r in real], np.int32))


@DATAMODULES.register("fscl-t2u-e2e-tune", "fscl-t2u-orig-e2e-tune",
                      "fscl-t2u-c-e2e-tune", "fscl-t2u-c2-e2e-tune")
class T2U2SDataModule(BaseDataModule):
    """Paired t2u + u2s batches of the same utterances (t2u/MixDataModule.py
    T2U2SDataModule): the u2s side takes the unit sequence as text and the
    unit-level duration, pitch and energy of the ssl_units sub-store."""

    def setup(self):
        self.pairs = [(dc, UnitDataset(path, self.stores[dc.name], dc))
                      for dc, path in _unit_splits(self)]

    def u2s_sample(self, dc: DataConfig, t2u_sample: dict) -> dict:
        """The u2s view of a UnitDataset sample: units (<eos> stripped) as the
        text, the mel cut to the units' total duration, pitch and energy
        normalised with the global stats as the supervised dataset does."""
        store = self.stores[dc.name]
        unit_store = store.get_ssl_unit_store(dc.unit_name)
        q = {"spk": t2u_sample.get("speaker_name", ""), "basename": t2u_sample["id"]}
        dur = np.asarray(unit_store.duration.read_from_query(q))
        mel = np.asarray(store.mel.read_from_query(q))
        if mel.shape[0] != int(dur.sum()) and mel.shape[-1] == int(dur.sum()):
            mel = mel.T
        pitch = np.asarray(unit_store.duration_avg_pitch.read_from_query(q))
        energy = np.asarray(unit_store.duration_avg_energy.read_from_query(q))
        v = self.model_cfg.variance
        if v.pitch_normalization:
            pitch = (pitch - DEFAULT_STATS.pitch.mean) / DEFAULT_STATS.pitch.std
        if v.energy_normalization:
            energy = (energy - DEFAULT_STATS.energy.mean) / DEFAULT_STATS.energy.std
        return {
            "id": t2u_sample["id"], "speaker": t2u_sample["speaker"], "text": "",
            "phonemes": t2u_sample["units"][:-1], "mel": mel[:int(dur.sum())],
            "pitch": pitch, "energy": energy, "duration": dur,
            "lang_id": t2u_sample["lang_id"], "symbol_id": dc.unit_name,
        }

    def _draw(self, rng):
        dc, ds = self.pairs[int(rng.integers(0, len(self.pairs)))]
        bs = self.train_cfg.optim.batch_size
        samples = [ds[int(i)] for i in rng.integers(0, len(ds), bs)]
        _, u2s = collate_batch([self.u2s_sample(dc, s) for s in samples], **self._var_kw)
        return ds, samples, collate_t2u(samples), u2s

    def train_batches(self):
        from fscl_tpu_torch.systems.t2u_tune import E2EBatch
        rng = np.random.default_rng(self.train_cfg.seed)
        while True:
            _, _, t2u, u2s = self._draw(rng)
            yield E2EBatch(t2u=t2u, u2s=u2s)


@DATAMODULES.register("fscl-t2u", "fscl-t2u-orig", "fscl-t2u-codebook",
                      "fscl-t2u-codebook2", "fscl-t2u-c", "fscl-t2u-c2",
                      "fscl-t2u-episodic", "fscl-t2u-orig-episodic")
class T2UEpisodicDataModule(BaseDataModule):
    """Episodic T2U loader (t2u FSCLDataModule over FSCLdataset.py:64-117):
    shots + queries utterances drawn with replacement, split by phoneme
    coverage; the support's raw speech and MFA segments, the queries'
    text -> unit batch. A fresh `.fscl.shard` (as many records as the split)
    serves the support side."""

    def __init__(self, *args, shots: int = 4, queries: int = 2,
                 upstream: str = "hubert_large_ll60k", native_io: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.shots = shots
        self.queries = queries
        self.upstream = upstream
        self.native_io = native_io

    def setup(self):
        self.pairs = []
        for dc, path in _unit_splits(self):
            fscl_ds = FSCLDataset(path, self.stores[dc.name], dc, self.model_cfg,
                                  upstream=self.upstream)
            shard = None
            if os.path.isfile(path + ".fscl.shard"):
                sh = PackedShard(path + ".fscl.shard", native=self.native_io)
                if len(sh) == len(fscl_ds):
                    shard = sh
            self.pairs.append((fscl_ds, UnitDataset(path, self.stores[dc.name], dc), shard))

    def train_batches(self):
        from fscl_tpu_torch.systems.t2u import T2UEpisode
        rng = np.random.default_rng(self.train_cfg.seed)
        k = self.shots + self.queries
        while True:
            fscl_ds, unit_ds, shard = self.pairs[int(rng.integers(0, len(self.pairs)))]
            idxs = rng.integers(0, len(fscl_ds), k)
            if shard is not None:
                sup, _, qry_ids = shard.collate_fscl_sup(idxs, self.shots, self.queries)
            else:
                fscl_samples = [fscl_ds[int(i)] for i in idxs]
                sup_ids, qry_ids = split_sup_qry(fscl_samples, self.shots, self.queries)
                sup = collate_sup_info([fscl_samples[i] for i in sup_ids])
            qry = collate_t2u([unit_ds[int(idxs[i])] for i in qry_ids])
            yield T2UEpisode(sup=sup, qry=qry)


@DATAMODULES.register("fscl-t2u-da-tune")
class T2UDADataModule(BaseDataModule):
    """A t2u stream and an independent real-unit stream for the
    discriminator (t2u/T2UDADataModule)."""

    def setup(self):
        self.train_set = ConcatDataset([UnitDataset(path, self.stores[dc.name], dc)
                                        for dc, path in _unit_splits(self)])

    def train_batches(self):
        from fscl_tpu_torch.systems.t2u_tune import DABatch
        rng = np.random.default_rng(self.train_cfg.seed)
        bs = self.train_cfg.optim.batch_size
        n = len(self.train_set)
        while True:
            samples = [self.train_set[int(i)] for i in rng.integers(0, n, bs)]
            real = [self.train_set[int(i)] for i in rng.integers(0, n, bs)]
            t2u = collate_t2u(samples)
            yield DABatch(t2u, *_real_units(real, t2u.units.shape[1]))


@DATAMODULES.register("fscl-t2u-da-e2e-tune", "fscl-t2u-dae2e-tune",
                      "fscl-t2u-c-da-e2e-tune", "fscl-t2u-c2-da-e2e-tune")
class T2U2SDADataModule(T2U2SDataModule):
    """Paired t2u + u2s batches plus an independent real-unit stream
    (t2u/MixDataModule.py T2U2SDADataModule)."""

    def train_batches(self):
        from fscl_tpu_torch.systems.t2u_tune import DAE2EBatch
        rng = np.random.default_rng(self.train_cfg.seed)
        bs = self.train_cfg.optim.batch_size
        while True:
            ds, _, t2u, u2s = self._draw(rng)
            real = [ds[int(i)] for i in rng.integers(0, len(ds), bs)]
            yield DAE2EBatch(t2u, u2s, *_real_units(real, t2u.units.shape[1]))
