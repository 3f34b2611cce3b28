"""Packed training shards: one file per split, native batch reads (port of
`fscl_tpu/data/shards.py`).

A packed mirror of a split for the training hot path: every utterance's
training features (phoneme ids, mel, pitch, energy, duration; FSCL shards
add the raw 16 kHz wav and the 20 ms frames per phoneme) laid end to end in
one binary file with a JSON index of offsets and shapes. A batch read is one
open and B seeks (`cpp/shard_batch.cc`) instead of 5 B file opens.

Layout, shared with fscl_tpu, so that each package reads the other's shards
and both write the same bytes from one store: [8-byte magic "FSCLSHRD"]
[uint64 index_len][index json][payload]. Index: {"records": [{"key",
"speaker", "lang_id", "offsets": {feature: [offset, shape, dtype]}}, ...],
"features", "meta"}; the payload holds raw little-endian C-order arrays.

`PackedShard(path, native=True)` reads through the C++ library (built with
g++ at first use, or the read raises); `native=False` reads the same offsets
with numpy. fscl_tpu probes the library and falls back to numpy in silence;
here the caller chooses.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from fscl_tpu_torch.data.batch import (
    MEL_BUCKETS, TEXT_BUCKETS, Batch, BatchMeta, SupInfo, bucket_len, pad_1d,
)
from fscl_tpu_torch.dsp.cpp_bindings import cpp_shard_pad_batch, cpp_shard_pad_rows

MAGIC = b"FSCLSHRD"

# sample-dict key -> packed dtype (the FastSpeech2Dataset sample's keys);
# texts are stored as phoneme ids, so the reader needs no frontend
PACK_DTYPES = {
    "phonemes": np.int32,
    "mel": np.float32,
    "pitch": np.float32,
    "energy": np.float32,
    "duration": np.int32,
}
# FSCL episodic shards add the raw SSL input and its alignment
FSCL_PACK_DTYPES = dict(PACK_DTYPES, raw_feat=np.float32, avg_frames=np.int32)


def write_packed_split(samples, path: str, features: Optional[Dict[str, type]] = None,
                       meta: Optional[Dict] = None) -> int:
    """Pack samples (dicts with the keys of `features`, plus id, speaker and
    lang_id) into one shard file; returns its size in bytes. Arrays take the
    canonical dtypes. `features` defaults to the supervised set
    (PACK_DTYPES); `meta` is stored verbatim in the index. The payload is
    streamed to a temporary file, so `samples` may be a lazy generator."""
    features = features or PACK_DTYPES
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".payload.tmp"
    records = []
    pos = 0
    with open(tmp, "wb") as pf:
        for s in samples:
            offsets = {}
            for name, dtype in features.items():
                arr = np.ascontiguousarray(np.asarray(s[name], dtype))
                raw = arr.tobytes()
                offsets[name] = [pos, list(arr.shape), np.dtype(dtype).str]
                pf.write(raw)
                pos += len(raw)
            records.append({"key": s.get("id", ""), "speaker": int(s.get("speaker", 0)),
                            "lang_id": int(s.get("lang_id", 0)), "offsets": offsets})
    index = json.dumps({"records": records,
                        "features": {k: np.dtype(v).str for k, v in features.items()},
                        "meta": meta or {}}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(index)))
        f.write(index)
        with open(tmp, "rb") as pf:
            shutil.copyfileobj(pf, f)
    os.remove(tmp)
    return len(MAGIC) + 8 + len(index) + pos


def _first_dim(rec, name) -> int:
    return rec["offsets"][name][1][0]


class PackedShard:
    """Reader over a packed split file: batches through the C++ reader
    (`native=True`, one call per batch) or numpy over the same offsets."""

    def __init__(self, path: str, native: bool = True):
        self.path = path
        self.native = native
        with open(path, "rb") as f:
            if f.read(8) != MAGIC:
                raise ValueError(f"not a packed shard: {path}")
            (index_len,) = struct.unpack("<Q", f.read(8))
            self.index = json.loads(f.read(index_len))
        self.data_offset = 8 + 8 + index_len
        self.records = self.index["records"]

    def __len__(self) -> int:
        return len(self.records)

    @property
    def meta(self) -> Dict:
        return self.index.get("meta", {})

    def lengths(self) -> List[int]:
        """Phoneme-sequence length per record (sampler grouping)."""
        return [_first_dim(r, "phonemes") for r in self.records]

    def _read_numpy(self, rec, name) -> np.ndarray:
        off, shape, dtype = rec["offsets"][name]
        count = int(np.prod(shape)) if shape else 1
        with open(self.path, "rb") as f:
            f.seek(self.data_offset + off)
            arr = np.frombuffer(f.read(count * np.dtype(dtype).itemsize), dtype=dtype)
        return arr.reshape(shape)

    def collate(self, idxs: Sequence[int], text_buckets=None, mel_buckets=None,
                pitch_feature: str = "phoneme_level", energy_feature: str = "phoneme_level",
                L: Optional[int] = None, T: Optional[int] = None, id_offset: int = 0,
                speaker_offset: int = 0):
        """Records -> (BatchMeta, Batch) with bucketed shapes, the contract of
        `data.batch.collate_batch`. `L` / `T` override the buckets
        (multi-shard stitching); `id_offset` / `speaker_offset` re-id into the
        concatenated multilingual table at collate time, so shards pack raw
        per-language ids."""
        recs = [self.records[int(i)] for i in idxs]
        src_lens = np.array([_first_dim(r, "phonemes") for r in recs], np.int32)
        mel_lens = np.array([_first_dim(r, "mel") for r in recs], np.int32)
        if L is None:
            L = bucket_len(int(src_lens.max()), text_buckets or TEXT_BUCKETS)
        if T is None:
            T = bucket_len(int(mel_lens.max()), mel_buckets or MEL_BUCKETS)
        var_lens = {"pitch": T if pitch_feature == "frame_level" else L,
                    "energy": T if energy_feature == "frame_level" else L}
        if self.native:
            arrays = cpp_shard_pad_batch(self.path, self.data_offset, recs, L, T, var_lens)
        else:
            B = len(recs)
            arrays = {"phonemes": np.zeros((B, L), np.int32),
                      "mel": np.zeros((B, T, 80), np.float32),
                      "pitch": np.zeros((B, var_lens["pitch"]), np.float32),
                      "energy": np.zeros((B, var_lens["energy"]), np.float32),
                      "duration": np.zeros((B, L), np.int32)}
            for b, rec in enumerate(recs):
                for name, out in arrays.items():
                    arr = self._read_numpy(rec, name)
                    n = min(len(arr), out.shape[1])
                    out[b, :n] = arr[:n]
        texts = arrays["phonemes"]
        if id_offset:
            # real ids are >= 1; padded slots stay 0
            texts = np.where(texts != 0, texts + id_offset, 0).astype(np.int32)
        batch = Batch(
            speaker_args=np.array([r["speaker"] + speaker_offset for r in recs], np.int32),
            texts=texts,
            src_lens=np.minimum(src_lens, L),
            mels=arrays["mel"],
            mel_lens=np.minimum(mel_lens, T),
            pitches=arrays["pitch"],
            energies=arrays["energy"],
            durations=arrays["duration"],
            lang_ids=np.array([r["lang_id"] for r in recs], np.int32))
        return BatchMeta(ids=[r["key"] for r in recs], raw_texts=[""] * len(recs)), batch

    def _read_rows(self, recs, name: str, maxlen: int, dtype) -> np.ndarray:
        """B 1-D arrays -> zero-padded (B, maxlen): one native call, or numpy."""
        out = np.zeros((len(recs), maxlen), dtype)
        if self.native:
            offs = np.array([r["offsets"][name][0] for r in recs], np.int64)
            rows = np.array([_first_dim(r, name) for r in recs], np.int64)
            cpp_shard_pad_rows(self.path, self.data_offset, offs, rows, maxlen, out)
        else:
            for b, r in enumerate(recs):
                arr = self._read_numpy(r, name)
                n = min(len(arr), maxlen)
                out[b, :n] = arr[:n]
        return out

    def _split(self, idxs, shots: int, queries: int):
        """The coverage split on the records' phoneme arrays: (records,
        phonemes, avg_frames, sup_ids, qry_ids)."""
        from fscl_tpu_torch.data.episodic import split_sup_qry
        if "raw_feat" not in self.index.get("features", {}):
            raise ValueError(f"{self.path} is not an FSCL shard (pack it with "
                             "pack_fscl_split_from_store)")
        recs = [self.records[int(i)] for i in idxs]
        phonemes = [self._read_numpy(r, "phonemes") for r in recs]
        avg_frames = [self._read_numpy(r, "avg_frames") for r in recs]
        sup_ids, qry_ids = split_sup_qry([{"phonemes": p} for p in phonemes], shots, queries)
        return recs, phonemes, avg_frames, sup_ids, qry_ids

    def collate_episode(self, idxs, shots: int, queries: int,
                        pitch_feature: str = "phoneme_level",
                        energy_feature: str = "phoneme_level", wav_dtype: str = "float32"):
        """A shard-backed FSCL episode (`systems.fscl.Episode`): the coverage
        split on the phoneme arrays, the SupInfo wavs by one native read, the
        query TTS batch by the packed batch read. wav_dtype="int16" ships the
        support wavs as 16-bit PCM (the upstream dequantises on the card)."""
        from fscl_tpu_torch.systems.fscl import Episode
        sup, _, qry_ids = self.collate_fscl_sup(idxs, shots, queries, wav_dtype)
        _, qry = self.collate([int(idxs[i]) for i in qry_ids], pitch_feature=pitch_feature,
                              energy_feature=energy_feature)
        return Episode(sup=sup, qry=qry, sup_batch=None)

    def collate_fscl_sup(self, idxs, shots: int, queries: int, wav_dtype: str = "float32"):
        """The coverage split and the support SupInfo only: (sup, sup_ids,
        qry_ids), for loaders whose query side comes from elsewhere (T2U: the
        unit store)."""
        from fscl_tpu_torch.data.episodic import WAV_BUCKETS
        recs, phonemes, avg_frames, sup_ids, qry_ids = self._split(idxs, shots, queries)
        sup_recs = [recs[i] for i in sup_ids]
        wav_lens = np.array([_first_dim(r, "raw_feat") for r in sup_recs], np.int32)
        W = bucket_len(int(wav_lens.max()), WAV_BUCKETS)
        wavs = self._read_rows(sup_recs, "raw_feat", W, np.float32)
        if wav_dtype == "int16":
            wavs = np.clip(np.rint(wavs * 32768.0), -32768, 32767).astype(np.int16)
        L = bucket_len(max(len(phonemes[i]) for i in sup_ids), TEXT_BUCKETS)
        sup = SupInfo(wavs=wavs, wav_lens=np.minimum(wav_lens, W),
                      avg_frames=pad_1d([avg_frames[i] for i in sup_ids], L, dtype=np.int32),
                      phonemes=pad_1d([phonemes[i] for i in sup_ids], L, dtype=np.int32),
                      n_symbols=int(self.meta.get("n_symbols", 0)))
        return sup, sup_ids, qry_ids

    def collate_pr_episode(self, idxs, shots: int, queries: int, symbol_id: str = "en",
                           n_symbols: int = 0):
        """A shard-backed PR episode (`systems.pr.PREpisode`, the semantics of
        PREpisodicDataModule): the coverage split, then support and query
        PRBatches with one native wav read each. An FSCL shard's avg_frames
        count 20 ms SSL frames (FSCLDataset's fp 0.02), as PRDataset's do."""
        from fscl_tpu_torch.data.episodic import WAV_BUCKETS
        from fscl_tpu_torch.systems.pr import PRBatch, PREpisode
        recs, phonemes, avg_frames, sup_ids, qry_ids = self._split(idxs, shots, queries)
        lang_id = int(self.meta.get("lang_id", 0))

        def batch(ids):
            rs = [recs[i] for i in ids]
            wav_lens = np.array([_first_dim(r, "raw_feat") for r in rs], np.int32)
            W = bucket_len(int(wav_lens.max()), WAV_BUCKETS)
            L = bucket_len(max(len(phonemes[i]) for i in ids), TEXT_BUCKETS)
            return PRBatch(
                wavs=self._read_rows(rs, "raw_feat", W, np.float32),
                wav_lens=np.minimum(wav_lens, W),
                avg_frames=pad_1d([avg_frames[i] for i in ids], L, dtype=np.int32),
                phonemes=pad_1d([phonemes[i] for i in ids], L, dtype=np.int32),
                lang_ids=np.full((len(ids),), lang_id, np.int32),
                n_symbols=n_symbols, symbol_id=symbol_id)

        return PREpisode(sup=batch(sup_ids), qry=batch(qry_ids))

    def sample(self, i: int) -> Dict:
        """One record as a sample dict (numpy reads): the slow path for
        callers that need arbitrary per-sample access."""
        rec = self.records[int(i)]
        out = {"id": rec["key"], "speaker": rec["speaker"], "lang_id": rec["lang_id"],
               "n_symbols": int(self.meta.get("n_symbols", 0))}
        for name in rec["offsets"]:
            out[name] = self._read_numpy(rec, name)
        return out


def provenance_meta(model_cfg, stats) -> Dict:
    """The variance levels and normalisation constants a shard was packed
    under, so that a shard packed for one configuration is not consumed by
    another (`shard_compatible`)."""
    v = model_cfg.variance
    return {
        "pitch_feature": v.pitch_feature,
        "energy_feature": v.energy_feature,
        "pitch_normalization": bool(v.pitch_normalization),
        "energy_normalization": bool(v.energy_normalization),
        "pitch_stats": [float(stats.pitch.mean), float(stats.pitch.std)],
        "energy_stats": [float(stats.energy.mean), float(stats.energy.std)],
    }


def shard_compatible(shard: PackedShard, model_cfg, stats) -> bool:
    """Whether a shard's packed content matches the model config's variance
    levels and the normalisation stats (else pitch and energy targets would
    be misaligned)."""
    meta, v = shard.meta, model_cfg.variance
    if meta.get("pitch_feature") != v.pitch_feature:
        return False
    if meta.get("energy_feature") != v.energy_feature:
        return False
    if bool(meta.get("pitch_normalization")) != bool(v.pitch_normalization):
        return False
    if bool(meta.get("energy_normalization")) != bool(v.energy_normalization):
        return False

    def close(pair, moments):
        return (pair is not None and abs(pair[0] - moments.mean) < 1e-6
                and abs(pair[1] - moments.std) < 1e-6)

    if v.pitch_normalization and not close(meta.get("pitch_stats"), stats.pitch):
        return False
    if v.energy_normalization and not close(meta.get("energy_stats"), stats.energy):
        return False
    return True


def pack_split_from_store(split_txt: str, store, config, model_cfg, path: str, stats=None,
                          id_offset: int = 0, speaker_offset: int = 0) -> int:
    """Pack a split's training features from the feature store with
    FastSpeech2Dataset's normalisation and level selection (train-ready)."""
    from fscl_tpu_torch.core.stats import DEFAULT_STATS
    from fscl_tpu_torch.data.datasets import FastSpeech2Dataset
    st = stats if stats is not None else DEFAULT_STATS
    ds = FastSpeech2Dataset(split_txt, store, config, model_cfg, stats=st, id_offset=id_offset,
                            speaker_offset=speaker_offset)
    return write_packed_split((ds[i] for i in range(len(ds))), path,
                              meta=provenance_meta(model_cfg, st))


def pack_fscl_split_from_store(split_txt: str, store, config, model_cfg, path: str, stats=None,
                               upstream: str = "hubert_large_ll60k") -> int:
    """Pack an FSCL split (TTS features, the raw 16 kHz wav, avg_frames) for
    shard-backed episodes (`PackedShard.collate_episode`,
    `collate_pr_episode`)."""
    from fscl_tpu_torch.core.stats import DEFAULT_STATS
    from fscl_tpu_torch.data.datasets import FSCLDataset
    if upstream == "mel":
        raise ValueError("FSCL shards pack 1-D raw wavs; the mel-upstream variant "
                         "(2-D raw_feat) is not supported — use the dataset path")
    st = stats if stats is not None else DEFAULT_STATS
    ds = FSCLDataset(split_txt, store, config, model_cfg, stats=st, upstream=upstream)
    if len(ds) == 0:
        raise ValueError(f"empty split: {split_txt}")
    meta = provenance_meta(model_cfg, st)
    meta.update({"n_symbols": int(ds[0]["n_symbols"]), "lang_id": int(config.lang_id)})
    return write_packed_split((ds[i] for i in range(len(ds))), path,
                              features=FSCL_PACK_DTYPES, meta=meta)


class MultiShardCollate:
    """Joint-training batches over several per-corpus shards: each packs raw
    per-language ids, the re-id and speaker offsets apply at collate. A batch
    may span corpora: each shard's rows are read at the batch's joint (L, T)
    and stitched back in order."""

    def __init__(self, shards: Sequence[PackedShard], id_offsets: Sequence[int],
                 speaker_offsets: Sequence[int]):
        self.shards = list(shards)
        self.id_offsets = list(id_offsets)
        self.speaker_offsets = list(speaker_offsets)
        self.starts = np.cumsum([0] + [len(s) for s in self.shards])

    def __len__(self) -> int:
        return int(self.starts[-1])

    def lengths(self) -> List[int]:
        return [n for s in self.shards for n in s.lengths()]

    def locate(self, i: int):
        c = int(np.searchsorted(self.starts, i, side="right") - 1)
        return c, int(i) - int(self.starts[c])

    def collate(self, idxs: Sequence[int], pitch_feature: str = "phoneme_level",
                energy_feature: str = "phoneme_level"):
        located = [self.locate(int(i)) for i in idxs]
        max_l = max_t = 1
        for c, j in located:
            rec = self.shards[c].records[j]
            max_l = max(max_l, _first_dim(rec, "phonemes"))
            max_t = max(max_t, _first_dim(rec, "mel"))
        L, T = bucket_len(max_l, TEXT_BUCKETS), bucket_len(max_t, MEL_BUCKETS)
        per_shard: Dict[int, List[int]] = {}
        for pos, (c, _) in enumerate(located):
            per_shard.setdefault(c, []).append(pos)
        metas, parts = {}, {}
        for c, positions in per_shard.items():
            metas[c], parts[c] = self.shards[c].collate(
                [located[p][1] for p in positions], pitch_feature=pitch_feature,
                energy_feature=energy_feature, L=L, T=T, id_offset=self.id_offsets[c],
                speaker_offset=self.speaker_offsets[c])
        B = len(located)

        def stitch(name):
            first = np.asarray(getattr(next(iter(parts.values())), name))
            out = np.zeros((B,) + first.shape[1:], first.dtype)
            for c, positions in per_shard.items():
                out[np.asarray(positions)] = np.asarray(getattr(parts[c], name))
            return out

        ids = [""] * B
        for c, positions in per_shard.items():
            for k, p in enumerate(positions):
                ids[p] = metas[c].ids[k]
        return BatchMeta(ids=ids, raw_texts=[""] * B), Batch(*[stitch(f) for f in Batch._fields])
