"""Native (C++) batch reader over a feature store (port of
`fscl_tpu/data/native_loader.py`, `NativeCollate` `:44`).

The Python path reads about 5 `.npy` files a sample
(`FastSpeech2Dataset._core`) and pads in `collate_batch`. `NativeCollate`
reads each feature of a whole batch in one ctypes call into
`cpp/npy_batch.cc` (`dsp/cpp_bindings.py`), which parses the npy headers,
cuts, normalises and pads natively and releases the GIL while it reads.

Numerics equal the Python path's: the same buckets, the same normalisation
((x - mean) / std applied as (x - shift) * scale in float64 before the f32
store), the same mel transpose, the same padding. The library is built with
g++ at first use or the read raises; fscl_tpu's `native_available` probe
(which fell back to Python in silence) has no counterpart: the datamodules
take `native_io=False` to ask for the Python path.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np

from fscl_tpu_torch.core.config import DataConfig, ModelConfig
from fscl_tpu_torch.core.stats import DEFAULT_STATS, GlobalStats
from fscl_tpu_torch.data.batch import (
    MEL_BUCKETS, TEXT_BUCKETS, Batch, BatchMeta, bucket_len, pad_1d,
)
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.dsp.cpp_bindings import (
    cpp_npy_pad_1d_f32, cpp_npy_pad_1d_i32, cpp_npy_pad_2d_f32,
)
from fscl_tpu_torch.frontend import text_to_sequence


class NativeCollate:
    """Batch reader over a FeatureStore through the C++ npy readers: the
    supervised FastSpeech2 path (phoneme- or frame-level variance features,
    table speakers). Raw wavs and d-vector slices stay on the Python path."""

    def __init__(self, store: FeatureStore, config: DataConfig, model_cfg: ModelConfig,
                 stats: GlobalStats = DEFAULT_STATS, id_offset: int = 0,
                 speaker_offset: int = 0):
        self.store = store
        self.config = config
        self.model_cfg = model_cfg
        self.stats = stats
        self.id_offset = id_offset
        self.speaker_offset = speaker_offset
        self.speakers = store.load_speakers()
        self.speaker_map = {s: i for i, s in enumerate(self.speakers)}
        self.symbol_id = config.symbol_id
        # bounded: an endless stream over a large corpus must not grow it
        self._text_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._text_cache_max = 65536

    def _texts(self, queries: List[dict]) -> List[np.ndarray]:
        out = []
        for q in queries:
            key = f"{q['spk']}-{q['basename']}"
            seq = self._text_cache.get(key)
            if seq is None:
                phonemes = self.store.phoneme.read_from_query(q)
                seq = np.asarray(text_to_sequence(f"{{{phonemes}}}", self.config.text_cleaners,
                                                  self.symbol_id), np.int32)
                if self.id_offset:
                    seq = seq + self.id_offset
                self._text_cache[key] = seq
                if len(self._text_cache) > self._text_cache_max:
                    self._text_cache.popitem(last=False)
            else:
                self._text_cache.move_to_end(key)
            out.append(seq)
        return out

    def collate(self, queries: List[dict], text_buckets: Sequence[int] = TEXT_BUCKETS,
                mel_buckets: Sequence[int] = MEL_BUCKETS,
                bucket: bool = True) -> Tuple[BatchMeta, Batch]:
        store, v = self.store, self.model_cfg.variance
        texts = self._texts(queries)
        src_lens = np.array([len(t) for t in texts], np.int32)
        L = int(src_lens.max())
        if bucket:
            L = bucket_len(L, text_buckets)

        def paths(feature):
            return [feature.path(q) for q in queries]

        # durations first: their row sums give the mel cut
        dur, dlens = cpp_npy_pad_1d_i32(paths(store.mfa_duration), L)
        # FastSpeech2Dataset._core's contract: a phoneme / duration count
        # mismatch raises rather than being padded over
        expect = np.minimum(src_lens, L)
        if not np.array_equal(expect, dlens):
            bad = [queries[i]["basename"] for i in np.nonzero(expect != dlens)[0]]
            raise ValueError(f"text/duration length mismatch for {bad} "
                             f"(text {expect.tolist()} vs duration {dlens.tolist()})")
        totals = dur.sum(axis=1).astype(np.int32)
        T = int(totals.max()) if totals.max() > 0 else 1
        if bucket:
            T = bucket_len(T, mel_buckets)

        n_mels = self.model_cfg.audio.n_mels
        mels, mel_lens = cpp_npy_pad_2d_f32(paths(store.mel), T, n_mels,
                                            trunc=np.minimum(totals, T),
                                            maybe_transposed_dim=n_mels)
        p_shift, p_scale = 0.0, 1.0
        if v.pitch_normalization:
            p_shift, p_scale = self.stats.pitch.mean, 1.0 / self.stats.pitch.std
        e_shift, e_scale = 0.0, 1.0
        if v.energy_normalization:
            e_shift, e_scale = self.stats.energy.mean, 1.0 / self.stats.energy.std
        frame_valid = np.arange(T)[None, :] < mel_lens[:, None]
        if v.pitch_feature == "phoneme_level":
            pitch, _ = cpp_npy_pad_1d_f32(paths(store.mfa_duration_avg_pitch), L, p_shift, p_scale)
        else:
            pitch, _ = cpp_npy_pad_1d_f32(paths(store.interpolate_pitch), T, p_shift, p_scale)
            pitch *= frame_valid
        if v.energy_feature == "phoneme_level":
            energy, _ = cpp_npy_pad_1d_f32(paths(store.mfa_duration_avg_energy), L, e_shift,
                                           e_scale)
        else:
            energy, _ = cpp_npy_pad_1d_f32(paths(store.energy), T, e_shift, e_scale)
            energy *= frame_valid

        # the Python path's dataset asserts: a NaN feature raises
        for name, arr in (("mel", mels), ("pitch", pitch), ("energy", energy)):
            rows = np.isnan(arr.reshape(len(queries), -1)).any(1)
            if rows.any():
                raise ValueError(f"NaN {name} feature for "
                                 f"{[queries[i]['basename'] for i in np.nonzero(rows)[0]]}")

        batch = Batch(
            speaker_args=np.array([self.speaker_map[q["spk"]] + self.speaker_offset
                                   for q in queries], np.int32),
            texts=pad_1d(texts, L, dtype=np.int32),
            src_lens=np.minimum(src_lens, L),
            mels=mels,
            mel_lens=mel_lens.astype(np.int32),
            pitches=pitch,
            energies=energy,
            durations=dur,
            lang_ids=np.full(len(queries), self.config.lang_id, np.int32))
        meta = BatchMeta(ids=[q["basename"] for q in queries],
                         raw_texts=[store.text.read_from_query(q) for q in queries],
                         symbol_id=self.symbol_id)
        return meta, batch
