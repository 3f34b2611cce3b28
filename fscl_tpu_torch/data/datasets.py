"""Datasets: feature-store readers producing sample dicts (port of
`fscl_tpu/data/datasets.py`).

Re-provides lightning/datasets/: FastSpeech2Dataset (language/
FastSpeech2Dataset.py), FSCLDataset (language/FSCLDataset.py:14-121 — adds
raw 16 kHz wav + avg_frames for SSL), TextDataset (inference). Normalization
uses the global stats exactly like Define.ALLSTATS["global"] consumption.
Items are numpy, equal to fscl_tpu's item for item. The T2U family's
`UnitFSCLDataset` and `UnitDataset` (`:151`, `:214`) read the pseudo-unit
sub-store `ssl_units/<name>` (`phoneme`, `duration`). `PRDataset` (`:304`)
is the PR family's (`wav_trim_16000`, `phoneme`, `mfa_segment`);
`ContiAEDataset` (`:260`) ContiAE's (`wav_trim_16000`, `mel`), with
`collate_conti_ae` (`:288`).

The features an item reads from a store (`data/feature_store.py`):
`mfa_duration`, `mel`, `mfa_duration_avg_pitch` / `interpolate_pitch`,
`mfa_duration_avg_energy` / `energy` (by the variance levels), `phoneme` and
`text` (json); with `spk_refer_wav`, `spk_ref_mel_slices`; FSCLDataset adds
`wav_trim_16000` and `mfa_segment` (json). `speakers.json` maps speakers to
ids.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from fscl_tpu_torch.core.config import DataConfig, ModelConfig
from fscl_tpu_torch.core.stats import DEFAULT_STATS, GlobalStats
from fscl_tpu_torch.data.feature_store import FeatureStore, read_queries_from_txt
from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS, n_symbols, text_to_sequence, units_to_sequence


def segment_to_duration(segment, fp: float = 0.02) -> List[int]:
    """TextGrid segments [(start, end), ...] -> frame counts at frame period
    fp (dlhlp_lib segment2duration equivalent used at FSCLDataset.py:111)."""
    durations = []
    pos = 0.0
    for start, end in segment:
        n = int(round(end / fp)) - int(round(pos / fp))
        durations.append(max(n, 0))
        pos = end
    return durations


class FastSpeech2Dataset:
    """Supervised TTS samples (mel/pitch/energy/duration/phonemes)."""

    def __init__(self, split_txt: str, store: FeatureStore, config: DataConfig,
                 model_cfg: ModelConfig, stats: GlobalStats = DEFAULT_STATS,
                 spk_refer_wav: bool = False, id_offset: int = 0,
                 speaker_offset: int = 0):
        """`id_offset` re-ids phoneme ids into the concatenated multilingual
        table space (FSCLCollate re_id / T2UCollate.py:38-44);
        `speaker_offset` does the same for the global speaker table
        (build_all_speakers)."""
        self.store = store
        self.config = config
        self.model_cfg = model_cfg
        self.stats = stats
        self.spk_refer_wav = spk_refer_wav
        self.id_offset = id_offset
        self.speaker_offset = speaker_offset
        self.queries = read_queries_from_txt(split_txt)
        self.speakers = store.load_speakers()
        self.speaker_map = {s: i for i, s in enumerate(self.speakers)}
        self.symbol_id = config.symbol_id

    def __len__(self):
        return len(self.queries)

    def _core(self, idx: int) -> Dict:
        q = self.queries[idx]
        query = {"spk": q["spk"], "basename": q["basename"]}
        duration = np.asarray(self.store.mfa_duration.read_from_query(query))
        total = int(duration.sum())
        mel = np.asarray(self.store.mel.read_from_query(query))
        if mel.shape[0] != total and mel.shape[-1] == total:
            mel = mel.T                       # stored (n_mels, T) like ref
        mel = mel[:total]

        v = self.model_cfg.variance
        if v.pitch_feature == "phoneme_level":
            pitch = np.asarray(
                self.store.mfa_duration_avg_pitch.read_from_query(query))
        else:
            pitch = np.asarray(
                self.store.interpolate_pitch.read_from_query(query))[:total]
        if v.energy_feature == "phoneme_level":
            energy = np.asarray(
                self.store.mfa_duration_avg_energy.read_from_query(query))
        else:
            energy = np.asarray(self.store.energy.read_from_query(query))[:total]

        if v.pitch_normalization:
            pitch = (pitch - self.stats.pitch.mean) / self.stats.pitch.std
        if v.energy_normalization:
            energy = (energy - self.stats.energy.mean) / self.stats.energy.std

        phonemes = self.store.phoneme.read_from_query(query)
        raw_text = self.store.text.read_from_query(query)
        text = np.asarray(text_to_sequence(
            f"{{{phonemes}}}", self.config.text_cleaners, self.symbol_id))

        for name, arr in (("mel", mel), ("pitch", pitch), ("energy", energy)):
            if np.isnan(arr).any():
                raise ValueError(f"NaN in {name}: {query}")
        if len(text) != len(duration):
            raise ValueError(f"{len(text)} phonemes but {len(duration)} durations: {query}")

        if self.id_offset:
            text = text + self.id_offset
        return {
            "id": q["basename"],
            "speaker": self.speaker_map[q["spk"]] + self.speaker_offset,
            "speaker_name": q["spk"],
            "text": raw_text,
            "phonemes": text,
            "mel": mel.astype(np.float32),
            "pitch": pitch.astype(np.float32),
            "energy": energy.astype(np.float32),
            "duration": duration.astype(np.int64),
            "lang_id": self.config.lang_id,
            "symbol_id": self.symbol_id,
            "n_symbols": len(LANG_ID2SYMBOLS[self.symbol_id]),
        }

    def __getitem__(self, idx: int) -> Dict:
        sample = self._core(idx)
        if self.spk_refer_wav:
            q = self.queries[idx]
            sample["spk_ref_mel_slices"] = np.asarray(
                self.store.spk_ref_mel_slices.read_from_query(
                    {"spk": q["spk"], "basename": q["basename"]}))
        return sample


class FSCLDataset(FastSpeech2Dataset):
    """FastSpeech2Dataset + raw 16 kHz wav and avg_frames for the SSL
    upstream (FSCLDataset.py:102-118)."""

    def __init__(self, *args, upstream: str = "hubert_large_ll60k", **kwargs):
        super().__init__(*args, **kwargs)
        self.upstream = upstream

    def __getitem__(self, idx: int) -> Dict:
        sample = super().__getitem__(idx)
        q = self.queries[idx]
        query = {"spk": q["spk"], "basename": q["basename"]}
        if self.upstream == "mel":
            sample["raw_feat"] = sample["mel"]
            sample["avg_frames"] = sample["duration"]
        else:
            sample["raw_feat"] = np.asarray(
                self.store.wav_trim_16000.read_from_query(query)).astype(np.float32)
            segment = self.store.mfa_segment.read_from_query(query)
            sample["avg_frames"] = np.asarray(
                segment_to_duration(segment, fp=0.02), dtype=np.int64)
        return sample


class UnitFSCLDataset(FSCLDataset):
    """FSCLDataset with the support's "phonemes" and avg_frames from the
    pseudo-unit segmentation in ssl_units/<unit_name> instead of MFA's, so
    the episode table is built over the unit inventory."""

    def __init__(self, *args, unit_name: str, **kwargs):
        super().__init__(*args, **kwargs)
        self.unit_name = unit_name
        self.unit_store = self.store.get_ssl_unit_store(unit_name)
        self.n_unit_symbols = n_symbols(unit_name)

    def __getitem__(self, idx: int) -> Dict:
        sample = super().__getitem__(idx)
        q = self.queries[idx]
        query = {"spk": q["spk"], "basename": q["basename"]}
        units = np.asarray(units_to_sequence(self.unit_store.phoneme.read_from_query(query),
                                             self.unit_name))
        sample.update({
            "phonemes": units,
            "avg_frames": np.asarray(self.unit_store.duration.read_from_query(query),
                                     dtype=np.int64),
            "symbol_id": self.unit_name,
            "n_symbols": self.n_unit_symbols,
        })
        return sample


class UnitDataset:
    """Text -> pseudo-unit targets for T2U (t2u/T2UDataset.py): phoneme ids
    from the text frontend, unit ids from ssl_units/<name> with <eos> = 8
    appended."""

    EOS = 8

    def __init__(self, split_txt: str, store: FeatureStore, config: DataConfig,
                 unit_name: Optional[str] = None):
        self.store = store
        self.config = config
        self.unit_name = unit_name or config.unit_name
        if not self.unit_name:
            raise ValueError("UnitDataset needs a unit_name")
        self.unit_store = store.get_ssl_unit_store(self.unit_name)
        self.queries = read_queries_from_txt(split_txt)
        self.speakers = store.load_speakers()
        self.speaker_map = {s: i for i, s in enumerate(self.speakers)}
        self.n_units = n_symbols(self.unit_name)

    def __len__(self):
        return len(self.queries)

    def __getitem__(self, idx: int) -> Dict:
        q = self.queries[idx]
        query = {"spk": q["spk"], "basename": q["basename"]}
        text = np.asarray(text_to_sequence(
            f"{{{self.store.phoneme.read_from_query(query)}}}", self.config.text_cleaners,
            self.config.symbol_id))
        units = np.asarray(units_to_sequence(self.unit_store.phoneme.read_from_query(query),
                                             self.unit_name))
        return {
            "id": q["basename"],
            "speaker": self.speaker_map[q["spk"]],
            "speaker_name": q["spk"],
            "text": q["text"],
            "phonemes": text,
            "units": np.concatenate([units, [self.EOS]]).astype(np.int64),
            "lang_id": self.config.lang_id,
            "symbol_id": self.config.symbol_id,
        }


class TextDataset:
    """Inference-only: lines `basename|spk|{phonemes}|text` without acoustic
    features (lightning/datasets/language/TextDataset.py)."""

    def __init__(self, split_txt: str, config: DataConfig):
        self.queries = read_queries_from_txt(split_txt)
        self.config = config

    def __len__(self):
        return len(self.queries)

    def __getitem__(self, idx: int) -> Dict:
        q = self.queries[idx]
        text = np.asarray(text_to_sequence(
            q["phonemes"] if q["phonemes"].startswith("{")
            else f"{{{q['phonemes']}}}",
            self.config.text_cleaners, self.config.symbol_id))
        return {
            "id": q["basename"], "speaker": 0, "speaker_name": q["spk"],
            "text": q["text"], "phonemes": text, "mel": None,
            "pitch": None, "energy": None, "duration": None,
            "lang_id": self.config.lang_id, "symbol_id": self.config.symbol_id,
        }


class ContiAEDataset:
    """Speech reconstruction for ContiAE (lightning/datasets/language
    ContiAEDataset): the 16 kHz wav (the SSL input) and the target mel."""

    def __init__(self, split_txt: str, store: FeatureStore, config: DataConfig):
        self.store = store
        self.config = config
        self.queries = read_queries_from_txt(split_txt)

    def __len__(self):
        return len(self.queries)

    def __getitem__(self, idx: int) -> Dict:
        q = self.queries[idx]
        query = {"spk": q["spk"], "basename": q["basename"]}
        wav = np.asarray(self.store.wav_trim_16000.read_from_query(query)).astype(np.float32)
        mel = np.asarray(self.store.mel.read_from_query(query))
        return {"id": q["basename"], "wav": wav, "mel": mel.astype(np.float32),
                "lang_id": self.config.lang_id}


def collate_conti_ae(samples):
    """`systems.conti_ae.ContiAEBatch` of ContiAEDataset samples: wavs
    padded to their wav bucket, mels to their mel bucket."""
    from fscl_tpu_torch.data.batch import MEL_BUCKETS, bucket_len, pad_1d, pad_2d
    from fscl_tpu_torch.data.episodic import WAV_BUCKETS
    from fscl_tpu_torch.systems.conti_ae import ContiAEBatch
    wav_lens = np.array([len(s["wav"]) for s in samples], np.int32)
    mel_lens = np.array([len(s["mel"]) for s in samples], np.int32)
    W = bucket_len(int(wav_lens.max()), WAV_BUCKETS)
    T = bucket_len(int(mel_lens.max()), MEL_BUCKETS)
    return ContiAEBatch(
        wavs=pad_1d([s["wav"] for s in samples], W, dtype=np.float32),
        wav_lens=np.minimum(wav_lens, W),
        mels=pad_2d([s["mel"] for s in samples], T),
        mel_lens=np.minimum(mel_lens, T))


class PRDataset:
    """Phoneme recognition: the 16 kHz wav, the phoneme ids, their 20 ms
    frame counts from the MFA segments, and frame labels by repetition
    (lightning/datasets/phoneme_recognition/PRDataset.py:13-161)."""

    def __init__(self, split_txt: str, store: FeatureStore, config: DataConfig,
                 fp: float = 0.02):
        self.store = store
        self.config = config
        self.fp = fp
        self.queries = read_queries_from_txt(split_txt)

    def __len__(self):
        return len(self.queries)

    def __getitem__(self, idx: int) -> Dict:
        q = self.queries[idx]
        query = {"spk": q["spk"], "basename": q["basename"]}
        wav = np.asarray(self.store.wav_trim_16000.read_from_query(query)).astype(np.float32)
        phonemes = self.store.phoneme.read_from_query(query)
        text = np.asarray(text_to_sequence(f"{{{phonemes}}}", self.config.text_cleaners,
                                           self.config.symbol_id))
        segment = self.store.mfa_segment.read_from_query(query)
        avg_frames = np.asarray(segment_to_duration(segment, self.fp), dtype=np.int64)
        labels = np.repeat(text[: len(avg_frames)], avg_frames)
        return {
            "id": q["basename"], "speaker": 0,
            "wav": wav, "phonemes": text, "avg_frames": avg_frames,
            "frame_labels": labels.astype(np.int64),
            "lang_id": self.config.lang_id, "symbol_id": self.config.symbol_id,
            "n_symbols": len(LANG_ID2SYMBOLS[self.config.symbol_id]),
        }


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[d][idx - int(self.offsets[d])]
