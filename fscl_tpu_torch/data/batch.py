"""Batch contracts and static-shape padding (port of `fscl_tpu/data/batch.py:19-61,75-175`).

The reference collates every task into a 13-tuple
(lightning/collates/utils.py:70-101). Here the device part is a `Batch` of
numpy arrays with bucketed shapes, as in the JAX package, and host-only
metadata (utterance ids, raw text) rides in `BatchMeta`. `to_device` copies
a `Batch` (or an FSCL `Episode`: `SupInfo` and a query `Batch`) to the
card, from pinned memory without blocking the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class Batch(NamedTuple):
    speaker_args: np.ndarray    # (B,) int32 speaker ids, or DvecRefs
    texts: np.ndarray           # (B, L) int32 phoneme ids
    src_lens: np.ndarray        # (B,) int32
    mels: np.ndarray            # (B, T, n_mels) float32
    mel_lens: np.ndarray        # (B,) int32
    pitches: np.ndarray         # (B, L) float32 (phoneme_level) or (B, T)
    energies: np.ndarray        # (B, L) float32 or (B, T)
    durations: np.ndarray       # (B, L) int32
    lang_ids: np.ndarray        # (B,) int32


class DvecRefs(NamedTuple):
    """Speaker-reference mel slices for the GE2E d-vector speaker paths,
    padded or cut to a static slice count N; padded slices are masked out of
    the GE2E average."""
    slices: np.ndarray          # (B, N, 160, 40) float32 partial-utterance mels
    mask: np.ndarray            # (B, N) float32, 1 for real slices


def collate_dvec_refs(samples: List[dict], n_slices: int) -> DvecRefs:
    """Pad each sample's (N_i, 160, 40) spk_ref_mel_slices to a fixed
    n_slices. Truncation keeps the leading slices (resemblyzer order)."""
    first = np.asarray(samples[0]["spk_ref_mel_slices"])
    T, C = first.shape[1], first.shape[2]
    out = np.zeros((len(samples), n_slices, T, C), np.float32)
    mask = np.zeros((len(samples), n_slices), np.float32)
    for i, s in enumerate(samples):
        sl = np.asarray(s["spk_ref_mel_slices"], np.float32)[:n_slices]
        out[i, : len(sl)] = sl
        mask[i, : len(sl)] = 1.0
    return DvecRefs(out, mask)


class SupInfo(NamedTuple):
    """The raw SSL inputs of an FSCL episode's support set (the JAX
    package's flax struct, `fscl_tpu/data/batch.py:63-72`). `n_symbols` is
    static metadata: `to_device` passes it through."""
    wavs: np.ndarray            # (S, T_wav) 16 kHz: float32, or int16 PCM
    wav_lens: np.ndarray        # (S,) int32
    avg_frames: np.ndarray      # (S, L) int32 SSL frames per phoneme
    phonemes: np.ndarray        # (S, L) int32 phoneme ids
    n_symbols: int = 0


@dataclass
class BatchMeta:
    ids: List[str]
    raw_texts: List[str]
    symbol_id: Optional[str] = None


def bucket_len(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest when none is)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


TEXT_BUCKETS = (32, 64, 128, 192, 256)
MEL_BUCKETS = (128, 256, 512, 768, 1000, 1024)


def pad_1d(seqs: Sequence[np.ndarray], length: int, value=0, dtype=None) -> np.ndarray:
    dtype = dtype or np.asarray(seqs[0]).dtype
    out = np.full((len(seqs), length), value, dtype=dtype)
    for i, s in enumerate(seqs):
        s = np.asarray(s)[:length]
        out[i, : len(s)] = s
    return out


def pad_2d(seqs: Sequence[np.ndarray], length: int, value=0.0) -> np.ndarray:
    dim = np.asarray(seqs[0]).shape[1]
    out = np.full((len(seqs), length, dim), value, dtype=np.float32)
    for i, s in enumerate(seqs):
        s = np.asarray(s)[:length]
        out[i, : len(s)] = s
    return out


def collate_batch(
    samples: List[dict],
    text_buckets: Sequence[int] = TEXT_BUCKETS,
    mel_buckets: Sequence[int] = MEL_BUCKETS,
    bucket: bool = True,
    dvec_slices: Optional[int] = None,
    pitch_feature: Optional[str] = None,
    energy_feature: Optional[str] = None,
) -> Tuple[BatchMeta, Batch]:
    """Samples are dicts with keys: id, text (str), phonemes (int array),
    mel (T, n_mels), pitch, energy, duration, speaker (int), lang_id (int).
    `dvec_slices`: when set and samples carry spk_ref_mel_slices, emit
    DvecRefs (padded to that static slice count) as speaker_args.
    `pitch_feature`/`energy_feature`: the variance level ("phoneme_level" |
    "frame_level"); when given, the pitch/energy targets pad to the text or
    mel bucket accordingly; when None the level is inferred from per-sample
    lengths. Equivalent of reprocess() (collates/utils.py:8-112), with
    bucketed shapes."""
    src_lens = np.array([len(s["phonemes"]) for s in samples], dtype=np.int32)
    mel_lens = np.array(
        [len(s["mel"]) if s.get("mel") is not None else 0 for s in samples],
        dtype=np.int32,
    )
    L = int(src_lens.max())
    T = int(mel_lens.max()) if mel_lens.max() > 0 else 1
    if bucket:
        L = bucket_len(L, text_buckets)
        T = bucket_len(T, mel_buckets)

    has_mel = samples[0].get("mel") is not None
    if dvec_slices is not None and "spk_ref_mel_slices" in samples[0]:
        speaker_args = collate_dvec_refs(samples, dvec_slices)
    else:
        speaker_args = np.array([s["speaker"] for s in samples], dtype=np.int32)

    # frame-level pitch/energy targets have mel-frame length: pad those to
    # the mel bucket so the variance adaptor sees (B, T) targets
    def _var_len(key: str, feature: Optional[str]) -> int:
        if feature is not None:
            return T if (has_mel and feature == "frame_level") else L
        if has_mel and any(len(s[key]) != len(s["phonemes"]) for s in samples):
            return T
        return L

    batch = Batch(
        speaker_args=speaker_args,
        texts=pad_1d([s["phonemes"] for s in samples], L, dtype=np.int32),
        src_lens=np.minimum(src_lens, L),
        mels=(pad_2d([s["mel"] for s in samples], T) if has_mel
              else np.zeros((len(samples), T, 80), np.float32)),
        mel_lens=np.minimum(mel_lens, T),
        pitches=pad_1d([s["pitch"] for s in samples],
                       _var_len("pitch", pitch_feature), dtype=np.float32)
        if has_mel else np.zeros((len(samples), L), np.float32),
        energies=pad_1d([s["energy"] for s in samples],
                        _var_len("energy", energy_feature), dtype=np.float32)
        if has_mel else np.zeros((len(samples), L), np.float32),
        durations=pad_1d([s["duration"] for s in samples], L, dtype=np.int32)
        if has_mel else np.zeros((len(samples), L), np.int32),
        lang_ids=np.array([s["lang_id"] for s in samples], dtype=np.int32),
    )
    meta = BatchMeta(
        ids=[s["id"] for s in samples],
        raw_texts=[s.get("text", "") for s in samples],
        symbol_id=samples[0].get("symbol_id"),
    )
    return meta, batch


def to_device(batch: Union[Batch, DvecRefs, SupInfo, tuple],
              device: Union[str, torch.device]):
    """The same NamedTuple (nested ones included: a `DvecRefs` as
    `speaker_args`, an `Episode`'s `SupInfo` and `Batch`es) with each numpy
    array as a tensor on `device` (dtypes kept); None and Python numbers
    (`SupInfo.n_symbols`) pass through. For a CUDA device each array is
    copied into pinned host memory and on to the card with `non_blocking`,
    on the calling thread's current stream, so a background thread can run
    ahead of the step."""
    device = torch.device(device)

    def put(x):
        if x is None or isinstance(x, (int, float)):
            return x
        if isinstance(x, tuple):
            return type(x)(*(put(f) for f in x))
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return put(batch)
