"""Shared preprocessing pipeline (Parsers/template.py:20-129 equivalent; the
port of `fscl_tpu/dsp/preprocess.py`).

Stages per utterance:
  1. prepare_initial_features: load wav at 22.05 k + 16 k, peak-normalize,
     store text (template.py:20-27).
  2. preprocess: TextGrid -> segments + phonemes; trim wavs to the voiced
     span; wav -> log-mel/energy (torch, batched on the device) + pitch
     (host C++ or numpy, or batched YIN / DIO on the device) + interpolated
     pitch; segments -> durations; duration-averaged pitch/energy;
     speaker-reference mel slices for the d-vector path; corpus stats.json
     (template.py:30-100).
  3. split datasets -> train/val/test txt files (template.py:103-129).

Device work is grouped by wav-length bucket (`WAV_BUCKETS`, `DVEC_BUCKETS`)
in batches of `device_batch`: one mel + energy (+ F0) pass per batch on the
22.05 kHz trims and one d-vector STFT pass per batch on the 16 kHz trims.
Every batch of a chunk is launched before any result is read; on the card
the wavs go up from pinned buffers and the results come back into pinned
buffers, with one synchronize per chunk.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fscl_tpu_torch.core.config import AudioConfig
from fscl_tpu_torch.data.batch import bucket_len
from fscl_tpu_torch.data.feature_store import FeatureStore, write_queries_to_txt
from fscl_tpu_torch.dsp.audio_io import load_wav, wav_normalization
from fscl_tpu_torch.dsp.pitch import PITCH_METHODS, extract_pitch, interpolate_f0
from fscl_tpu_torch.dsp.pitch_device import yin_f0_batched
from fscl_tpu_torch.dsp.textgrid import textgrid_to_segments_and_phonemes
from fscl_tpu_torch.dsp.world_device import world_f0_batched
from fscl_tpu_torch.ops.stft import mel_filterbank_tensor, mel_spectrogram, stft_magnitude

# d-vector slicing constants (resemblyzer contract: 16 kHz, 40-mel,
# 10 ms hop, ~1.6 s partials with 50% overlap)
DVEC_SR = 16000
DVEC_MEL = 40
DVEC_HOP = 160
DVEC_WIN = 400
PARTIAL_FRAMES = 160
PARTIAL_HOP = 80

WAV_BUCKETS = tuple(22050 * s for s in (2, 4, 6, 8, 10, 12, 15, 20))
DVEC_BUCKETS = tuple(16000 * s for s in (2, 4, 6, 8, 10, 12, 15, 20))
DEVICE_PITCH = {"world_device": world_f0_batched, "yin_device": yin_f0_batched}


def prepare_initial_features(store: FeatureStore, query, wav_path: str,
                             text: str, audio: AudioConfig = AudioConfig()):
    wav22 = wav_normalization(load_wav(wav_path, audio.sampling_rate))
    wav16 = wav_normalization(load_wav(wav_path, audio.ssl_sampling_rate))
    store.wav_22050.save(wav22, query)
    store.wav_16000.save(wav16, query)
    store.text.save(text, query)


def mel_energy_pitch(wavs: torch.Tensor, lengths: Optional[torch.Tensor],
                     audio: AudioConfig, pitch_method: Optional[str] = None):
    """One bucket batch on its device: (B, T) padded 22.05 kHz wavs ->
    log-mel (B, F, n_mels), energy (B, F) and, for a device pitch method,
    F0 (B, F) (else None)."""
    mel, energy = mel_spectrogram(
        wavs, sr=audio.sampling_rate, n_fft=audio.n_fft, hop_length=audio.hop_length,
        win_length=audio.win_length, n_mels=audio.n_mels, fmin=audio.mel_fmin,
        fmax=audio.mel_fmax)
    f0 = None
    if pitch_method in DEVICE_PITCH:
        f0 = DEVICE_PITCH[pitch_method](wavs, lengths, sr=audio.sampling_rate,
                                        hop_length=audio.hop_length)
    return mel, energy, f0


def dvec_mel(wavs: torch.Tensor) -> torch.Tensor:
    """The d-vector 40-mel log spectrogram of (..., T) 16 kHz wavs on their
    device (resemblyzer's STFT: 400-sample window, 10 ms hop)."""
    fb = mel_filterbank_tensor(DVEC_SR, DVEC_WIN, DVEC_MEL, 0.0, DVEC_SR / 2, wavs.device)
    mag = stft_magnitude(wavs, n_fft=DVEC_WIN, hop_length=DVEC_HOP, win_length=DVEC_WIN)
    return torch.log(torch.clamp(mag @ fb.T, min=1e-10))


def _padded(wav: np.ndarray, buckets) -> Tuple[torch.Tensor, int]:
    n = len(wav)
    padded = np.zeros((1, bucket_len(n, buckets)), np.float32)
    padded[0, :n] = wav
    return torch.from_numpy(padded), n


def mel_energy_from_wav(wav: np.ndarray, audio: AudioConfig, device=None):
    """Log-mel + energy of one wav on `device` (default cuda), padded to its
    wav bucket; the padded frames are sliced off."""
    from fscl_tpu_torch.core.device import resolve_device
    padded, n = _padded(wav, WAV_BUCKETS)
    mel, energy, _ = mel_energy_pitch(padded.to(resolve_device(device)), None, audio)
    n_frames = 1 + n // audio.hop_length
    return mel[0, :n_frames].cpu().numpy(), energy[0, :n_frames].cpu().numpy()


def _dvec_slices_from_mel(mel: np.ndarray) -> np.ndarray:
    """Host tail of the d-vector feature: partial slicing only
    (resemblyzer contract: ~1.6 s partials, 50% overlap)."""
    n = mel.shape[0]
    if n < PARTIAL_FRAMES:
        mel = np.pad(mel, ((0, PARTIAL_FRAMES - n), (0, 0)))
        n = PARTIAL_FRAMES
    starts = list(range(0, n - PARTIAL_FRAMES + 1, PARTIAL_HOP)) or [0]
    return np.stack([mel[s: s + PARTIAL_FRAMES] for s in starts]).astype(np.float32)


def dvec_mel_slices(wav16: np.ndarray, device=None) -> np.ndarray:
    """Speaker-reference 40-mel slices (spk_ref_mel_slices feature):
    resemblyzer-style partial utterances for GE2E averaging. The STFT runs
    on `device` (default cuda), padded to the wav's bucket."""
    from fscl_tpu_torch.core.device import resolve_device
    padded, n = _padded(wav16, DVEC_BUCKETS)
    mel = dvec_mel(padded.to(resolve_device(device)))[0, :1 + n // DVEC_HOP]
    return _dvec_slices_from_mel(mel.cpu().numpy())


def _stage2_prepare(store: FeatureStore, query, textgrid_path: str,
                    audio: AudioConfig) -> Optional[Dict]:
    """Host half A of stage-2: TextGrid parse + wav reads + trims.
    Returns a record for the device stage, or None on sanity failure."""
    segments, phonemes = textgrid_to_segments_and_phonemes(textgrid_path)
    if not segments:
        return None
    t0, t1 = segments[0][0], segments[-1][1]

    wav22 = store.wav_22050.read_from_query(query)
    wav16 = store.wav_16000.read_from_query(query)
    trim22 = wav22[int(t0 * audio.sampling_rate): int(t1 * audio.sampling_rate)]
    trim16 = wav16[int(t0 * audio.ssl_sampling_rate): int(t1 * audio.ssl_sampling_rate)]
    if len(trim22) < audio.n_fft:
        return None

    # re-zero segments to the trimmed origin
    segments = [(s - t0, e - t0) for s, e in segments]
    return {"query": query, "trim22": trim22, "trim16": trim16,
            "segments": segments, "phonemes": phonemes}


def preprocess_utterance(
    store: FeatureStore, query, textgrid_path: str,
    audio: AudioConfig = AudioConfig(),
    pitch_method: str = "world",
    device=None,
) -> Optional[Dict[str, float]]:
    """Full per-utterance stage-2 (device work on `device`, default cuda):
    returns pitch/energy samples for stats, or None if the utterance fails
    sanity checks."""
    rec = _stage2_prepare(store, query, textgrid_path, audio)
    if rec is None:
        return None
    mel, energy = mel_energy_from_wav(rec["trim22"], audio, device)
    dvec = dvec_mel_slices(rec["trim16"], device)
    if pitch_method in DEVICE_PITCH:
        rec["pitch"] = extract_pitch(rec["trim22"], audio.sampling_rate, audio.hop_length,
                                     method=pitch_method, device=device)
    return _stage2_finish(store, rec, mel, energy, dvec, audio, pitch_method)


def _stage2_finish(store: FeatureStore, rec: Dict, mel, energy, dvec,
                   audio: AudioConfig,
                   pitch_method: str) -> Optional[Dict[str, float]]:
    """Host half B of stage-2: pitch, durations, averages, saves."""
    query, trim22, trim16 = rec["query"], rec["trim22"], rec["trim16"]
    segments, phonemes = rec["segments"], rec["phonemes"]
    if "pitch" in rec:                 # computed by the device pass
        pitch = rec["pitch"]
    else:
        pitch = extract_pitch(trim22, audio.sampling_rate, audio.hop_length,
                              method=pitch_method)
    n = min(len(mel), len(pitch), len(energy))
    mel, pitch, energy = mel[:n], pitch[:n], energy[:n]
    interp_pitch, _ = interpolate_f0(pitch)

    fp = audio.hop_length / audio.sampling_rate
    durations = []
    pos = 0.0
    for s, e in segments:
        d = int(round(e / fp)) - int(round(pos / fp))
        durations.append(max(d, 0))
        pos = e
    total = sum(durations)
    if total > n:
        # clamp the last segments into the available frames
        overflow = total - n
        for i in range(len(durations) - 1, -1, -1):
            take = min(durations[i], overflow)
            durations[i] -= take
            overflow -= take
            if overflow == 0:
                break
        total = sum(durations)

    # duration-averaged pitch/energy (phoneme level)
    avg_pitch, avg_energy = [], []
    pos = 0
    for d in durations:
        if d > 0:
            seg_pitch = interp_pitch[pos: pos + d]
            avg_pitch.append(float(np.mean(seg_pitch)))
            avg_energy.append(float(np.mean(energy[pos: pos + d])))
        else:
            avg_pitch.append(0.0)
            avg_energy.append(0.0)
        pos += d

    store.wav_trim_22050.save(trim22, query)
    store.wav_trim_16000.save(trim16, query)
    store.mel.save(mel.astype(np.float32), query)
    store.pitch.save(pitch.astype(np.float32), query)
    store.interpolate_pitch.save(interp_pitch.astype(np.float32), query)
    store.energy.save(energy.astype(np.float32), query)
    store.mfa_duration.save(np.asarray(durations, np.int64), query)
    store.mfa_duration_avg_pitch.save(np.asarray(avg_pitch, np.float32), query)
    store.mfa_duration_avg_energy.save(np.asarray(avg_energy, np.float32), query)
    store.mfa_segment.save([[float(s), float(e)] for s, e in segments], query)
    store.phoneme.save(" ".join(phonemes), query)
    store.spk_ref_mel_slices.save(dvec, query)

    voiced = pitch[pitch > 0]
    return {
        "pitch": voiced.tolist(),
        "energy": energy.tolist(),
    }


def preprocess_utterances_batched(
    store: FeatureStore,
    items: Sequence[Tuple[Dict, str]],
    audio: AudioConfig = AudioConfig(),
    pitch_method: str = "world",
    device_batch: int = 16,
    chunk_size: int = 256,
    on_error=None,
    device=None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[List[Dict[str, list]], List[Dict]]:
    """Stage-2 over many utterances with batched device passes on `device`
    (default cuda).

    Utterances are grouped by wav-length bucket and each group of
    `device_batch` runs as one batched pass (the frame/FFT ops take a
    leading batch dim). `items` = sequence of (query, textgrid_path).
    Per-utterance failures are isolated: `on_error(query, exception)` is
    called (default: print) and the rest proceed. Returns (stats_samples,
    ok_queries) in input order, the per-utterance loop's accounting. At most
    `chunk_size` utterances' wavs and features are held at once. With
    `timings`, the seconds spent in the host prepare, the device passes
    (launch to the chunk's synchronize) and the host finish are added under
    "prepare", "device" and "finish", the batches under "batches" and the
    mel (+ F0) batches among them under "mel_batches".
    """
    from fscl_tpu_torch.core.device import resolve_device

    if pitch_method not in PITCH_METHODS:
        raise ValueError(f"pitch method {pitch_method!r} not one of {PITCH_METHODS}")
    dev = resolve_device(device)

    def _report(q, e):
        if on_error is not None:
            on_error(q, e)
        else:
            print(f"[preprocess] failed {q}: {e}")

    stats_samples, ok_queries = [], []
    t = timings if timings is not None else {}
    for c in range(0, len(items), max(1, chunk_size)):
        s, q = _preprocess_chunk_batched(
            store, items[c: c + chunk_size], audio, pitch_method,
            device_batch, _report, dev, t)
        stats_samples.extend(s)
        ok_queries.extend(q)
    return stats_samples, ok_queries


def _bucket_batches(lengths: Sequence[int], buckets, device_batch: int):
    """(bucket, indices) for each batch: indices grouped by wav bucket in
    order of first appearance, then cut into batches of device_batch."""
    groups: Dict[int, List[int]] = {}
    for i, n in enumerate(lengths):
        groups.setdefault(bucket_len(n, buckets), []).append(i)
    return [(bucket, idxs[c: c + device_batch]) for bucket, idxs in groups.items()
            for c in range(0, len(idxs), device_batch)]


def _upload(wavs: Sequence[np.ndarray], bucket: int, dev: torch.device):
    """The wavs zero-padded to (len(wavs), bucket) and their lengths on
    `dev`, through pinned buffers on the card; returns the device tensors and
    the host buffers, which must live until the copies are done."""
    pin = dev.type == "cuda"
    host = torch.zeros(len(wavs), bucket, pin_memory=pin)
    lens = torch.zeros(len(wavs), dtype=torch.int64, pin_memory=pin)
    h, ln = host.numpy(), lens.numpy()
    for row, w in enumerate(wavs):
        h[row, :len(w)] = w
        ln[row] = len(w)
    return (host.to(dev, non_blocking=True), lens.to(dev, non_blocking=True)), (host, lens)


def _download(x: torch.Tensor) -> torch.Tensor:
    """x copied into a new (pinned, on the card) host tensor, asynchronously."""
    if x.device.type == "cpu":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    return out


def _preprocess_chunk_batched(store, items, audio, pitch_method, device_batch, _report,
                              dev, timings):
    t0 = time.perf_counter()
    recs = []
    for query, tg_path in items:
        try:
            rec = _stage2_prepare(store, query, tg_path, audio)
        except Exception as e:  # ignore_errors=True semantics
            _report(query, e)
            continue
        if rec is not None:
            recs.append(rec)
    t1 = time.perf_counter()

    # launch every batch before reading any result: the host fills the next
    # batch while the device runs this one, and the copies back land in
    # pinned buffers read after one synchronize
    pending = []      # (kind, indices, host outputs, buffers kept alive)
    for bucket, chunk in _bucket_batches([len(r["trim22"]) for r in recs], WAV_BUCKETS,
                                         device_batch):
        (wavs, lens), keep = _upload([recs[i]["trim22"] for i in chunk], bucket, dev)
        mel, energy, f0 = mel_energy_pitch(wavs, lens, audio, pitch_method)
        outs = [_download(mel), _download(energy)] + ([_download(f0)] if f0 is not None
                                                      else [])
        pending.append(("mel", chunk, outs, keep))
    for bucket, chunk in _bucket_batches([len(r["trim16"]) for r in recs], DVEC_BUCKETS,
                                         device_batch):
        (wavs, _), keep = _upload([recs[i]["trim16"] for i in chunk], bucket, dev)
        pending.append(("dvec", chunk, [_download(dvec_mel(wavs))], keep))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()

    for kind, chunk, outs, _ in pending:
        outs = [o.numpy() for o in outs]
        for row, i in enumerate(chunk):
            if kind == "mel":
                nf = 1 + len(recs[i]["trim22"]) // audio.hop_length
                recs[i]["mel"] = outs[0][row, :nf]
                recs[i]["energy"] = outs[1][row, :nf]
                if len(outs) > 2:
                    recs[i]["pitch"] = outs[2][row, :nf]
            else:
                nf = 1 + len(recs[i]["trim16"]) // DVEC_HOP
                recs[i]["dvec"] = _dvec_slices_from_mel(outs[0][row, :nf])
    n_batches = len(pending)
    n_mel = sum(kind == "mel" for kind, *_ in pending)
    del pending

    # host tail (pitch, durations, averages, saves) in input order
    stats_samples, ok_queries = [], []
    for rec in recs:
        try:
            s = _stage2_finish(store, rec, rec["mel"], rec["energy"],
                               rec["dvec"], audio, pitch_method)
        except Exception as e:
            _report(rec["query"], e)
            continue
        if s is not None:
            stats_samples.append(s)
            ok_queries.append(rec["query"])
    t3 = time.perf_counter()
    for key, dt in (("prepare", t1 - t0), ("device", t2 - t1), ("finish", t3 - t2),
                    ("batches", n_batches), ("mel_batches", n_mel)):
        timings[key] = timings.get(key, 0) + dt
    return stats_samples, ok_queries


def compute_stats(samples: List[Dict[str, list]], store: FeatureStore) -> dict:
    """Corpus stats.json: pitch/energy min/max/mean/std over all frames
    (voiced-only pitch), like get_stats in template.preprocess."""
    pitch = np.concatenate([np.asarray(s["pitch"]) for s in samples if s["pitch"]])
    energy = np.concatenate([np.asarray(s["energy"]) for s in samples])
    stats = {
        "pitch": [float(pitch.min()), float(pitch.max()),
                  float(pitch.mean()), float(pitch.std())],
        "energy": [float(energy.min()), float(energy.max()),
                   float(energy.mean()), float(energy.std())],
    }
    with open(store.stats_path, "w") as f:
        json.dump(stats, f, indent=4)
    return stats


def split_monospeaker_dataset(store: FeatureStore, queries, output_dir: str,
                              val_size: int = 400, test_size: int = 400):
    """(template.py:103-115): deterministic tail split."""
    train = queries[: -(val_size + test_size)] if len(queries) > val_size + test_size else queries
    val = queries[-(val_size + test_size): -test_size] if len(queries) > val_size + test_size else queries
    test = queries[-test_size:] if len(queries) > test_size else queries
    write_queries_to_txt(store, train, os.path.join(output_dir, "train.txt"))
    write_queries_to_txt(store, val, os.path.join(output_dir, "val.txt"))
    write_queries_to_txt(store, test, os.path.join(output_dir, "test.txt"))


def split_multispeaker_dataset(store: FeatureStore, queries, output_dir: str,
                               val_spk_frac: float = 0.05):
    """(template.py:118-129): hold out whole speakers for val/test."""
    spks = sorted({q["spk"] for q in queries})
    n_hold = max(1, int(len(spks) * val_spk_frac))
    val_spks = set(spks[-2 * n_hold: -n_hold])
    test_spks = set(spks[-n_hold:])
    train = [q for q in queries if q["spk"] not in val_spks | test_spks]
    val = [q for q in queries if q["spk"] in val_spks]
    test = [q for q in queries if q["spk"] in test_spks]
    write_queries_to_txt(store, train, os.path.join(output_dir, "train.txt"))
    write_queries_to_txt(store, val, os.path.join(output_dir, "val.txt"))
    write_queries_to_txt(store, test, os.path.join(output_dir, "test.txt"))
