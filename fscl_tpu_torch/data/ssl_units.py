"""Pseudo-unit discovery: the writer side of the `ssl_units/<name>` sub-store
(port of `fscl_tpu/data/ssl_units.py`: `label_propagate` `:21`,
`batched_ssl_extractor` `:50`, `generate_ssl_units` `:132`,
`kmeans_unit_labeler` `:203`).

Frame features (stored mels, or one hidden layer of an SSL upstream run on
the card) are clustered by k-means on the device; each utterance's frame
logits (negative squared distances to the centroids) are DPDP-decoded on
the host into unit segments, which the sub-store keeps with the durations,
the duration-averaged pitch and energy, and optionally the confidence
matrices a pseudo-label filter reads.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from fscl_tpu_torch.data.batch import bucket_len
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.eval.dpdp import dpdp_decode, dpdp_segment_to_time, merge_repeats
from fscl_tpu_torch.models.hubert import (
    init_random_, load_torch_checkpoint, make_upstream, ssl_num_frames,
)
from fscl_tpu_torch.nn.phoneme_embedding import kmeans, sq_distances
from fscl_tpu_torch.ops.masking import length_mask

SSL_WAV_BUCKETS = tuple(16000 * s for s in (2, 4, 6, 8, 10, 12, 15, 20))
DEVICE_BATCH = 8
MEL_FRAME_PERIOD = 256 / 22050


def label_propagate(probs: np.ndarray, n_iters: int = 2, alpha: float = 0.5,
                    window: int = 2) -> np.ndarray:
    """Label propagation over the temporal frame graph: each frame's class
    distribution is pulled toward its neighbours', weighted by their
    similarity, then mixed back with the original (P <- alpha W P +
    (1 - alpha) P0)."""
    P0 = P = probs
    T = len(probs)
    for _ in range(n_iters):
        acc = np.zeros_like(P)
        wsum = np.zeros((T, 1), P.dtype)
        for off in range(1, min(window, T - 1) + 1):
            w = (P[:-off] * P[off:]).sum(-1, keepdims=True)
            acc[:-off] += w * P[off:]
            wsum[:-off] += w
            acc[off:] += w * P[:-off]
            wsum[off:] += w
        smoothed = np.where(wsum > 0, acc / np.maximum(wsum, 1e-12), P)
        P = alpha * smoothed + (1.0 - alpha) * P0
        P = P / np.maximum(P.sum(-1, keepdims=True), 1e-12)
    return P


def batched_ssl_extractor(
    store: FeatureStore,
    queries: Sequence[dict],
    source: str = "hubert_base",
    layer: int = -1,
    device_batch: int = DEVICE_BATCH,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    cfg=None,
    device=None,
    seed: int = 0,
) -> Callable[[dict], torch.Tensor]:
    """One SSL layer's hidden states for every query, computed on `device`
    in wav-length buckets of `device_batch` utterances, every batch launched
    before any is read; returns `extract(q) -> (T', D)` float32 tensor in
    host memory. Each batch keeps only the chosen layer, copied to the host
    as it is launched (into pinned memory, without a wait, on the card), so
    the device holds one batch's upstream activations at a time whatever
    the corpus size. `state_dict`: upstream weights in any layout
    `models.hubert.load_torch_checkpoint` reads (a released HF, fairseq or
    s3prl checkpoint, or the port's keys from fscl_tpu params through
    `convert.hubert_state_dict`); without it the weights are drawn on the
    device from `seed` (`models.hubert.init_random_`)."""
    with torch.device("meta"):
        upstream = make_upstream(source, cfg)
    upstream = upstream.to_empty(device=device)
    if state_dict is not None:
        upstream.load_state_dict(load_torch_checkpoint(state_dict, upstream), strict=True)
    else:
        init_random_(upstream, torch.Generator(device=device).manual_seed(seed))
    upstream.requires_grad_(False).eval()
    layer_idx = layer if layer >= 0 else upstream.n_layers + 1 + layer

    wavs, groups = {}, {}
    for q in queries:
        w = np.asarray(store.wav_trim_16000.read_from_query(q)).astype(np.float32)
        key = (q["spk"], q["basename"])
        wavs[key] = w
        groups.setdefault(bucket_len(len(w), SSL_WAV_BUCKETS), []).append(key)

    pin = torch.device(device if device is not None else "cpu").type == "cuda"
    pending = []
    with torch.inference_mode():
        for bucket, keys in groups.items():
            for c in range(0, len(keys), device_batch):
                chunk = keys[c: c + device_batch]
                padded = np.zeros((device_batch, bucket), np.float32)
                lens = np.zeros(device_batch, np.int64)
                for row, k in enumerate(chunk):
                    padded[row, :len(wavs[k])] = wavs[k]
                    lens[row] = len(wavs[k])
                wb = torch.from_numpy(padded).to(device)
                vb = length_mask(torch.from_numpy(lens).to(device), bucket)
                h = upstream(wb, vb)[0][:, :, layer_idx, :]
                host = torch.empty(h.shape, dtype=h.dtype, pin_memory=pin)
                host.copy_(h, non_blocking=pin)
                pending.append((host, chunk, lens))
        if pin:
            torch.cuda.synchronize(device)

    table = {}
    for host, chunk, lens in pending:
        for row, k in enumerate(chunk):
            table[k] = host[row, :ssl_num_frames(int(lens[row]))]

    def extract(q):
        return table[(q["spk"], q["basename"])]

    return extract


def generate_ssl_units(
    store: FeatureStore,
    unit_name: str,
    frame_logits_fn: Callable[[dict], np.ndarray],   # query -> (T, n_units)
    queries: Optional[Sequence[dict]] = None,
    fp: float = 0.02,
    lam: float = 0.0,
    save_matrices: bool = True,
    lp_iters: int = 2,
    lp_alpha: float = 0.5,
) -> int:
    """Populate ssl_units/<unit_name> with segments, unit strings, durations
    and the duration-averaged pitch / energy; with `save_matrices`, also the
    cost matrices `alignment_matrix` (1 - softmax of the frame logits) and
    `lp_matrix` (1 - the label-propagated probabilities). A query without
    the features its logits need is skipped, as in fscl_tpu. Returns the
    utterances written."""
    unit_store = store.get_ssl_unit_store(unit_name)
    queries = queries if queries is not None else store.load_metadata()
    n_done = 0
    n_units = None
    for q in queries:
        try:
            logits = frame_logits_fn(q)
        except (KeyError, FileNotFoundError):
            continue
        logits = np.asarray(logits)
        n_units = logits.shape[-1]
        logp = logits - np.max(logits, axis=-1, keepdims=True)
        logp = logp - np.log(np.sum(np.exp(logp), -1, keepdims=True))
        segments, labels = merge_repeats(*dpdp_decode(logp, lam=lam))
        time_segments = dpdp_segment_to_time(segments, fp)
        unit_store.segment.save([[float(s), float(e)] for s, e in time_segments], q)
        unit_store.phoneme.save(" ".join(str(l) for l in labels), q)
        unit_store.duration.save(np.array([e - s for s, e in segments], np.int64), q)

        if save_matrices:
            probs = np.exp(logp)
            unit_store.alignment_matrix.save((1.0 - probs).astype(np.float32), q)
            lp = label_propagate(probs, n_iters=lp_iters, alpha=lp_alpha)
            unit_store.lp_matrix.save((1.0 - lp).astype(np.float32), q)

        if store.interpolate_pitch.exists(q) and store.energy.exists(q):
            # unit frames of `fp` s against mel frames of 256 / 22050 s
            pitch = np.asarray(store.interpolate_pitch.read_from_query(q))
            energy = np.asarray(store.energy.read_from_query(q))
            avg_p, avg_e = [], []
            for s, e in time_segments:
                i0 = int(s / MEL_FRAME_PERIOD)
                i1 = max(int(e / MEL_FRAME_PERIOD), i0 + 1)
                avg_p.append(float(pitch[i0:i1].mean()) if i0 < len(pitch) else 0.0)
                avg_e.append(float(energy[i0:i1].mean()) if i0 < len(energy) else 0.0)
            unit_store.duration_avg_pitch.save(np.asarray(avg_p, np.float32), q)
            unit_store.duration_avg_energy.save(np.asarray(avg_e, np.float32), q)
        n_done += 1
    unit_store.flush()
    if n_units is not None:
        unit_store.save_attrs({"n_units": int(n_units), "fp": fp})
    return n_done


def kmeans_unit_labeler(
    extract_features: Callable[[dict], object],   # query -> (T, D) numpy or tensor
    queries: Sequence[dict],
    n_units: int = 64,
    max_frames: int = 50000,
    seed: int = 0,
    device=None,
) -> Callable[[dict], np.ndarray]:
    """k-means over the queries' frames in order, up to `max_frames` (on
    `device`), then a frame-logit function: the negative squared distances
    to the centroids, (T, n_units) numpy."""
    def feats(q):
        return torch.as_tensor(extract_features(q), dtype=torch.float32, device=device)

    pool, total = [], 0
    for q in queries:
        pool.append(feats(q))
        total += len(pool[-1])
        if total >= max_frames:
            break
    centroids, _ = kmeans(torch.cat(pool)[:max_frames], n_units, seed=seed)

    def frame_logits(q):
        return (-sq_distances(feats(q), centroids)).cpu().numpy()

    return frame_logits
