"""A preprocessed corpus written from a seed, for the port's data, CLI and
card tests and for phase 12 of chip_smoke.py, which writes it at full size
(JAX-free: tests/test_torch_cuda.py and chip_smoke.py import it).

`write_corpus` writes a feature store in the layout of
`fscl_tpu/data/feature_store.py` with every feature the datasets read
(`data/datasets.py:63-150`: mfa_duration, frames at hop 256 / 22.05 kHz
summing to the mel's T; mel (T, 80); the phoneme-averaged pitch and energy;
phoneme and text; for FSCL mfa_segment, the phonemes' boundaries in seconds,
and wav_trim_16000, the 16 kHz wav of the same length; for d-vector models
spk_ref_mel_slices of 160 x 40), speakers.json, data_info.json and
stats.json, the train and val split files and a data config YAML. Targets
follow a per-phoneme table plus noise, so that training lowers the loss.
`write_hifigan_checkpoint` writes a HiFi-GAN V1 generator checkpoint.
"""
from __future__ import annotations

import os

import numpy as np

from fscl_tpu_torch.data.feature_store import FeatureStore, write_queries_to_txt
from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS

SR, HOP, SSL_SR = 22050, 256, 16000
MODEL_YAML = (
    "transformer:\n  encoder_layer: 1\n  decoder_layer: 1\n"
    "  encoder_hidden: 32\n  decoder_hidden: 32\n"
    "  conv_filter_size: 32\n  encoder_head: 2\n  decoder_head: 2\n"
    "  encoder_dropout: 0.0\n  decoder_dropout: 0.0\n"
    "variance_predictor:\n  filter_size: 32\n  dropout: 0.0\n"
    "variance_embedding:\n  n_bins: 16\n"
    "speaker:\n  n_speakers: 2\n"
    "max_seq_len: 256\n")
# a tiny custom upstream (models/hubert.py:make_upstream): 2 layers of 32
FSCL_MODEL_YAML = MODEL_YAML + (
    "upstream:\n  name: tiny\n  dim: 32\n  n_layers: 3\n"
    "codebook:\n  size: 8\n  nhead: 2\n")


def phones(symbol_id: str):
    """The language's phoneme names (its '@' symbols without the '@')."""
    return [s[1:] for s in LANG_ID2SYMBOLS[symbol_id]
            if s.startswith("@") and s not in ("@sp", "@spn", "@sil")]


def write_corpus(root: str, name: str, symbol_id: str, lang_id: int, seed: int,
                 n_train: int = 8, n_val: int = 4, speakers=("spkA", "spkB"),
                 frames=(24, 80), n_phones=(6, 14), n_slices=(2, 4), tune: int = 0) -> str:
    """Write corpus `name` under `root`: n_train + n_val utterances of
    `frames` mel frames and `n_phones` phonemes (inclusive ranges), the
    speakers in turn. Returns its data config path; with `tune` > 0 also a
    split of the first `tune` train utterances and its data config,
    `tune.yaml` beside it."""
    rng = np.random.default_rng(seed)
    inventory = phones(symbol_id)
    table = np.random.default_rng(seed + 1).normal(size=(len(inventory), 82))
    store = FeatureStore(os.path.join(root, name, "features"))
    queries = []
    for i in range(n_train + n_val):
        q = {"spk": speakers[i % len(speakers)], "basename": f"{name}-{i:03d}"}
        T = int(rng.integers(frames[0], frames[1] + 1))
        n = int(rng.integers(n_phones[0], n_phones[1] + 1))
        ph = rng.integers(0, len(inventory), n)
        dur = 1 + rng.multinomial(T - n, rng.dirichlet(np.ones(n)))
        frame_ph = np.repeat(ph, dur)
        mel = table[frame_ph, :80] + 0.1 * rng.normal(size=(T, 80))
        store.mel.save(mel.astype(np.float32), q)
        store.mfa_duration.save(dur.astype(np.int64), q)
        store.mfa_duration_avg_pitch.save(
            (180 + 40 * table[ph, 80] + 5 * rng.normal(size=n)).astype(np.float32), q)
        store.mfa_duration_avg_energy.save(
            (50 + 20 * table[ph, 81] + 2 * rng.normal(size=n)).astype(np.float32), q)
        ends = np.cumsum(dur) * HOP / SR
        store.mfa_segment.save([[float(a), float(b)] for a, b in
                                zip(np.concatenate([[0.0], ends[:-1]]), ends)], q)
        n_wav = int(round(ends[-1] * SSL_SR))
        store.wav_trim_16000.save((0.1 * rng.normal(size=n_wav)).astype(np.float32), q)
        k = int(rng.integers(n_slices[0], n_slices[1] + 1))
        store.spk_ref_mel_slices.save(rng.normal(size=(k, 160, 40)).astype(np.float32), q)
        store.phoneme.save(" ".join(inventory[j] for j in ph), q)
        store.text.save(f"utterance {i} of {name}", q)
        queries.append(q)
    store.flush()
    store.save_metadata(queries)
    store.save_speakers(sorted(set(speakers)))
    with open(store.stats_path, "w") as f:
        f.write('{"pitch": [60.0, 400.0, 180.0, 40.0], "energy": [0.0, 120.0, 50.0, 20.0]}')
    split_dir = os.path.join(root, name, "splits")
    write_queries_to_txt(store, queries[:n_train], os.path.join(split_dir, "train.txt"))
    write_queries_to_txt(store, queries[n_train:], os.path.join(split_dir, "val.txt"))
    configs = {"data.yaml": "  train: splits/train.txt\n  val: splits/val.txt\n"}
    if tune:
        write_queries_to_txt(store, queries[:tune], os.path.join(split_dir, "tune.txt"))
        configs["tune.yaml"] = "  train: splits/tune.txt\n"
    for config, subsets in configs.items():
        with open(os.path.join(root, name, config), "w") as f:
            f.write(f"name: {name}\nlang_id: {lang_id}\nsymbol_id: {symbol_id}\n"
                    f"data_dir: {store.root}\ntext_cleaners: [basic_cleaners]\n"
                    f"subsets:\n{subsets}")
    return os.path.join(root, name, "data.yaml")


def write_hifigan_checkpoint(path: str, seed: int) -> None:
    """A HiFi-GAN V1 generator with torch's init under `seed`, saved in the
    official layout: `{"generator": state_dict}` with every conv's weight as
    a weight-norm pair (weight_g, weight_v)."""
    import torch
    from fscl_tpu_torch.models.hifigan import HiFiGANGenerator

    torch.manual_seed(seed)
    sd = {}
    for k, v in HiFiGANGenerator().state_dict().items():
        if k.endswith(".weight") and v.dim() == 3:
            norm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
            sd[k[:-len("weight")] + "weight_g"] = norm.reshape(-1, 1, 1)
            sd[k[:-len("weight")] + "weight_v"] = v
        else:
            sd[k] = v
    torch.save({"generator": sd}, path)
