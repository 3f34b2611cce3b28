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
`write_raw_corpus` writes a raw corpus in the LJSpeech layout, with MFA-style
TextGrids, for the preprocessing tests and phase 13 of chip_smoke.py.
"""
from __future__ import annotations

import os
from typing import Tuple

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
                 frames=(24, 80), n_phones=(6, 14), n_slices=(2, 4), tune: int = 0,
                 unit_name: str = "") -> str:
    """Write corpus `name` under `root`: n_train + n_val utterances of
    `frames` mel frames and `n_phones` phonemes (inclusive ranges), the
    speakers in turn. Returns its data config path; with `tune` > 0 also a
    split of the first `tune` train utterances and its data config,
    `tune.yaml` beside it. With `unit_name`, also the frame-level
    `interpolate_pitch` and `energy` that pseudo-unit discovery averages
    (data/ssl_units.py) and `t2u.yaml`, the data config with a
    `target: unit_name` (the T2U family's)."""
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
        if unit_name:
            store.interpolate_pitch.save(np.repeat(180 + 40 * table[ph, 80], dur)
                                         .astype(np.float32), q)
            store.energy.save(np.repeat(50 + 20 * table[ph, 81], dur).astype(np.float32), q)
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
    if unit_name:
        configs["t2u.yaml"] = (configs["data.yaml"]
                               + f"target:\n  unit_name: {unit_name}\n")
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


def write_melgan_checkpoint(path: str, seed: int) -> None:
    """A melgan-neurips generator with torch's init under `seed`, saved in
    its released layout: the Generator's state_dict (`model.{i}.` keys) with
    every conv's weight as a weight-norm pair (weight_g over dim 0,
    weight_v)."""
    import torch
    from fscl_tpu_torch.models.melgan import MelGANGenerator

    torch.manual_seed(seed)
    sd = {}
    for k, v in MelGANGenerator().state_dict().items():
        if k.endswith(".weight") and v.dim() == 3:
            norm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
            sd[k[:-len("weight")] + "weight_g"] = norm.reshape(-1, 1, 1)
            sd[k[:-len("weight")] + "weight_v"] = v
        else:
            sd[k] = v
    torch.save(sd, path)


RAW_PHONES = ("HH", "AY1", "W", "ER1", "L", "D", "AH0", "N", "S", "IY1", "T", "R",
              "K", "AE1", "M", "OW1")


def textgrid(intervals, xmax: float) -> str:
    """A long-format TextGrid with one "phones" tier of (start, end, label)
    intervals, as MFA writes it."""
    body = "".join(
        f"        intervals [{i + 1}]:\n"
        f"            xmin = {a}\n            xmax = {b}\n"
        f"            text = \"{p}\"\n"
        for i, (a, b, p) in enumerate(intervals))
    return (
        'File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
        f"xmin = 0\nxmax = {xmax}\ntiers? <exists>\nsize = 1\nitem []:\n"
        "    item [1]:\n        class = \"IntervalTier\"\n"
        "        name = \"phones\"\n"
        f"        xmin = 0\n        xmax = {xmax}\n"
        f"        intervals: size = {len(intervals)}\n" + body)


def write_raw_corpus(root: str, n_utts: int, seed: int, seconds=(1.5, 10.0),
                     sr: int = SR) -> Tuple[str, str]:
    """Write a raw corpus in the LJSpeech layout under `root`: metadata.csv
    (`name|raw|normalized`), wavs/<name>.wav as 16-bit PCM at `sr`, and an
    MFA-style TextGrid per utterance under TextGrid/LJSpeech/. Each
    utterance lasts a uniform draw from `seconds`: a leading silence, phones
    of 60-200 ms, each a harmonic tone at its phone's F0 (70-400 Hz, jittered
    per utterance) over noise, with a 100-250 ms pause ("sp", low noise)
    after about one phone in six, and a trailing silence. Returns (the
    corpus root, the TextGrid directory to pass as --textgrid_dir)."""
    from fscl_tpu_torch.dsp.audio_io import save_wav

    rng = np.random.default_rng(seed)
    f0_of = dict(zip(RAW_PHONES, np.linspace(70.0, 400.0, len(RAW_PHONES))))
    tg_dir = os.path.join(root, "TextGrid")
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    os.makedirs(os.path.join(tg_dir, "LJSpeech"), exist_ok=True)
    lines = []
    for i in range(n_utts):
        name = f"LJ{seed:03d}-{i:04d}"
        total = float(rng.uniform(*seconds))
        jitter = float(rng.uniform(0.9, 1.1))
        t = float(rng.uniform(0.05, 0.2))
        intervals = [(0.0, t, "")]
        while t < total - 0.25:
            if len(intervals) > 2 and rng.random() < 1 / 6:
                dur, label = float(rng.uniform(0.1, 0.25)), "sp"
            else:
                dur, label = float(rng.uniform(0.06, 0.2)), str(rng.choice(RAW_PHONES))
            intervals.append((t, t + dur, label))
            t += dur
        if intervals[-1][2] == "sp":
            intervals[-1] = (intervals[-1][0], intervals[-1][1], str(rng.choice(RAW_PHONES)))
        xmax = max(total, t + 0.05)
        intervals.append((t, xmax, ""))
        n = int(xmax * sr)
        wav = 0.003 * rng.standard_normal(n)
        for a, b, label in intervals:
            if label in ("", "sp"):
                continue
            s0, s1 = int(a * sr), int(b * sr)
            f0 = f0_of[label] * jitter
            tt = np.arange(s1 - s0) / sr
            tone = sum(np.sin(2 * np.pi * f0 * h * tt + h) / h for h in (1, 2, 3))
            ramp = np.minimum(1.0, np.minimum(tt, tt[::-1]) / 0.01)
            wav[s0:s1] += 0.3 * tone * ramp + 0.02 * rng.standard_normal(s1 - s0)
        save_wav(os.path.join(root, "wavs", f"{name}.wav"), (0.9 * wav / np.abs(wav).max())
                 .astype(np.float32), sr)
        with open(os.path.join(tg_dir, "LJSpeech", f"{name}.TextGrid"), "w") as f:
            f.write(textgrid(intervals, xmax))
        words = " ".join(p.lower().rstrip("012") for _, _, p in intervals if p not in ("", "sp"))
        lines.append(f"{name}|{words}|{words}")
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return root, tg_dir
