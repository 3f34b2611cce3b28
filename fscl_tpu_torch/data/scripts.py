"""Corpus-glue scripts (reference scripts/ long tail); the port's own copy of
`fscl_tpu/data/scripts.py`, whose synthetic corpus runs the port's stage 2
on the device it is given.

- jsut_hts_to_textgrid: JSUT ships HTS-style full-context label files; this
  converts them to MFA-like TextGrids (scripts/jsut_hts2textgrid.py).
- prepare_hifigan_tune_data: dump (mel, wav) pairs for HiFi-GAN fine-tuning
  (scripts/hifigan_tune_prepare.py:11-40).
- merge_global_stats: corpus stats.json files -> global stats
  (scripts/gloabal_normalize_stats.py:7-24; see core.stats.merge_stats).
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fscl_tpu_torch.core.stats import GlobalStats, merge_stats
from fscl_tpu_torch.data.feature_store import FeatureStore, write_queries_to_txt

_HTS_TIME_UNIT = 1e-7   # HTS label times are in 100 ns units


def parse_hts_labels(path: str) -> List[Tuple[float, float, str]]:
    """HTS full-context label lines `start end context` -> (s, e, phone);
    the phoneme is the `-x+` segment of the context string."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 3:
                continue
            start, end, context = parts[0], parts[1], parts[2]
            m = re.search(r"-(.+?)\+", context)
            phone = m.group(1) if m else context
            out.append((float(start) * _HTS_TIME_UNIT,
                        float(end) * _HTS_TIME_UNIT, phone))
    return out


def jsut_hts_to_textgrid(label_path: str, output_path: str) -> None:
    intervals = parse_hts_labels(label_path)
    if not intervals:
        raise ValueError(f"no labels in {label_path}")
    xmax = intervals[-1][1]
    body = []
    for i, (s, e, p) in enumerate(intervals):
        text = "" if p in ("sil", "pau") else p
        body.append(
            f"        intervals [{i+1}]:\n"
            f"            xmin = {s}\n            xmax = {e}\n"
            f"            text = \"{text}\"\n")
    content = (
        'File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
        f"xmin = 0\nxmax = {xmax}\ntiers? <exists>\nsize = 1\nitem []:\n"
        "    item [1]:\n        class = \"IntervalTier\"\n"
        "        name = \"phones\"\n"
        f"        xmin = 0\n        xmax = {xmax}\n"
        f"        intervals: size = {len(intervals)}\n" + "".join(body))
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        f.write(content)


def prepare_hifigan_tune_data(
    store: FeatureStore,
    queries: Sequence[dict],
    output_dir: str,
) -> int:
    """Dump (mel.npy, wav.npy) pairs for vocoder fine-tuning on this
    corpus's (possibly synthesized) mels."""
    os.makedirs(output_dir, exist_ok=True)
    n = 0
    for q in queries:
        if not (store.mel.exists(q) and store.wav_trim_22050.exists(q)):
            continue
        key = f"{q['spk']}-{q['basename']}"
        np.save(os.path.join(output_dir, f"{key}-mel.npy"),
                store.mel.read_from_query(q))
        np.save(os.path.join(output_dir, f"{key}-wav.npy"),
                store.wav_trim_22050.read_from_query(q))
        n += 1
    return n


def merge_global_stats(stats_paths: Sequence[str],
                       output_path: Optional[str] = None) -> GlobalStats:
    per_corpus = {}
    for p in stats_paths:
        with open(p) as f:
            per_corpus[p] = json.load(f)
    merged = merge_stats(per_corpus)
    if output_path:
        merged.to_json(output_path)
    return merged


def prepare_mfa_corpus(store, mfa_data_dir: str, queries=None,
                       sr: int = 16000) -> int:
    """Stage the corpus for the external `mfa align` CLI: per-speaker
    directories of <basename>.wav + <basename>.txt transcript pairs
    (reference Preprocessor.prepare_mfa, Parsers/css10.py:82-103 — there
    via hard links to raw wavs; here wavs are materialized from the 16 kHz
    feature store since features live as arrays)."""
    import numpy as np

    from fscl_tpu_torch.dsp.audio_io import save_wav

    queries = queries if queries is not None else store.load_metadata()
    n = 0
    for q in queries:
        query = {"spk": q["spk"], "basename": q["basename"]}
        if not store.wav_16000.exists(query):
            continue
        text = store.text.read_from_query(query)
        if not text:
            continue
        spk_dir = os.path.join(mfa_data_dir, q["spk"])
        os.makedirs(spk_dir, exist_ok=True)
        wav = np.asarray(store.wav_16000.read_from_query(query))
        save_wav(os.path.join(spk_dir, q["basename"] + ".wav"), wav, sr)
        with open(os.path.join(spk_dir, q["basename"] + ".txt"), "w",
                  encoding="utf-8") as f:
            f.write(str(text))
        n += 1
    return n


def build_korean_lexicon(store_or_texts, output_path: str) -> int:
    """Generate an MFA pronunciation lexicon for Korean with the KoG2P rule
    engine, word -> space-joined phones (reference: scripts/kss.py:22-38
    builds lexicon/kss-lexicon.txt from the transcript via g2p_ko).

    Accepts a FeatureStore (reads every stored transcript) or an iterable
    of raw text strings. Returns the number of lexicon entries written.
    """
    import re

    from fscl_tpu_torch.frontend.kog2p import g2p_ko_string

    if hasattr(store_or_texts, "load_metadata"):
        store = store_or_texts
        texts = (str(store.text.read_from_query(
            {"spk": q["spk"], "basename": q["basename"]}) or "")
            for q in store.load_metadata())
    else:
        texts = store_or_texts
    lexicon = {}
    for text in texts:
        for word in re.sub(r"[^가-힣\s]", "", text).split():
            if word and word not in lexicon:
                phones = g2p_ko_string(word)
                if phones:
                    lexicon[word] = phones
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        for word, phones in lexicon.items():
            f.write(f"{word}\t{phones}\n")
    return len(lexicon)


def mfa_align_command(mfa_data_dir: str, dictionary_path: str,
                      acoustic_model_path: str, output_dir: str,
                      n_jobs: int = 8) -> str:
    """The `mfa align` invocation the reference issues after prepare_mfa
    (Parsers/css10.py:105-111). MFA stays an external stage; this returns
    the exact command for the user (or an orchestrator) to run."""
    return (f"mfa align {mfa_data_dir} {dictionary_path} "
            f"{acoustic_model_path} {output_dir} -j {n_jobs} -v --clean")


def synthetic_textgrid(phones: Sequence[str], seg_dur: float = 0.12,
                       lead: float = 0.05) -> str:
    """ooTextFile LONG-format TextGrid with one interval per phone — the
    format the dsp.textgrid parser ingests (MFA's output format)."""
    xmax = lead + len(phones) * seg_dur + 0.05
    intervals = [(0.0, lead, "")]
    t = lead
    for p in phones:
        intervals.append((t, t + seg_dur, p))
        t += seg_dur
    intervals.append((t, xmax, ""))
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


def _corpus_cache_version() -> str:
    """Content hash of the source files whose behavior the cached corpus
    depends on — a code change to generation or preprocessing invalidates
    every cache entry automatically."""
    import hashlib
    h = hashlib.sha256()
    here = os.path.dirname(os.path.abspath(__file__))
    for rel in (os.path.join(here, "scripts.py"),
                os.path.join(here, "feature_store.py"),
                os.path.join(here, "..", "dsp", "preprocess.py")):
        with open(rel, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _write_corpus_yaml(root: str, name: str, lang_id: int,
                       symbol_id: str) -> str:
    """data.yaml carries the ABSOLUTE store root, so it is regenerated at
    the corpus's final location (generation and cache-restore paths)."""
    cfg_path = os.path.join(root, "data.yaml")
    with open(cfg_path, "w") as f:
        f.write(
            f"name: {name}\nlang_id: {lang_id}\nsymbol_id: {symbol_id}\n"
            f"data_dir: {os.path.join(root, 'features')}\n"
            "text_cleaners: [basic_cleaners]\n"
            "subsets:\n  train: splits/train.txt\n  val: splits/val.txt\n")
    return cfg_path


def make_synthetic_corpus(
    root: str,
    name: str = "synthetic",
    n_utts: int = 12,
    seed: int = 0,
    phones: Sequence[str] = ("HH", "AY1", "W", "ER1", "L", "D", "AH0", "N"),
    n_phones_per_utt: int = 6,
    lang_id: int = 0,
    symbol_id: str = "en",
    val_frac: float = 0.25,
    f0_base: float = 140.0,
    cache_dir: Optional[str] = None,
    device=None,
) -> str:
    """Build a fully-preprocessed synthetic mini-corpus (wavs with
    per-phone carrier frequencies + long-format TextGrids, run through the
    REAL preprocessing stages) and return the path of its data-config
    yaml. The acoustics are a deterministic function of the phone
    sequence, so phoneme->acoustic mappings are learnable — the fixture
    for end-to-end rehearsals and CLI tests.

    With `cache_dir`, the fully-preprocessed corpus tree is persisted
    under a content-hash key (all generation parameters + a hash of the
    generating source files) and restored by copy on later runs: the
    output is a pure function of these arguments. The device passes of stage 2 run on `device` (default cuda)."""
    from fscl_tpu_torch.dsp.audio_io import save_wav
    from fscl_tpu_torch.dsp.preprocess import (
        compute_stats, prepare_initial_features,
        preprocess_utterances_batched,
    )

    if cache_dir:
        import hashlib
        import shutil
        key_src = json.dumps({
            "name": name, "n_utts": n_utts, "seed": seed,
            "phones": list(phones), "n_phones_per_utt": n_phones_per_utt,
            "lang_id": lang_id, "symbol_id": symbol_id,
            "val_frac": val_frac, "f0_base": f0_base,
            "version": _corpus_cache_version()}, sort_keys=True)
        key = hashlib.sha256(key_src.encode()).hexdigest()[:24]
        entry = os.path.join(cache_dir, key)
        if os.path.exists(os.path.join(entry, "COMPLETE")):
            shutil.copytree(entry, root, dirs_exist_ok=True)
            os.remove(os.path.join(root, "COMPLETE"))
            return _write_corpus_yaml(root, name, lang_id, symbol_id)

    os.makedirs(root, exist_ok=True)
    store = FeatureStore(os.path.join(root, "features"))
    rng = np.random.default_rng(seed)
    sr = 22050
    seg = 0.12
    # per-phone carrier: acoustics correlate with phone identity
    freqs = {p: f0_base + 35.0 * i for i, p in enumerate(phones)}

    queries, items = [], []
    for i in range(n_utts):
        utt_phones = [phones[int(j)] for j in
                      rng.integers(0, len(phones), n_phones_per_utt)]
        dur = 0.05 + n_phones_per_utt * seg + 0.05
        n = int(sr * dur)
        wav = 0.03 * rng.normal(size=n).astype(np.float32)
        for k, p in enumerate(utt_phones):
            a, b = int(sr * (0.05 + k * seg)), int(sr * (0.05 + (k + 1) * seg))
            t = np.arange(b - a) / sr
            wav[a:b] += (0.4 * np.sin(2 * np.pi * freqs[p] * t)
                         + 0.1 * np.sin(2 * np.pi * 2 * freqs[p] * t)
                         ).astype(np.float32)
        wav_path = os.path.join(root, f"u{i}.wav")
        save_wav(wav_path, wav, sr)
        tg_path = os.path.join(root, f"u{i}.TextGrid")
        with open(tg_path, "w") as f:
            f.write(synthetic_textgrid(utt_phones, seg))
        q = {"spk": "spk0", "basename": f"u{i}"}
        prepare_initial_features(store, q, wav_path, " ".join(utt_phones))
        queries.append(q)
        items.append((q, tg_path))
    # batched device passes (one mel/STFT pass per wav bucket batch)
    samples, ok = preprocess_utterances_batched(store, items, device=device)
    assert len(ok) == n_utts, \
        f"synthetic corpus: {n_utts - len(ok)} utterances failed preprocessing"
    compute_stats(samples, store)
    store.save_speakers(["spk0"])
    store.flush()

    splits_dir = os.path.join(root, "splits")
    os.makedirs(splits_dir, exist_ok=True)
    n_val = max(1, int(n_utts * val_frac))
    write_queries_to_txt(store, queries[n_val:],
                         os.path.join(splits_dir, "train.txt"))
    write_queries_to_txt(store, queries[:n_val],
                         os.path.join(splits_dir, "val.txt"))

    cfg_path = _write_corpus_yaml(root, name, lang_id, symbol_id)
    if cache_dir:
        import shutil
        os.makedirs(cache_dir, exist_ok=True)
        tmp = entry + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        shutil.copytree(root, tmp)
        with open(os.path.join(tmp, "COMPLETE"), "w") as f:
            f.write(key_src)
        # atomic publish: a concurrent run either sees the COMPLETE entry
        # or regenerates — never a half-written tree
        if not os.path.exists(entry):
            os.replace(tmp, entry)
        else:
            shutil.rmtree(tmp)
    return cfg_path
