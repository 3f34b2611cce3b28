"""Raw corpus parsers: 13 corpora -> feature store (the port's own copy of
`fscl_tpu/data/parsers.py`).

Re-provides Parsers/ (13 corpus parsers, SURVEY §2.2): each `walk_*`
generator yields (query, wav_path, text) from the public corpus layout
(layouts cited per function); `parse_corpus` drives metadata + initial
feature extraction (the reference's RawParser.parse + Pool.imap of
prepare_initial_features), and `Preprocessor` runs the offline stage-2
pipeline over MFA TextGrids. MFA alignment itself remains an external CLI
stage (`mfa align`), as in the reference (Parsers/css10.py:106-112).

The pool's workers only read, resample and save wavs on the host. They are
started with `spawn`, so that none inherits a CUDA context of the parent.
"""
from __future__ import annotations

import json
import os
import re
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

from fscl_tpu_torch.core.registry import RAW_PARSERS
from fscl_tpu_torch.data.feature_store import FeatureStore

WalkItem = Tuple[Dict[str, str], str, str]   # (query, wav_path, text)


def _reg(name):
    def deco(fn):
        RAW_PARSERS.add(name, fn)
        return fn
    return deco


@_reg("LJSpeech")
def walk_ljspeech(root: str) -> Iterator[WalkItem]:
    """metadata.csv lines `name|raw|normalized` + wavs/<name>.wav
    (Parsers/ljspeech.py:26-48)."""
    with open(os.path.join(root, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            wav_name, _, text = line.strip().split("|")
            if text and text[-1].isalpha():
                text += "."
            wav_path = os.path.join(root, "wavs", wav_name + ".wav")
            if os.path.isfile(wav_path):
                yield {"spk": "LJSpeech", "basename": wav_name}, wav_path, text


@_reg("LibriTTS")
def walk_libritts(root: str, dsets=("train-clean-100",)) -> Iterator[WalkItem]:
    """<dset>/<spk>/<chapter>/<name>.wav + .normalized.txt
    (Parsers/libritts.py:33-60)."""
    for dset in dsets:
        base = os.path.join(root, dset)
        if not os.path.isdir(base):
            continue
        for speaker in sorted(os.listdir(base)):
            for chapter in sorted(os.listdir(os.path.join(base, speaker))):
                cdir = os.path.join(base, speaker, chapter)
                for filename in sorted(os.listdir(cdir)):
                    if not filename.endswith(".wav"):
                        continue
                    basename = filename[:-4]
                    txt = os.path.join(cdir, basename + ".normalized.txt")
                    if not os.path.isfile(txt):
                        continue
                    with open(txt, encoding="utf-8") as f:
                        text = f.readline().strip()
                    yield ({"spk": speaker, "basename": basename},
                           os.path.join(cdir, filename), text)


@_reg("CSS10")
def walk_css10(root: str) -> Iterator[WalkItem]:
    """transcript.txt lines `path|raw|normalized|dur`; speaker tag from the
    language directory name (Parsers/css10.py:17-58)."""
    lang = os.path.basename(os.path.normpath(root))
    speakers = {"french": "css10-fr", "german": "css10-de",
                "spanish": "css10-es", "dutch": "css10-nl",
                "russian": "css10-ru", "japanese": "css10-jp"}
    speaker = speakers.get(lang, f"css10-{lang}")
    with open(os.path.join(root, "transcript.txt"), encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            wav_name, _, text, _ = line.strip().split("|")
            wav_path = os.path.join(root, wav_name)
            if os.path.isfile(wav_path):
                base = os.path.basename(wav_name)[:-4]
                yield ({"spk": speaker, "basename": f"{speaker}-{base}"},
                       wav_path, text)


@_reg("KSS")
def walk_kss(root: str) -> Iterator[WalkItem]:
    """transcript.v.1.4.txt `path|raw|text|...|en_text` (Parsers/kss.py:24-49)."""
    with open(os.path.join(root, "transcript.v.1.4.txt"), encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            wav_name, _, text, _, _, _ = line.strip().split("|")
            wav_path = os.path.join(root, wav_name)
            if os.path.isfile(wav_path):
                base = os.path.basename(wav_name)[:-4]
                yield {"spk": "kss", "basename": f"kss-{base}"}, wav_path, text


@_reg("JSUT")
def walk_jsut(root: str) -> Iterator[WalkItem]:
    """basic5000/transcript_utf8.txt `name:text` (Parsers/jsut.py:24-50)."""
    with open(os.path.join(root, "basic5000", "transcript_utf8.txt"),
              encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            basename, text = line.strip().split(":", 1)
            wav_path = os.path.join(root, "basic5000", "wav", basename + ".wav")
            if os.path.isfile(wav_path):
                yield {"spk": "jsut", "basename": basename}, wav_path, text


@_reg("AISHELL-3")
def walk_aishell3(root: str) -> Iterator[WalkItem]:
    """train/label_train-set.txt `name|pinyin|text`; speaker = name[:-4]
    (Parsers/aishell3.py:24-53)."""
    path = os.path.join(root, "train", "label_train-set.txt")
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i < 5 or not line.strip():
                continue
            wav_name, _, text = line.strip().split("|")
            text = text.replace("%", "").replace("$", "")
            speaker = wav_name[:-4]
            wav_path = os.path.join(root, "train", "wav", speaker,
                                    wav_name + ".wav")
            if os.path.isfile(wav_path):
                yield {"spk": speaker, "basename": wav_name}, wav_path, text


@_reg("CSMSC")
def walk_csmsc(root: str) -> Iterator[WalkItem]:
    """ProsodyLabeling/000001-010000.txt with #N prosody marks stripped
    (Parsers/csmsc.py:24-54)."""
    path = os.path.join(root, "ProsodyLabeling", "000001-010000.txt")
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip() or line[0] == "\t":
                continue
            wav_name, text = line.strip().split("\t")
            text = re.sub(r"#\d", "", text)
            wav_path = os.path.join(root, "Wave", wav_name + ".wav")
            if os.path.isfile(wav_path):
                yield ({"spk": "csmsc", "basename": f"csmsc-{wav_name}"},
                       wav_path, text)


@_reg("M-AILABS")
def walk_mailabs(root: str, lang: str = "") -> Iterator[WalkItem]:
    """by_book/{male,female}/<spk>/<book>/metadata.csv (+ fr_FR quirk:
    gender dirs at top level) (Parsers/m_ailabs.py:40-70)."""
    lang = lang or os.path.basename(os.path.normpath(root))
    if lang == "fr_FR":
        gender_dirs = [os.path.join(root, "male"), os.path.join(root, "female")]
    else:
        gender_dirs = [os.path.join(root, "by_book", g) for g in ("male", "female")]
    for gdir in gender_dirs:
        if not os.path.isdir(gdir):
            continue
        for speaker in sorted(os.listdir(gdir)):
            sdir = os.path.join(gdir, speaker)
            if not os.path.isdir(sdir):
                continue
            for book in sorted(os.listdir(sdir)):
                bdir = os.path.join(sdir, book)
                meta = os.path.join(bdir, "metadata.csv")
                if not os.path.isfile(meta):
                    continue
                with open(meta, encoding="utf-8") as f:
                    for line in f:
                        if not line.strip():
                            continue
                        wav_name, _, text = line.strip().split("|")
                        wav_path = os.path.join(bdir, "wavs", wav_name + ".wav")
                        if os.path.isfile(wav_path):
                            yield ({"spk": speaker, "basename": wav_name},
                                   wav_path, text)


@_reg("ALFFA")
def walk_alffa(root: str, lang: str = "sw") -> Iterator[WalkItem]:
    """Kaldi-style data dirs: data_broadcastnews_sw (speaker = basename[:15])
    / data_readspeech_am with utt2spk (Parsers/alffa.py:26-130)."""
    if lang == "sw":
        base = os.path.join(root, "data_broadcastnews_sw", "data")
        for split in ("train", "test"):
            sdir = os.path.join(base, split)
            text_path = os.path.join(sdir, "text")
            if not os.path.isfile(text_path):
                continue
            utt2spk = {}
            u2s = os.path.join(sdir, "utt2spk")
            if os.path.isfile(u2s):
                with open(u2s, encoding="utf-8") as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) == 2:
                            utt2spk[parts[0]] = parts[1]
            with open(text_path, encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    basename, text = parts
                    speaker = utt2spk.get(basename, basename[:15])
                    wav_path = os.path.join(sdir, "wav", speaker,
                                            basename + ".wav")
                    if os.path.isfile(wav_path):
                        yield ({"spk": speaker, "basename": basename},
                               wav_path, text)
    else:  # am / wo read-speech layout
        base = os.path.join(root, f"data_readspeech_{lang}", "data")
        for split in ("train", "test"):
            sdir = os.path.join(base, split)
            text_path = os.path.join(sdir, "text")
            if not os.path.isfile(text_path):
                continue
            utt2spk = {}
            with open(os.path.join(sdir, "utt2spk"), encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 2:
                        utt2spk[parts[0]] = parts[1]
            with open(text_path, encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split(maxsplit=1)
                    if len(parts) != 2:
                        continue
                    basename, text = parts
                    speaker = utt2spk.get(basename, basename)
                    wav_path = os.path.join(sdir, "wav", f"{basename}.wav")
                    if os.path.isfile(wav_path):
                        yield ({"spk": speaker, "basename": basename},
                               wav_path, text)


@_reg("GlobalPhone")
def walk_globalphone(root: str) -> Iterator[WalkItem]:
    """wav/<spk>_<id>.wav + corpus/<name>.lab (Parsers/globalphone.py)."""
    wav_dir = os.path.join(root, "wav")
    corpus_dir = os.path.join(root, "corpus")
    if not os.path.isdir(wav_dir):
        return
    for filename in sorted(os.listdir(wav_dir)):
        if not filename.endswith(".wav"):
            continue
        basename = filename[:-4]
        speaker = basename.split("_")[0]
        lab = os.path.join(corpus_dir, basename + ".lab")
        if not os.path.isfile(lab):
            continue
        with open(lab, encoding="utf-8") as f:
            text = f.readline().strip()
        yield ({"spk": speaker, "basename": basename.replace("_", "-")},
               os.path.join(wav_dir, filename), text)


@_reg("LAD")
def walk_lad(root: str, lang: str = "en") -> Iterator[WalkItem]:
    """Language Audio Database: 48000_orig wavs + <id>/<spk>/text.xml
    recording script (Parsers/lad.py:43-70). XML parsed with stdlib."""
    import xml.etree.ElementTree as ET
    wav_dir = os.path.join(root, "48000_orig")
    if not os.path.isdir(wav_dir):
        return
    first = sorted(os.listdir(wav_dir))[0]
    spk = first.split("_")[0]
    identifier = {"en": "en_us", "ko": "ko_kr"}.get(lang, lang)
    xml_path = os.path.join(root, identifier, spk, "text.xml")
    tree = ET.parse(xml_path)
    for node in tree.getroot().iter("fileid"):
        basename = node.get("id")
        text = (node.text or "").strip()
        if lang == "en":
            basename = f"{spk}_{basename}"
        wav_path = os.path.join(wav_dir, basename + ".wav")
        if os.path.isfile(wav_path):
            yield {"spk": spk, "basename": basename}, wav_path, text


@_reg("TAT_TTS")
def walk_tat_tts(root: str) -> Iterator[WalkItem]:
    """<spk>/<partition>/<name>.wav + .json with Tai-lo transcription.
    data_info carries spk/basename/partition (Parsers/TAT_TTS.py:12-37;
    the reference file is marked unfinished and calls a non-existent
    `os.isdir` — the partition-directory filter here is what that code
    intends)."""
    for speaker in sorted(os.listdir(root)):
        sdir = os.path.join(root, speaker)
        if not os.path.isdir(sdir):
            continue
        for partition in sorted(os.listdir(sdir)):
            pdir = os.path.join(sdir, partition)
            if not os.path.isdir(pdir):
                continue
            for filename in sorted(os.listdir(pdir)):
                if not filename.endswith(".wav"):
                    continue
                basename = filename[:-4]
                jpath = os.path.join(pdir, basename + ".json")
                if not os.path.isfile(jpath):
                    continue
                with open(jpath, encoding="utf-8") as f:
                    labels = json.load(f)
                text = labels.get("台羅數字調", "")
                yield ({"spk": speaker, "basename": basename,
                        "partition": partition},
                       os.path.join(pdir, filename), text)


def _prep_one(args):
    root, query, wav_path, text = args
    from fscl_tpu_torch.dsp.preprocess import prepare_initial_features
    store = FeatureStore(root)
    prepare_initial_features(store, query, wav_path, text)
    return query


def parse_corpus(parser_name: str, raw_root: str, store: FeatureStore,
                 n_workers: int = 4, limit: Optional[int] = None) -> List[dict]:
    """RawParser.parse equivalent: walk, write metadata/speakers, extract
    initial features in a process pool."""
    walk = RAW_PARSERS.get(parser_name)
    items = list(walk(raw_root))
    if limit:
        items = items[:limit]
    queries = [q for q, _, _ in items]
    speakers = sorted({q["spk"] for q in queries})
    store.save_metadata(queries)
    store.save_speakers(speakers)
    tasks = [(store.root, q, w, t) for q, w, t in items]
    if n_workers > 1:
        with ProcessPoolExecutor(max_workers=n_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            list(ex.map(_prep_one, tasks, chunksize=16))
    else:
        for task in tasks:
            _prep_one(task)
    # merge the per-process text json shards: re-save centrally
    st = FeatureStore(store.root)
    for q, w, t in items:
        st.text.save(t, q)
    st.flush()
    return queries
