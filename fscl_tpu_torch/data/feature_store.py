"""Per-corpus feature store (DataParser equivalent); the port's own copy of
`fscl_tpu/data/feature_store.py`, with the same on-disk layout, so that each
package reads the stores the other writes.

Re-provides Parsers/parser.py:122-229 (`DataParser` v2): a directory of
named per-utterance features under `preprocessed_data/<corpus>/`, plus
data_info.json / speakers.json / stats.json and nested `ssl_units/<name>`
sub-stores. Array features are .npy files keyed `<spk>-<basename>`; string
features (phoneme/text) live in one json per feature (faster metadata reads
than the reference's per-file layout, same query API).

Queries are dicts {"spk": ..., "basename": ...} like the reference.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

ARRAY_FEATURES = [
    "wav_16000", "wav_22050", "wav_trim_16000", "wav_trim_22050",
    "mel", "pitch", "interpolate_pitch", "energy",
    "mfa_duration", "mfa_duration_avg_pitch", "mfa_duration_avg_energy",
    "spk_ref_mel_slices",
]
JSON_FEATURES = ["phoneme", "text", "mfa_segment"]

UNIT_ARRAY_FEATURES = [
    "duration", "duration_avg_pitch", "duration_avg_energy",
    "alignment_matrix", "lp_matrix",
]
UNIT_JSON_FEATURES = ["phoneme", "segment"]


def _key(query: Dict[str, str]) -> str:
    return f"{query['spk']}-{query['basename']}"


class ArrayFeature:
    """One named feature = directory of .npy files + optional RAM cache."""

    def __init__(self, root: str, name: str, cache: bool = False):
        self.dir = os.path.join(root, name)
        self.name = name
        self._cache: Optional[Dict[str, np.ndarray]] = {} if cache else None

    def path(self, query) -> str:
        return os.path.join(self.dir, _key(query) + ".npy")

    def save(self, arr: np.ndarray, query) -> None:
        os.makedirs(self.dir, exist_ok=True)
        np.save(self.path(query), np.asarray(arr))

    def read_from_query(self, query) -> np.ndarray:
        k = _key(query)
        if self._cache is not None and k in self._cache:
            return self._cache[k]
        arr = np.load(self.path(query))
        if self._cache is not None:
            self._cache[k] = arr
        return arr

    def exists(self, query) -> bool:
        return os.path.isfile(self.path(query))


class JsonFeature:
    """String/structured feature stored in a single <name>.json map."""

    def __init__(self, root: str, name: str):
        self.path = os.path.join(root, name + ".json")
        self.name = name
        self._data: Optional[Dict[str, Any]] = None
        self._dirty = False

    def _load(self):
        if self._data is None:
            if os.path.isfile(self.path):
                with open(self.path, encoding="utf-8") as f:
                    self._data = json.load(f)
            else:
                self._data = {}

    def save(self, value, query) -> None:
        self._load()
        self._data[_key(query)] = value
        self._dirty = True

    def flush(self) -> None:
        if self._dirty and self._data is not None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "w", encoding="utf-8") as f:
                json.dump(self._data, f, ensure_ascii=False)
            self._dirty = False

    def read_from_query(self, query):
        self._load()
        return self._data[_key(query)]

    def exists(self, query) -> bool:
        self._load()
        return _key(query) in self._data


class UnitStore:
    """ssl_units/<name> sub-store (Parsers/parser.py SSLUnitParser)."""

    def __init__(self, root: str):
        self.root = root
        for name in UNIT_ARRAY_FEATURES:
            setattr(self, name, ArrayFeature(root, name))
        for name in UNIT_JSON_FEATURES:
            setattr(self, name, JsonFeature(root, name))

    def flush(self):
        for name in UNIT_JSON_FEATURES:
            getattr(self, name).flush()

    def save_attrs(self, attrs: Dict[str, Any]) -> None:
        """Unit-inventory metadata (n_units, source) so consumers can
        register the symbol set without out-of-band knowledge."""
        os.makedirs(self.root, exist_ok=True)
        with open(os.path.join(self.root, "attrs.json"), "w") as f:
            json.dump(attrs, f)

    def load_attrs(self) -> Dict[str, Any]:
        path = os.path.join(self.root, "attrs.json")
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            return json.load(f)


class FeatureStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        for name in ARRAY_FEATURES:
            setattr(self, name, ArrayFeature(root, name))
        for name in JSON_FEATURES:
            setattr(self, name, JsonFeature(root, name))
        self._units: Dict[str, UnitStore] = {}

    # --- metadata ---------------------------------------------------------
    @property
    def metadata_path(self) -> str:
        return os.path.join(self.root, "data_info.json")

    @property
    def speakers_path(self) -> str:
        return os.path.join(self.root, "speakers.json")

    @property
    def stats_path(self) -> str:
        return os.path.join(self.root, "stats.json")

    def save_metadata(self, queries: List[Dict[str, Any]]) -> None:
        with open(self.metadata_path, "w", encoding="utf-8") as f:
            json.dump(queries, f, ensure_ascii=False, indent=2)

    def load_metadata(self) -> List[Dict[str, Any]]:
        with open(self.metadata_path, encoding="utf-8") as f:
            return json.load(f)

    def save_speakers(self, speakers: List[str]) -> None:
        with open(self.speakers_path, "w", encoding="utf-8") as f:
            json.dump(speakers, f, ensure_ascii=False, indent=2)

    def load_speakers(self) -> List[str]:
        with open(self.speakers_path, encoding="utf-8") as f:
            return json.load(f)

    # --- units -------------------------------------------------------------
    def get_ssl_unit_store(self, unit_name: str) -> UnitStore:
        if unit_name not in self._units:
            self._units[unit_name] = UnitStore(
                os.path.join(self.root, "ssl_units", unit_name))
        return self._units[unit_name]

    def flush(self) -> None:
        for name in JSON_FEATURES:
            getattr(self, name).flush()
        for store in self._units.values():
            store.flush()


def read_queries_from_txt(path: str) -> List[Dict[str, str]]:
    """train.txt lines `basename|spk|{phonemes}|raw text`
    (Parsers/utils.py:6-24)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            n, s, t, r = line.split("|", 3)
            out.append({"basename": n, "spk": s, "phonemes": t, "text": r})
    return out


def write_queries_to_txt(store: FeatureStore, queries, path: str) -> None:
    """(Parsers/utils.py:27-40)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lines = []
    for q in queries:
        phn = store.phoneme.read_from_query(q)
        text = store.text.read_from_query(q)
        lines.append(f"{q['basename']}|{q['spk']}|{{{phn}}}|{text}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
