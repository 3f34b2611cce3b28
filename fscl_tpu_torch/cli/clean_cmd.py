"""`fscl_tpu_torch clean` — data validation and filtering (port of
`fscl_tpu/cli/clean_cmd.py`, clean.py:13-140).

Checks each utterance of a feature store: the mel, duration and phoneme
files exist, the 22.05 kHz trimmed wav lasts 1-15 s, no feature is NaN, no
unknown token (`spn`). Writes the kept queries to data_info-clean.json (or
`--output`) and returns {"kept", "total", "filtered": reasons}. As in
fscl_tpu, an utterance whose read fails counts under "existence".
"""
from __future__ import annotations

import json
import os

import numpy as np

from fscl_tpu_torch.data.feature_store import FeatureStore


def run(args):
    store = FeatureStore(args.data_dir)
    queries = store.load_metadata()
    kept, reasons = [], {"length": 0, "existence": 0, "nan": 0, "spn": 0}
    for q in queries:
        try:
            if not (store.mel.exists(q) and store.mfa_duration.exists(q)
                    and store.phoneme.exists(q)):
                reasons["existence"] += 1
                continue
            wav = store.wav_trim_22050.read_from_query(q)
            if not 1.0 <= len(wav) / 22050.0 <= 15.0:
                reasons["length"] += 1
                continue
            if any(np.isnan(np.asarray(feat.read_from_query(q))).any()
                   for feat in (store.mel, store.pitch, store.energy,
                                store.mfa_duration_avg_pitch, store.mfa_duration_avg_energy)):
                reasons["nan"] += 1
                continue
            if "spn" in store.phoneme.read_from_query(q).split():
                reasons["spn"] += 1
                continue
            kept.append(q)
        except Exception:       # fscl_tpu's accounting: an unreadable utterance
            reasons["existence"] += 1
    out = args.output or os.path.join(args.data_dir, "data_info-clean.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(kept, f, indent=2)
    print(f"[clean] kept {len(kept)}/{len(queries)}; filtered: {reasons}")
    print(f"[clean] wrote {out}")
    return {"kept": len(kept), "total": len(queries), "filtered": reasons}
