"""`fscl_tpu_torch evaluate` — PER / FER over a directory of task JSONs
(port of `fscl_tpu/cli/evaluate_cmd.py`, evaluation/fs_error_rate.py's
`__main__`); `--pl_filter` runs the pseudo-label confidence threshold sweep
over a feature store's ssl_units/<name> matrices (compare_unit.py).

Prints what fscl_tpu prints and returns the numbers: {"per": [...],
"fer": [...]} per task file, or the sweep's result.
"""
from __future__ import annotations

import glob
import json

import numpy as np

from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.eval.drivers import evaluate_pl_filter
from fscl_tpu_torch.eval.metrics import fer_over_infos, per_over_infos


def run(args):
    if args.pl_filter:
        if not args.unit_name:
            raise ValueError("--pl_filter needs --unit_name")
        ref2unify = pred2unify = None
        if args.unify_map:
            with open(args.unify_map, encoding="utf-8") as f:
                maps = json.load(f)
            ref2unify, pred2unify = maps.get("ref2unify"), maps.get("pred2unify")
        result = evaluate_pl_filter(
            FeatureStore(args.dir), args.unit_name, ref2unify, pred2unify,
            thresholds=[float(t) for t in args.thresholds.split(",")], matrix=args.matrix)
        print(f"[{args.unit_name}] total frames: {result['n_frames']}, "
              f"skipped: {result['n_skipped']}")
        for row in result["sweep"]:
            print(f"Threshold {row['threshold']}:")
            print(f"Activated: {row['activated']}/{result['n_frames']} = "
                  f"{row['activated_rate'] * 100:.2f}%")
            print(f"Accuracy: {row['matched']}/{result['n_frames']} = "
                  f"{row['accuracy'] * 100:.2f}%")
            print("")
        return result

    files = sorted(glob.glob(f"{args.dir}/*.json"))
    if not files:
        raise FileNotFoundError(f"no task jsons under {args.dir}")
    pers, fers = [], []
    for path in files:
        with open(path, encoding="utf-8") as f:
            infos = json.load(f)
        if args.metric in ("per", "both"):
            pers.append(per_over_infos(infos))
        if args.metric in ("fer", "both"):
            fers.append(fer_over_infos(infos))
    if pers:
        print(f"[{args.dir}] PER: {np.mean(pers) * 100:.2f}%, std {np.std(pers) * 100:.2f}%.")
    if fers:
        print(f"[{args.dir}] FER: {np.mean(fers) * 100:.2f}%, std {np.std(fers) * 100:.2f}%.")
    return {"per": pers, "fer": fers}
