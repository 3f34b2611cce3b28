"""`fscl_tpu_torch pack` — write packed training shards for a data config's
splits (port of `fscl_tpu/cli/pack_cmd.py`; `data/shards.py`). The
supervised datamodule prefers `<split>.shard`, the PR and T2U episodic ones
`<split>.fscl.shard` (`--fscl`), over per-utterance feature reads. The bytes
equal fscl_tpu's `pack` on the same store, so either package reads them.

Prints one line per split and returns {split: {"path", "bytes",
"seconds"}}.
"""
from __future__ import annotations

import os
import time

from fscl_tpu_torch.core.config import ModelConfig, model_config_from_yaml, read_data_config
from fscl_tpu_torch.core.stats import DEFAULT_STATS, GlobalStats
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.data.shards import pack_fscl_split_from_store, pack_split_from_store


def run(args):
    dc = read_data_config(args.data_config)
    model_cfg = model_config_from_yaml(args.model_config) if args.model_config else ModelConfig()
    store = FeatureStore(dc.data_dir)
    # the normalisation must be the training datamodule's: the global stats
    # (Define.ALLSTATS["global"]); a corpus's stats.json only when asked
    stats = GlobalStats.from_json(args.stats) if args.stats else DEFAULT_STATS
    out = {}
    for split in args.splits.split(","):
        src = dc.subset_path(split)
        if not src or not os.path.isfile(src):
            print(f"[pack] split {split}: no txt, skipped")
            continue
        t0 = time.perf_counter()
        if args.fscl:
            path = src + ".fscl.shard"
            n_bytes = pack_fscl_split_from_store(src, store, dc, model_cfg, path, stats=stats,
                                                 upstream=model_cfg.upstream.name)
        else:
            path = src + ".shard"
            n_bytes = pack_split_from_store(src, store, dc, model_cfg, path, stats=stats)
        out[split] = {"path": path, "bytes": n_bytes, "seconds": time.perf_counter() - t0}
        print(f"[pack] {split}: {path} ({n_bytes / 1e6:.1f} MB)")
    return out
