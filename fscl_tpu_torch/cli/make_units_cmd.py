"""`fscl_tpu_torch make-units` — pseudo-unit discovery over a feature store
(port of `fscl_tpu/cli/make_units_cmd.py`).

Populates `ssl_units/<unit_name>` (segments, unit strings, durations,
duration-averaged pitch and energy, the cost matrices, attrs) by k-means over
frame features on the device, then DPDP segmentation on the host. Sources:

- `mel` (default): the stored mel frames (20 ms units become 256 / 22050 s
  mel frames), no model;
- an SSL upstream name (`hubert_large_ll60k`, ...): one hidden layer
  (`--layer`, default the last) of the upstream run on the device in wav
  buckets, with the weights of `--upstream_ckpt` or drawn on the device
  from `--seed`. The file is a released checkpoint in any layout
  `models/hubert.py:load_torch_checkpoint` reads (HF, fairseq or s3prl
  containers and key names, weight-normed positional conv), or a state dict
  under the port's keys (`convert.hubert_state_dict` of fscl_tpu params).
  `torch.load` reads it with `weights_only=True`, as torch's default is
  since 2.6, which refuses older fairseq files that pickle an
  `argparse.Namespace` (fscl_tpu's bare `torch.load` refuses them too).

Prints, and returns, the utterances written and the seconds of each stage
(upstream features, k-means, units: frame logits on the device, DPDP and
the store writes on the host).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.data.ssl_units import (
    MEL_FRAME_PERIOD, batched_ssl_extractor, generate_ssl_units, kmeans_unit_labeler,
)


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run(args):
    device = resolve_device(args.device)
    store = FeatureStore(args.features_dir)
    queries = store.load_metadata()
    if args.limit:
        queries = queries[:args.limit]

    t0 = _clock(device)
    if args.source == "mel":
        fp = MEL_FRAME_PERIOD

        def extract(q):
            return np.asarray(store.mel.read_from_query(q))
    else:
        fp = 0.02
        state_dict = (torch.load(args.upstream_ckpt, map_location="cpu", weights_only=True)
                      if args.upstream_ckpt else None)
        extract = batched_ssl_extractor(store, queries, source=args.source,
                                        layer=args.layer or -1, state_dict=state_dict,
                                        device=device, seed=args.seed)
    t1 = _clock(device)
    logits_fn = kmeans_unit_labeler(extract, queries, n_units=args.n_units, seed=args.seed,
                                    device=device)
    t2 = _clock(device)
    n = generate_ssl_units(store, args.unit_name, logits_fn, queries=queries, fp=fp)
    t3 = _clock(device)
    seconds = {"upstream": t1 - t0, "kmeans": t2 - t1, "units": t3 - t2}
    print(f"[make-units] {n} utterances -> ssl_units/{args.unit_name} "
          f"({args.n_units} units, source={args.source}); seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return {"utterances": n, "seconds": seconds}
