"""`fscl_tpu_torch preprocess` — the staged corpus pipeline (port of
`fscl_tpu/cli/preprocess_cmd.py`; reference preprocess.py:23-103).

`--parse_raw` walks the raw corpus (`data/parsers.py`) and writes the
metadata and the 22.05 / 16 kHz wavs in a pool of host processes;
`--prepare_mfa` stages wav + txt pairs for the external `mfa align`;
`--preprocess` runs stage 2 over the TextGrids, its batched passes on
`--device` (default cuda; `--pitch_method` `world_device` and `yin_device`
put F0 there too, `world` and `yin` run the host C++ trackers);
`--create_dataset` writes the splits. `--parse_raw` comes before any CUDA
call of the process, and its workers are spawned, so none of them holds a
CUDA context.
"""
from __future__ import annotations

import os
import time


def run(args):
    from fscl_tpu_torch.core.device import resolve_device
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.data.parsers import parse_corpus

    pre_cfg = None
    if args.preprocess_config:
        from fscl_tpu_torch.core.config import read_preprocess_config
        pre_cfg = read_preprocess_config(args.preprocess_config)
        args.corpus_dir = args.corpus_dir or pre_cfg.corpus_path
        args.output_dir = args.output_dir or pre_cfg.preprocessed_path
        args.parser = args.parser or pre_cfg.parser
    if not (args.corpus_dir and args.output_dir):
        raise ValueError("corpus_dir and output_dir are required (positionally or "
                         "through --preprocess_config)")
    args.parser = args.parser or "LJSpeech"

    store = FeatureStore(args.output_dir)
    limit = 128 if args.debug else None
    result = {}

    if args.parse_raw:
        t0 = time.perf_counter()
        queries = parse_corpus(args.parser, args.corpus_dir, store,
                               n_workers=args.n_workers, limit=limit)
        result["parse_raw_s"] = time.perf_counter() - t0
        print(f"[parse_raw] {len(queries)} utterances in {result['parse_raw_s']:.2f} s")

    if args.prepare_mfa:
        from fscl_tpu_torch.data.scripts import mfa_align_command, prepare_mfa_corpus
        n = prepare_mfa_corpus(store, args.prepare_mfa)
        print(f"[prepare_mfa] staged {n} wav+txt pairs in {args.prepare_mfa}")
        print("[prepare_mfa] next: " + mfa_align_command(
            args.prepare_mfa, "<lexicon.txt>", "<acoustic_model.zip>",
            os.path.join(args.output_dir, "TextGrid")))

    if args.preprocess:
        if not args.textgrid_dir:
            raise ValueError("--preprocess requires --textgrid_dir")
        from fscl_tpu_torch.dsp.preprocess import compute_stats, preprocess_utterances_batched
        from fscl_tpu_torch.ops import dio_contour
        device = resolve_device(args.device)
        queries = store.load_metadata()
        if limit:
            queries = queries[:limit]
        items = []
        for q in queries:
            tg = os.path.join(args.textgrid_dir, q["spk"], q["basename"] + ".TextGrid")
            if not os.path.isfile(tg):
                tg = os.path.join(args.textgrid_dir, q["basename"] + ".TextGrid")
            if not os.path.isfile(tg):
                print(f"[preprocess] no TextGrid for {q}")
                continue
            items.append((q, tg))
        kw = {}
        if pre_cfg is not None:
            kw = dict(audio=pre_cfg.audio, pitch_method=pre_cfg.pitch_method)
        if args.pitch_method:           # the command line overrides the YAML
            kw["pitch_method"] = args.pitch_method
        timings = {}
        t0 = time.perf_counter()
        stats_samples, ok_queries = preprocess_utterances_batched(
            store, items, device=device, timings=timings, **kw)
        store.flush()
        stats = compute_stats(stats_samples, store)
        result.update(preprocess_s=time.perf_counter() - t0, n_ok=len(ok_queries),
                      n_queries=len(queries), timings=timings)
        print(f"[preprocess] {len(ok_queries)}/{len(queries)} ok in "
              f"{result['preprocess_s']:.2f} s (host prepare {timings.get('prepare', 0):.2f} s, "
              f"device {timings.get('device', 0):.2f} s in {timings.get('batches', 0)} "
              f"batches ({timings.get('mel_batches', 0)} mel), host finish "
              f"{timings.get('finish', 0):.2f} s), {dio_contour.LAUNCHES} contour-fix "
              f"launches, stats: {stats}")

    if args.create_dataset:
        from fscl_tpu_torch.dsp.preprocess import (
            split_monospeaker_dataset, split_multispeaker_dataset)
        t0 = time.perf_counter()
        queries = [q for q in store.load_metadata() if store.mfa_duration.exists(q)]
        speakers = store.load_speakers()
        out = os.path.join(args.output_dir, "splits")
        vs = pre_cfg.val_size if pre_cfg is not None and pre_cfg.val_size else 400
        if len(speakers) > 1:
            split_multispeaker_dataset(store, queries, out)
        else:
            split_monospeaker_dataset(
                store, queries, out,
                val_size=min(vs, max(1, len(queries) // 10)),
                test_size=min(vs, max(1, len(queries) // 10)))
        result["create_dataset_s"] = time.perf_counter() - t0
        print(f"[create_dataset] splits under {out}")
    return result
