"""`fscl_tpu_torch rehearse` — a whole experiment family as one command
(port of `fscl_tpu/cli/rehearse_cmd.py`).

Three flows (`--flow`), each chaining a reference experiment end to end with
per-phase wall-clock timing into rehearsal.json:

- `fscl` (default): the few-shot cross-lingual TTS flow: corpus ->
  meta-train (`fscl-orig` episodes from packed FSCL shards) -> tasks
  (coverage-constrained K-shot task generation on the target split) ->
  transplant (`tune_init`) -> eval-pre -> adapt (`adapt_on_chip_resident`
  for --adapt_steps) -> synthesis (`synthesize_bucketed`) -> [vocode] ->
  eval (teacher-forced MCD and the predicted durations' frame-level FER).
- `t2u`: corpus -> units (k-means pseudo-units over mel frames) -> u2s-train
  -> meta-train (`fscl-t2u` episodes) -> tasks -> transplant
  (`t2u_tune_init` into an E2ETuneSystem through the frozen u2s) -> eval-pre
  -> tune -> synthesis (text -> units -> mel) -> [vocode] -> eval (unit PER,
  teacher-forced and chained MCD).
- `pr`: corpus -> pr-train (protonet episodes) -> tasks -> eval (zero-shot
  transcription over the tasks, PER and FER).

Every phase name, every rehearsal.json key and every quality gate (name,
bar, `serious` threshold: gates are enforced from 100 adaptation or tune
steps, or 100 PR episodes) are fscl_tpu's; the run exits 1 when an
enforced gate fails. The steps are the systems' `train_step` on the
device (`--device`, default cuda); what is JAX-only (donated buffers,
the compilation cache) has no counterpart. Each phase's end line also
gives the kernel launches it made (attention, MRF stage, DIO contour fix),
which `chip_smoke.py` reads. The synthetic corpora go to the port's own
cache directory, made by the port's preprocessing (`--corpus_cache`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time


class _Phases:
    """Per-phase wall clock (the device synchronized at each phase's end)
    and kernel launches."""

    def __init__(self, device):
        self.device = device
        self.times = {}
        self.order = []
        self.launches = {}

    def __call__(self, name):
        phases = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.monotonic()
                self.counts = _launch_counts()
                print(f"[rehearse] {name}...", flush=True)
                return self

            def __exit__(self, *exc):
                if phases.device.type == "cuda":
                    import torch
                    torch.cuda.synchronize(phases.device)
                dt = time.monotonic() - self.t0
                phases.times[name] = dt
                phases.order.append(name)
                counts = {k: v - self.counts[k] for k, v in _launch_counts().items()}
                phases.launches[name] = counts
                print(f"[rehearse] {name} done in {dt:.1f}s (launches: "
                      + ", ".join(f"{k} {v}" for k, v in counts.items()) + ")", flush=True)

        return _Ctx()


def _launch_counts():
    from fscl_tpu_torch.ops import attention, dio_contour, mrf_stage
    return {"attention_fwd": attention.LAUNCHES, "mrf_stage": mrf_stage.LAUNCHES,
            "dio_contour": dio_contour.LAUNCHES}


def _var_kw(model_cfg) -> dict:
    v = model_cfg.variance
    return {"pitch_feature": v.pitch_feature, "energy_feature": v.energy_feature}


def _preset_cfg(preset: str):
    from fscl_tpu_torch.core.config import (
        CodebookConfig, ModelConfig, SpeakerConfig, TransformerConfig, UpstreamConfig,
    )

    if preset == "tiny":
        return ModelConfig(
            transformer=TransformerConfig(
                encoder_layer=1, decoder_layer=1, encoder_hidden=32,
                decoder_hidden=32, conv_filter_size=64, encoder_head=2,
                decoder_head=2, encoder_dropout=0.0, decoder_dropout=0.0),
            codebook=CodebookConfig(size=8, num_heads=2, dim=32),
            upstream=UpstreamConfig(name="tiny", dim=16, n_layers=2),
            max_seq_len=128, speaker=SpeakerConfig(n_speakers=4))
    # full: reference scale, enc4/dec6 256d FastSpeech2 and HuBERT-large in
    # bf16 (the support wavs ship as int16 PCM); the port's HuBERT is a
    # plain loop over its layers and takes `scan_layers` as given
    return dataclasses.replace(
        ModelConfig(speaker=SpeakerConfig(n_speakers=8), max_seq_len=1000),
        upstream=UpstreamConfig(scan_layers=True, compute_dtype="bfloat16"))


def _corpora(args, phases):
    """Phase 1 shared by every flow: user corpora via --data_config/--target
    or preprocessed synthetic mini-corpora (2 meta-train "languages" + 1
    held-out target)."""
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.scripts import make_synthetic_corpus

    with phases("corpus"):
        if args.data_config:
            meta_cfgs = [read_data_config(p) for p in args.data_config]
            target_cfg = read_data_config(args.target)
        else:
            n = args.corpus_utts
            cache = args.corpus_cache or None
            paths = [
                make_synthetic_corpus(
                    os.path.join(args.exp_dir, f"corpus_l{i}"),
                    name=f"meta-l{i}", n_utts=n, seed=i + 1,
                    f0_base=120.0 + 40.0 * i, lang_id=i, cache_dir=cache,
                    device=phases.device)
                for i in range(2)]
            target_path = make_synthetic_corpus(
                os.path.join(args.exp_dir, "corpus_target"),
                name="target", n_utts=n, seed=7, f0_base=200.0, lang_id=2,
                cache_dir=cache, device=phases.device)
            meta_cfgs = [read_data_config(p) for p in paths]
            target_cfg = read_data_config(target_path)
    return meta_cfgs, target_cfg


def _gate(report, name, ok, detail, enforced=True, bar=None):
    """Record a quality gate: the rehearsal fails when adaptation stops
    improving synthesis quality. `enforced=False` records the outcome
    without failing the run (smoke runs whose few steps cannot move a
    quality metric); `bar` records the numeric bar the gate holds."""
    rec = {"ok": bool(ok), "detail": detail, "enforced": bool(enforced)}
    if bar is not None:
        rec["bar"] = bar
    report.setdefault("gates", {})[name] = rec


def _finish(args, phases, report, lines):
    """Write rehearsal.json and print the per-flow summary; return 1 when an
    enforced quality gate failed (the report is written first, so it
    records the failure)."""
    report["phase_seconds"] = {k: phases.times[k] for k in phases.order}
    report["total_seconds"] = sum(phases.times.values())
    out_path = os.path.join(args.exp_dir, "rehearsal.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)

    print(f"\n=== rehearsal summary ({args.flow}) ===")
    for k in phases.order:
        print(f"  {k:<12} {phases.times[k]:8.1f}s")
    print(f"  {'TOTAL':<12} {report['total_seconds']:8.1f}s")
    for line in lines:
        print(f"  {line}")
    for name, g in report.get("gates", {}).items():
        status = "ok" if g["ok"] else ("FAIL" if g["enforced"] else "fail (advisory)")
        print(f"  gate {name}: {status} — {g['detail']}")
    print(f"  report: {out_path}")
    failed = [n for n, g in report.get("gates", {}).items() if g["enforced"] and not g["ok"]]
    if failed:
        print(f"  QUALITY GATES FAILED: {', '.join(failed)}")
        return 1
    return 0


def run(args):
    if args.episodes < 1:
        raise SystemExit("rehearse: --episodes must be >= 1")
    if args.data_config and not args.target:
        raise SystemExit(
            "rehearse: --data_config (meta-train corpora) requires "
            "--target (held-out target-language data config)")
    if args.flow == "t2u":
        if args.u2s_steps < 1 or args.tune_steps < 1:
            raise SystemExit("rehearse: --u2s_steps and --tune_steps must be >= 1")
        return run_t2u(args)
    if args.flow == "pr":
        return run_pr(args)
    return run_fscl(args)


def _tasks(args, phases, target_cfg):
    """Coverage-constrained K-shot task generation on the target split
    (every flow). Returns (target_store, task_root, task_dir, task_cfg)."""
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.eval.task_generation import TaskGenerator

    with phases("tasks"):
        target_store = FeatureStore(target_cfg.data_dir)
        gen = TaskGenerator("target", target_store, target_cfg.lang_id, target_cfg.symbol_id)
        task_root = os.path.join(args.exp_dir, "few_shot_tasks")
        gen.generate(target_cfg.subset_path("train"), task_root,
                     shots=[args.shots], n_qry=args.queries, n_tasks=1)
        task_dir = os.path.join(task_root, f"{args.shots}-shot", "task-0")
        task_cfg = read_data_config(os.path.join(task_dir, "config.yaml"))
    return target_store, task_root, task_dir, task_cfg


def _fresh_fscl_shards(cfgs, model_cfg):
    """A `<train.txt>.fscl.shard` per corpus, packed where missing or stale."""
    from fscl_tpu_torch.data.feature_store import FeatureStore, read_queries_from_txt
    from fscl_tpu_torch.data.shards import PackedShard, pack_fscl_split_from_store
    shards = []
    for dc in cfgs:
        split = dc.subset_path("train")
        sp = split + ".fscl.shard"
        n_expected = len(read_queries_from_txt(split))
        sh = PackedShard(sp) if os.path.isfile(sp) else None
        if sh is None or len(sh) != n_expected:
            pack_fscl_split_from_store(split, FeatureStore(dc.data_dir), dc, model_cfg, sp,
                                       upstream=model_cfg.upstream.name)
            sh = PackedShard(sp)
        shards.append(sh)
    return shards


def _sup_batches(task_dir, target_store, task_cfg, model_cfg):
    """The task's support split as SupInfo batches of 4."""
    from fscl_tpu_torch.data.datasets import FSCLDataset
    from fscl_tpu_torch.data.episodic import collate_sup_info
    ds = FSCLDataset(os.path.join(task_dir, "train.txt"), target_store, task_cfg, model_cfg,
                     upstream=model_cfg.upstream.name)
    return [collate_sup_info([ds[i] for i in range(s, min(s + 4, len(ds)))])
            for s in range(0, len(ds), 4)]


def _write_wavs(args, phases, mels, lens):
    """Griffin-Lim of each mel into exp_dir/wavs/ (its own phase: the host
    loop stays out of the synthesis throughput)."""
    import numpy as np
    from fscl_tpu_torch.audio_out.vocoder import griffin_lim
    from fscl_tpu_torch.dsp.audio_io import save_wav
    with phases("vocode"):
        wav_dir = os.path.join(args.exp_dir, "wavs")
        os.makedirs(wav_dir, exist_ok=True)
        for i in range(len(mels)):
            n = max(int(lens[i]), 1)
            wav = np.asarray(griffin_lim(mels[i][:n]))
            save_wav(os.path.join(wav_dir, f"{i:04d}.wav"), wav, 22050)
    return wav_dir


def run_fscl(args):
    import numpy as np
    import torch

    from fscl_tpu_torch.core.config import OptimConfig
    from fscl_tpu_torch.core.device import resolve_device
    from fscl_tpu_torch.data.batch import collate_batch, to_device
    from fscl_tpu_torch.data.datasets import FastSpeech2Dataset
    from fscl_tpu_torch.data.episodic import EpisodicSampler, collate_episode
    from fscl_tpu_torch.data.feature_store import read_queries_from_txt
    from fscl_tpu_torch.data.shards import PackedShard, pack_split_from_store
    from fscl_tpu_torch.eval.metrics import fer_over_infos, mel_cepstral_distortion
    from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    from fscl_tpu_torch.systems.fscl import TransEmbSystem
    from fscl_tpu_torch.systems.tune import (
        adapt_on_chip_resident, adaptable_params, load_adapted, tune_init,
    )
    from fscl_tpu_torch.train.trainer import prefetch_batches

    dev = resolve_device(args.device)
    os.makedirs(args.exp_dir, exist_ok=True)
    phases = _Phases(dev)
    model_cfg = _preset_cfg(args.preset)
    optim = OptimConfig(lr=args.lr, warmup_step=50, anneal_steps=())
    report = {"flow": "fscl", "preset": args.preset, "episodes": args.episodes,
              "adapt_steps": args.adapt_steps, "shots": args.shots}

    # ---- 1. corpus --------------------------------------------------------
    meta_cfgs, target_cfg = _corpora(args, phases)
    n_symbols = max(len(LANG_ID2SYMBOLS[dc.symbol_id]) for dc in meta_cfgs + [target_cfg])

    # ---- 2. meta-train ----------------------------------------------------
    torch.manual_seed(43)
    fscl = TransEmbSystem(model_cfg, n_symbols, device=dev, optim_cfg=optim, upstream_seed=43)
    wav_dtype = "int16" if model_cfg.upstream.compute_dtype == "bfloat16" else "float32"
    with phases("meta-train"):
        shards = _fresh_fscl_shards(meta_cfgs, model_cfg)
        labels = []
        for sh, dc in zip(shards, meta_cfgs):
            labels.extend([dc.lang_id] * len(sh))
        sampler = EpisodicSampler(labels, args.shots, args.queries, seed=43)
        starts = np.cumsum([0] + [len(sh) for sh in shards])

        def locate(i):
            c = int(np.searchsorted(starts, i, side="right") - 1)
            return c, int(i) - int(starts[c])

        def episode_at(idxs):
            located = [locate(int(i)) for i in idxs]
            corpora = {c for c, _ in located}
            if len(corpora) == 1:
                return shards[corpora.pop()].collate_episode(
                    [j for _, j in located], args.shots, args.queries,
                    wav_dtype=wav_dtype, **_var_kw(model_cfg))
            # two corpora sharing a lang_id: the generic episode collate
            samples = [shards[c].sample(j) for c, j in located]
            return collate_episode(samples, args.shots, args.queries,
                                   var_kw=_var_kw(model_cfg), wav_dtype=wav_dtype)

        it = sampler.infinite()
        state = fscl.init_state()

        def _episodes():
            for _ in range(args.episodes):
                yield episode_at(next(it))

        _t = time.monotonic()
        for i, ep in enumerate(prefetch_batches(_episodes(), size=4,
                                                place=lambda e: to_device(e, dev))):
            state, metrics = fscl.train_step(state, ep)
            if i == 0:
                report["meta_first_loss"] = float(metrics["Total Loss"])
                print(f"[rehearse]   first episode {time.monotonic() - _t:.1f}s", flush=True)
                _t = time.monotonic()
        report["meta_last_loss"] = float(metrics["Total Loss"])
        print(f"[rehearse]   {args.episodes - 1} episodes {time.monotonic() - _t:.1f}s",
              flush=True)
    report["episodes_per_s"] = args.episodes / phases.times["meta-train"]

    # ---- 3. task generation ----------------------------------------------
    target_store, _, task_dir, task_cfg = _tasks(args, phases, target_cfg)
    qry_queries = read_queries_from_txt(os.path.join(task_dir, "val.txt"))

    # ---- 4. transplant ----------------------------------------------------
    torch.manual_seed(1)
    baseline = BaselineSystem(model_cfg, ((target_cfg.symbol_id, n_symbols),), device=dev,
                              optim_cfg=optim)
    with phases("transplant"):
        tune_init(fscl, baseline, _sup_batches(task_dir, target_store, task_cfg, model_cfg),
                  target_cfg.symbol_id)
    del fscl

    # pre-adaptation quality reference: teacher-forced MCD with the
    # transplant-only parameters on the held-out query split; the adapted
    # MCD must beat it
    qry_ds = FastSpeech2Dataset(os.path.join(task_dir, "val.txt"), target_store, task_cfg,
                                model_cfg)
    _, qry_batch = collate_batch([qry_ds[i] for i in range(len(qry_ds))], **_var_kw(model_cfg))
    qry_dev = to_device(qry_batch, dev)

    def _tf_mcd():
        with torch.no_grad():
            tf = baseline(qry_dev)
        tf_mel = tf.postnet_mel.float().cpu().numpy()
        return tf, float(np.mean([mel_cepstral_distortion(
            tf_mel[i][: int(qry_batch.mel_lens[i])],
            np.asarray(qry_batch.mels[i][: int(qry_batch.mel_lens[i])]))
            for i in range(len(qry_ds))]))

    with phases("eval-pre"):
        _, mcd_pre = _tf_mcd()
        report["mcd_teacher_forced_transplant_only"] = mcd_pre

    # ---- 5. adapt ---------------------------------------------------------
    with phases("adapt"):
        # the task's train split packed, read once, resident on the device
        shard_path = os.path.join(task_dir, "train.txt.shard")
        pack_split_from_store(os.path.join(task_dir, "train.txt"), target_store, task_cfg,
                              model_cfg, shard_path)
        shard = PackedShard(shard_path)
        n = len(shard)
        support_all = shard.collate(np.arange(n), **_var_kw(model_cfg))[1]
        adapted, losses = adapt_on_chip_resident(
            baseline, adaptable_params(baseline), support_all, args.adapt_steps,
            batch_size=min(args.shots, n), lr=args.adapt_lr)
        losses = losses.cpu().numpy()
        report["adapt_first_loss"] = float(losses[0])
        report["adapt_last_loss"] = float(losses[-1])
    report["adapt_steps_per_s"] = args.adapt_steps / phases.times["adapt"]
    load_adapted(baseline, adapted)

    # ---- 6. synthesis -----------------------------------------------------
    with phases("synthesis"):
        out = baseline.synthesize_bucketed(qry_batch.texts, qry_batch.src_lens,
                                           qry_batch.speaker_args, qry_batch.lang_ids)
        synth_mels = out.postnet_mel.float().cpu().numpy()
        synth_mel_lens = out.mel_len.cpu().numpy()
        frames = int(synth_mel_lens.sum())
        report["synth_frames"] = frames
    report["synth_frames_per_s"] = frames / phases.times["synthesis"]

    if args.write_wavs:
        report["wav_dir"] = _write_wavs(args, phases, synth_mels, synth_mel_lens)

    # ---- 7. eval ----------------------------------------------------------
    with phases("eval"):
        tf, mcd_post = _tf_mcd()
        report["mcd_teacher_forced"] = mcd_post
        report["mcd_note"] = (
            "synthetic-corpus mels make absolute MCD uninterpretable; "
            "quality signal = transplant-only vs adapted delta")
        # duration quality as frame-level FER: gt = MFA segments, pred = the
        # predicted durations' segments (the teacher-forced forward's own
        # prediction is log_duration_prediction: round(exp(x) - 1))
        pred_durs = np.maximum(np.round(
            np.exp(tf.log_duration_prediction.float().cpu().numpy()) - 1.0), 0.0)
        fp = 256 / 22050
        infos = []
        for i, q in enumerate(qry_queries[: len(qry_ds)]):
            phns = target_store.phoneme.read_from_query(q).strip()
            gt_seg = target_store.mfa_segment.read_from_query(q)
            L = int(qry_batch.src_lens[i])
            t, pred_seg = 0.0, []
            for d in pred_durs[i][:L].astype(np.float64):
                pred_seg.append([t, t + float(d) * fp])
                t += float(d) * fp
            # gt and pred share the phoneme string on purpose: this isolates
            # duration quality
            infos.append({"gt": phns, "pred": phns, "gt_segment": gt_seg,
                          "pred_segment": pred_seg})
        report["duration_fer"] = fer_over_infos(infos)

    # quality gates (advisory below 100 steps)
    serious = args.adapt_steps >= 100
    _gate(report, "adapt_loss_improves",
          report["adapt_last_loss"] < report["adapt_first_loss"],
          f"{report['adapt_first_loss']:.3f} -> {report['adapt_last_loss']:.3f}",
          enforced=serious)
    _gate(report, "mcd_improves_with_adaptation", mcd_post < mcd_pre,
          f"teacher-forced MCD transplant-only {mcd_pre:.3f} -> adapted {mcd_post:.3f}",
          enforced=serious)
    _gate(report, "duration_fer_margin", report["duration_fer"] < 0.06,
          f"duration-FER {report['duration_fer']:.3f} (bar < 0.06, fscl_tpu's bar)",
          enforced=serious, bar="duration_fer < 0.06")

    return _finish(args, phases, report, [
        f"meta loss {report['meta_first_loss']:.3f} -> {report['meta_last_loss']:.3f} "
        f"({report['episodes_per_s']:.2f} eps/s)",
        f"adapt loss {report['adapt_first_loss']:.3f} -> {report['adapt_last_loss']:.3f} "
        f"({report['adapt_steps_per_s']:.1f} steps/s)",
        f"synthesis {report['synth_frames_per_s']:.0f} mel-frames/s",
        f"MCD(tf) {report['mcd_teacher_forced']:.3f} (transplant-only {mcd_pre:.3f})  "
        f"duration-FER {report['duration_fer']:.3f}",
    ])


def _t2u_cfg(preset: str, n_unit_symbols: int):
    """Per-preset TacoT2U config; `n_units` covers the whole unit symbol
    table (common symbols + units)."""
    from fscl_tpu_torch.models.tacotron2_t2u import T2UConfig

    if preset == "tiny":
        return T2UConfig(
            n_units=n_unit_symbols, d_unit=16, symbols_embedding_dim=16,
            encoder_embedding_dim=32, prenet_dim=16, attention_rnn_dim=32,
            decoder_rnn_dim=32, attention_dim=16,
            attention_location_n_filters=4,
            attention_location_kernel_size=7)
    return T2UConfig(n_units=n_unit_symbols)


def run_t2u(args):
    """The text-to-unit family end to end: unit discovery -> u2s -> fscl-t2u
    meta -> transplant -> E2E tune -> autoregressive units -> chained
    synthesis -> unit PER + MCD."""
    import numpy as np
    import torch

    from fscl_tpu_torch.core.config import OptimConfig, TrainConfig
    from fscl_tpu_torch.core.device import resolve_device
    from fscl_tpu_torch.data.batch import collate_batch, to_device
    from fscl_tpu_torch.data.datamodules import collate_t2u
    from fscl_tpu_torch.data.datasets import UnitDataset
    from fscl_tpu_torch.data.feature_store import FeatureStore, read_queries_from_txt
    from fscl_tpu_torch.data.mix_datamodules import T2U2SDataModule, T2UEpisodicDataModule
    from fscl_tpu_torch.data.ssl_units import generate_ssl_units, kmeans_unit_labeler
    from fscl_tpu_torch.eval.metrics import mel_cepstral_distortion, per_over_infos
    from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS, register_unit_symbols
    from fscl_tpu_torch.frontend import n_symbols as n_sym_of
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    from fscl_tpu_torch.systems.t2u import TransEmbT2USystem
    from fscl_tpu_torch.systems.t2u_tune import E2ETuneSystem, t2u_tune_init

    dev = resolve_device(args.device)
    os.makedirs(args.exp_dir, exist_ok=True)
    phases = _Phases(dev)
    model_cfg = _preset_cfg(args.preset)
    optim = OptimConfig(lr=args.lr, warmup_step=50, anneal_steps=())
    unit_name = "units-rehearse"
    report = {"flow": "t2u", "preset": args.preset, "episodes": args.episodes,
              "n_units": args.n_units, "u2s_steps": args.u2s_steps,
              "tune_steps": args.tune_steps, "shots": args.shots}

    # ---- 1. corpus ---------------------------------------------------------
    meta_cfgs, target_cfg = _corpora(args, phases)

    # ---- 2. units: k-means pseudo-units per corpus (make-units' mel path) --
    with phases("units"):
        register_unit_symbols(unit_name, args.n_units)
        fp = 256 / 22050
        for dc in meta_cfgs + [target_cfg]:
            store = FeatureStore(dc.data_dir)
            # every split's utterances need units (synthetic corpora carry
            # no data_info.json, only split txts)
            if os.path.isfile(store.metadata_path):
                queries = store.load_metadata()
            else:
                queries = []
                for split in ("train", "val", "test"):
                    p = dc.subset_path(split)
                    if p and os.path.isfile(p):
                        queries.extend(read_queries_from_txt(p))

            def extract(q, store=store):
                return np.asarray(store.mel.read_from_query(q))

            logits_fn = kmeans_unit_labeler(extract, queries, n_units=args.n_units, seed=0,
                                            device=dev)
            generate_ssl_units(store, unit_name, logits_fn, queries=queries, fp=fp,
                               save_matrices=False)
        meta_cfgs = [dataclasses.replace(dc, unit_name=unit_name) for dc in meta_cfgs]
        target_cfg = dataclasses.replace(target_cfg, unit_name=unit_name)
    n_unit_symbols = n_sym_of(unit_name)
    t2u_cfg = _t2u_cfg(args.preset, n_unit_symbols)
    train_cfg = TrainConfig(optim=dataclasses.replace(optim, batch_size=4), seed=43)

    # ---- 3. u2s-train: FastSpeech2 over the unit symbol set ---------------
    with phases("u2s-train"):
        dm = T2U2SDataModule(meta_cfgs, model_cfg, train_cfg, exp_dir=args.exp_dir)
        dm.setup()
        batches = dm.train_batches()
        torch.manual_seed(11)
        u2s = BaselineSystem(model_cfg, ((unit_name, n_unit_symbols),), device=dev,
                             optim_cfg=optim)
        u2s_state = u2s.init_state()
        for i in range(args.u2s_steps):
            u2s_state, m = u2s.train_step(u2s_state, to_device(next(batches).u2s, dev))
            if i == 0:
                report["u2s_first_loss"] = float(m["Total Loss"])
        report["u2s_last_loss"] = float(m["Total Loss"])

    # ---- 4. meta-train: episodic fscl-t2u ----------------------------------
    n_symbols = max(n_sym_of(dc.symbol_id) for dc in meta_cfgs + [target_cfg])
    torch.manual_seed(21)
    fscl = TransEmbT2USystem(model_cfg, n_symbols, t2u_cfg, device=dev, optim_cfg=optim,
                             upstream_seed=21, seed=22)
    with phases("meta-train"):
        _fresh_fscl_shards(meta_cfgs, model_cfg)
        edm = T2UEpisodicDataModule(meta_cfgs, model_cfg, train_cfg, shots=args.shots,
                                    queries=args.queries, upstream=model_cfg.upstream.name)
        edm.setup()
        eps = edm.train_batches()
        state = fscl.init_state()
        for i in range(args.episodes):
            state, m = fscl.train_step(state, to_device(next(eps), dev))
            if i == 0:
                report["meta_first_loss"] = float(m["Total Loss"])
        report["meta_last_loss"] = float(m["Total Loss"])
    report["episodes_per_s"] = args.episodes / phases.times["meta-train"]

    # ---- 5. tasks ----------------------------------------------------------
    target_store, _, task_dir, task_cfg = _tasks(args, phases, target_cfg)
    task_cfg = dataclasses.replace(task_cfg, unit_name=unit_name)

    # ---- 6. transplant + E2E tune ------------------------------------------
    torch.manual_seed(31)
    t2u_sys = E2ETuneSystem(model_cfg, ((target_cfg.symbol_id, n_symbols),), t2u_cfg, u2s,
                            device=dev, optim_cfg=optim, seed=32, u2s_symbol_id=unit_name)
    with phases("transplant"):
        tune_dm = T2U2SDataModule([task_cfg], model_cfg, train_cfg, exp_dir=args.exp_dir)
        tune_dm.setup()
        tune_batches = tune_dm.train_batches()
        tb0 = to_device(next(tune_batches), dev)
        t_state = t2u_sys.init_state()
        t2u_tune_init(fscl, t2u_sys, _sup_batches(task_dir, target_store, task_cfg, model_cfg),
                      target_cfg.symbol_id)
    del fscl

    # pre-tune quality reference: teacher-forced unit accuracy with the
    # transplant-only embedding on the first tune batch
    with phases("eval-pre"):
        report["tune_unit_acc_transplant_only"] = float(t2u_sys.eval_step(t_state, tb0)["Acc"])

    with phases("tune"):
        for i in range(args.tune_steps):
            b = tb0 if i == 0 else to_device(next(tune_batches), dev)
            t_state, m = t2u_sys.train_step(t_state, b)
            if i == 0:
                report["tune_first_loss"] = float(m["Total Loss"])
        report["tune_last_loss"] = float(m["Total Loss"])
        report["tune_unit_acc"] = float(m["Acc"])
    report["tune_steps_per_s"] = args.tune_steps / phases.times["tune"]
    # post-tune accuracy on the batch the pre-tune reference used
    report["tune_unit_acc_post"] = float(t2u_sys.eval_step(t_state, tb0)["Acc"])
    serious = args.tune_steps >= 100
    _gate(report, "tune_loss_improves",
          report["tune_last_loss"] < report["tune_first_loss"],
          f"{report['tune_first_loss']:.3f} -> {report['tune_last_loss']:.3f}",
          enforced=serious)
    _gate(report, "unit_acc_improves_with_tune",
          report["tune_unit_acc_post"] > report["tune_unit_acc_transplant_only"],
          f"teacher-forced unit acc transplant-only "
          f"{report['tune_unit_acc_transplant_only']:.3f} -> tuned "
          f"{report['tune_unit_acc_post']:.3f}", enforced=serious)
    _gate(report, "tuned_unit_acc_margin", report["tune_unit_acc_post"] > 0.8,
          f"tuned unit acc {report['tune_unit_acc_post']:.3f} (bar > 0.8, fscl_tpu's bar)",
          enforced=serious, bar="tune_unit_acc_post > 0.8")

    # ---- 7. chained synthesis: text -> units -> mel ------------------------
    qry_ds = UnitDataset(os.path.join(task_dir, "val.txt"), target_store, task_cfg)
    qry_samples = [qry_ds[i] for i in range(len(qry_ds))]
    with phases("synthesis"):
        t2u_b = collate_t2u(qry_samples)
        _, preds, n_steps, _ = t2u_sys.infer(t2u_b.texts, t2u_b.src_lens)
        preds = preds.cpu().numpy()
        n_steps = np.maximum(n_steps.cpu().numpy(), 1)
        out = u2s.synthesize_bucketed(
            preds.astype(np.int64), n_steps.astype(np.int64), np.zeros(len(preds), np.int64),
            np.zeros(len(preds), np.int64), symbol_id=unit_name)
        chained_mels = out.postnet_mel.float().cpu().numpy()
        chained_lens = out.mel_len.cpu().numpy()
        report["synth_frames"] = int(chained_lens.sum())
    report["synth_frames_per_s"] = report["synth_frames"] / phases.times["synthesis"]

    if args.write_wavs:
        report["wav_dir"] = _write_wavs(args, phases, chained_mels, chained_lens)

    # ---- 8. eval: unit PER + chained / teacher-forced MCD ------------------
    with phases("eval"):
        unit_store = target_store.get_ssl_unit_store(unit_name)
        syms = LANG_ID2SYMBOLS[unit_name]
        val_queries = read_queries_from_txt(os.path.join(task_dir, "val.txt"))
        infos = []
        for i, q in enumerate(val_queries[: len(qry_samples)]):
            gt = unit_store.phoneme.read_from_query(q).strip()
            toks = [syms[int(u)] for u in preds[i][: int(n_steps[i])] if 0 < int(u) < len(syms)]
            infos.append({"gt": gt, "pred": " ".join(toks)})
        report["unit_per"] = per_over_infos(infos)

        # teacher-forced u2s MCD on ground-truth units (u2s quality) and
        # chained MCD against the ground-truth mels (the whole chain)
        _, u2s_val = collate_batch([tune_dm.u2s_sample(task_cfg, s) for s in qry_samples],
                                   **_var_kw(model_cfg))
        with torch.no_grad():
            tf = u2s(to_device(u2s_val, dev), unit_name)
        tf_mel = tf.postnet_mel.float().cpu().numpy()
        mcds_tf, mcds_chain = [], []
        for i in range(len(qry_samples)):
            L = int(u2s_val.mel_lens[i])
            gt_mel = np.asarray(u2s_val.mels[i][:L])
            mcds_tf.append(mel_cepstral_distortion(tf_mel[i][:L], gt_mel))
            mcds_chain.append(mel_cepstral_distortion(
                chained_mels[i][: int(chained_lens[i])], gt_mel))
        report["mcd_u2s_teacher_forced"] = float(np.mean(mcds_tf))
        report["mcd_chained"] = float(np.mean(mcds_chain))

    return _finish(args, phases, report, [
        f"u2s loss {report['u2s_first_loss']:.3f} -> {report['u2s_last_loss']:.3f}",
        f"meta loss {report['meta_first_loss']:.3f} -> {report['meta_last_loss']:.3f} "
        f"({report['episodes_per_s']:.2f} eps/s)",
        f"tune loss {report['tune_first_loss']:.3f} -> {report['tune_last_loss']:.3f} "
        f"(unit acc {report['tune_unit_acc']:.3f})",
        f"unit PER {report['unit_per']:.3f}",
        f"MCD(u2s tf) {report['mcd_u2s_teacher_forced']:.3f}  "
        f"MCD(chained) {report['mcd_chained']:.3f}",
    ])


def run_pr(args):
    """The phoneme-recognition family end to end: episodic protonet training
    -> task generation -> zero-shot transcription -> PER/FER."""
    import torch

    from fscl_tpu_torch.core.config import OptimConfig, TrainConfig
    from fscl_tpu_torch.core.device import resolve_device
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.data.datamodules import PREpisodicDataModule
    from fscl_tpu_torch.eval.metrics import fer_over_infos, per_over_infos
    from fscl_tpu_torch.eval.protonet_eval import run_protonet_eval
    from fscl_tpu_torch.frontend import n_symbols as n_sym_of
    from fscl_tpu_torch.systems.pr import SSLProtoNetSystem

    dev = resolve_device(args.device)
    os.makedirs(args.exp_dir, exist_ok=True)
    phases = _Phases(dev)
    model_cfg = _preset_cfg(args.preset)
    optim = OptimConfig(lr=args.lr, warmup_step=50, anneal_steps=())
    report = {"flow": "pr", "preset": args.preset, "episodes": args.episodes,
              "shots": args.shots}

    # ---- 1. corpus ---------------------------------------------------------
    meta_cfgs, target_cfg = _corpora(args, phases)

    # ---- 2. episodic protonet training -------------------------------------
    id2symbols = tuple(sorted({(dc.symbol_id, n_sym_of(dc.symbol_id))
                               for dc in meta_cfgs + [target_cfg]}))
    torch.manual_seed(41)
    system = SSLProtoNetSystem(model_cfg, id2symbols, device=dev, optim_cfg=optim,
                               upstream_seed=41)
    with phases("pr-train"):
        # PR episodes carry raw wavs on both sides: the datamodule reads
        # them from the packed FSCL shards
        _fresh_fscl_shards(meta_cfgs, model_cfg)
        dm = PREpisodicDataModule(meta_cfgs, model_cfg, TrainConfig(optim=optim, seed=43),
                                  shots=args.shots, queries=args.queries)
        dm.setup()
        eps = dm.train_batches()
        state = system.init_state()
        for i in range(args.episodes):
            state, m = system.train_step(state, to_device(next(eps), dev))
            if i == 0:
                report["pr_first_loss"] = float(m["Total Loss"])
        report["pr_last_loss"] = float(m["Total Loss"])
        report["pr_train_acc"] = float(m["Acc"])
    report["episodes_per_s"] = args.episodes / phases.times["pr-train"]

    # ---- 3. tasks -----------------------------------------------------------
    _, task_root, _, _ = _tasks(args, phases, target_cfg)

    # ---- 4. eval: zero-shot protonet transcription over the tasks ----------
    with phases("eval"):
        out_dir = os.path.join(args.exp_dir, "pr_results")
        paths = run_protonet_eval(system, os.path.join(task_root, f"{args.shots}-shot"),
                                  out_dir)
        infos = []
        for p in paths:
            with open(p) as f:
                infos.extend(json.load(f))
        report["per"] = per_over_infos(infos)
        report["fer"] = fer_over_infos(infos)
        report["n_eval_utts"] = len(infos)

    # quality gates: protonet training must lower the episodic loss, and
    # zero-shot transcription must beat chance frame accuracy
    serious = args.episodes >= 100
    _gate(report, "pr_loss_improves", report["pr_last_loss"] < report["pr_first_loss"],
          f"{report['pr_first_loss']:.3f} -> {report['pr_last_loss']:.3f}", enforced=serious)
    _gate(report, "fer_beats_chance", report["fer"] < 0.9,
          f"zero-shot FER {report['fer']:.3f} (chance ~0.95+)", enforced=serious)
    _gate(report, "fer_margin", report["fer"] < 0.5,
          f"zero-shot FER {report['fer']:.3f} (bar < 0.5, fscl_tpu's bar)",
          enforced=serious, bar="fer < 0.5")

    return _finish(args, phases, report, [
        f"pr loss {report['pr_first_loss']:.3f} -> {report['pr_last_loss']:.3f} "
        f"(train acc {report['pr_train_acc']:.3f}, {report['episodes_per_s']:.2f} eps/s)",
        f"zero-shot PER {report['per']:.3f}  FER {report['fer']:.3f} "
        f"over {report['n_eval_utts']} utts",
    ])
