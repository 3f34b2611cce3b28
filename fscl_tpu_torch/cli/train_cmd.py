"""`fscl_tpu_torch train` — train a system on preprocessed corpora (port of
`fscl_tpu/cli/train_cmd.py`, main.py:43-208).

Ported: the `baseline`/`baseline-tune` and `fscl`/`fscl-orig` paths
(`:90-125`), the generic path (`:121-133`: `systems/factory.py:build_system`
and the key's registered datamodule, which the T2U family's keys take),
`--pretrain_ckpt` (warm start), `--resume` (full restore), `--debug`,
`--total_step`, `--steps_per_dispatch`, and `--use_tracker` / `--exp_key`
(`:187-200`: an `obs/tracking.py:ExperimentTracker` under
`<exp_dir>/experiments`, named after the system, with the run's params; the
same key resumes it).

Several ranks (`:30-37`, `:167-181`), one process each (`parallel/`):
`--distributed` joins processes started from outside (the FSCL_* or
torchrun environment, `parallel.multihost.maybe_initialize`; each reads a
stream of its own); `--n_devices N` spawns N x n_model ranks on this host,
which all read the one global stream and keep their rows. The mesh is
(n_data, n_model): n_data is `--n_devices` (the world // n_model under
`--distributed`), n_model is `--n_model`, 2 by default when
`--upstream_parallel pp|sp` shards the frozen upstream over the model axis.
Each rank builds the system from the seed (rank 0's trainable weights are
then broadcast), restores on `--resume`, and runs the data-parallel step;
rank 0 alone logs, tracks and saves. In the spawning process `run` returns
None: the result is the checkpoint. The generic path keeps
fscl_tpu's faults (ROADMAP Queue 3): it passes the factory no T2U config (a
model YAML's `tacotron2:` block is not read) and no u2s (the E2E keys
raise); the episodic PR keys take episodes of 4 + 2 (the algorithm YAML's
shots are not passed); and every corpus is opened as a FastSpeech2Dataset
first (fscl_tpu's `:80-86`), so a PR corpus needs a speakers.json too.
A frozen upstream never reaches a checkpoint: fscl_tpu keeps it outside the
saved state (`TrainState.frozen`), the port strips `upstream.` for every
system that has one (the PR systems included).

One repair against fscl_tpu: with a d-vector model (`speaker_emb: dvec`,
config/model/fscl-fastspeech2.yaml) fscl_tpu's episodes carry speaker ids
where the system needs the reference mel slices, and its first episode
raises; the port's episodes carry the slices (`DvecRefs`), as its baseline
batches do.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from fscl_tpu_torch.core.checkpoint import CheckpointManager
from fscl_tpu_torch.core.config import (
    AlgorithmConfig, ModelConfig, TrainConfig, model_config_from_yaml, read_algorithm_config,
    read_data_config, train_config_from_yaml,
)
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.data.batch import collate_batch
from fscl_tpu_torch.data.datamodules import datamodule_kwargs_for, get_datamodule
from fscl_tpu_torch.data.datasets import ConcatDataset, FastSpeech2Dataset, FSCLDataset
from fscl_tpu_torch.data.episodic import EpisodicSampler, InfiniteEpisodes
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS, register_unit_symbols
from fscl_tpu_torch.obs.loggers import CheckpointCallback, LossTableLogger, TensorBoardLogger
from fscl_tpu_torch.obs.tracking import ExperimentTracker
from fscl_tpu_torch.parallel.mesh import choose_backend, make_mesh, replicate, world
from fscl_tpu_torch.parallel.multihost import launch, maybe_initialize, process_info
from fscl_tpu_torch.parallel.pipeline import attach_parallel_upstream
from fscl_tpu_torch.systems import get_system
from fscl_tpu_torch.systems.factory import build_system
from fscl_tpu_torch.systems.fscl import FrozenUpstream
from fscl_tpu_torch.train.trainer import Trainer

def check_speaker_table(datasets, model_cfg: ModelConfig) -> None:
    """A speaker-table model must have a row for every speaker id the
    datasets give (`speakers.json` order). fscl_tpu does not check: its
    table lookup gives NaN for an id past the table (base.yaml has no
    `speaker:` block, so one row); the port raises here instead of failing
    inside the step (on the card, a device-side assert)."""
    if model_cfg.speaker.emb_type != "table":
        return
    n = max((d.speaker_offset + len(d.speakers) for d in datasets), default=0)
    if n > model_cfg.speaker.n_speakers:
        raise ValueError(
            f"the corpora have {n} speakers but the model config's speaker table has "
            f"{model_cfg.speaker.n_speakers} rows: set speaker.n_speakers")


def baseline_batches(dataset, train_cfg: TrainConfig, model_cfg: ModelConfig, dvec_slices):
    """The baseline path's endless batch stream: batch_size utterances drawn
    uniformly with replacement from `seed` (fscl_tpu's `batches()`), read
    from the stores and collated on the host."""
    rng = np.random.default_rng(train_cfg.seed)
    bs = train_cfg.optim.batch_size
    while True:
        idxs = rng.integers(0, len(dataset), bs)
        _, batch = collate_batch(
            [dataset[int(i)] for i in idxs], dvec_slices=dvec_slices,
            pitch_feature=model_cfg.variance.pitch_feature,
            energy_feature=model_cfg.variance.energy_feature)
        yield batch


def _main_path(name, data_configs, model_cfg, train_cfg, algo_cfg, id2symbols, device):
    """The baseline and FSCL systems with fscl_tpu's own collates: (system,
    batch-stream factory)."""
    sys_cls = get_system(name)
    stores = {dc.name: FeatureStore(dc.data_dir) for dc in data_configs}
    need_ssl = name.startswith("fscl")
    # d-vector speaker paths need per-utterance reference mel slices
    # (speaker_encoder.py:115-136); datasets load them, collate pads them
    dvec_slices = model_cfg.speaker.n_ref_slices if model_cfg.speaker.uses_dvec else None
    ds_kw = {"spk_refer_wav": True} if dvec_slices else {}
    ds_cls = FSCLDataset if need_ssl else FastSpeech2Dataset
    datasets = [ds_cls(dc.subset_path("train"), stores[dc.name], dc, model_cfg, **ds_kw)
                for dc in data_configs]
    dataset = ConcatDataset(datasets)
    check_speaker_table(datasets, model_cfg)
    if not need_ssl:
        system = sys_cls(model_cfg, id2symbols, device=device, optim_cfg=train_cfg.optim)
        return system, lambda: baseline_batches(dataset, train_cfg, model_cfg, dvec_slices)
    # episodes carry raw per-language ids; the generated table only needs
    # to cover the largest per-language inventory (static shape)
    n_symbols = max(n for _, n in id2symbols)
    system = sys_cls(model_cfg, n_symbols, device=device, optim_cfg=train_cfg.optim,
                     upstream_seed=train_cfg.seed)
    labels = []
    for d in datasets:
        labels.extend([d.config.lang_id] * len(d))
    shots, queries = algo_cfg.adapt.shots, algo_cfg.adapt.queries
    sampler = EpisodicSampler(labels, shots=shots, queries=queries, seed=train_cfg.seed)
    # fscl_tpu draws one episode to initialise its state before training;
    # drawing its task here keeps both on the same episodes
    sampler.sample_task()
    stream = InfiniteEpisodes(dataset, sampler, shots, queries,
                              var_kw={"dvec_slices": dvec_slices} if dvec_slices else None)
    return system, lambda: iter(stream)


def _generic_path(args, data_configs, model_cfg, train_cfg, algo_cfg, device):
    """Any other registered key: the factory's system and the key's
    datamodule (fscl_tpu's `:121-133`); the T2U systems' dropout generator
    and every other system's frozen upstream are seeded from the train
    config's seed."""
    if args.system.startswith(("tacot2u", "fscl-t2u")):
        seeds = {"seed": train_cfg.seed}
        if args.system.startswith("fscl-t2u") and "tune" not in args.system:
            seeds["upstream_seed"] = train_cfg.seed
    else:
        seeds = {"upstream_seed": train_cfg.seed}
    system = build_system(args.system, model_cfg, train_cfg.optim, data_configs, algo_cfg,
                          device=device, **seeds)
    dm = get_datamodule(args.system)(data_configs, model_cfg, train_cfg, exp_dir=args.exp_dir,
                                     **datamodule_kwargs_for(args.system, algo_cfg))
    dm.setup()
    return system, dm.train_batches


def mesh_shape(args):
    """(n_data or None, n_model) of fscl_tpu's rule: n_model defaults to 2
    once the upstream is parallel."""
    if args.upstream_parallel == "none":
        return args.n_devices, args.n_model or 1
    return args.n_devices, max(args.n_model or 2, 2)


def run(args):
    """Returns (system, final TrainState); None in a process that spawned
    the ranks (`--n_devices`)."""
    device = resolve_device(args.device)
    n_data, n_model = mesh_shape(args)
    if args.distributed and maybe_initialize(device_type=device.type):
        pid, pcount = process_info()
        print(f"[distributed] process {pid}/{pcount}, backend "
              f"{torch.distributed.get_backend()}")
    if world()[1] == 1 and (n_data or 1) * n_model > 1:
        n = (n_data or 1) * n_model
        print(f"[parallel] {n} ranks ({n_data or 1} data x {n_model} model) on this host, "
              f"backend {choose_backend(device, n)}: nccl when every rank has a card of its "
              f"own, else gloo")
        launch(_rank_run, n, args, device_type=device.type)
        return None
    return _train(args, device, n_data, n_model)


def _rank_run(rank: int, device: torch.device, args):
    _train(args, device, args.n_devices, mesh_shape(args)[1])


def _train(args, device, n_data, n_model):
    rank, size = world()
    if device.type == "cuda" and size > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(n_data if not args.distributed else None, n_model, device) \
        if size > 1 else None
    lead = rank == 0

    data_configs = [read_data_config(p) for p in args.data_config]
    model_cfg = (model_config_from_yaml(args.model_config)
                 if args.model_config else ModelConfig())
    train_cfg = (train_config_from_yaml(args.train_config)
                 if args.train_config else TrainConfig())
    algo_cfg = (read_algorithm_config(args.algorithm_config)
                if args.algorithm_config else AlgorithmConfig(type=args.system))
    if args.total_step:
        train_cfg = dataclasses.replace(train_cfg, total_step=args.total_step)
    if args.steps_per_dispatch:
        train_cfg = dataclasses.replace(train_cfg, steps_per_dispatch=args.steps_per_dispatch)

    # register pseudo-unit inventories recorded by `make-units`
    # (reference: build_id2symbols adds common_symbols + unit ids,
    # lightning/build.py:24-31)
    for dc in data_configs:
        if dc.unit_name and dc.unit_name not in LANG_ID2SYMBOLS:
            attrs = FeatureStore(dc.data_dir).get_ssl_unit_store(dc.unit_name).load_attrs()
            if "n_units" not in attrs:
                raise FileNotFoundError(
                    f"unit set '{dc.unit_name}' not found in {dc.data_dir}: "
                    "run `fscl_tpu make-units` first")
            register_unit_symbols(dc.unit_name, attrs["n_units"])
    id2symbols = tuple((dc.symbol_id, len(LANG_ID2SYMBOLS[dc.symbol_id]))
                       for dc in data_configs)

    for dc in data_configs:
        if not dc.subset_path("train"):
            raise ValueError(f"data config {dc.name} has no train subset")
        # fscl_tpu opens every corpus as a FastSpeech2Dataset before choosing
        # a path (its split and speakers.json), whatever the system
        FastSpeech2Dataset(dc.subset_path("train"), FeatureStore(dc.data_dir), dc, model_cfg)
    # the trunk from torch's init under the seed (and an FSCL upstream drawn
    # on the device from it)
    torch.manual_seed(train_cfg.seed)
    if args.system in ("baseline", "baseline-tune", "fscl", "fscl-orig"):
        system, batches = _main_path(args.system, data_configs, model_cfg, train_cfg, algo_cfg,
                                     id2symbols, device)
    else:
        system, batches = _generic_path(args, data_configs, model_cfg, train_cfg, algo_cfg,
                                        device)
    state = system.init_state()
    if mesh is not None:
        # the same seed gives every rank the same weights; rank 0's are
        # broadcast all the same (the frozen upstream, drawn on the device
        # from the seed, is left out: it is large and never trained)
        replicate([p for n, p in system.named_parameters() if not n.startswith("upstream.")]
                  + list(system.buffers()), mesh)

    if args.debug:
        # reference --debug harness (main.py:45-49, system.py:32-36): print
        # the model structure and cap the run to a couple of steps
        print(f"[debug] system={args.system} ({type(system).__name__} on {system.device})")
        for name, module in system.named_children():
            n = sum(p.numel() for p in module.parameters())
            print(f"[debug]   {name}: {n:,} params")
        train_cfg = dataclasses.replace(
            train_cfg, total_step=min(train_cfg.total_step, 2),
            log_step=1, val_step=10**9, synth_step=10**9, save_step=10**9)
        print(f"[debug] total_step capped to {train_cfg.total_step}")

    ckpt_dir = os.path.join(args.exp_dir, "ckpt")
    strip = ("upstream",) if isinstance(system, FrozenUpstream) else ()
    mgr = CheckpointManager(ckpt_dir, strip_prefixes=strip, max_to_keep=5)
    if args.pretrain_ckpt:
        CheckpointManager(args.pretrain_ckpt).restore_into(system, state)
    if args.resume and mgr.all_steps():
        state = mgr.restore_into(system, state, full=True)

    if args.upstream_parallel != "none":
        # pipeline- or sequence-parallel frozen upstream over the model axis;
        # the step is unchanged: extract_ssl dispatches through the hook
        attach_parallel_upstream(system, args.upstream_parallel, mesh)
        if lead:
            print(f"[parallel] frozen upstream {args.upstream_parallel} over "
                  f"{mesh.size('model')} model-axis ranks")
    if not lead:
        Trainer(system, train_cfg, mesh=mesh).fit(state, batches())
        return system, state
    tb = TensorBoardLogger(os.path.join(args.exp_dir, "tb"))
    callbacks = [LossTableLogger(os.path.join(args.exp_dir, "log")), tb,
                 CheckpointCallback(mgr, system)]
    tracker = None
    if args.use_tracker:
        # experiment tracking with a persistent exp_key (the reference's
        # --use_comet + --exp_key resume flow, main.py:91-137)
        tracker = ExperimentTracker(
            os.path.join(args.exp_dir, "experiments"), name=args.system,
            exp_key=args.exp_key,
            params={"system": args.system, "total_step": train_cfg.total_step,
                    "batch_size": train_cfg.optim.batch_size, "lr": train_cfg.optim.lr})
        print(f"[tracker] exp_key={tracker.exp_key} ({tracker.dir})")
        callbacks.append(tracker)
    try:
        state = Trainer(system, train_cfg, callbacks=callbacks, mesh=mesh).fit(state, batches())
    finally:
        tb.close()
        if tracker is not None:
            tracker.close()
    mgr.save(state.step, system, state)
    print(f"[train] done at step {state.step}; ckpts in {ckpt_dir}")
    return system, state
