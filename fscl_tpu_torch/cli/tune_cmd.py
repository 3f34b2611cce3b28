"""`fscl_tpu_torch tune` — few-shot transfer to a new language (port of
`fscl_tpu/cli/tune_cmd.py`; main.py --tune path, §3.3: the tune_init
embedding transplant, then supervised fine-tuning on the few-shot split).

As in fscl_tpu: the FSCL checkpoint (`--fscl_ckpt`, warm start) gives the
codebook, the frozen upstream is drawn from seed 0, and the reference table
of the split, streamed through it in SupInfo batches of 4, is transplanted
into a `BaselineSystem` whose trunk starts from its own init under the train
seed. `--scan_adapt` runs the adaptation loop of `systems/tune.py` on the
device with the split resident (`adapt_on_chip_resident`), or, for splits
of more than 128 utterances or with d-vector speakers, chunk by chunk
(`adapt_on_chip_chunked`); without it the `Trainer` fine-tunes.
"""
from __future__ import annotations

import os

import torch

from fscl_tpu_torch.core.checkpoint import CheckpointManager
from fscl_tpu_torch.core.config import (
    ModelConfig, TrainConfig, model_config_from_yaml, read_data_config,
)
from fscl_tpu_torch.cli.train_cmd import check_speaker_table
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.data.datamodules import FastSpeech2DataModule
from fscl_tpu_torch.data.datasets import FSCLDataset
from fscl_tpu_torch.data.episodic import collate_sup_info
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS
from fscl_tpu_torch.obs.loggers import AdaptationSaver, CheckpointCallback, LossTableLogger
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.systems.fscl import TransEmbSystem
from fscl_tpu_torch.systems.tune import (
    adapt_on_chip_chunked, adapt_on_chip_resident, adaptable_params, load_adapted, tune_init,
)
from fscl_tpu_torch.train.trainer import Trainer

SUP_BATCH = 4     # support wavs per upstream call (fscl_tpu's tune_cmd.py:55-57)


def run(args):
    """Returns (the adapted system, per-step adaptation losses on the
    host for --scan_adapt, else None)."""
    device = resolve_device(args.device)
    dc = read_data_config(args.data_config)
    model_cfg = (model_config_from_yaml(args.model_config)
                 if args.model_config else ModelConfig())
    train_cfg = TrainConfig(total_step=args.adaptation_steps)
    id2symbols = ((dc.symbol_id, len(LANG_ID2SYMBOLS[dc.symbol_id])),)
    n_symbols = len(LANG_ID2SYMBOLS[dc.symbol_id])

    # data
    store = FeatureStore(dc.data_dir)
    fscl_ds = FSCLDataset(dc.subset_path("train"), store, dc, model_cfg,
                          upstream=model_cfg.upstream.name)
    dm = FastSpeech2DataModule([dc], model_cfg, train_cfg, exp_dir=args.exp_dir)
    dm.setup()
    check_speaker_table(dm.train_set.datasets, model_cfg)

    # systems: pretrained FSCL (frozen meta-learned codebook) + baseline
    torch.manual_seed(train_cfg.seed)
    baseline = BaselineSystem(model_cfg, id2symbols, device=device, optim_cfg=train_cfg.optim)
    b_state = baseline.init_state()
    fscl = TransEmbSystem(model_cfg, n_symbols, device=device, optim_cfg=train_cfg.optim,
                          upstream_seed=0)
    sup_batches = [collate_sup_info([fscl_ds[i] for i in range(
        start, min(start + SUP_BATCH, len(fscl_ds)))])
        for start in range(0, len(fscl_ds), SUP_BATCH)]
    if args.fscl_ckpt:
        CheckpointManager(args.fscl_ckpt).restore_into(fscl)

    # embedding transplant (tune_init)
    tune_init(fscl, baseline, sup_batches, dc.symbol_id)
    del fscl

    ckpt_dir = os.path.join(args.exp_dir, "ckpt")
    mgr = CheckpointManager(ckpt_dir, max_to_keep=3)
    losses = None
    if args.scan_adapt:
        # few-shot splits fit on the device whole: uploaded once, each
        # step's batch gathered there; larger or d-vector splits stream in
        # chunks. The per-ft-step loss curve is saved like the reference's
        # meta saver CSVs (lightning/callbacks/saver.py:23-321)
        params = adaptable_params(baseline)
        support = dm.full_train_batch()
        if support is not None:
            adapted, losses = adapt_on_chip_resident(
                baseline, params, support, args.adaptation_steps,
                batch_size=train_cfg.optim.batch_size, lr=args.scan_lr,
                symbol_id=dc.symbol_id, optimizer=args.scan_optimizer, seed=train_cfg.seed)
        else:
            adapted, losses = adapt_on_chip_chunked(
                baseline, params, dm.train_batches(), args.adaptation_steps,
                lr=args.scan_lr, symbol_id=dc.symbol_id, optimizer=args.scan_optimizer)
        load_adapted(baseline, adapted)
        losses = losses.cpu().numpy()
        path = AdaptationSaver(os.path.join(args.exp_dir, "csv")).save_curve(dc.symbol_id, losses)
        print(f"[tune] scan adaptation loss {float(losses[0]):.3f} -> "
              f"{float(losses[-1]):.3f}; curve at {path}")
    else:
        trainer = Trainer(baseline, train_cfg, callbacks=[
            LossTableLogger(os.path.join(args.exp_dir, "log")),
            CheckpointCallback(mgr, baseline)])
        b_state = trainer.fit(b_state, dm.train_batches())
    mgr.save(b_state.step, baseline, b_state)
    print(f"[tune] adapted to {dc.symbol_id}; ckpts in {ckpt_dir}")
    return baseline, losses
