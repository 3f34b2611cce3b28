"""T2U tune family: few-shot transfer, the E2E chain through a frozen u2s,
domain-adversarial tuning (port of `fscl_tpu/systems/t2u_tune.py`).

- `t2u_build_reference_table` (`:38`) / `t2u_tune_init` (`:77`): the target
  language's phoneme table from the few-shot split, through the FSCL-T2U
  system's frozen upstream, frame features and post-extraction transform
  (so a C or C2 meta-system gives its codebook-path table), copied into a
  TacoT2USystem's `table-<symbol_id>` in place.
- `T2UTuneSystem` (`:97`): supervised TacoT2U on the split after the
  transplant.
- `E2ETuneSystem` (`:111`): the T2U's softmax over units times the frozen
  u2s BaselineSystem's unit table, through the u2s FastSpeech2, loss T2U +
  U2S (`u2s_forward` `:166-201`). The u2s is frozen as fscl_tpu's
  `TrainState.frozen` is: its parameters do not require grad (so they stay
  out of `trainable_mask`), and it is in eval mode whatever the system's mode (fscl_tpu
  applies it with `deterministic=True`: dropout off, the PostNet's
  BatchNorm on its running statistics). The gradient reaches the T2U
  through it: the u2s trunk's attention runs under `AttentionFunction`.
- `DAE2ETuneSystem` (`:251`) and `DATuneSystem` (`:291`): a gradient-
  reversal unit discriminator over the soft predicted units against one-hot
  real unit sequences.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from fscl_tpu_torch.core.config import ModelConfig, OptimConfig
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.data.batch import Batch, SupInfo, to_device
from fscl_tpu_torch.models.fastspeech2 import FastSpeech2Output
from fscl_tpu_torch.models.tacotron2_t2u import T2UConfig, T2UMasks
from fscl_tpu_torch.nn.losses import fastspeech2_loss, framewise_accuracy, framewise_ce_loss
from fscl_tpu_torch.ops.masking import length_mask
from fscl_tpu_torch.ops.segment_ops import phoneme_query_sums, queries_from_sums
from fscl_tpu_torch.ops.global_reduce import global_mean
from fscl_tpu_torch.systems.fscl import transplant_embedding
from fscl_tpu_torch.systems.t2u import DA, T2UBatch, TacoT2USystem, TransEmbT2USystem


@torch.no_grad()
def t2u_build_reference_table(fscl_t2u: TransEmbT2USystem,
                              sup_batches: Iterable[SupInfo]) -> torch.Tensor:
    """(n_symbols, d) table of the split (numpy SupInfo batches): per-symbol
    sums of segment means accumulated batch by batch, then the means and
    the system's `post_table`."""
    fscl_t2u.eval()
    total_sums = total_counts = None
    for sup in sup_batches:
        sup = to_device(sup, fscl_t2u.device)
        hidden, _ = fscl_t2u.extract_ssl(sup.wavs, sup.wav_lens)
        Tp = hidden.shape[1]
        frame_valid = length_mask(sup.avg_frames.sum(dim=-1).clamp(max=Tp), Tp)
        x = fscl_t2u.frame_features(hidden, frame_valid)
        sums, counts = phoneme_query_sums(x[:, :, None, :], sup.avg_frames, sup.phonemes,
                                          fscl_t2u.n_symbols)
        total_sums = sums if total_sums is None else total_sums + sums
        total_counts = counts if total_counts is None else total_counts + counts
    return fscl_t2u.post_table(queries_from_sums(total_sums, total_counts)[0, :, 0])


def t2u_tune_init(fscl_t2u: TransEmbT2USystem, t2u_system: TacoT2USystem,
                  sup_batches: Iterable[SupInfo], symbol_id: str) -> torch.Tensor:
    """The embedding transplant: the split's table copied into
    `t2u_system`'s `table-<symbol_id>`, in place. Returns the table."""
    table = t2u_build_reference_table(fscl_t2u, sup_batches)
    transplant_embedding(t2u_system, table, symbol_id)
    return table


@SYSTEMS.register("fscl-t2u-tune", "fscl-t2u-orig-tune")
class T2UTuneSystem(TacoT2USystem):
    """Plain few-shot T2U fine-tuning (TransEmbTune/TransEmbOrigTune):
    supervised TacoT2U on the split after `t2u_tune_init`."""


class E2EBatch(NamedTuple):
    """Paired t2u + u2s data (T2U2SDataModule CombinedLoader semantics)."""
    t2u: T2UBatch
    u2s: Batch


class DABatch(NamedTuple):
    t2u: T2UBatch
    real_units: np.ndarray      # (B, T_u) unit ids from the unit LM stream
    real_unit_lens: np.ndarray


class DAE2EBatch(NamedTuple):
    t2u: T2UBatch
    u2s: Batch
    real_units: np.ndarray
    real_unit_lens: np.ndarray


@SYSTEMS.register("fscl-t2u-e2e-tune", "fscl-t2u-orig-e2e-tune",
                  "fscl-t2u-c-e2e-tune", "fscl-t2u-c2-e2e-tune")
class E2ETuneSystem(TacoT2USystem):
    """T2U fine-tuning chained through a frozen u2s BaselineSystem (its
    parameters under `u2s_system.`). The C/C2 keys share this class: they
    differ in how the tune-time table is made, which
    `t2u_build_reference_table` takes from the meta-system it is given."""

    def __init__(self, model_cfg: ModelConfig, id2symbols: Tuple[Tuple[str, int], ...],
                 t2u_cfg: T2UConfig, u2s_system, device: Optional[Union[str, torch.device]] = None,
                 optim_cfg: Optional[OptimConfig] = None, seed: int = 0,
                 u2s_symbol_id: Optional[str] = None):
        super().__init__(model_cfg, id2symbols, t2u_cfg, device, optim_cfg, seed)
        self.u2s_system = u2s_system.to(self.device)
        self.u2s_system.requires_grad_(False)
        self.u2s_symbol_id = u2s_symbol_id
        self.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        if "u2s_system" in self._modules:       # not yet while the base class builds
            self.u2s_system.eval()
        return self

    def u2s_unit_table(self) -> torch.Tensor:
        """The frozen u2s unit-embedding table: `table-<u2s_symbol_id>`, or
        the only table of a u2s with one."""
        tables = self.u2s_system.embedding_model.tables
        if self.u2s_symbol_id is not None:
            key = f"table-{self.u2s_symbol_id}"
            if key not in tables:
                raise KeyError(f"u2s checkpoint has no embedding table {key!r}; "
                               f"available: {sorted(tables)}")
            return tables[key]
        if len(tables) != 1:
            raise ValueError(f"u2s checkpoint is multilingual ({sorted(tables)}); pass "
                             "u2s_symbol_id to select the unit table")
        return next(iter(tables.values()))

    def u2s_forward(self, t2u_logits: torch.Tensor, u2s_batch: Batch) -> FastSpeech2Output:
        """The soft unit distribution times the frozen u2s unit table, cut
        or zero-padded to the u2s batch's unit length, through the u2s
        FastSpeech2 (teacher-forced on the u2s batch's targets)."""
        table = self.u2s_unit_table()
        probs = torch.softmax(t2u_logits, dim=-1)[..., :table.shape[0]]
        T_u = u2s_batch.durations.shape[1]
        probs = probs[:, :T_u] if probs.shape[1] >= T_u else \
            F.pad(probs, (0, 0, 0, T_u - probs.shape[1]))
        emb = torch.matmul(probs, table)
        b = u2s_batch
        return self.u2s_system.model(
            emb, b.src_lens, b.mels.shape[1], speaker_args=b.speaker_args,
            mel_lens=b.mel_lens, p_targets=b.pitches, e_targets=b.energies,
            d_targets=b.durations, lang_args=b.lang_ids)

    def e2e_loss(self, batch, masks: Optional[T2UMasks] = None):
        """(total, metrics, t2u logits) of the chain."""
        logits, _ = self(batch.t2u, masks)
        t2u_loss = framewise_ce_loss(logits, batch.t2u.units)
        out = self.u2s_forward(logits, batch.u2s)
        var = self.model_cfg.variance
        u2s = fastspeech2_loss(
            out.mel, out.postnet_mel, out.pitch_prediction, out.energy_prediction,
            out.log_duration_prediction, batch.u2s.mels, batch.u2s.pitches,
            batch.u2s.energies, batch.u2s.durations, out.src_valid, out.mel_valid,
            var.pitch_feature, var.energy_feature)
        total = t2u_loss + u2s.total
        metrics = {"Total Loss": total.detach(), "T2U Loss": t2u_loss.detach(),
                   "U2S Loss": u2s.total.detach(),
                   "Acc": framewise_accuracy(logits.detach(), batch.t2u.units)}
        return total, metrics, logits

    def loss_and_metrics(self, batch: E2EBatch, masks: Optional[T2UMasks] = None):
        total, metrics, _ = self.e2e_loss(batch, masks)
        return total, metrics


def da_loss(da: DA, logits, units, real_units, real_unit_lens, n_units: int):
    """softplus(-real score) + softplus(fake score), each a batch mean; the
    fake side is the soft predicted units through the gradient reversal."""
    fake = da(torch.softmax(logits, dim=-1), units != 0)
    real = da(F.one_hot(real_units.long(), n_units).float(),
              length_mask(real_unit_lens, real_units.shape[1]))
    return global_mean(F.softplus(-real)) + global_mean(F.softplus(fake))


@SYSTEMS.register("fscl-t2u-dae2e-tune", "fscl-t2u-da-e2e-tune",
                  "fscl-t2u-c-da-e2e-tune", "fscl-t2u-c2-da-e2e-tune")
class DAE2ETuneSystem(E2ETuneSystem):
    """E2E chain + gradient-reversal unit discriminator
    (TransEmbDAE2ETune.py): Total = T2U + U2S + da_weight * DA."""

    def __init__(self, *args, da_weight: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.da = DA(self.t2u_cfg.n_units).to(self.device)
        self.da_weight = da_weight

    def loss_and_metrics(self, batch: DAE2EBatch, masks: Optional[T2UMasks] = None):
        e2e_total, metrics, logits = self.e2e_loss(batch, masks)
        d = da_loss(self.da, logits, batch.t2u.units, batch.real_units, batch.real_unit_lens,
                    self.t2u_cfg.n_units)
        total = e2e_total + self.da_weight * d
        return total, dict(metrics, **{"DA Loss": d.detach(), "Total Loss": total.detach()})


@SYSTEMS.register("fscl-t2u-da-tune")
class DATuneSystem(TacoT2USystem):
    """T2U fine-tuning with a gradient-reversal unit discriminator
    (TransEmbDATune; wav2vec2-U style): Total = T2U + da_weight * DA."""

    def __init__(self, model_cfg: ModelConfig, id2symbols: Tuple[Tuple[str, int], ...],
                 t2u_cfg: T2UConfig, device=None, optim_cfg=None, seed: int = 0,
                 da_weight: float = 1.0):
        super().__init__(model_cfg, id2symbols, t2u_cfg, device, optim_cfg, seed)
        self.da = DA(t2u_cfg.n_units).to(self.device)
        self.da_weight = da_weight

    def loss_and_metrics(self, batch: DABatch, masks: Optional[T2UMasks] = None):
        logits, _ = self(batch.t2u, masks)
        t2u_loss = framewise_ce_loss(logits, batch.t2u.units)
        d = da_loss(self.da, logits, batch.t2u.units, batch.real_units, batch.real_unit_lens,
                    self.t2u_cfg.n_units)
        total = t2u_loss + self.da_weight * d
        return total, {"Total Loss": total.detach(), "T2U Loss": t2u_loss.detach(),
                       "DA Loss": d.detach(),
                       "Acc": framewise_accuracy(logits.detach(), batch.t2u.units)}
