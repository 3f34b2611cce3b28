"""Losses (port of `fscl_tpu/nn/losses.py:18-63`).

Masked means over valid positions, as the reference's masked_select(...)
.mean() reductions (lightning/model/loss.py); `masked_mean` counts at least
one position. `framewise_ce_loss` and `framewise_accuracy` (`:66-80`) are
the T2U family's: cross-entropy and accuracy over the frames whose target
is not PAD. Under `parallel.mesh.data_parallel` every mean is over the
global batch (`global_sum` of the sums and the counts).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from fscl_tpu_torch.ops.masking import masked_mean
from fscl_tpu_torch.ops.global_reduce import global_sum


class FastSpeech2LossOutput(NamedTuple):
    total: torch.Tensor
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor
    duration: torch.Tensor

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {
            "Total Loss": self.total, "Mel Loss": self.mel,
            "Mel-Postnet Loss": self.postnet_mel, "Pitch Loss": self.pitch,
            "Energy Loss": self.energy, "Duration Loss": self.duration,
        }


def fastspeech2_loss(
    mel_pred, postnet_mel_pred,          # (B, T, n_mels)
    pitch_pred, energy_pred,             # (B, L) or (B, T) per feature level
    log_d_pred,                          # (B, L)
    mel_target, pitch_target, energy_target, duration_target,
    src_valid, mel_valid,
    pitch_level: str = "phoneme_level",
    energy_level: str = "phoneme_level",
) -> FastSpeech2LossOutput:
    """FastSpeech2Loss (loss.py:15-88): L1 mel + L1 postnet + MSE pitch,
    energy and log-duration over valid positions."""
    log_d_target = torch.log(duration_target.float() + 1.0)

    p_valid = src_valid if pitch_level == "phoneme_level" else mel_valid
    e_valid = src_valid if energy_level == "phoneme_level" else mel_valid

    mel_l = masked_mean((mel_pred - mel_target).abs(), mel_valid)
    post_l = masked_mean((postnet_mel_pred - mel_target).abs(), mel_valid)
    pitch_l = masked_mean((pitch_pred - pitch_target) ** 2, p_valid)
    energy_l = masked_mean((energy_pred - energy_target) ** 2, e_valid)
    dur_l = masked_mean((log_d_pred - log_d_target) ** 2, src_valid)
    total = mel_l + post_l + pitch_l + energy_l + dur_l
    return FastSpeech2LossOutput(total, mel_l, post_l, pitch_l, energy_l, dur_l)


def fastspeech2_ada_loss(mel_pred, postnet_mel_pred, mel_target, mel_valid):
    """FastSpeech2ADALoss (loss.py:105-140): mel losses only; returns
    (total, mel, postnet_mel)."""
    mel_l = masked_mean((mel_pred - mel_target).abs(), mel_valid)
    post_l = masked_mean((postnet_mel_pred - mel_target).abs(), mel_valid)
    return mel_l + post_l, mel_l, post_l


def framewise_ce_loss(logits, targets, ignore_index: int = 0):
    """Mean cross-entropy over the frames whose target is not
    `ignore_index` (at least one frame in the count)."""
    valid = targets != ignore_index
    ce = -torch.log_softmax(logits.float(), dim=-1).gather(
        -1, targets.clamp(min=0).long()[..., None])[..., 0]
    return global_sum(torch.where(valid, ce, 0.0).sum()) / global_sum(valid.sum()).clamp(min=1)


def framewise_accuracy(logits, targets, ignore_index: int = 0):
    valid = targets != ignore_index
    correct = (logits.argmax(dim=-1) == targets) & valid
    return global_sum(correct.sum()) / global_sum(valid.sum()).clamp(min=1)
