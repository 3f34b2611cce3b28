"""MelGAN generator (port of `fscl_tpu/models/melgan.py`).

The melgan-neurips mel2wav generator: mel (B, T, n_mels) log10-mel ->
waveform (B, T * prod(ratios)). Reflection-padded convs, leaky ReLU slope
0.2, and per stage a transposed conv then residual blocks with a 1x1
shortcut. The module is the same `nn.Sequential` as the published one, so
its keys are melgan-neurips' (`model.{i}.weight`, `model.{i}.block.2.weight`,
`model.{i}.shortcut.weight`, ...) with weight norm folded in;
`load_torch_checkpoint` folds a released checkpoint. MelGAN runs no kernel
of its own: every op is a plain torch op on either device.

The reference feeds `mel / ln(10)` into MelGAN (natural-log mel -> log10);
`audio_out.vocoder.Vocoder` does the same.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from fscl_tpu_torch.models.hifigan import StateDict, fold_weight_norm

SLOPE = 0.2


class ResnetBlock(nn.Module):
    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        self.block = nn.Sequential(
            nn.LeakyReLU(SLOPE),
            nn.ReflectionPad1d(dilation),
            nn.Conv1d(channels, channels, 3, dilation=dilation),
            nn.LeakyReLU(SLOPE),
            nn.Conv1d(channels, channels, 1))
        self.shortcut = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) + self.block(x)


class MelGANGenerator(nn.Module):
    """melgan-neurips configuration: 512 base channels, ratios (8, 8, 2, 2),
    3 residual blocks per stage with dilations 1, 3, 9."""

    def __init__(self, n_mels: int = 80, base_channels: int = 512,
                 ratios: Sequence[int] = (8, 8, 2, 2), n_residual: int = 3):
        super().__init__()
        self.n_mels = n_mels
        self.ratios = tuple(int(r) for r in ratios)
        layers = [nn.ReflectionPad1d(3), nn.Conv1d(n_mels, base_channels, 7)]
        for i, r in enumerate(self.ratios):
            cin, ch = base_channels // (2 ** i), base_channels // (2 ** (i + 1))
            layers += [nn.LeakyReLU(SLOPE),
                       nn.ConvTranspose1d(cin, ch, 2 * r, stride=r, padding=r // 2 + r % 2,
                                          output_padding=r % 2)]
            layers += [ResnetBlock(ch, dilation=3 ** j) for j in range(n_residual)]
        layers += [nn.LeakyReLU(SLOPE), nn.ReflectionPad1d(3),
                   nn.Conv1d(base_channels // (2 ** len(self.ratios)), 1, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    @property
    def hop(self) -> int:
        n = 1
        for r in self.ratios:
            n *= r
        return n

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mels) log10-mel -> wav (B, T * hop)."""
        return self.model(mel.transpose(1, 2))[:, 0]


def load_torch_checkpoint(state_dict: Mapping) -> StateDict:
    """A melgan-neurips Generator state_dict (weight-norm convs under
    `model.`, or under `mel2wav.model.` in hub bundles, or unscoped) -> this
    module's `state_dict`. A port `state_dict` passes through."""
    sd = dict(state_dict)
    if any(k.startswith("mel2wav.model.") for k in sd):
        sd = {k[len("mel2wav."):]: v for k, v in sd.items() if k.startswith("mel2wav.model.")}
    elif not any(k.startswith("model.") for k in sd):
        sd = {f"model.{k}": v for k, v in sd.items()}
    return fold_weight_norm(sd)
