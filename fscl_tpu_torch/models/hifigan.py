"""HiFi-GAN generator (port of `fscl_tpu/models/hifigan.py`).

mel (B, T, n_mels) -> waveform (B, T * prod(upsample_rates)). Parameters
use the official torch HiFi-GAN key names with weight norm folded in:
`conv_pre.weight`, `ups.{i}.weight`, `resblocks.{i*n+j}.convs{1,2}.{c}.weight`
and `conv_post.weight` (each with its `.bias`). `load_torch_checkpoint`
folds the weight norm of an official generator checkpoint the way
`convert_torch_checkpoint` does in the JAX package.

Each MRF stage (the mean of the stage's resblocks, and for the last stage
the leaky -> conv_post -> tanh head) runs through `ops.mrf_stage.mrf_stage`:
the Hopper kernel on CUDA tensors, the plain version on CPU tensors.
`conv_pre` and the transposed-conv upsamplers are `F.conv1d` and
`F.conv_transpose1d`; ConvTranspose1d with padding (k - r) // 2 computes
what the JAX package's flax `ConvTranspose(padding="SAME")` computes.

The leaky ReLU before conv_post has slope 0.1, as in `fscl_tpu`; the
published HiFi-GAN uses torch's default 0.01 there (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fscl_tpu_torch.ops.mrf_stage import SLOPE, mrf_stage, resblock_reference

UPSAMPLE_IMPLS = ("conv_transpose", "subpixel")


class ResBlock1(nn.Module):
    """x <- x + conv2(leaky(conv1_d(leaky(x)))) for each dilation d."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = int(kernel_size)
        self.dilations = tuple(int(d) for d in dilations)
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size - 1) // 2 * d) for d in self.dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in self.dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, C, T)
        return resblock_reference(x, self)


class HiFiGANGenerator(nn.Module):
    """HiFi-GAN V1 by default: 512 initial channels, upsample rates
    (8, 8, 2, 2) with kernels (16, 16, 4, 4), resblock kernels (3, 7, 11)
    with dilations (1, 3, 5) each; hop 256.

    `upsample_impl="subpixel"` is accepted for the JAX package's
    SubpixelUpsample: it has the same parameter layout and computes the same
    values as the transposed conv, so the port runs the transposed conv
    either way."""

    def __init__(self, n_mels: int = 80,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_impl: str = "conv_transpose"):
        super().__init__()
        if upsample_impl not in UPSAMPLE_IMPLS:
            raise ValueError(f"upsample_impl {upsample_impl!r} not in {UPSAMPLE_IMPLS}")
        self.n_mels = n_mels
        self.upsample_rates = tuple(int(r) for r in upsample_rates)
        self.upsample_kernel_sizes = tuple(int(k) for k in upsample_kernel_sizes)
        self.upsample_initial_channel = int(upsample_initial_channel)
        self.resblock_kernel_sizes = tuple(int(k) for k in resblock_kernel_sizes)
        self.resblock_dilations = tuple(tuple(int(d) for d in ds) for ds in resblock_dilations)
        self.upsample_impl = upsample_impl
        ch0 = self.upsample_initial_channel
        self.conv_pre = nn.Conv1d(n_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (r, k) in enumerate(zip(self.upsample_rates, self.upsample_kernel_sizes)):
            ch = ch0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch0 // (2 ** i), ch, k, stride=r,
                                               padding=(k - r) // 2))
            for rk, rd in zip(self.resblock_kernel_sizes, self.resblock_dilations):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch0 // (2 ** len(self.upsample_rates)), 1, 7, padding=3)

    @property
    def hop(self) -> int:
        n = 1
        for r in self.upsample_rates:
            n *= r
        return n

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mels) log-mel -> wav (B, T * hop)."""
        x = self.conv_pre(mel.transpose(1, 2))
        n = len(self.resblock_kernel_sizes)
        last = len(self.ups) - 1
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, SLOPE)).contiguous()
            x = mrf_stage(x, self.resblocks[i * n:(i + 1) * n],
                          post=self.conv_post if i == last else None)
        return x


StateDict = Dict[str, torch.Tensor]
WEIGHT_NORM_PAIRS = ((".weight_g", ".weight_v"),
                     (".parametrizations.weight.original0", ".parametrizations.weight.original1"))


def strip_packaging(state_dict: Mapping) -> StateDict:
    """Unwrap `{"generator": sd}` and drop a `generator.` or `module.`
    (DataParallel) prefix carried by every key."""
    if "generator" in state_dict and isinstance(state_dict["generator"], Mapping):
        state_dict = state_dict["generator"]
    sd = dict(state_dict)
    for prefix in ("generator.", "module."):
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def fold_weight_norm(state_dict: Mapping) -> StateDict:
    """Replace every weight-norm pair (`weight_g`/`weight_v`, or torch>=2.1's
    `parametrizations.weight.original0/1`) by its weight g * v / ||v||, the
    norm taken over all but the first dimension (torch's weight_norm dim=0,
    the fold of `convert_torch_checkpoint`). Other keys pass through."""
    out: StateDict = {}
    for key, value in state_dict.items():
        for g_suffix, v_suffix in WEIGHT_NORM_PAIRS:
            if key.endswith(v_suffix):      # folded with its g
                break
            if key.endswith(g_suffix):
                prefix = key[:-len(g_suffix)]
                g = torch.as_tensor(value)
                v = torch.as_tensor(state_dict[prefix + v_suffix])
                norm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
                out[prefix + ".weight"] = g * v / norm.reshape(-1, *([1] * (v.dim() - 1)))
                break
        else:
            out[key] = torch.as_tensor(value)
    return out


def load_torch_checkpoint(state_dict: Mapping) -> StateDict:
    """An official HiFi-GAN generator checkpoint (any of its packagings) ->
    this module's `state_dict`. A port `state_dict` passes through."""
    return fold_weight_norm(strip_packaging(state_dict))
