"""ContiAE and semi-supervised FSCL (port of `fscl_tpu/systems/conti_ae.py`).

- `ContiAESystem` ("conti-ae", `:47-130`): speech reconstructed from one
  layer of the frozen SSL upstream: a Linear embed of that layer's features,
  nearest-neighbour interpolation from the 50 Hz SSL frame rate to the mel
  frame rate, then FastSpeech2's decoder half (`MelDecoder`: decoder,
  mel_linear, PostNet).
- `SemiTransEmbSystem` ("semi-fscl", `:133-177`): the FSCL episode loss plus
  the same reconstruction of an unlabelled stream (`SemiEpisode.unsup`)
  through the trunk's decoder.

As in fscl_tpu every reconstruction decodes in eval mode (BatchNorm on its
running statistics). In `SemiTransEmbSystem` the episode's train-mode pass
updates those statistics; the reconstruction reads them as they were before
the step (fscl_tpu applies the update after the step), from copies.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from fscl_tpu_torch.core.config import ModelConfig, OptimConfig
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.core.stats import DEFAULT_STATS, GlobalStats
from fscl_tpu_torch.models.hubert import SSLUpstream
from fscl_tpu_torch.nn.fft_block import Decoder, PostNet
from fscl_tpu_torch.ops.masking import length_mask, masked_mean
from fscl_tpu_torch.systems.base import System, module_mode
from fscl_tpu_torch.systems.fscl import Episode, FrozenUpstream, TransEmbSystem


class ContiAEBatch(NamedTuple):
    wavs: np.ndarray          # (B, T_wav) 16 kHz
    wav_lens: np.ndarray
    mels: np.ndarray          # (B, T_mel, 80) targets
    mel_lens: np.ndarray


def interpolate_frames(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Nearest-neighbour time interpolation (B, T, D) -> (B, target_len, D):
    frame round(k * T / target_len) in float32, halves to even (fscl_tpu's
    `jnp.round` of a float32 product), clipped to T - 1."""
    T = x.shape[1]
    pos = torch.arange(target_len, dtype=torch.float32, device=x.device) * np.float32(
        T / target_len)
    idx = torch.round(pos).long().clamp(0, T - 1)
    return x[:, idx]


class MelDecoder(nn.Module):
    """FastSpeech2's decoder half under its names (`decoder`, `mel_linear`,
    `postnet`): the parameters fscl_tpu's ContiAE initialises through
    `FastSpeech2.decode`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        t = cfg.transformer
        self.decoder = Decoder(t.decoder_layer, t.decoder_hidden, t.decoder_head,
                               t.conv_filter_size, t.conv_kernel_size, t.decoder_dropout,
                               cfg.max_seq_len)
        self.mel_linear = nn.Linear(t.decoder_hidden, cfg.audio.n_mels)
        self.postnet = PostNet(cfg.audio.n_mels)

    def decode(self, x, mel_valid):
        """Decoder -> mel_linear -> postnet residual."""
        mel = self.mel_linear(self.decoder(x, mel_valid))
        return mel, mel + self.postnet(mel)

    def forward(self, x, mel_valid):
        return self.decode(x, mel_valid)


def reconstruction_loss(model: nn.Module, x: torch.Tensor, mels: torch.Tensor,
                        mel_lens: torch.Tensor, buffers=None):
    """(mel L1, postnet L1) of `model.decode(x)` in eval mode against `mels`
    on the valid frames; with `buffers`, the decode reads those BatchNorm
    statistics in place of the module's."""
    mel_valid = length_mask(mel_lens, mels.shape[1])
    with module_mode(model, False):
        if buffers is None:
            mel, postnet_mel = model.decode(x, mel_valid)
        else:
            mel, postnet_mel = torch.func.functional_call(_Decode(model), buffers, (x, mel_valid))
    return (masked_mean(torch.abs(mel - mels), mel_valid),
            masked_mean(torch.abs(postnet_mel - mels), mel_valid))


class _Decode(nn.Module):
    """`model.decode` as a module's forward, for `functional_call` (state
    names under `model.`)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, mel_valid):
        return self.model.decode(x, mel_valid)


@SYSTEMS.register("conti-ae")
class ContiAESystem(FrozenUpstream, System):
    """Parameters under `upstream.` (frozen, as in `TransEmbSystem`),
    `embed.` and `model.` (a `MelDecoder`). Batches are `ContiAEBatch`es."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        stats: GlobalStats = DEFAULT_STATS,
        device: Optional[Union[str, torch.device]] = None,
        optim_cfg: Optional[OptimConfig] = None,
        upstream: Optional[SSLUpstream] = None,
        upstream_seed: int = 0,
        layer_idx: int = 0,
    ):
        super().__init__(optim_cfg)
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.layer_idx = layer_idx
        self.embed = nn.Linear(model_cfg.upstream.dim, model_cfg.transformer.encoder_hidden)
        self.model = MelDecoder(model_cfg)
        self.to(self.device)
        self.attach_upstream(upstream, upstream_seed)
        self.eval()

    def extract_layer(self, wavs: torch.Tensor, wav_lens: torch.Tensor):
        hidden, frame_valid = self.extract_ssl(wavs, wav_lens)
        return hidden[:, :, self.layer_idx], frame_valid

    def loss_and_metrics(self, batch: ContiAEBatch):
        feats, _ = self.extract_layer(batch.wavs, batch.wav_lens)
        x = interpolate_frames(self.embed(feats), batch.mels.shape[1])
        mel_l, post_l = reconstruction_loss(self.model, x, batch.mels, batch.mel_lens)
        total = mel_l + post_l
        return total, {"Total Loss": total.detach(), "Mel Loss": mel_l.detach(),
                       "Mel-Postnet Loss": post_l.detach()}


class SemiEpisode(NamedTuple):
    sup_episode: Episode          # labelled FSCL episode
    unsup: ContiAEBatch           # unlabelled speech stream


@SYSTEMS.register("semi-fscl", "semi-fscl-tune")
class SemiTransEmbSystem(TransEmbSystem):
    """The episode loss + `unsup_weight` x the reconstruction of
    `SemiEpisode.unsup` from layer `layer_idx` through `unsup_embed.` and
    the trunk's decoder."""

    def __init__(self, *args, unsup_weight: float = 1.0, layer_idx: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.unsup_weight = unsup_weight
        self.layer_idx = layer_idx
        self.unsup_embed = nn.Linear(self.model_cfg.upstream.dim,
                                     self.model_cfg.transformer.encoder_hidden).to(self.device)

    def loss_and_metrics(self, episode: SemiEpisode):
        buffers = {f"model.{n}": b.clone() for n, b in self.model.named_buffers()}
        sup_total, metrics = super().loss_and_metrics(episode.sup_episode)
        unsup = episode.unsup
        hidden, _ = self.extract_ssl(unsup.wavs, unsup.wav_lens)
        x = interpolate_frames(self.unsup_embed(hidden[:, :, self.layer_idx]),
                               unsup.mels.shape[1])
        unsup_l = sum(reconstruction_loss(self.model, x, unsup.mels, unsup.mel_lens, buffers))
        total = sup_total + self.unsup_weight * unsup_l
        metrics = dict(metrics)
        metrics["Unsup Loss"] = unsup_l.detach()
        metrics["Total Loss"] = total.detach()
        return total, metrics
