"""Variance adaptor: duration/pitch/energy prediction + length regulation
(port of `fscl_tpu/nn/variance_adaptor.py:24-188`).

Bin edges come from the global normalization stats as in the JAX package;
`digitize` is `torch.bucketize`. Durations are
`max(round(exp(log_d) - 1) * d_control, 0)`, masked, then truncated to int;
`torch.round` rounds half to even, as `jnp.round` does.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from fscl_tpu_torch.core.config import ModelConfig
from fscl_tpu_torch.core.stats import GlobalStats
from fscl_tpu_torch.nn.fft_block import LN_EPS, ConvNorm, conv_nlc
from fscl_tpu_torch.ops.bucketize import digitize
from fscl_tpu_torch.ops.length_regulator import regulate_lengths
from fscl_tpu_torch.ops.masking import length_mask


def variance_bins(stats: GlobalStats, cfg: ModelConfig) -> tuple:
    """Quantization bin edges ((n_bins-1,) each) for pitch and energy."""
    n_bins = cfg.variance_embedding.n_bins
    p = stats.pitch
    e = stats.energy
    p_min, p_max = (p.normalized_range() if cfg.variance.pitch_normalization
                    else (p.min, p.max))
    e_min, e_max = (e.normalized_range() if cfg.variance.energy_normalization
                    else (e.min, e.max))

    def edges(vmin, vmax, quant):
        if quant == "log":
            return np.exp(np.linspace(np.log(vmin), np.log(vmax), n_bins - 1))
        return np.linspace(vmin, vmax, n_bins - 1)

    return (
        edges(p_min, p_max, cfg.variance_embedding.pitch_quantization).astype(np.float32),
        edges(e_min, e_max, cfg.variance_embedding.energy_quantization).astype(np.float32),
    )


class _NLC(ConvNorm):
    """ConvNorm applied to (B, L, C) features."""

    def forward(self, x):
        return conv_nlc(self.conv, x)


class VariancePredictor(nn.Module):
    """2x (conv1d -> relu -> LN -> dropout) -> linear (modules.py:199-253)."""

    def __init__(self, d_model: int, filter_size: int = 256,
                 kernel_size: int = 3, dropout: float = 0.5):
        super().__init__()
        self.conv_layer = nn.Sequential(OrderedDict([
            ("conv1d_1", _NLC(d_model, filter_size, kernel_size)),
            ("relu_1", nn.ReLU()),
            ("layer_norm_1", nn.LayerNorm(filter_size, eps=LN_EPS)),
            ("dropout_1", nn.Dropout(dropout)),
            ("conv1d_2", _NLC(filter_size, filter_size, kernel_size)),
            ("relu_2", nn.ReLU()),
            ("layer_norm_2", nn.LayerNorm(filter_size, eps=LN_EPS)),
            ("dropout_2", nn.Dropout(dropout)),
        ]))
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x, valid: Optional[torch.Tensor] = None):
        out = self.linear_layer(self.conv_layer(x))[..., 0]
        if valid is not None:
            out = out.masked_fill(~valid, 0.0)
        return out


class VarianceAdaptorOutput(NamedTuple):
    x: torch.Tensor                 # (B, T_mel, D) frame-level features
    pitch_prediction: torch.Tensor
    energy_prediction: torch.Tensor
    log_duration_prediction: torch.Tensor
    duration_rounded: torch.Tensor
    mel_len: torch.Tensor           # (B,)
    mel_valid: torch.Tensor         # (B, T_mel) bool


def round_durations(log_d: torch.Tensor, valid: torch.Tensor,
                    d_control: float = 1.0) -> torch.Tensor:
    """Frames per phoneme from predicted log durations (`:158-162`)."""
    dur = torch.clamp(torch.round(torch.exp(log_d) - 1.0) * d_control, min=0.0)
    return dur.masked_fill(~valid, 0.0).long()


class VarianceAdaptor(nn.Module):
    """Semantics of modules.py:104-160 with a static max_mel_len."""

    def __init__(self, cfg: ModelConfig, stats: GlobalStats):
        super().__init__()
        self.cfg = cfg
        vp = cfg.variance_predictor
        d_model = cfg.transformer.encoder_hidden

        def predictor():
            return VariancePredictor(d_model, vp.filter_size, vp.kernel_size, vp.dropout)

        self.duration_predictor = predictor()
        self.pitch_predictor = predictor()
        self.energy_predictor = predictor()
        n_bins = cfg.variance_embedding.n_bins
        self.pitch_embedding = nn.Embedding(n_bins, d_model)
        self.energy_embedding = nn.Embedding(n_bins, d_model)
        pitch_edges, energy_edges = variance_bins(stats, cfg)
        self.register_buffer("pitch_bins", torch.from_numpy(pitch_edges), persistent=False)
        self.register_buffer("energy_bins", torch.from_numpy(energy_edges), persistent=False)

    def predict_log_durations(self, x, src_valid):
        """Standalone duration prediction (pass 1 of bucketed synthesis)."""
        return self.duration_predictor(x, src_valid)

    def _add_variance(self, feats, predictor, emb_table, edges, target, valid, control):
        prediction = predictor(feats, valid)
        if target is not None:
            emb = emb_table(digitize(target, edges))
        else:
            prediction = prediction * control
            emb = emb_table(digitize(prediction, edges))
        return prediction, emb

    def forward(
        self,
        x,                       # (B, L, D)
        src_valid,               # (B, L) bool
        max_mel_len: int,
        mel_valid=None,          # (B, T) bool or None (inference)
        pitch_target=None,
        energy_target=None,
        duration_target=None,
        p_control: float = 1.0,
        e_control: float = 1.0,
        d_control: float = 1.0,
    ) -> VarianceAdaptorOutput:
        var = self.cfg.variance
        log_d_prediction = self.duration_predictor(x, src_valid)

        pitch_prediction = energy_prediction = None
        if var.pitch_feature == "phoneme_level":
            pitch_prediction, emb = self._add_variance(
                x, self.pitch_predictor, self.pitch_embedding, self.pitch_bins,
                pitch_target, src_valid, p_control)
            x = x + emb
        if var.energy_feature == "phoneme_level":
            energy_prediction, emb = self._add_variance(
                x, self.energy_predictor, self.energy_embedding, self.energy_bins,
                energy_target, src_valid, e_control)
            x = x + emb

        if duration_target is not None:
            duration_rounded = duration_target
        else:
            duration_rounded = round_durations(log_d_prediction, src_valid, d_control)

        x, mel_len = regulate_lengths(x, duration_rounded, max_mel_len)
        mel_len = mel_len.clamp(max=max_mel_len)
        if mel_valid is None:
            mel_valid = length_mask(mel_len, max_mel_len)

        if var.pitch_feature == "frame_level":
            pitch_prediction, emb = self._add_variance(
                x, self.pitch_predictor, self.pitch_embedding, self.pitch_bins,
                pitch_target, mel_valid, p_control)
            x = x + emb
        if var.energy_feature == "frame_level":
            energy_prediction, emb = self._add_variance(
                x, self.energy_predictor, self.energy_embedding, self.energy_bins,
                energy_target, mel_valid, e_control)
            x = x + emb

        return VarianceAdaptorOutput(
            x=x,
            pitch_prediction=pitch_prediction,
            energy_prediction=energy_prediction,
            log_duration_prediction=log_d_prediction,
            duration_rounded=duration_rounded,
            mel_len=mel_len,
            mel_valid=mel_valid,
        )
