"""ADA systems: AdaSpeech2-style adaptation on untranscribed speech (port of
`fscl_tpu/systems/ada.py`).

- `ADAEncoder` (`:33-46`): a Linear embed, then an FFT `Encoder` stack, into
  the space of the trunk's decoder input.
- `TransEmbADASystem` (`:69-142`): stage "matching" trains the ADA encoder
  alone so that its output matches the trunk's decoder input (MSE on the
  valid frames) and reconstructs the mel through the decoder; stage
  "unsup_tuning" trains the decoder's and the PostNet's norm layers alone on
  the reconstruction.
- `SSLEpisode` and `TransEmbSSLADASystem` (`:145-183`): the ADA encoder reads
  the query speech's SSL features, interpolated to mel length, in place of
  the mels.

As in fscl_tpu, the reference pass that gives the decoder input runs in
eval mode without a gradient, and the reconstruction decodes in eval mode
(BatchNorm on its running statistics, which no ADA step updates); the ADA
encoder runs in the module's mode. Parameters of the ADA encoder live under
`ada.` (fscl_tpu's `params["ada"]`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch import nn

from fscl_tpu_torch.core.config import ModelConfig
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.nn.fft_block import BatchNorm, Encoder
from fscl_tpu_torch.ops.masking import length_mask, masked_mean
from fscl_tpu_torch.systems.base import module_mode
from fscl_tpu_torch.systems.fscl import Episode, TransEmbSystem

STAGES = ("matching", "unsup_tuning")


class ADAEncoder(nn.Module):
    """Mel (or SSL feature) encoder: Linear(in_dim -> encoder_hidden), then
    the encoder's FFT stack at the model config's width."""

    def __init__(self, cfg: ModelConfig, in_dim: int):
        super().__init__()
        t = cfg.transformer
        self.embed = nn.Linear(in_dim, t.encoder_hidden)
        self.encoder = Encoder(t.encoder_layer, t.encoder_hidden, t.encoder_head,
                               t.conv_filter_size, t.conv_kernel_size, t.encoder_dropout,
                               cfg.max_seq_len)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.embed(x), valid)


def norm_only_mask(module: nn.Module) -> Dict[str, bool]:
    """Parameter name -> trains, selecting the norm layers (LayerNorm and
    BatchNorm) under a `decoder` or `postnet` scope (fscl_tpu's
    freeze_non_norm_layer, `:48-66`)."""
    mask = {}
    for mod_name, mod in module.named_modules():
        in_scope = any(k in ("decoder", "postnet") for k in mod_name.split("."))
        for name, _ in mod.named_parameters(prefix=mod_name, recurse=False):
            mask[name] = in_scope and isinstance(mod, (nn.LayerNorm, BatchNorm))
    return mask


@SYSTEMS.register("fscl-ada", "fscl-ada1", "fscl-ada2")
class TransEmbADASystem(TransEmbSystem):
    """FSCL + the ADA plug-in. `ada_stage` is "matching" or "unsup_tuning"."""

    def __init__(self, *args, ada_stage: str = "matching", **kwargs):
        if ada_stage not in STAGES:
            raise ValueError(f"ada_stage {ada_stage!r} not one of {STAGES}")
        super().__init__(*args, **kwargs)
        self.ada_stage = ada_stage
        self.ada = ADAEncoder(self.model_cfg, self.ada_in_dim()).to(self.device).eval()

    def ada_in_dim(self) -> int:
        return self.model_cfg.audio.n_mels

    def ada_input(self, episode: Episode):
        """What the ADA encoder reads: the query's target mels and their
        valid frames."""
        qry = episode.qry
        return qry.mels, length_mask(qry.mel_lens, qry.mels.shape[1])

    def trainable_mask(self) -> Dict[str, bool]:
        base = super().trainable_mask()
        if self.ada_stage == "matching":
            return {n: base[n] and n.startswith("ada.") for n in base}
        norms = norm_only_mask(self)
        return {n: base[n] and norms[n] and n.startswith("model.") for n in base}

    def common_ada_step(self, episode: Episode) -> Dict[str, torch.Tensor]:
        qry = episode.qry
        mel_valid = length_mask(qry.mel_lens, qry.mels.shape[1])
        with torch.no_grad(), module_mode(self, False):
            out = self(episode)
        ada_in, ada_valid = self.ada_input(episode)
        feat = self.ada(ada_in, ada_valid)
        match_loss = masked_mean((feat - out.decoder_input) ** 2, out.mel_valid)
        with module_mode(self.model, False):
            mel, postnet_mel = self.model.decode(feat, mel_valid)
        mel_l = masked_mean(torch.abs(mel - qry.mels), mel_valid)
        post_l = masked_mean(torch.abs(postnet_mel - qry.mels), mel_valid)
        return {"Match Loss": match_loss, "Recon Loss": mel_l + post_l,
                "Mel Loss": mel_l, "Mel-Postnet Loss": post_l}

    def loss_and_metrics(self, episode: Episode):
        metrics = self.common_ada_step(episode)
        total = metrics["Recon Loss"]
        if self.ada_stage == "matching":
            total = total + metrics["Match Loss"]
        metrics["Total Loss"] = total
        return total, {k: v.detach() for k, v in metrics.items()}


class SSLEpisode(NamedTuple):
    """An FSCL episode with the query set's raw 16 kHz speech
    (`collate_episode(with_qry_wavs=True)`)."""
    sup: Any
    qry: Any
    qry_wavs: Any = None       # (B, T_wav)
    qry_wav_lens: Any = None
    sup_batch: Any = None


@SYSTEMS.register("fscl-ssl_ada", "fscl-ssl_ada1", "fscl-ssl_ada2")
class TransEmbSSLADASystem(TransEmbADASystem):
    """The ADA encoder reads layer `ssl_layer_idx` of the frozen upstream's
    hidden states over the query speech, interpolated to mel length."""

    def __init__(self, *args, ssl_layer_idx: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.ssl_layer_idx = ssl_layer_idx

    def ada_in_dim(self) -> int:
        return self.model_cfg.upstream.dim

    def ada_input(self, episode: SSLEpisode):
        from fscl_tpu_torch.systems.conti_ae import interpolate_frames
        qry = episode.qry
        hidden, _ = self.extract_ssl(episode.qry_wavs, episode.qry_wav_lens)
        feat = interpolate_frames(hidden[:, :, self.ssl_layer_idx], qry.mels.shape[1])
        return feat, length_mask(qry.mel_lens, qry.mels.shape[1])
