"""Headless multilingual FastSpeech2 (port of `fscl_tpu/models/fastspeech2.py`).

Pre-embedded text -> Encoder -> (+speaker embedding, optionally
batch-averaged) -> (+language embedding) -> VarianceAdaptor -> (+speaker
embedding) -> Decoder -> mel linear -> PostNet residual. Inference only in
this slice: the target arguments are kept so teacher-forced synthesis
matches the JAX model, but no loss or backward exists yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from fscl_tpu_torch.core.config import ModelConfig
from fscl_tpu_torch.core.stats import GlobalStats
from fscl_tpu_torch.nn.fft_block import Decoder, Encoder, PostNet
from fscl_tpu_torch.nn.speaker_encoder import LanguageEncoder, SpeakerEncoder
from fscl_tpu_torch.nn.variance_adaptor import VarianceAdaptor, round_durations
from fscl_tpu_torch.ops.masking import length_mask


class FastSpeech2Output(NamedTuple):
    """The JAX model's output contract (masks as valid-masks)."""
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch_prediction: torch.Tensor
    energy_prediction: torch.Tensor
    log_duration_prediction: torch.Tensor
    duration_rounded: torch.Tensor
    src_valid: torch.Tensor
    mel_valid: torch.Tensor
    src_len: torch.Tensor
    mel_len: torch.Tensor
    decoder_input: Optional[torch.Tensor] = None


class FastSpeech2(nn.Module):
    def __init__(self, cfg: ModelConfig, stats: GlobalStats):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype!r}: the port runs float32")
        self.cfg = cfg
        t = cfg.transformer
        self.encoder = Encoder(
            t.encoder_layer, t.encoder_hidden, t.encoder_head,
            t.conv_filter_size, t.conv_kernel_size, t.encoder_dropout,
            cfg.max_seq_len)
        self.variance_adaptor = VarianceAdaptor(cfg, stats)
        self.decoder = Decoder(
            t.decoder_layer, t.decoder_hidden, t.decoder_head,
            t.conv_filter_size, t.conv_kernel_size, t.decoder_dropout,
            cfg.max_seq_len)
        self.mel_linear = nn.Linear(t.decoder_hidden, cfg.audio.n_mels)
        self.postnet = PostNet(cfg.audio.n_mels)
        if cfg.multi_speaker:
            self.speaker_emb = SpeakerEncoder(
                cfg.speaker.emb_type, cfg.speaker.n_speakers, t.encoder_hidden)
        if cfg.multi_lingual:
            self.language_emb = LanguageEncoder(cfg.n_languages, t.encoder_hidden)

    def _condition(self, x, speaker_args, lang_args, average_spk_emb):
        """Add the speaker and language embeddings to the encoder output;
        returns (x, speaker embedding or None)."""
        cfg = self.cfg
        spk_emb = None
        if cfg.multi_speaker and speaker_args is not None:
            spk_emb = self.speaker_emb(speaker_args)
            if average_spk_emb:
                spk_emb = spk_emb.mean(dim=0, keepdim=True).expand_as(spk_emb)
            x = x + spk_emb[:, None, :]
        if cfg.multi_lingual and cfg.use_lang_id and lang_args is not None:
            x = x + self.language_emb(lang_args)[:, None, :]
        return x, spk_emb

    def predict_mel_len(self, emb_texts, src_lens, speaker_args=None,
                        lang_args=None, average_spk_emb: bool = False,
                        d_control: float = 1.0) -> torch.Tensor:
        """Pass 1 of bucketed synthesis: predicted total mel frames per
        sample (encoder + duration predictor only)."""
        src_valid = length_mask(src_lens, emb_texts.shape[1])
        x = self.encoder(emb_texts, src_valid)
        x, _ = self._condition(x, speaker_args, lang_args, average_spk_emb)
        log_d = self.variance_adaptor.predict_log_durations(x, src_valid)
        return round_durations(log_d, src_valid, d_control).sum(dim=-1)

    def decode(self, x, mel_valid):
        """Decoder -> mel_linear -> postnet residual."""
        mel = self.mel_linear(self.decoder(x, mel_valid))
        return mel, mel + self.postnet(mel)

    def forward(
        self,
        emb_texts,                 # (B, L, D) pre-embedded phonemes
        src_lens,                  # (B,)
        max_mel_len: int,
        speaker_args=None,         # (B,) ids
        mel_lens=None,             # (B,) or None at inference
        p_targets=None, e_targets=None, d_targets=None,
        lang_args=None,            # (B,) language ids
        p_control: float = 1.0, e_control: float = 1.0, d_control: float = 1.0,
        average_spk_emb: bool = False,
    ) -> FastSpeech2Output:
        src_valid = length_mask(src_lens, emb_texts.shape[1])
        mel_valid = (length_mask(mel_lens, max_mel_len)
                     if mel_lens is not None else None)

        x = self.encoder(emb_texts, src_valid)
        x, spk_emb = self._condition(x, speaker_args, lang_args, average_spk_emb)

        va = self.variance_adaptor(
            x, src_valid, max_mel_len, mel_valid,
            p_targets, e_targets, d_targets, p_control, e_control, d_control)
        x = va.x
        if spk_emb is not None:
            x = x + spk_emb[:, None, :]

        mel, postnet_mel = self.decode(x, va.mel_valid)
        return FastSpeech2Output(
            mel=mel,
            postnet_mel=postnet_mel,
            pitch_prediction=va.pitch_prediction,
            energy_prediction=va.energy_prediction,
            log_duration_prediction=va.log_duration_prediction,
            duration_rounded=va.duration_rounded,
            src_valid=src_valid,
            mel_valid=va.mel_valid,
            src_len=src_lens,
            mel_len=va.mel_len,
            decoder_input=x,
        )
