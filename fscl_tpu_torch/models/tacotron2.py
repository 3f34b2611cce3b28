"""Full mel Tacotron2 (port of `fscl_tpu/models/tacotron2.py`), kept beside
the T2U variant as the reference keeps lightning/systems/t2u/tacotron2/
model.py. No system uses it.

A location-sensitive-attention LSTM decoder emits `n_frames_per_step` mel
frames per step and a stop gate, then the FastSpeech2 PostNet refines the
mel. It is built from the T2U model's parts (`models/tacotron2_t2u.py`:
`T2UEncoder`, `Prenet`, `LocationAttention`, the one-bias LSTM cells), as
the JAX module builds it from its T2U module (`:15-19`), and steps its
decoder in a Python loop where fscl_tpu runs `nn.scan` (`__call__` `:112`,
`infer` `:153`). fscl_tpu computes it in XLA, with no Pallas kernel, so the
port is plain torch.

Random streams are the T2U model's: the prenet's dropout is on at inference
too; in train mode the encoder's, the attention- and decoder-RNN dropouts
join it, every mask drawn up front (`draw_masks`) or passed in as a
`T2UMasks`; the PostNet's Dropout(0.5) is a module's, on in train mode.
`infer` runs all `max_steps` steps with a per-sample finished flag on the
device (no host wait), as the scan does.

Parameter names: `encoder.*`, `prenet.layers.{i}`, `memory_layer`,
`attention_rnn`, `attention_layer.*`, `decoder_rnn`, `linear_projection`,
`gate_layer`, `postnet.convolutions.{i}.*`; `convert.tacotron2_entries`
maps them to the flax tree.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from fscl_tpu_torch.models.tacotron2_t2u import (
    LocationAttention, Prenet, T2UConfig, T2UEncoder, T2UMasks, _drop, _lstm_cell, draw_masks,
    encode, zero_carry,
)
from fscl_tpu_torch.nn.fft_block import PostNet


class Tacotron2Config(NamedTuple):
    n_mels: int = 80
    n_frames_per_step: int = 3
    symbols_embedding_dim: int = 512
    encoder_embedding_dim: int = 512
    encoder_n_convolutions: int = 3
    encoder_kernel_size: int = 5
    prenet_dim: int = 256
    attention_rnn_dim: int = 1024
    decoder_rnn_dim: int = 1024
    attention_dim: int = 128
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31
    p_attention_dropout: float = 0.1
    p_decoder_dropout: float = 0.1
    gate_threshold: float = 0.5
    max_decoder_ratio: int = 10

    def as_t2u(self) -> T2UConfig:
        """The T2U parts' configuration (the JAX `as_t2u`, with this
        config's decoder dropout rates for the masks)."""
        return T2UConfig(
            n_units=1, d_unit=self.n_mels * self.n_frames_per_step,
            symbols_embedding_dim=self.symbols_embedding_dim,
            encoder_embedding_dim=self.encoder_embedding_dim,
            encoder_n_convolutions=self.encoder_n_convolutions,
            encoder_kernel_size=self.encoder_kernel_size,
            prenet_dim=self.prenet_dim,
            attention_rnn_dim=self.attention_rnn_dim,
            decoder_rnn_dim=self.decoder_rnn_dim,
            attention_dim=self.attention_dim,
            attention_location_n_filters=self.attention_location_n_filters,
            attention_location_kernel_size=self.attention_location_kernel_size,
            p_attention_dropout=self.p_attention_dropout,
            p_decoder_dropout=self.p_decoder_dropout,
        )


class Tacotron2Output(NamedTuple):
    """The teacher-forced forward's outputs."""
    mel: torch.Tensor              # (B, T, n_mels)
    postnet_mel: torch.Tensor      # (B, T, n_mels)
    gates: torch.Tensor            # gate logits (B, steps)
    alignments: torch.Tensor       # (B, steps, L)


class Tacotron2Inference(NamedTuple):
    """`infer`'s outputs."""
    mel: torch.Tensor              # (B, max_steps * r, n_mels), 0 after the stop
    postnet_mel: torch.Tensor
    n_frames: torch.Tensor         # frames emitted per sample (B,), int32
    alignments: torch.Tensor       # (B, max_steps, L)


class Tacotron2(nn.Module):
    """Takes pre-embedded text (B, L, symbols_embedding_dim)."""

    def __init__(self, cfg: Tacotron2Config = Tacotron2Config()):
        super().__init__()
        self.cfg = c = cfg
        t2u = cfg.as_t2u()
        self.encoder = T2UEncoder(t2u)
        self.prenet = Prenet(c.n_mels, (c.prenet_dim, c.prenet_dim))
        self.memory_layer = nn.Linear(c.encoder_embedding_dim, c.attention_dim, bias=False)
        self.attention_rnn = _lstm_cell(c.prenet_dim + c.encoder_embedding_dim,
                                        c.attention_rnn_dim)
        self.attention_layer = LocationAttention(t2u)
        self.decoder_rnn = _lstm_cell(c.attention_rnn_dim + c.encoder_embedding_dim,
                                      c.decoder_rnn_dim)
        hc = c.decoder_rnn_dim + c.encoder_embedding_dim
        self.linear_projection = nn.Linear(hc, c.n_mels * c.n_frames_per_step)
        self.gate_layer = nn.Linear(hc, 1)
        self.postnet = PostNet(c.n_mels)

    def draw_masks(self, B: int, L: int, n_steps: int, train: bool,
                   generator: Optional[torch.Generator], device) -> T2UMasks:
        return draw_masks(self.cfg.as_t2u(), B, L, n_steps, train, generator, device)

    def _decode_step(self, carry, dec_in, memory, processed, src_valid,
                     keep_attn=None, keep_dec=None):
        """One step (`_decode_step`, `:84-110`): (carry, frames (B, n_mels *
        r), gate logit (B,), attention weights (B, L))."""
        c = self.cfg
        attn_h, attn_c, dec_h, dec_c, attn_w, attn_w_cum, attn_ctx = carry
        attn_h, attn_c = self.attention_rnn(torch.cat([dec_in, attn_ctx], -1), (attn_h, attn_c))
        attn_h = _drop(attn_h, keep_attn, 1.0 - c.p_attention_dropout)
        attn_ctx, attn_w = self.attention_layer(
            attn_h, memory, processed, torch.stack([attn_w, attn_w_cum], 1), src_valid)
        attn_w_cum = attn_w_cum + attn_w
        dec_h, dec_c = self.decoder_rnn(torch.cat([attn_h, attn_ctx], -1), (dec_h, dec_c))
        dec_h = _drop(dec_h, keep_dec, 1.0 - c.p_decoder_dropout)
        hc = torch.cat([dec_h, attn_ctx], -1)
        carry = (attn_h, attn_c, dec_h, dec_c, attn_w, attn_w_cum, attn_ctx)
        return carry, self.linear_projection(hc), self.gate_layer(hc)[..., 0], attn_w

    def forward(self, emb_text, src_lens, mels, masks: Optional[T2UMasks] = None,
                generator: Optional[torch.Generator] = None) -> Tacotron2Output:
        """Teacher-forced, in the module's mode: mels (B, T_mel, n_mels) with
        T_mel a multiple of n_frames_per_step; each step reads the last
        frame of the previous step's group (zeros first). Returns (mel,
        postnet_mel, gate logits (B, T_mel / r), alignments)."""
        c = self.cfg
        B, L, _ = emb_text.shape
        T = mels.shape[1]
        r = c.n_frames_per_step
        n_steps = T // r
        if masks is None:
            masks = self.draw_masks(B, L, n_steps, self.training, generator, emb_text.device)
        src_valid, memory, processed = encode(self, emb_text, src_lens, masks.encoder)
        carry = zero_carry(self.cfg, memory)
        grouped = mels.reshape(B, n_steps, r * c.n_mels)
        teacher = torch.cat([grouped.new_zeros(B, 1, r * c.n_mels), grouped[:, :-1]], 1)
        teacher_last = teacher[..., -c.n_mels:]
        frames, gates, aligns = [], [], []
        for t in range(n_steps):
            carry, f, g, w = self._decode_step(
                carry, self.prenet(teacher_last[:, t], masks.prenet[t]), memory, processed,
                src_valid, None if masks.attention is None else masks.attention[t],
                None if masks.decoder is None else masks.decoder[t])
            frames.append(f)
            gates.append(g)
            aligns.append(w)
        mel = torch.stack(frames, 1).reshape(B, T, c.n_mels)
        return Tacotron2Output(mel, mel + self.postnet(mel), torch.stack(gates, 1),
                               torch.stack(aligns, 1))

    @torch.no_grad()
    def infer(self, emb_text, src_lens, max_steps: Optional[int] = None,
              masks: Optional[T2UMasks] = None,
              generator: Optional[torch.Generator] = None) -> Tacotron2Inference:
        """Batched decoding for `max_steps` steps (default max_decoder_ratio
        * L), each step fed its own last frame; a sample's frames from the
        step whose gate fires on are set to 0. The module should be in eval
        mode (the PostNet's running statistics). Returns (mel, postnet_mel,
        frames emitted per sample (B,), alignments)."""
        c = self.cfg
        B, L, _ = emb_text.shape
        max_steps = max_steps or c.max_decoder_ratio * L
        if masks is None:
            masks = self.draw_masks(B, L, max_steps, False, generator, emb_text.device)
        src_valid, memory, processed = encode(self, emb_text, src_lens, None)
        carry = zero_carry(self.cfg, memory)
        last = memory.new_zeros(B, c.n_mels)
        finished = torch.zeros(B, dtype=torch.bool, device=memory.device)
        frames, active, aligns = [], [], []
        for t in range(max_steps):
            carry, f, g, w = self._decode_step(
                carry, self.prenet(last, masks.prenet[t]), memory, processed, src_valid)
            finished = finished | (torch.sigmoid(g) > c.gate_threshold)
            last = f[..., -c.n_mels:]
            frames.append(f)
            active.append(~finished)
            aligns.append(w)
        active = torch.stack(active, 1)
        r = c.n_frames_per_step
        mel = torch.stack(frames, 1).reshape(B, max_steps * r, c.n_mels)
        mel = torch.where(active.repeat_interleave(r, dim=1)[..., None], mel, 0.0)
        n_frames = active.sum(dim=1, dtype=torch.int32) * r
        return Tacotron2Inference(mel, mel + self.postnet(mel), n_frames,
                                  torch.stack(aligns, 1))
