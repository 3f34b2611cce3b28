"""Tacotron2-style text-to-unit (T2U) model (port of
`fscl_tpu/models/tacotron2_t2u.py`).

Text embeddings in, unit logits out: a conv + BatchNorm + BiLSTM encoder, a
location-sensitive attention decoder stepped by an explicit loop where the
JAX package runs `nn.scan` (`T2UConfig` `:29`, `Prenet` `:47`,
`LocationAttention` `:61`, `T2UEncoder` `:86`, `DecoderCell` `:114`,
`TacoT2U.__call__` `:175`, `TacoT2U.infer` `:222`). fscl_tpu computes the
decoder in XLA, with no Pallas kernel, so the port's counterpart is plain
torch: `nn.LSTMCell` / `nn.LSTM` for the recurrences, `torch.matmul` for the
products.

Random streams. The prenet's dropout (rate 0.5) is on at inference too, as in
the reference; in train mode the encoder's Dropout(0.5) and the attention-
and decoder-RNN dropouts join it. Every mask is drawn up front, for all steps
at once, from an explicit `torch.Generator` (`draw_masks`), or comes in as a
`T2UMasks` (the parity tests rebuild fscl_tpu's masks from its key schedule).
Scheduled sampling (a teacher-forcing ratio below 1) draws its per-step
choices the same way, after the dropout masks and only then, so a forward
at ratio 1 draws exactly what it drew before the option existed. The loop
itself draws nothing and never waits for the device: `infer` runs
all `max_decoder_ratio * L` steps as fscl_tpu does, with a per-sample
finished flag on the device.

Layouts against flax: an LSTM cell has one bias per gate (flax's hidden-side
Dense); torch's `bias_ih` stays 0 and does not require grad, so only
`bias_hh` trains. The encoder's backward LSTM starts at each row's last valid
frame (flax's `seq_lengths` with `reverse=True, keep_order=True`): its input
is each row reversed within its length, gathered on the device, so the
forward needs no host wait for the lengths. Its BatchNorm is flax's (`nn.fft_block.BatchNorm`:
momentum 0.9, biased batch variance).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fscl_tpu_torch.nn.fft_block import BatchNorm
from fscl_tpu_torch.ops.masking import length_mask

EOS_ID = 8   # reference: <eos> unit id (tacot2u_model.py:344, T2UDataset)
PRENET_KEEP = 0.5
ENCODER_KEEP = 0.5


class T2UConfig(NamedTuple):
    n_units: int = 512
    d_unit: int = 256
    symbols_embedding_dim: int = 256
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
    max_decoder_ratio: int = 10


class T2UMasks(NamedTuple):
    """Keep masks (bool) for one forward; None where a dropout is off.

    prenet: (T, 2, B, prenet_dim); encoder: (n_conv, B, L, enc_dim);
    attention: (T, B, attention_rnn_dim); decoder: (T, B, decoder_rnn_dim).
    teacher: (T,), True where a teacher-forced step reads the previous
    target rather than the embedding of its own previous argmax, one choice
    for the whole batch (step 0 always the target); None at ratio 1, every
    step the target."""
    prenet: torch.Tensor
    encoder: Optional[torch.Tensor] = None
    attention: Optional[torch.Tensor] = None
    decoder: Optional[torch.Tensor] = None
    teacher: Optional[torch.Tensor] = None


def _keep(shape, p_keep: float, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < p_keep


def draw_masks(cfg: T2UConfig, B: int, L: int, T: int, train: bool,
               generator: Optional[torch.Generator], device,
               teacher_forcing_ratio: float = 1.0) -> T2UMasks:
    """Every mask of one forward of T decoder steps, drawn in one call per
    kind from `generator` (the device's default generator when None); below
    ratio 1, then the teacher choices (`draw_teacher`)."""
    c = cfg
    masks = T2UMasks(prenet=_keep((T, 2, B, c.prenet_dim), PRENET_KEEP, generator, device))
    if train:
        masks = masks._replace(
            encoder=_keep((c.encoder_n_convolutions, B, L, c.encoder_embedding_dim),
                          ENCODER_KEEP, generator, device),
            attention=_keep((T, B, c.attention_rnn_dim), 1.0 - c.p_attention_dropout,
                            generator, device),
            decoder=_keep((T, B, c.decoder_rnn_dim), 1.0 - c.p_decoder_dropout,
                          generator, device))
    return masks._replace(teacher=draw_teacher(T, teacher_forcing_ratio, generator, device))


def draw_teacher(T: int, ratio: float, generator: Optional[torch.Generator], device
                 ) -> Optional[torch.Tensor]:
    """The (T,) teacher choices of scheduled sampling: step t reads the
    target where a uniform draw falls below `ratio`, step 0 always, as
    fscl_tpu's scan decides it (one draw per step for the whole batch).
    None at ratio 1 or above, with nothing drawn."""
    if ratio >= 1.0:
        return None
    teacher = torch.rand((T,), generator=generator, device=device) < ratio
    teacher[0] = True
    return teacher


def _drop(x: torch.Tensor, keep: Optional[torch.Tensor], p_keep: float) -> torch.Tensor:
    return x if keep is None else torch.where(keep, x / p_keep, 0.0)


def _one_bias(module: nn.Module) -> nn.Module:
    """flax's LSTM cells have one bias per gate: torch's `bias_ih*` stay 0
    and out of training."""
    for name, p in module.named_parameters():
        if name.startswith("bias_ih"):
            with torch.no_grad():
                p.zero_()
            p.requires_grad_(False)
    return module


def _lstm_cell(n_in: int, n_hidden: int) -> nn.LSTMCell:
    return _one_bias(nn.LSTMCell(n_in, n_hidden))


def one_bias_lstm(n_in: int, n_hidden: int) -> nn.LSTM:
    """A batch-first `nn.LSTM` with flax's one bias per gate."""
    return _one_bias(nn.LSTM(n_in, n_hidden, batch_first=True))


def bilstm(lstm_fwd: nn.LSTM, lstm_bwd: nn.LSTM, x: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """One bidirectional layer as flax's `nn.RNN` pair with `seq_lengths`
    (the backward one `reverse=True, keep_order=True`): (B, L, 2 * hidden),
    padding frames zeroed. The backward direction reads each row reversed
    within its length (pad frames after), so that it starts at the last valid
    frame; the same gather puts its outputs back in order. The lengths stay
    on the device."""
    L = x.shape[1]
    t = torch.arange(L, device=x.device)[None, :]
    lens = valid.sum(dim=-1, keepdim=True)
    rev = torch.where(t < lens, lens - 1 - t, t)[..., None]
    fwd, _ = lstm_fwd(x)
    bwd, _ = lstm_bwd(x.gather(1, rev.expand(-1, -1, x.shape[2])))
    bwd = bwd.gather(1, rev.expand(-1, -1, bwd.shape[2]))
    return torch.where(valid[..., None], torch.cat([fwd, bwd], -1), 0.0)


def zero_carry(cfg, memory):
    """The decoder's first carry: (attention h, c, decoder h, c, attention
    weights, their running sum, context), zeros."""
    B, T_mem = memory.shape[:2]
    z = lambda d: memory.new_zeros(B, d)
    return (z(cfg.attention_rnn_dim), z(cfg.attention_rnn_dim), z(cfg.decoder_rnn_dim),
            z(cfg.decoder_rnn_dim), z(T_mem), z(T_mem), z(cfg.encoder_embedding_dim))


def encode(model: nn.Module, emb_text, src_lens, keep):
    """(src_valid, memory, processed memory) through `model.encoder` and
    `model.memory_layer`."""
    src_valid = length_mask(src_lens, emb_text.shape[1])
    memory = model.encoder(emb_text, src_valid, keep)
    return src_valid, memory, model.memory_layer(memory)


class Prenet(nn.Module):
    """2-layer bias-free ReLU prenet; its dropout is always on."""

    def __init__(self, n_in: int, sizes=(256, 256)):
        super().__init__()
        dims = (n_in,) + tuple(sizes)
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], bias=False) for i in range(len(sizes)))

    def forward(self, x, keep):                      # keep: (2, B, d)
        for i, layer in enumerate(self.layers):
            x = _drop(F.relu(layer(x)), keep[i], PRENET_KEEP)
        return x


class LocationAttention(nn.Module):
    def __init__(self, cfg: T2UConfig):
        super().__init__()
        c = cfg
        self.query_layer = nn.Linear(c.attention_rnn_dim, c.attention_dim, bias=False)
        k = c.attention_location_kernel_size
        self.location_conv = nn.Conv1d(2, c.attention_location_n_filters, k,
                                       padding=k // 2, bias=False)
        self.location_dense = nn.Linear(c.attention_location_n_filters, c.attention_dim,
                                        bias=False)
        self.v = nn.Linear(c.attention_dim, 1, bias=False)

    def forward(self, query, memory, processed_memory, attn_weights_cat, memory_valid):
        processed_query = self.query_layer(query)[:, None]
        loc = self.location_dense(self.location_conv(attn_weights_cat).transpose(1, 2))
        energies = self.v(torch.tanh(processed_query + loc + processed_memory))[..., 0]
        weights = torch.softmax(torch.where(memory_valid, energies, -1e9), dim=1)
        context = torch.bmm(weights[:, None], memory)[:, 0]
        return context, weights


class T2UEncoder(nn.Module):
    """3 x (conv5 + BatchNorm + ReLU + dropout, padding zeroed) + BiLSTM."""

    def __init__(self, cfg: T2UConfig):
        super().__init__()
        c = cfg
        dims = [c.symbols_embedding_dim] + [c.encoder_embedding_dim] * c.encoder_n_convolutions
        k = c.encoder_kernel_size
        self.convs = nn.ModuleList(
            nn.Conv1d(dims[i], dims[i + 1], k, padding=k // 2)
            for i in range(c.encoder_n_convolutions))
        self.norms = nn.ModuleList(BatchNorm(dims[i + 1])
                                   for i in range(c.encoder_n_convolutions))
        half = c.encoder_embedding_dim // 2
        self.lstm_fwd = one_bias_lstm(c.encoder_embedding_dim, half)
        self.lstm_bwd = one_bias_lstm(c.encoder_embedding_dim, half)

    def forward(self, emb_text, src_valid, keep: Optional[torch.Tensor] = None):
        x = emb_text.transpose(1, 2)
        valid = src_valid[:, None, :]
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            x = F.relu(norm(conv(x)))
            if keep is not None:
                x = _drop(x, keep[i].transpose(1, 2), ENCODER_KEEP)
            x = torch.where(valid, x, 0.0)
        return bilstm(self.lstm_fwd, self.lstm_bwd, x.transpose(1, 2), src_valid)


class DecoderCell(nn.Module):
    """One decoder step: attention LSTM, location attention, decoder LSTM,
    projections to unit logits."""

    def __init__(self, cfg: T2UConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.attention_rnn = _lstm_cell(c.prenet_dim + c.encoder_embedding_dim,
                                        c.attention_rnn_dim)
        self.attention_layer = LocationAttention(cfg)
        self.decoder_rnn = _lstm_cell(c.attention_rnn_dim + c.encoder_embedding_dim,
                                      c.decoder_rnn_dim)
        self.linear_projection = nn.Linear(c.decoder_rnn_dim + c.encoder_embedding_dim,
                                           c.encoder_embedding_dim)
        self.final_proj = nn.Linear(c.encoder_embedding_dim, c.n_units)

    def forward(self, carry, decoder_input, memory, processed_memory, memory_valid,
                keep_attn=None, keep_dec=None):
        c = self.cfg
        attn_h, attn_c, dec_h, dec_c, attn_w, attn_w_cum, attn_ctx = carry
        attn_h, attn_c = self.attention_rnn(torch.cat([decoder_input, attn_ctx], -1),
                                            (attn_h, attn_c))
        attn_h = _drop(attn_h, keep_attn, 1.0 - c.p_attention_dropout)
        attn_ctx, attn_w = self.attention_layer(
            attn_h, memory, processed_memory, torch.stack([attn_w, attn_w_cum], 1),
            memory_valid)
        attn_w_cum = attn_w_cum + attn_w
        dec_h, dec_c = self.decoder_rnn(torch.cat([attn_h, attn_ctx], -1), (dec_h, dec_c))
        dec_h = _drop(dec_h, keep_dec, 1.0 - c.p_decoder_dropout)
        logits = self.final_proj(self.linear_projection(torch.cat([dec_h, attn_ctx], -1)))
        return (attn_h, attn_c, dec_h, dec_c, attn_w, attn_w_cum, attn_ctx), logits, attn_w


class TacoT2U(nn.Module):
    """Encoder + step-loop decoder over pre-embedded text (the multilingual
    or FSCL embedding lives outside, as for the FastSpeech2 trunk)."""

    def __init__(self, cfg: T2UConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = T2UEncoder(cfg)
        self.unit_embedding = nn.Embedding(cfg.n_units, cfg.d_unit)
        nn.init.normal_(self.unit_embedding.weight, std=1.0)     # flax Embed's init
        self.prenet = Prenet(cfg.d_unit, (cfg.prenet_dim, cfg.prenet_dim))
        self.decoder_cell = DecoderCell(cfg)
        self.memory_layer = nn.Linear(cfg.encoder_embedding_dim, cfg.attention_dim, bias=False)

    def forward(self, emb_text, src_lens, units, masks: Optional[T2UMasks] = None,
                generator: Optional[torch.Generator] = None,
                teacher_forcing_ratio: float = 1.0):
        """Teacher-forced forward over T_out = units.shape[1] steps, in the
        module's mode (train: every dropout; eval: the prenet's alone), with
        scheduled sampling below `teacher_forcing_ratio` 1: a step whose
        `masks.teacher` entry is False reads the embedding of the previous
        step's argmax unit instead of the previous target (no gradient
        through the argmax; the embedding's rows get theirs). Given masks
        decide; without a `teacher` entry they are completed from
        `generator` at a ratio below 1. Returns (logits (B, T_out, n_units),
        alignments (B, T_out, L))."""
        B, L, _ = emb_text.shape
        T_out = units.shape[1]
        if masks is None:
            masks = draw_masks(self.cfg, B, L, T_out, self.training, generator,
                               emb_text.device, teacher_forcing_ratio)
        elif masks.teacher is None:
            masks = masks._replace(teacher=draw_teacher(T_out, teacher_forcing_ratio, generator,
                                                        emb_text.device))
        src_valid, memory, processed = encode(self, emb_text, src_lens, masks.encoder)
        carry = zero_carry(self.cfg, memory)
        teacher_emb = self.unit_embedding(units)
        teacher_in = torch.cat([teacher_emb.new_zeros(B, 1, self.cfg.d_unit),
                                teacher_emb[:, :-1]], 1)
        logits_all, aligns = [], []
        for t in range(T_out):
            dec_in = teacher_in[:, t]
            if masks.teacher is not None and t > 0:
                sampled = self.unit_embedding(logits_all[-1].detach().argmax(dim=-1))
                dec_in = torch.where(masks.teacher[t], dec_in, sampled)
            carry, logits, attn_w = self.decoder_cell(
                carry, self.prenet(dec_in, masks.prenet[t]), memory, processed, src_valid,
                None if masks.attention is None else masks.attention[t],
                None if masks.decoder is None else masks.decoder[t])
            logits_all.append(logits)
            aligns.append(attn_w)
        return torch.stack(logits_all, 1), torch.stack(aligns, 1)

    def infer(self, emb_text, src_lens, max_steps: Optional[int] = None,
              masks: Optional[T2UMasks] = None,
              generator: Optional[torch.Generator] = None):
        """Batched argmax decoding until <eos> (id 8), for max_decoder_ratio
        * L steps (all of them, with no host wait: a sample's positions from
        its <eos> on are set to 0). Returns (logits (B, S, n_units), unit ids
        (B, S), lengths (B,), alignments (B, S, L))."""
        B, L, _ = emb_text.shape
        max_steps = max_steps or self.cfg.max_decoder_ratio * L
        if masks is None:
            masks = draw_masks(self.cfg, B, L, max_steps, False, generator, emb_text.device)
        src_valid, memory, processed = encode(self, emb_text, src_lens, None)
        carry = zero_carry(self.cfg, memory)
        prev_in = memory.new_zeros(B, self.cfg.d_unit)
        finished = torch.zeros(B, dtype=torch.bool, device=memory.device)
        logits_all, preds, active, aligns = [], [], [], []
        for t in range(max_steps):
            carry, logits, attn_w = self.decoder_cell(
                carry, self.prenet(prev_in, masks.prenet[t]), memory, processed, src_valid)
            pred = logits.argmax(dim=-1)
            finished = finished | (pred == EOS_ID)
            prev_in = self.unit_embedding(pred)
            logits_all.append(logits)
            preds.append(pred)
            active.append(~finished)
            aligns.append(attn_w)
        active = torch.stack(active, 1)
        preds = torch.where(active, torch.stack(preds, 1), 0)
        n_steps = active.sum(dim=1, dtype=torch.int32)
        return torch.stack(logits_all, 1), preds, n_steps, torch.stack(aligns, 1)
