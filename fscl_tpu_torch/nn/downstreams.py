"""SSL downstreams and the PR heads (port of `fscl_tpu/nn/downstreams.py`:
`WeightedSumLayer` `:21`, `LinearDownstream` `:41`, `BiLSTMDownstream` `:54`,
`EncoderBlock` `:80`, `CodeformerBlock` `:109`, `Downstream1` `:141`,
`Downstream2` `:161`, `MultilingualPRHead` `:186`, `MultilingualClusterHead`
`:199`).

A learned softmax-weighted sum over the SSL layers, a projection, then
post-LN transformer blocks (`Downstream1`), the last of them a cross-attention
to a learned codebook in `Downstream2`; or a 2-layer BiLSTM (`BiLSTMDownstream`,
the T2U encoder's flax-layout LSTMs: one bias per gate, the backward
direction reversed within each row's length). The blocks' self-attention goes
through `ops.attention.attend`: on the card, the attention kernel (under
`AttentionFunction` when a gradient is needed). The codeformer's attention is
L queries against codebook_size rows, which the kernel does not take
(Lq == Lk only): `torch.matmul` and `softmax` there, as fscl_tpu's `einsum`.
LayerNorm eps is flax's 1e-6.

The PR heads hold one head per language of `id2symbols` (`head-<symbol_id>`,
fscl_tpu's parameter name) and pick it by the batch's `symbol_id`, a Python
string that never reaches the card. fscl_tpu's flax heads create only the
head of the language they are initialised with.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fscl_tpu_torch.models.tacotron2_t2u import bilstm, one_bias_lstm
from fscl_tpu_torch.ops.attention import attend

LN_EPS = 1e-6


class WeightedSumLayer(nn.Module):
    """softmax(weight_raw)-weighted sum over the layer axis; with
    `specific_layer` a fixed one-hot instead (raw -1e9 but 10.0 there, no
    gradient; `weight_raw` stays a parameter the loss does not reach)."""

    def __init__(self, n_in_layers: int, specific_layer: Optional[int] = None):
        super().__init__()
        self.weight_raw = nn.Parameter(torch.randn(n_in_layers))
        pinned = None
        if specific_layer is not None:
            pinned = torch.full((n_in_layers,), -1e9)
            pinned[specific_layer] = 10.0
        self.register_buffer("pinned_weight_raw", pinned, persistent=False)

    def forward(self, x, axis: int = 2):
        raw = self.weight_raw if self.pinned_weight_raw is None else self.pinned_weight_raw
        shape = [1] * x.dim()
        shape[axis] = raw.shape[0]
        return (torch.softmax(raw, dim=0).reshape(shape) * x).sum(dim=axis)


class LinearDownstream(nn.Module):
    """Weighted sum over (B, T, n_layers, d_in) + a linear projection."""

    def __init__(self, n_in_layers: int, d_in: int, d_out: int,
                 specific_layer: Optional[int] = None):
        super().__init__()
        self.weighted_sum = WeightedSumLayer(n_in_layers, specific_layer)
        self.proj = nn.Linear(d_in, d_out)

    def forward(self, reprs):
        return self.proj(self.weighted_sum(reprs))


class BiLSTMDownstream(nn.Module):
    """Weighted sum + projection + 2 bidirectional LSTM layers of d_out / 2
    a direction; padding frames zeroed after each layer."""

    def __init__(self, n_in_layers: int, d_in: int, d_out: int,
                 specific_layer: Optional[int] = None):
        super().__init__()
        self.weighted_sum = WeightedSumLayer(n_in_layers, specific_layer)
        self.proj = nn.Linear(d_in, d_out)
        half = d_out // 2
        self.lstm_fwd = nn.ModuleList(one_bias_lstm(d_out, half) for _ in range(2))
        self.lstm_bwd = nn.ModuleList(one_bias_lstm(d_out, half) for _ in range(2))

    def forward(self, reprs, valid=None):
        x = self.proj(self.weighted_sum(reprs))
        if valid is None:
            valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        for fwd, bwd in zip(self.lstm_fwd, self.lstm_bwd):
            x = bilstm(fwd, bwd, x, valid)
        return x


class EncoderBlock(nn.Module):
    """Post-LN transformer block; dropout after the attention's output
    projection and after the FFN."""

    def __init__(self, d_model: int, n_head: int, d_ff: int, dropout: float = 0.1):
        super().__init__()
        self.n_head = n_head
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff1 = nn.Linear(d_model, d_ff)
        self.ff2 = nn.Linear(d_ff, d_model)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, valid=None):
        B, L, D = x.shape
        dh = D // self.n_head

        def split(t):
            return t.view(B, L, self.n_head, dh).transpose(1, 2).contiguous()

        o = attend(split(self.q(x)), split(self.k(x)), split(self.v(x)), key_valid=valid,
                   temperature=dh ** 0.5)
        o = self.dropout(self.out(o.transpose(1, 2).reshape(B, L, D)))
        x = self.ln1(x + o)
        h = self.dropout(self.ff2(F.relu(self.ff1(x))))
        return self.ln2(x + h)


class CodeformerBlock(nn.Module):
    """Cross-attention of the frames to a learned codebook (keys and values
    both the codebook), then the FFN; returns (x, weights or None)."""

    def __init__(self, codebook_size: int, d_model: int, n_head: int, d_ff: int,
                 dropout: float = 0.1):
        super().__init__()
        self.n_head = n_head
        self.codebook = nn.Parameter(torch.randn(codebook_size, d_model))
        self.q = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff1 = nn.Linear(d_model, d_ff)
        self.ff2 = nn.Linear(d_ff, d_model)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, need_weights: bool = False):
        B, L, D = x.shape
        C, dh = self.codebook.shape[0], D // self.n_head
        qh = self.q(x).view(B, L, self.n_head, dh).transpose(1, 2)
        kh = self.codebook.view(C, self.n_head, dh).transpose(0, 1)
        attn = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) / dh ** 0.5, dim=-1)
        o = torch.matmul(attn, kh).transpose(1, 2).reshape(B, L, D)
        x = self.ln1(x + self.out(o))
        h = self.dropout(self.ff2(F.relu(self.ff1(x))))
        return self.ln2(x + h), (attn if need_weights else None)


class Downstream1(nn.Module):
    """Weighted sum over (B, T, n_layers, d_in) + projection + one
    EncoderBlock per entry of d_ff; returns (B, T, d_model)."""

    def __init__(self, n_in_layers: int, d_in: int, d_model: int = 256, n_head: int = 2,
                 d_ff: Sequence[int] = (1024, 1024), dropout: float = 0.1,
                 specific_layer: Optional[int] = None):
        super().__init__()
        self.weighted_sum = WeightedSumLayer(n_in_layers, specific_layer)
        self.proj = nn.Linear(d_in, d_model)
        self.layers = nn.ModuleList(EncoderBlock(d_model, n_head, ff, dropout) for ff in d_ff)

    def forward(self, reprs, valid=None):
        x = self.proj(self.weighted_sum(reprs))
        for layer in self.layers:
            x = layer(x, valid)
        return x


class Downstream2(nn.Module):
    """Downstream1 with a CodeformerBlock as its last layer; returns
    (x, codebook weights or None)."""

    def __init__(self, n_in_layers: int, d_in: int, codebook_size: int = 128,
                 d_model: int = 256, n_head: int = 2, d_ff: Sequence[int] = (1024, 1024),
                 dropout: float = 0.1, specific_layer: Optional[int] = None):
        super().__init__()
        self.weighted_sum = WeightedSumLayer(n_in_layers, specific_layer)
        self.proj = nn.Linear(d_in, d_model)
        self.layers = nn.ModuleList(
            EncoderBlock(d_model, n_head, ff, dropout) for ff in d_ff[:-1])
        self.codeformer = CodeformerBlock(codebook_size, d_model, n_head, d_ff[-1], dropout)

    def forward(self, reprs, valid=None, need_weights: bool = False):
        x = self.proj(self.weighted_sum(reprs))
        for layer in self.layers:
            x = layer(x, valid)
        return self.codeformer(x, need_weights)


class MultilingualPRHead(nn.Module):
    """Per-language linear classification heads (heads.py:7-19)."""

    def __init__(self, id2symbols: Tuple[Tuple[str, int], ...], d_in: int = 256):
        super().__init__()
        self.heads = nn.ModuleDict({f"head-{sid}": nn.Linear(d_in, n) for sid, n in id2symbols})

    def forward(self, x, symbol_id: str):
        return self.heads[f"head-{symbol_id}"](x)


class MultilingualClusterHead(nn.Module):
    """Per-language cluster centres; logits are the temperature-scaled
    cosine similarity ("cos") or the negative Euclidean distance ("l2")
    (heads.py:22-50)."""

    def __init__(self, id2symbols: Tuple[Tuple[str, int], ...], d_in: int = 256,
                 temperature: float = 0.1, mode: str = "cos"):
        super().__init__()
        if mode not in ("cos", "l2"):
            raise NotImplementedError(mode)
        self.temperature = temperature
        self.mode = mode
        self.centers = nn.ParameterDict(
            {f"head-{sid}": nn.Parameter(torch.randn(n, d_in)) for sid, n in id2symbols})

    def forward(self, x, symbol_id: str):
        centers = self.centers[f"head-{symbol_id}"]
        if self.mode == "cos":
            xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
            cn = centers / (torch.linalg.vector_norm(centers, dim=-1, keepdim=True) + 1e-8)
            return torch.matmul(xn, cn.T) / self.temperature
        # the distances directly, not through |x|^2 - 2 x.c + |c|^2, whose
        # rounding near 0 the square root would amplify
        return -torch.cdist(x, centers.expand(x.shape[0], -1, -1),
                            compute_mode="donot_use_mm_for_euclid_dist")
