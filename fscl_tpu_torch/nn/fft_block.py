"""FFT-block transformer: encoder/decoder stacks + PostNet
(port of `fscl_tpu/nn/fft_block.py`).

Post-LN FFT blocks (MHA + conv1d FFN), key-side masking, sinusoidal PE and
masked fills after each sublayer. Activations stay (B, L, D) at every public
call, as in the JAX package; the convs transpose to PyTorch's (B, D, L)
around themselves. Module and parameter names follow the reference torch
key names (`encoder.layer_stack.{i}.slf_attn.w_qs`, `postnet.convolutions.
{i}.0.conv`), which `benchmarks/convert_reference.py` reads.

LayerNorm eps is 1e-6 (flax's default, not torch's 1e-5); BatchNorm eps is
1e-5 in both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from fscl_tpu_torch.ops.attention import attend
from fscl_tpu_torch.ops.masking import mask_fill

LN_EPS = 1e-6
BN_EPS = 1e-5


def sinusoid_position_encoding(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoid PE table; formula matches transformer/Models.py:10-30."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def conv_nlc(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to (B, L, C) and return (B, L, C')."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention (SubLayers.py:8-58)."""

    def __init__(self, n_head: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.n_head = n_head
        self.d_k = d_model // n_head
        self.w_qs = nn.Linear(d_model, n_head * self.d_k)
        self.w_ks = nn.Linear(d_model, n_head * self.d_k)
        self.w_vs = nn.Linear(d_model, n_head * self.d_k)
        self.fc = nn.Linear(n_head * self.d_k, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, key_valid: Optional[torch.Tensor] = None,
                return_weights: bool = False):
        B, L, _ = x.shape
        residual = x

        def split(t):
            return t.view(B, L, self.n_head, self.d_k).transpose(1, 2).contiguous()

        out = attend(split(self.w_qs(x)), split(self.w_ks(x)), split(self.w_vs(x)),
                     key_valid=key_valid, temperature=self.d_k ** 0.5,
                     return_weights=return_weights)
        weights = None
        if return_weights:
            out, weights = out
        out = out.transpose(1, 2).reshape(B, L, self.n_head * self.d_k)
        out = self.dropout(self.fc(out))
        return self.layer_norm(out + residual), weights


class ConvFFN(nn.Module):
    """Position-wise conv1d feed-forward, post-LN (SubLayers.py:61-98)."""

    def __init__(self, d_model: int, d_inner: int,
                 kernel_size: Tuple[int, int] = (9, 1), dropout: float = 0.1):
        super().__init__()
        k1, k2 = kernel_size
        self.w_1 = nn.Conv1d(d_model, d_inner, k1, padding=(k1 - 1) // 2)
        self.w_2 = nn.Conv1d(d_inner, d_model, k2, padding=(k2 - 1) // 2)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        h = torch.relu(conv_nlc(self.w_1, x))
        h = self.dropout(conv_nlc(self.w_2, h))
        return self.layer_norm(h + x)


class FFTBlock(nn.Module):
    """MHA + conv FFN with masked fills after each sublayer (Layers.py:11-31)."""

    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_size: Tuple[int, int] = (9, 1), dropout: float = 0.1):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, dropout)
        self.pos_ffn = ConvFFN(d_model, d_inner, kernel_size, dropout)

    def forward(self, x, valid: Optional[torch.Tensor] = None,
                return_weights: bool = False):
        out, w = self.slf_attn(x, key_valid=valid, return_weights=return_weights)
        if valid is not None:
            out = mask_fill(out, valid)
        out = self.pos_ffn(out)
        if valid is not None:
            out = mask_fill(out, valid)
        return out, w


class FFTStack(nn.Module):
    """Shared body of Encoder and Decoder (Models.py:103-237): adds the
    sinusoidal PE (recomputed when L > max_seq_len, as the JAX package's
    `FFTStack` does at `:133-136`) and runs n_layers FFT blocks."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_size: Tuple[int, int] = (9, 1), dropout: float = 0.1,
                 max_seq_len: int = 1000):
        super().__init__()
        self.d_model = d_model
        self.layer_stack = nn.ModuleList(
            FFTBlock(d_model, n_head, d_inner, kernel_size, dropout)
            for _ in range(n_layers))
        self.register_buffer(
            "position_table",
            torch.from_numpy(sinusoid_position_encoding(max_seq_len + 1, d_model)),
            persistent=False)

    def forward(self, x, valid):
        L = x.shape[1]
        pe = self.position_table
        if L > pe.shape[0]:
            pe = torch.from_numpy(sinusoid_position_encoding(L, self.d_model)).to(x.device)
        x = x + pe[None, :L, :].to(x.dtype)
        for layer in self.layer_stack:
            x, _ = layer(x, valid)
        return x


class Encoder(FFTStack):
    """Encoder2 semantics: embedding-less, takes pre-embedded text."""

    def __init__(self, n_layers: int = 4, d_model: int = 256, n_head: int = 2,
                 d_inner: int = 1024, kernel_size: Tuple[int, int] = (9, 1),
                 dropout: float = 0.2, max_seq_len: int = 1000):
        super().__init__(n_layers, d_model, n_head, d_inner, kernel_size,
                         dropout, max_seq_len)


class Decoder(FFTStack):
    """Mel decoder stack (Models.py:171-237)."""

    def __init__(self, n_layers: int = 6, d_model: int = 256, n_head: int = 2,
                 d_inner: int = 1024, kernel_size: Tuple[int, int] = (9, 1),
                 dropout: float = 0.2, max_seq_len: int = 1000):
        super().__init__(n_layers, d_model, n_head, d_inner, kernel_size,
                         dropout, max_seq_len)


class ConvNorm(nn.Module):
    """A Conv1d under the name `conv`, as the reference's ConvNorm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2)

    def forward(self, x):       # (B, C, T)
        return self.conv(x)


class PostNet(nn.Module):
    """5-layer conv postnet with batch norm + tanh (Layers.py:66-137)."""

    def __init__(self, n_mel_channels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convolutions: int = 5):
        super().__init__()
        chans = [n_mel_channels] + [embedding_dim] * (n_convolutions - 1) + [n_mel_channels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(chans[i], chans[i + 1], kernel_size),
                          nn.BatchNorm1d(chans[i + 1], eps=BN_EPS, momentum=0.1))
            for i in range(n_convolutions))
        self.dropout = nn.Dropout(0.5)

    def forward(self, x):       # (B, T, n_mels)
        h = x.transpose(1, 2)
        last = len(self.convolutions) - 1
        for i, conv in enumerate(self.convolutions):
            h = conv(h)
            if i < last:
                h = torch.tanh(h)
            h = self.dropout(h)
        return h.transpose(1, 2)
