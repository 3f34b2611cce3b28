"""FFT-block transformer: encoder/decoder stacks + PostNet
(port of `fscl_tpu/nn/fft_block.py`).

Post-LN FFT blocks (MHA + conv1d FFN), key-side masking, sinusoidal PE and
masked fills after each sublayer. Activations stay (B, L, D) at every public
call, as in the JAX package; the convs transpose to PyTorch's (B, D, L)
around themselves. Module and parameter names follow the reference torch
key names (`encoder.layer_stack.{i}.slf_attn.w_qs`, `postnet.convolutions.
{i}.0.conv`), which `benchmarks/convert_reference.py` reads.

LayerNorm eps is 1e-6 (flax's default, not torch's 1e-5); BatchNorm eps is
1e-5 in both. Dropout sits where the JAX package puts it (`:62, 83, 212,
221`): after the attention's output projection, after the FFN's second conv,
and after each PostNet layer (rate 0.5, fixed). In train mode the PostNet's
BatchNorm follows flax (`BatchNorm`, below), not `nn.BatchNorm1d`.

Compute dtype (`dtype`, fscl_tpu's per-module `dtype` at `:38, 73, 94, 129,
197`). With `dtype=torch.bfloat16` every Linear and Conv of the blocks and
the PostNet casts its input, weight and bias to bf16 and returns bf16, as a
flax `nn.Dense(dtype=bf16)` over f32 parameters does (`dense`, `conv`
below). The rest follows from type promotion, as in JAX: the residual add
of a bf16 sublayer output to the f32 stream gives f32, so the residual
stream and the LayerNorms stay f32; the attention runs in bf16 on bf16
q, k, v; the PostNet's BatchNorms normalise in f32 and return f32. The
policy is written out here rather than left to `torch.autocast`, whose
rules (which ops run in bf16, what a sum returns) are not flax's.

`remat=True` recomputes each FFT block in the backward
(`torch.utils.checkpoint`, non-reentrant, the RNG state kept so that the
dropout masks replay), fscl_tpu's `nn.remat(FFTBlock)` (`:137-138`). The
recompute launches the attention kernel again, through `AttentionFunction`.
A double backward (second-order MAML) runs through it; a `torch.func`
transform does not (torch's checkpoint refuses saved-tensor hooks and
vmapped tensors there), and `FFTStack` raises a clear error under one, where
JAX's remat composes with `vmap`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from fscl_tpu_torch.ops.attention import attend
from fscl_tpu_torch.ops.masking import mask_fill
from fscl_tpu_torch.ops.global_reduce import data_parallel_active, global_sum

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


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`layer(x)`, computed in `dtype` when given (input, weight and bias
    cast to it; the result in it)."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def conv(layer: nn.Conv1d, x: torch.Tensor,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`layer(x)` on (B, C, T), computed in `dtype` when given."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv1d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride,
                    layer.padding, layer.dilation, layer.groups)


def conv_nlc(layer: nn.Conv1d, x: torch.Tensor,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply a Conv1d to (B, L, C) and return (B, L, C')."""
    return conv(layer, x.transpose(1, 2), dtype).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention (SubLayers.py:8-58)."""

    def __init__(self, n_head: int, d_model: int, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
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

        dt = self.dtype
        out = attend(split(dense(self.w_qs, x, dt)), split(dense(self.w_ks, x, dt)),
                     split(dense(self.w_vs, x, dt)), key_valid=key_valid, temperature=self.d_k ** 0.5,
                     return_weights=return_weights)
        weights = None
        if return_weights:
            out, weights = out
        out = out.transpose(1, 2).reshape(B, L, self.n_head * self.d_k)
        out = self.dropout(dense(self.fc, out, dt))
        return self.layer_norm(out + residual), weights


class ConvFFN(nn.Module):
    """Position-wise conv1d feed-forward, post-LN (SubLayers.py:61-98)."""

    def __init__(self, d_model: int, d_inner: int,
                 kernel_size: Tuple[int, int] = (9, 1), dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        k1, k2 = kernel_size
        self.w_1 = nn.Conv1d(d_model, d_inner, k1, padding=(k1 - 1) // 2)
        self.w_2 = nn.Conv1d(d_inner, d_model, k2, padding=(k2 - 1) // 2)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        h = torch.relu(conv_nlc(self.w_1, x, self.dtype))
        h = self.dropout(conv_nlc(self.w_2, h, self.dtype))
        return self.layer_norm(h + x)


class FFTBlock(nn.Module):
    """MHA + conv FFN with masked fills after each sublayer (Layers.py:11-31)."""

    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 kernel_size: Tuple[int, int] = (9, 1), dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, dropout, dtype)
        self.pos_ffn = ConvFFN(d_model, d_inner, kernel_size, dropout, dtype)

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
    `FFTStack` does at `:133-136`) and runs n_layers FFT blocks, each
    recomputed in the backward under `remat` (when a graph is being built)."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_size: Tuple[int, int] = (9, 1), dropout: float = 0.1,
                 max_seq_len: int = 1000, remat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model = d_model
        self.remat = remat
        self.layer_stack = nn.ModuleList(
            FFTBlock(d_model, n_head, d_inner, kernel_size, dropout, dtype)
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
        remat = self.remat and torch.is_grad_enabled()
        if remat and torch._C._functorch.peek_interpreter_stack() is not None:
            raise RuntimeError(
                "remat: torch.utils.checkpoint cannot run under a torch.func transform "
                "(grad, vmap); build the model with remat off for such a path (the "
                "many-task adaptation, systems/tune.py:adapt_many_on_chip)")
        for layer in self.layer_stack:
            if remat:
                names, tensors = zip(*layer.named_parameters())
                x = checkpoint(_block_out, layer, names, x, valid, *tensors,
                               use_reentrant=False)
            else:
                x, _ = layer(x, valid)
        return x


def _block_out(layer: FFTBlock, names, x, valid, *tensors):
    """One block's output with the parameter tensors it was given. The
    recompute runs in the backward, after a caller's `functional_call` (the
    adaptation loops, MAML's inner loop) has put the module's own
    parameters back: passing the tensors in keeps the recompute on the
    ones the forward used."""
    return functional_call(layer, dict(zip(names, tensors)), (x, valid))[0]


class Encoder(FFTStack):
    """Encoder2 semantics: embedding-less, takes pre-embedded text."""

    def __init__(self, n_layers: int = 4, d_model: int = 256, n_head: int = 2,
                 d_inner: int = 1024, kernel_size: Tuple[int, int] = (9, 1),
                 dropout: float = 0.2, max_seq_len: int = 1000, remat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(n_layers, d_model, n_head, d_inner, kernel_size,
                         dropout, max_seq_len, remat, dtype)


class Decoder(FFTStack):
    """Mel decoder stack (Models.py:171-237)."""

    def __init__(self, n_layers: int = 6, d_model: int = 256, n_head: int = 2,
                 d_inner: int = 1024, kernel_size: Tuple[int, int] = (9, 1),
                 dropout: float = 0.2, max_seq_len: int = 1000, remat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(n_layers, d_model, n_head, d_inner, kernel_size,
                         dropout, max_seq_len, remat, dtype)


class ConvNorm(nn.Module):
    """A Conv1d under the name `conv`, as the reference's ConvNorm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2)

    def forward(self, x, dtype: Optional[torch.dtype] = None):       # (B, C, T)
        return conv(self.conv, x, dtype)


class BatchNorm(nn.BatchNorm1d):
    """flax's `nn.BatchNorm(momentum=0.9)` over (B, C, T), under torch's
    BatchNorm1d keys. Eval mode normalises with the running statistics, as
    BatchNorm1d does. Train mode normalises with the biased batch statistics
    over B and T (padding frames included, as in flax) and updates the
    running buffers as flax does: `r = 0.9 r + 0.1 stat`, with the biased
    variance where BatchNorm1d takes the unbiased one (a difference of
    1 / (B T - 1), 3 % at a few dozen frames). `num_batches_tracked` is
    not advanced: flax keeps no such count. An input of another dtype than
    the parameters' (a bf16 conv's output) is normalised in theirs, as
    flax's BatchNorm (`dtype=None`) promotes it. Under
    `parallel.mesh.data_parallel` the statistics are the global batch's (two
    differentiable sums over the data axis: the mean, then the squared
    deviations from it), as in fscl_tpu's sharded step; one implementation
    for the CPU and the card, where `nn.SyncBatchNorm` takes CUDA only."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=0.1)

    def forward(self, x):       # (B, C, T)
        x = x.to(self.weight.dtype)
        if not self.training:
            return super().forward(x)
        if data_parallel_active():
            n = global_sum(torch.tensor(float(x.shape[0] * x.shape[2]), device=x.device))
            mean = global_sum(x.sum(dim=(0, 2))) / n
            var = global_sum(((x - mean[:, None]) ** 2).sum(dim=(0, 2))) / n
        else:
            var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class PostNet(nn.Module):
    """5-layer conv postnet with batch norm + tanh (Layers.py:66-137)."""

    def __init__(self, n_mel_channels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convolutions: int = 5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        chans = [n_mel_channels] + [embedding_dim] * (n_convolutions - 1) + [n_mel_channels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(chans[i], chans[i + 1], kernel_size),
                          BatchNorm(chans[i + 1]))
            for i in range(n_convolutions))
        self.dropout = nn.Dropout(0.5)

    def forward(self, x):       # (B, T, n_mels)
        h = x.transpose(1, 2)
        last = len(self.convolutions) - 1
        for i, (conv_norm, batch_norm) in enumerate(self.convolutions):
            h = batch_norm(conv_norm(h, self.dtype))
            if i < last:
                h = torch.tanh(h)
            h = self.dropout(h)
        return h.transpose(1, 2)
