"""SSL speech upstream, HuBERT / wav2vec2 family (port of
`fscl_tpu/models/hubert.py:29-198`, `:237-303`, `:362-376`).

A wav2vec2-style conv feature extractor and transformer encoder that returns
every hidden state stacked: (B, T', n_layers + 1, dim), the conv features
after the projection and positional conv followed by each layer's output,
with no final LayerNorm (the s3prl convention the FSCL system reads). 16 kHz
input, 320x downsampling: 50 frames per second.

Parameter names are HuggingFace `HubertModel`'s
(`feature_extractor.conv_layers.{i}.conv.weight`,
`encoder.pos_conv_embed.conv.weight`,
`encoder.layers.{i}.attention.q_proj.weight`, ...), so that a state dict of
this module converts into the JAX package's params with
`fscl_tpu/models/hubert.py:convert_torch_checkpoint`. The numerics are the
JAX package's, not HF's: GELU is the tanh approximation (flax's `nn.gelu`)
and LayerNorm / GroupNorm eps is 1e-6 (flax's default).

The attention runs through `ops.attention.attend` at head dim 64 (16 heads
in the large model): on the card, the attention kernel. The custom dims of
`make_upstream` give other head dims (dim 80 in 2 heads of 40, dim 96 in 2
of 48): `attention_cuda` zero-pads those to the kernel's 64. The layers run
as a plain loop (the JAX package's `scan_layers` only shortens its
compiles).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fscl_tpu_torch.ops.attention import attend
from fscl_tpu_torch.ops.masking import length_mask

# conv feature extractor: (dim, kernel, stride) x 7, 320x in all
CONV_SPEC = ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2
SAMPLES_PER_FRAME = 320
NORM_EPS = 1e-6


def ssl_num_frames(n_samples: int) -> int:
    n = n_samples
    for _, k, s in CONV_SPEC:
        n = (n - k) // s + 1
    return n


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class ConvLayer(nn.Module):
    """One strided conv, its norm (a channel LayerNorm, a GroupNorm with one
    channel per group, or none) and GELU, on (B, C, T)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, bias: bool,
                 norm: Optional[str]):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=stride, bias=bias)
        self.norm = norm
        if norm == "layer":
            self.layer_norm = nn.LayerNorm(c_out, eps=NORM_EPS)
        elif norm == "group":
            self.layer_norm = nn.GroupNorm(c_out, c_out, eps=NORM_EPS)

    def forward(self, x):
        x = self.conv(x)
        if self.norm == "layer":
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.norm == "group":
            x = self.layer_norm(x)
        return gelu(x)


class ConvFeatureExtractor(nn.Module):
    """7-layer strided conv stack. Modes (fairseq `extractor_mode`, HF
    `feat_extract_norm`): "group_norm" (base models) has bias-less convs and
    one GroupNorm(512, 512) after conv 0 only; "layer_norm" (hubert-large,
    wav2vec2-large, XLSR) has biased convs and a channel LayerNorm after
    every conv."""

    def __init__(self, mode: str = "group_norm"):
        super().__init__()
        if mode not in ("group_norm", "layer_norm"):
            raise ValueError(f"extractor mode {mode!r}")
        layers, c_in = [], 1
        for i, (dim, k, s) in enumerate(CONV_SPEC):
            norm = "layer" if mode == "layer_norm" else ("group" if i == 0 else None)
            layers.append(ConvLayer(c_in, dim, k, s, mode == "layer_norm", norm))
            c_in = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav):                         # (B, T) -> (B, T', 512)
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, c_in: int, dim: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c_in, eps=NORM_EPS)
        self.projection = nn.Linear(c_in, dim)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv over time, padding kernel // 2 on each side; for an even
    kernel the last frame is dropped, as in the JAX package (`:76-77`)."""

    def __init__(self, dim: int = 1024, kernel: int = 128, groups: int = 16):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, kernel, padding=kernel // 2, groups=groups)
        self.trim = kernel % 2 == 0

    def forward(self, x):                           # (B, T, D)
        h = self.conv(x.transpose(1, 2))
        if self.trim:
            h = h[:, :, :-1]
        return gelu(h).transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, valid):
        B, L, D = x.shape
        dh = D // self.n_heads

        def split(t):
            return t.view(B, L, self.n_heads, dh).transpose(1, 2).contiguous()

        o = attend(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)),
                   key_valid=valid, temperature=dh ** 0.5)
        return self.out_proj(o.transpose(1, 2).reshape(B, L, D))


class FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(dim, ffn_dim)
        self.output_dense = nn.Linear(ffn_dim, dim)

    def forward(self, x):
        return self.output_dense(gelu(self.intermediate_dense(x)))


class TransformerLayer(nn.Module):
    """Pre-LN (the large models) or post-LN (the base models)."""

    def __init__(self, dim: int = 1024, n_heads: int = 16, ffn_dim: int = 4096,
                 layer_norm_first: bool = True):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.attention = SelfAttention(dim, n_heads)
        self.layer_norm = nn.LayerNorm(dim, eps=NORM_EPS)
        self.feed_forward = FeedForward(dim, ffn_dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=NORM_EPS)

    def forward(self, x, valid):
        if self.layer_norm_first:
            x = x + self.attention(self.layer_norm(x), valid)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, valid))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, dim, n_layers, n_heads, ffn_dim, layer_norm_first,
                 pos_conv_kernel, pos_conv_groups):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(dim, pos_conv_kernel, pos_conv_groups)
        if not layer_norm_first:    # post-LN: a LayerNorm after the positional conv
            self.layer_norm = nn.LayerNorm(dim, eps=NORM_EPS)
        self.layers = nn.ModuleList(
            TransformerLayer(dim, n_heads, ffn_dim, layer_norm_first) for _ in range(n_layers))


class SSLUpstream(nn.Module):
    """HuBERT / wav2vec2 encoder returning all hidden states."""

    def __init__(self, dim: int = 1024, n_layers: int = 24, n_heads: int = 16,
                 ffn_dim: int = 4096, layer_norm_first: bool = True,
                 pos_conv_kernel: int = 128, pos_conv_groups: int = 16,
                 extractor_mode: str = "group_norm"):
        super().__init__()
        self.dim, self.n_layers, self.n_heads = dim, n_layers, n_heads
        self.layer_norm_first = layer_norm_first
        self.feature_extractor = ConvFeatureExtractor(extractor_mode)
        self.feature_projection = FeatureProjection(CONV_SPEC[-1][0], dim)
        self.encoder = Encoder(dim, n_layers, n_heads, ffn_dim, layer_norm_first,
                               pos_conv_kernel, pos_conv_groups)

    def forward(self, wav: torch.Tensor, wav_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """wav: (B, T) 16 kHz; wav_valid: (B, T) bool or None. Returns
        (hidden (B, T', n_layers + 1, dim), frame_valid (B, T') bool). A
        frame is valid below floor(valid samples / 320), clipped to T' (the
        JAX package's count, not HF's conv-length formula)."""
        x, frame_valid = pre_transformer_features(self, wav, wav_valid)
        hiddens = [x]
        for layer in self.encoder.layers:
            x = layer(x, frame_valid)
            hiddens.append(x)
        return torch.stack(hiddens, dim=2), frame_valid


def pre_transformer_features(upstream: SSLUpstream, wav: torch.Tensor,
                             wav_valid: Optional[torch.Tensor]):
    """Everything before the layer stack: the conv extractor, the projection
    (invalid frames zeroed), the positional conv and, post-LN, the encoder's
    LayerNorm (`fscl_tpu/models/hubert.py:pre_transformer_features`). Returns
    (x (B, T', dim), frame_valid (B, T')): the first hidden state, which the
    pipeline- and sequence-parallel schedules run the layers on."""
    feats = upstream.feature_extractor(wav)
    Tp = feats.shape[1]
    if wav_valid is not None:
        n_valid = wav_valid.sum(dim=-1)
        frame_len = torch.floor(n_valid.float() / float(SAMPLES_PER_FRAME)).long()
        frame_valid = length_mask(frame_len.clamp(0, Tp), Tp)
    else:
        frame_valid = torch.ones(feats.shape[:2], dtype=torch.bool, device=feats.device)
    x = upstream.feature_projection(feats)
    x = torch.where(frame_valid[..., None], x, 0.0)
    x = x + upstream.encoder.pos_conv_embed(x)
    if not upstream.layer_norm_first:
        x = upstream.encoder.layer_norm(x)
    return x, frame_valid


def make_upstream(name: str = "hubert_large_ll60k", cfg=None) -> SSLUpstream:
    """The released shapes by name; `cfg` (core.config.UpstreamConfig) with
    a dim other than 1024 gives a custom upstream of cfg.n_layers - 1 layers
    (at least 1), max(dim // 64, 2) heads and a 4 * dim FFN."""
    if name in ("hubert", "wav2vec2"):      # base models: 768d, 12 layers, post-LN
        return SSLUpstream(dim=768, n_layers=12, n_heads=12, ffn_dim=3072,
                           layer_norm_first=False)
    if cfg is not None and cfg.dim != 1024:
        dim = cfg.dim
        return SSLUpstream(dim=dim, n_layers=max(cfg.n_layers - 1, 1),
                           n_heads=max(dim // 64, 2), ffn_dim=4 * dim)
    # hubert_large_ll60k / wav2vec2_large_ll60k / xlsr_53: 1024d, 24 layers
    return SSLUpstream(extractor_mode="layer_norm")


@torch.no_grad()
def init_random_(upstream: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn on the parameters' device from `generator`, in
    the spirit of flax's defaults: matrices and conv kernels normal with
    std 1 / sqrt(fan_in), biases 0, norm scales 1. On the card this takes
    milliseconds where torch's own init of HuBERT-large on the host takes
    seconds."""
    for name, p in upstream.named_parameters():
        if p.dim() >= 2:
            p.normal_(0.0, (p[0].numel()) ** -0.5, generator=generator)
        elif "norm" in name and name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()


def dequant_and_cast_inputs(wavs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int16 PCM wavs (the wire format) are dequantised on the device by
    1 / 32768; then the wavs are cast to the compute dtype."""
    if not wavs.is_floating_point():
        wavs = wavs.float() * (1.0 / 32768.0)
    return wavs.to(dtype)


def frozen_upstream_features(upstream: SSLUpstream, wavs: torch.Tensor,
                             wav_valid: Optional[torch.Tensor]):
    """The frozen forward every SSL system's `extract_ssl` runs: no
    gradient, so no activation is kept for a backward; wavs dequantised and
    cast to the upstream's storage dtype (float32, or bfloat16 after
    `upstream.to(torch.bfloat16)`, the JAX package's `storage_cast`); hidden
    states returned as float32. Returns (hidden (B, T', n_layers + 1, dim),
    frame_valid (B, T'))."""
    dtype = next(upstream.parameters()).dtype
    with torch.no_grad():
        hidden, frame_valid = upstream(dequant_and_cast_inputs(wavs, dtype), wav_valid)
    return hidden.float(), frame_valid
