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
compiles); `unstack_layer_params` reads its stacked params.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
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
        self.mode = mode
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


# -- released checkpoints ----------------------------------------------------

POS_CONV = "encoder.pos_conv_embed.conv"


def normalize_checkpoint_layout(state_dict: Mapping) -> Dict[str, Any]:
    """Any released SSL checkpoint layout -> HF HubertModel key names (copy
    of `fscl_tpu/models/hubert.py:normalize_checkpoint_layout`):

    - containers: fairseq `{"model": sd, "cfg": ...}`, s3prl
      `{"model_weight": sd}`, generic `{"state_dict": sd}`;
    - prefixes carried by every key: `w2v_encoder.w2v_model.` (fairseq's
      fine-tuned CTC files), `w2v_model.`, `model.`;
    - fairseq key names: `self_attn` -> `attention`, `fc1` / `fc2` ->
      `feed_forward.*`, `post_extract_proj` -> `feature_projection.projection`,
      the top-level `layer_norm` -> `feature_projection.layer_norm`, the conv
      blocks' Sequential indices -> `conv` / `layer_norm`,
      `encoder.pos_conv.0` -> `encoder.pos_conv_embed.conv`.

    Keys neither family needs (`mask_emb`, `label_embs_concat`,
    `final_proj`, `masked_spec_embed`, ...) pass through; an unknown layout
    passes through unchanged."""
    sd = state_dict
    for container in ("model", "model_weight", "state_dict"):
        if container in sd and isinstance(sd[container], Mapping):
            sd = sd[container]
            break
    for prefix in ("w2v_encoder.w2v_model.", "w2v_model.", "model."):
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    if "feature_projection.projection.weight" in sd or "post_extract_proj.weight" not in sd:
        return dict(sd)

    out = {}
    for k, v in sd.items():
        nk = k
        if k.startswith("feature_extractor.conv_layers."):
            parts = k.split(".")
            i, sub = parts[2], parts[3:]
            # Sequential index 0 is the conv; ".2.{w,b}" the GroupNorm,
            # ".2.1.{w,b}" the channel LayerNorm
            what = "conv" if sub[0] == "0" else "layer_norm"
            nk = f"feature_extractor.conv_layers.{i}.{what}.{sub[-1]}"
        elif k.startswith("post_extract_proj."):
            nk = "feature_projection.projection." + k.split(".", 1)[1]
        elif k.startswith("layer_norm."):
            nk = "feature_projection." + k
        elif k.startswith("encoder.pos_conv.0."):
            nk = f"{POS_CONV}." + k[len("encoder.pos_conv.0."):]
        elif k.startswith("encoder.layers."):
            parts = k.split(".", 3)
            sub = parts[3]
            sub = (sub.replace("self_attn_layer_norm.", "layer_norm.")
                   if sub.startswith("self_attn_layer_norm.") else
                   sub.replace("self_attn.", "attention.")
                   .replace("fc1.", "feed_forward.intermediate_dense.")
                   .replace("fc2.", "feed_forward.output_dense."))
            nk = f"encoder.layers.{parts[2]}.{sub}"
        out[nk] = v
    return out


def _fold_pos_conv(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The positional conv's weight norm folded into `weight`, in both key
    formats. The conv is weight-normed on dim 2 (one g per kernel tap, g of
    shape (1, 1, k)), so ||v|| is over dims (0, 1) for `weight_g` /
    `weight_v`, and over the dims where g has size 1 for
    `parametrizations.weight.original0/1`, as fscl_tpu's converter folds
    them. (HiFi-GAN's convs are normed on dim 0: `models/hifigan.py:
    fold_weight_norm` would give this conv wrong weights.) In float64, cast
    back to v's dtype."""
    pairs = ((".weight_g", ".weight_v"),
             (".parametrizations.weight.original0", ".parametrizations.weight.original1"))
    for g_suffix, v_suffix in pairs:
        if POS_CONV + g_suffix not in sd:
            continue
        g = torch.as_tensor(sd.pop(POS_CONV + g_suffix))
        v = torch.as_tensor(sd.pop(POS_CONV + v_suffix))
        dims = ((0, 1) if g_suffix == ".weight_g"
                else tuple(i for i in range(v.dim()) if g.shape[i] == 1))
        norm = torch.linalg.vector_norm(v.double(), dim=dims, keepdim=True)
        sd[POS_CONV + ".weight"] = (g.double() * v.double() / norm).to(v.dtype)
        break
    return sd


def load_torch_checkpoint(state_dict: Mapping, upstream: SSLUpstream
                          ) -> Dict[str, torch.Tensor]:
    """A released SSL checkpoint in any layout `normalize_checkpoint_layout`
    reads (or a state dict under the port's keys, numpy leaves allowed) ->
    a state dict that `upstream` loads with `strict=True`, as
    `fscl_tpu/models/hubert.py:convert_torch_checkpoint` converts it: the
    positional conv's weight norm folded; `encoder.layer_norm` used by a
    post-LN module and dropped for a pre-LN one (the large family applies
    it after the last layer, which the s3prl hidden states leave out); every
    key the module has no place for dropped (`masked_spec_embed`,
    `mask_emb`, `label_embs_concat`, `final_proj`, a group-norm file's conv
    biases, ...). Raises, naming the key, where the module needs a key the
    file lacks or a shape differs; raises where the file's extractor mode
    (per-conv LayerNorms, or one GroupNorm) is not the module's, or where
    the file holds a layer beyond the module's last."""
    sd = _fold_pos_conv(normalize_checkpoint_layout(state_dict))
    if "feature_extractor.conv_layers.0.conv.weight" in sd:
        mode = ("layer_norm" if "feature_extractor.conv_layers.1.layer_norm.weight" in sd
                else "group_norm")
        if mode != upstream.feature_extractor.mode:
            raise ValueError(f"the checkpoint's conv extractor is {mode!r}, the module's "
                             f"{upstream.feature_extractor.mode!r}")
    for k in sd:
        if k.startswith("encoder.layers.") and int(k.split(".")[2]) >= upstream.n_layers:
            raise ValueError(f"the checkpoint holds {k!r}; the module has "
                             f"{upstream.n_layers} layers")
    out: Dict[str, torch.Tensor] = {}
    for key, ref in upstream.state_dict().items():
        if key not in sd:
            raise KeyError(f"the checkpoint lacks {key!r}")
        value = torch.as_tensor(sd[key])
        if value.shape != ref.shape:
            raise ValueError(f"{key!r}: the checkpoint's shape {tuple(value.shape)}, "
                             f"the module's {tuple(ref.shape)}")
        out[key] = value
    return out


def unstack_layer_params(params: Mapping) -> dict:
    """fscl_tpu's scan layout (one `layers` collection whose leaves carry a
    leading n_layers axis) -> its per-layer layout (`layer_0` ..
    `layer_{n-1}`); other keys unchanged (a copy of
    `fscl_tpu/models/hubert.py:unstack_layer_params` over nested mappings
    of arrays, numpy leaves out)."""
    def leaves(tree):
        if isinstance(tree, Mapping):
            for v in tree.values():
                yield from leaves(v)
        else:
            yield tree

    def take(tree, i):
        if isinstance(tree, Mapping):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    p = {k: v for k, v in params.items() if k != "layers"}
    n = np.shape(next(leaves(params["layers"])))[0]
    for i in range(n):
        p[f"layer_{i}"] = take(params["layers"], i)
    return p
