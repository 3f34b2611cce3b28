"""Sequence-parallel frozen SSL upstream: the frame axis sharded over the
mesh (port of `fscl_tpu/parallel/sequence_parallel.py`).

Every per-frame op (layer norms, the projections, the FFN, the residuals)
runs on the rank's chunk of T' / S frames; only attention needs the other
chunks, and gets them as one all-gather of each layer's K and V: the local
queries attend to all T' keys (`attend` at Lq = T' / S, Lk = T', on the
card the attention kernel). The frame axis is padded with invalid frames
to a multiple of S, so any bucketed T' works. The layer wiring is
`models.hubert.TransformerLayer`'s, pre-LN or post-LN, through the same
submodules.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fscl_tpu_torch.models.hubert import dequant_and_cast_inputs, pre_transformer_features
from fscl_tpu_torch.ops.attention import attend
from fscl_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_gather


def _sp_layer(layer, x_loc, fv_full, group):
    """One TransformerLayer on a local frame chunk: Q from the chunk, K and
    V gathered to the full length."""
    attn = layer.attention
    B, Tl, D = x_loc.shape
    H = attn.n_heads
    dh = D // H

    def mha(h):
        kv = all_gather(torch.stack((attn.k_proj(h), attn.v_proj(h))), group, dim=2)
        Tf = kv.shape[2]
        q = attn.q_proj(h).view(B, Tl, H, dh).transpose(1, 2).contiguous()
        k, v = (t.view(B, Tf, H, dh).transpose(1, 2).contiguous() for t in kv)
        o = attend(q, k, v, key_valid=fv_full, temperature=dh ** 0.5)
        return attn.out_proj(o.transpose(1, 2).reshape(B, Tl, D))

    if layer.layer_norm_first:
        x_loc = x_loc + mha(layer.layer_norm(x_loc))
        return x_loc + layer.feed_forward(layer.final_layer_norm(x_loc))
    x_loc = layer.layer_norm(x_loc + mha(x_loc))
    return layer.final_layer_norm(x_loc + layer.feed_forward(x_loc))


@torch.no_grad()
def sequence_parallel_upstream_features(upstream, wavs: torch.Tensor,
                                        wav_valid: Optional[torch.Tensor], mesh: Mesh,
                                        axis: str = MODEL_AXIS):
    """Drop-in parallel of `models.hubert.frozen_upstream_features` with the
    layer stack sequence-parallel over `mesh[axis]`: the same (hidden
    (B, T', n_layers + 1, D) f32, frame_valid) on every rank of the axis."""
    S, s = mesh.size(axis), mesh.index(axis)
    group = mesh.group(axis)
    dtype = next(upstream.parameters()).dtype
    x, frame_valid = pre_transformer_features(
        upstream, dequant_and_cast_inputs(wavs, dtype), wav_valid)
    B, T, D = x.shape
    pad = (-T) % S
    xp = F.pad(x, (0, 0, 0, pad))
    fv = F.pad(frame_valid, (0, pad))
    Tl = (T + pad) // S
    h = xp[:, s * Tl:(s + 1) * Tl]
    ys = []
    for layer in upstream.encoder.layers:
        h = _sp_layer(layer, h, fv, group)
        ys.append(h.float())
    ys = all_gather(torch.stack(ys, dim=2), group, dim=1)[:, :T]   # (B, T', n_layers, D)
    return torch.cat([x.float()[:, :, None], ys], dim=2), frame_valid
