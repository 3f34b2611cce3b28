"""Carry weights from the JAX package to the port.

`baseline_state_dict` turns the variables of `fscl_tpu`'s BaselineSystem
(`{"params": {"embedding", "model"}, "batch_stats": {"model"}}`, as
`BaselineSystem.init_variables` returns them, leaves as numpy arrays) into a
`state_dict` that the port's BaselineSystem loads with `strict=True`.

The model's keys are the reference torch FastSpeech2 keys, so
`benchmarks/convert_reference.py:convert_fastspeech2_state_dict` maps the
result back to the same flax params: an independent second route the tests
hold this one against. Layouts: a flax Dense kernel is (in, out) where torch
keeps (out, in); a flax Conv kernel is (k, in, out) where torch keeps
(out, in, k); a flax ConvTranspose kernel under `transpose_kernel=True` is
(k, out, in) where torch's ConvTranspose1d keeps (in, out, k).

`hifigan_state_dict` and `melgan_state_dict` do the same for the JAX
vocoders' params (`{"params": ...}` as `HiFiGANGenerator.init` and
`MelGANGenerator.init` return them). Their keys are the official HiFi-GAN and
melgan-neurips keys with weight norm folded, so each package's
`convert_torch_checkpoint` is the second route for them.

The FSCL slice: `hubert_state_dict` (SSLUpstream params, per-layer layout
`layer_{i}`; scan-layout params go through `unstack_layer_params` first)
gives HF HubertModel keys, which `fscl_tpu/models/hubert.py:
convert_torch_checkpoint` reads back; `ge2e_state_dict` gives resemblyzer's
LSTM keys, which `convert_resemblyzer_checkpoint` reads back (flax keeps one
bias per gate on the hidden side: it goes to `bias_hh`, `bias_ih` is 0);
`codebook_state_dict` the codebook's; `transemb_state_dict` the whole
TransEmbSystem, the frozen upstream included when the variables hold it.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv1d(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["kernel"]).permute(2, 1, 0).contiguous()
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose1d(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["kernel"]).permute(2, 1, 0).contiguous()
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _fft_stack(sd: StateDict, prefix: str, p: Mapping) -> None:
    stack = p["stack"]
    for i in range(len(stack)):
        layer, key = stack[f"layer_{i}"], f"{prefix}.layer_stack.{i}"
        attn, ffn = layer["slf_attn"], layer["pos_ffn"]
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            _linear(sd, f"{key}.slf_attn.{name}", attn[name])
        _norm(sd, f"{key}.slf_attn.layer_norm", attn["layer_norm"])
        _conv1d(sd, f"{key}.pos_ffn.w_1", ffn["w_1"])
        _conv1d(sd, f"{key}.pos_ffn.w_2", ffn["w_2"])
        _norm(sd, f"{key}.pos_ffn.layer_norm", ffn["layer_norm"])


def _variance_predictor(sd: StateDict, prefix: str, p: Mapping) -> None:
    _conv1d(sd, f"{prefix}.conv_layer.conv1d_1.conv", p["conv1d_1"])
    _norm(sd, f"{prefix}.conv_layer.layer_norm_1", p["layer_norm_1"])
    _conv1d(sd, f"{prefix}.conv_layer.conv1d_2.conv", p["conv1d_2"])
    _norm(sd, f"{prefix}.conv_layer.layer_norm_2", p["layer_norm_2"])
    _linear(sd, f"{prefix}.linear_layer", p["linear_layer"])


def fastspeech2_state_dict(params: Mapping, batch_stats: Mapping) -> StateDict:
    """flax FastSpeech2 params + batch_stats -> the port's FastSpeech2 keys."""
    sd: StateDict = {}
    _fft_stack(sd, "encoder", params["encoder"])
    va = params["variance_adaptor"]
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _variance_predictor(sd, f"variance_adaptor.{name}", va[name])
    for name in ("pitch_embedding", "energy_embedding"):
        sd[f"variance_adaptor.{name}.weight"] = _t(va[name]["embedding"])
    _fft_stack(sd, "decoder", params["decoder"])
    _linear(sd, "mel_linear", params["mel_linear"])
    postnet, stats = params["postnet"], batch_stats["postnet"]
    for i in range(len(stats)):
        key = f"postnet.convolutions.{i}"
        _conv1d(sd, f"{key}.0.conv", postnet[f"conv_{i}"])
        _norm(sd, f"{key}.1", postnet[f"bn_{i}"])
        sd[f"{key}.1.running_mean"] = _t(stats[f"bn_{i}"]["mean"])
        sd[f"{key}.1.running_var"] = _t(stats[f"bn_{i}"]["var"])
        sd[f"{key}.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for name in ("speaker_emb", "language_emb"):
        if name in params and "table" in params[name]:
            sd[f"{name}.model.weight"] = _t(params[name]["table"]["embedding"])
    if "ge2e" in params.get("speaker_emb", {}):
        sd.update({f"speaker_emb.ge2e.{k}": v
                   for k, v in ge2e_state_dict(params["speaker_emb"]["ge2e"]).items()})
    return sd


LSTM_GATES = ("i", "f", "g", "o")     # torch's row order in weight_ih / weight_hh


def _gates(cell: Mapping, side: str, leaf: str) -> torch.Tensor:
    """A flax LSTM cell's per-gate Dense leaves (`ii`..`io` on the input
    side, `hi`..`ho` on the hidden side) stacked in torch's layout."""
    parts = [_t(cell[f"{side}{g}"][leaf]) for g in LSTM_GATES]
    return torch.cat([x.T for x in parts] if leaf == "kernel" else parts).contiguous()


def ge2e_state_dict(params: Mapping) -> StateDict:
    """flax GE2EEncoder params (`lstm_{i}` cells, `proj`) -> the port's
    GE2EEncoder (resemblyzer keys)."""
    sd: StateDict = {}
    i = 0
    while f"lstm_{i}" in params:
        cell = params[f"lstm_{i}"]
        sd[f"lstm.weight_ih_l{i}"] = _gates(cell, "i", "kernel")
        sd[f"lstm.weight_hh_l{i}"] = _gates(cell, "h", "kernel")
        sd[f"lstm.bias_hh_l{i}"] = _gates(cell, "h", "bias")
        sd[f"lstm.bias_ih_l{i}"] = torch.zeros_like(sd[f"lstm.bias_hh_l{i}"])
        i += 1
    _linear(sd, "linear", params["proj"])
    return sd


def codebook_state_dict(params: Mapping) -> StateDict:
    """flax SoftMultiAttCodebook(2) params -> the port's codebook."""
    sd: StateDict = {name: _t(params[name]) for name in ("weight_raw", "emb_banks", "att_banks")
                     if name in params}
    if "q_linear" in params:
        _linear(sd, "q_linear", params["q_linear"])
    return sd


def hubert_state_dict(variables: Mapping) -> StateDict:
    """flax SSLUpstream params (or `{"params": ...}`) in the per-layer
    layout -> the port's SSLUpstream (HF HubertModel keys)."""
    p = variables.get("params", variables)
    if "layers" in p:
        raise ValueError("scan-layout params: unstack them (hubert.unstack_layer_params)")
    fe = p["feature_extractor"]
    sd: StateDict = {}
    i = 0
    while f"conv_{i}" in fe:
        key = f"feature_extractor.conv_layers.{i}"
        sd[f"{key}.conv.weight"] = _t(fe[f"conv_{i}"]["kernel"]).permute(2, 1, 0).contiguous()
        if "bias" in fe[f"conv_{i}"]:
            sd[f"{key}.conv.bias"] = _t(fe[f"conv_{i}"]["bias"])
        norm = fe.get(f"conv_ln_{i}", fe.get("group_norm") if i == 0 else None)
        if norm is not None:
            _norm(sd, f"{key}.layer_norm", norm)
        i += 1
    _norm(sd, "feature_projection.layer_norm", p["feat_layer_norm"])
    _linear(sd, "feature_projection.projection", p["post_extract_proj"])
    _conv1d(sd, "encoder.pos_conv_embed.conv", p["pos_conv"]["conv"])
    if "encoder_layer_norm" in p:
        _norm(sd, "encoder.layer_norm", p["encoder_layer_norm"])
    i = 0
    while f"layer_{i}" in p:
        layer, key = p[f"layer_{i}"], f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{key}.attention.{name}", layer[name])
        _linear(sd, f"{key}.feed_forward.intermediate_dense", layer["fc1"])
        _linear(sd, f"{key}.feed_forward.output_dense", layer["fc2"])
        _norm(sd, f"{key}.layer_norm", layer["self_attn_layer_norm"])
        _norm(sd, f"{key}.final_layer_norm", layer["final_layer_norm"])
        i += 1
    return sd


def transemb_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu TransEmbSystem variables (`{"params": {"codebook", "model"},
    "batch_stats": {"model"}, "frozen": {"upstream"}}`) -> the port's
    TransEmbSystem; the `upstream.` keys only when `frozen` is there."""
    params = variables["params"]
    sd = {f"codebook.{k}": v for k, v in codebook_state_dict(params["codebook"]).items()}
    model = fastspeech2_state_dict(params["model"], variables["batch_stats"]["model"])
    sd.update({f"model.{k}": v for k, v in model.items()})
    if variables.get("frozen") is not None:
        up = hubert_state_dict(variables["frozen"]["upstream"])
        sd.update({f"upstream.{k}": v for k, v in up.items()})
    return sd


def baseline_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu BaselineSystem variables -> the port's BaselineSystem."""
    params = variables["params"]
    sd: StateDict = {f"embedding_model.tables.{name}": _t(table)
                     for name, table in params["embedding"].items()}
    model = fastspeech2_state_dict(params["model"], variables["batch_stats"]["model"])
    sd.update({f"model.{k}": v for k, v in model.items()})
    return sd


def _count(params: Mapping, prefix: str) -> int:
    return sum(1 for k in params if k.startswith(prefix))


def hifigan_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu HiFiGANGenerator variables -> the port's HiFiGANGenerator."""
    p = variables["params"]
    n_ups = _count(p, "ups_")
    n_res = _count(p, "resblock_0_")
    sd: StateDict = {}
    _conv1d(sd, "conv_pre", p["conv_pre"])
    for i in range(n_ups):
        _conv_transpose1d(sd, f"ups.{i}", p[f"ups_{i}"])
        for j in range(n_res):
            rb, key = p[f"resblock_{i}_{j}"], f"resblocks.{i * n_res + j}"
            for c in range(_count(rb, "convs1_")):
                _conv1d(sd, f"{key}.convs1.{c}", rb[f"convs1_{c}"])
                _conv1d(sd, f"{key}.convs2.{c}", rb[f"convs2_{c}"])
    _conv1d(sd, "conv_post", p["conv_post"])
    return sd


def melgan_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu MelGANGenerator variables -> the port's MelGANGenerator,
    whose `model.{i}` indices are melgan-neurips' nn.Sequential."""
    p = variables["params"]
    n_ups = _count(p, "ups_")
    n_res = _count(p, "res_0_")
    sd: StateDict = {}
    _conv1d(sd, "model.1", p["conv_pre"])
    for i in range(n_ups):
        base = 2 + i * (2 + n_res)          # LeakyReLU, ConvTranspose1d, resblocks
        _conv_transpose1d(sd, f"model.{base + 1}", p[f"ups_{i}"])
        for j in range(n_res):
            rb, key = p[f"res_{i}_{j}"], f"model.{base + 2 + j}"
            _conv1d(sd, f"{key}.block.2", rb["conv_dil"])
            _conv1d(sd, f"{key}.block.4", rb["conv_1x1"])
            _conv1d(sd, f"{key}.shortcut", rb["shortcut"])
    _conv1d(sd, f"model.{2 + n_ups * (2 + n_res) + 2}", p["conv_post"])
    return sd
