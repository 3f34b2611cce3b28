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
(out, in, k).
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
        if name in params:
            sd[f"{name}.model.weight"] = _t(params[name]["table"]["embedding"])
    return sd


def baseline_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu BaselineSystem variables -> the port's BaselineSystem."""
    params = variables["params"]
    sd: StateDict = {f"embedding_model.tables.{name}": _t(table)
                     for name, table in params["embedding"].items()}
    model = fastspeech2_state_dict(params["model"], variables["batch_stats"]["model"])
    sd.update({f"model.{k}": v for k, v in model.items()})
    return sd
