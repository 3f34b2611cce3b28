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
`layer_{i}` or the scan layout's stacked `layers`, which the port's
`models/hubert.py:unstack_layer_params` splits) gives HF HubertModel keys, which `fscl_tpu/models/hubert.py:
convert_torch_checkpoint` reads back; `ge2e_state_dict` gives resemblyzer's
LSTM keys, which `convert_resemblyzer_checkpoint` reads back (flax keeps one
bias per gate on the hidden side: it goes to `bias_hh`, `bias_ih` is 0);
`codebook_state_dict` the codebook's; `transemb_state_dict` the whole
TransEmbSystem, the frozen upstream included when the variables hold it.
The meta-learning variants: the ADA encoder (`ada_state_dict`, under `ada.`)
and semi-FSCL's `unsup_embed` ride in `transemb_state_dict`;
`conti_ae_state_dict` gives ContiAE's `embed`, its decoder half
(`mel_decoder_state_dict`, FastSpeech2's decoder, mel_linear and PostNet)
and its upstream.

The T2U family (`tacot2u_entries`, `downstream_entries`, `da_entries`,
`t2u_entries`) is written as tables of (torch key, flax path, layout) read in
both directions: `state_dict_from` / `t2u_state_dict` carry fscl_tpu's
variables to the port, `variables_from` / `t2u_variables` carry the port's
state dict back to fscl_tpu's params and batch_stats. The PR family
(`pr_entries`, `pr_state_dict`, `pr_variables`) uses the same tables: its
heads are `head-<symbol_id>` on both sides (a Dense, or a cluster-centre
array), and `BiLSTMDownstream`'s four flax cells, named by creation order,
map to the port's `lstm_fwd.{0,1}` / `lstm_bwd.{0,1}`. The mel Tacotron2
(`tacotron2_entries`, `tacotron2_state_dict`, `tacotron2_variables`) too.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from fscl_tpu_torch.models.hubert import unstack_layer_params

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
    sd.update(mel_decoder_state_dict(params, batch_stats))
    for name in ("speaker_emb", "language_emb"):
        if name in params and "table" in params[name]:
            sd[f"{name}.model.weight"] = _t(params[name]["table"]["embedding"])
    if "ge2e" in params.get("speaker_emb", {}):
        sd.update({f"speaker_emb.ge2e.{k}": v
                   for k, v in ge2e_state_dict(params["speaker_emb"]["ge2e"]).items()})
    return sd


def mel_decoder_state_dict(params: Mapping, batch_stats: Mapping) -> StateDict:
    """FastSpeech2's decoder half (`decoder`, `mel_linear`, `postnet` with
    its BatchNorm statistics) -> the port's names, as
    `systems/conti_ae.py:MelDecoder` and `FastSpeech2` hold them."""
    sd: StateDict = {}
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
    """flax SSLUpstream params (or `{"params": ...}`), per-layer or in the
    scan layout (`scan_layers=True`) -> the port's SSLUpstream (HF
    HubertModel keys)."""
    p = variables.get("params", variables)
    if "layers" in p:
        p = unstack_layer_params(p)
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


def ada_state_dict(params: Mapping) -> StateDict:
    """flax ADAEncoder params (`params["ada"]`: `embed`, `encoder`) -> the
    port's ADAEncoder."""
    sd: StateDict = {}
    _linear(sd, "embed", params["embed"])
    _fft_stack(sd, "encoder", params["encoder"])
    return sd


def _upstream(sd: StateDict, variables: Mapping) -> None:
    if variables.get("frozen") is not None:
        up = hubert_state_dict(variables["frozen"]["upstream"])
        sd.update({f"upstream.{k}": v for k, v in up.items()})


def transemb_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu TransEmbSystem variables (`{"params": {"codebook", "model"},
    "batch_stats": {"model"}, "frozen": {"upstream"}}`) -> the port's
    TransEmbSystem; the `upstream.` keys only when `frozen` is there. The
    ADA systems' `params["ada"]` goes to `ada.`, semi-FSCL's
    `params["unsup_embed"]` to `unsup_embed.`."""
    params = variables["params"]
    sd = {f"codebook.{k}": v for k, v in codebook_state_dict(params["codebook"]).items()}
    model = fastspeech2_state_dict(params["model"], variables["batch_stats"]["model"])
    sd.update({f"model.{k}": v for k, v in model.items()})
    if "ada" in params:
        sd.update({f"ada.{k}": v for k, v in ada_state_dict(params["ada"]).items()})
    if "unsup_embed" in params:
        _linear(sd, "unsup_embed", params["unsup_embed"])
    _upstream(sd, variables)
    return sd


def conti_ae_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu ContiAESystem variables (`{"params": {"embed", "model"},
    "batch_stats": {"model"}, "frozen": {"upstream"}}`, the model holding
    FastSpeech2's decoder half) -> the port's ContiAESystem."""
    params = variables["params"]
    sd: StateDict = {}
    _linear(sd, "embed", params["embed"])
    model = mel_decoder_state_dict(params["model"], variables["batch_stats"]["model"])
    sd.update({f"model.{k}": v for k, v in model.items()})
    _upstream(sd, variables)
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


# --- the T2U family: one table of (torch key, flax path, layout) per module,
# read in both directions -----------------------------------------------------
# A flax path starts at the variables' collection ("params" or
# "batch_stats"). Layouts: "dense" (flax (in, out) <-> torch (out, in)),
# "conv" ((k, in, out) <-> (out, in, k)), "plain" (same array), "gates_i" /
# "gates_h" (a flax LSTM cell's four per-gate kernels <-> torch's stacked
# weight_ih / weight_hh), "gates_b" (the hidden-side biases <-> bias_hh),
# "zero" (torch's bias_ih, 0 and frozen: no flax leaf), "count" (BatchNorm's
# num_batches_tracked: no flax leaf).
Entry = Tuple[str, Tuple[str, ...], str]


def _get(tree: Mapping, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _to_torch(layout: str, x) -> torch.Tensor:
    if layout == "dense":
        return _t(x).T.contiguous()
    if layout == "conv":
        return _t(x).permute(2, 1, 0).contiguous()
    if layout in ("gates_i", "gates_h", "gates_b"):
        return _gates(x, layout[-1] if layout != "gates_b" else "h",
                      "bias" if layout == "gates_b" else "kernel")
    return _t(x)


def _to_flax(layout: str, w: torch.Tensor, tree: dict, path: Tuple[str, ...]) -> None:
    a = w.detach().cpu().float().numpy()
    if layout == "dense":
        _set(tree, path, np.ascontiguousarray(a.T))
    elif layout == "conv":
        _set(tree, path, np.ascontiguousarray(a.transpose(2, 1, 0)))
    elif layout in ("gates_i", "gates_h", "gates_b"):
        side = "h" if layout == "gates_b" else layout[-1]
        leaf = "bias" if layout == "gates_b" else "kernel"
        for g, part in zip(LSTM_GATES, np.split(a, 4, axis=0)):
            _set(tree, path + (f"{side}{g}", leaf),
                 np.ascontiguousarray(part.T if leaf == "kernel" else part))
    elif layout == "plain":
        _set(tree, path, a)


def _lstm_entries(torch_prefix: str, path: Tuple[str, ...], suffix: str = "") -> List[Entry]:
    return [(f"{torch_prefix}.weight_ih{suffix}", path, "gates_i"),
            (f"{torch_prefix}.weight_hh{suffix}", path, "gates_h"),
            (f"{torch_prefix}.bias_hh{suffix}", path, "gates_b"),
            (f"{torch_prefix}.bias_ih{suffix}", path, "zero")]


def _linear_entries(torch_prefix: str, path: Tuple[str, ...], bias: bool = True) -> List[Entry]:
    out = [(f"{torch_prefix}.weight", path + ("kernel",), "dense")]
    if bias:
        out.append((f"{torch_prefix}.bias", path + ("bias",), "plain"))
    return out


def _norm_entries(torch_prefix: str, path: Tuple[str, ...]) -> List[Entry]:
    return [(f"{torch_prefix}.weight", path + ("scale",), "plain"),
            (f"{torch_prefix}.bias", path + ("bias",), "plain")]


def tacot2u_entries(n_conv: int = 3) -> List[Entry]:
    """flax TacoT2U (`params`, `batch_stats`) <-> the port's TacoT2U."""
    P, S = ("params",), ("batch_stats",)
    e: List[Entry] = []
    for i in range(n_conv):
        e += [(f"encoder.convs.{i}.weight", P + ("encoder", f"conv_{i}", "kernel"), "conv"),
              (f"encoder.convs.{i}.bias", P + ("encoder", f"conv_{i}", "bias"), "plain")]
        e += _norm_entries(f"encoder.norms.{i}", P + ("encoder", f"bn_{i}"))
        e += [(f"encoder.norms.{i}.running_mean", S + ("encoder", f"bn_{i}", "mean"), "plain"),
              (f"encoder.norms.{i}.running_var", S + ("encoder", f"bn_{i}", "var"), "plain"),
              (f"encoder.norms.{i}.num_batches_tracked", (), "count")]
    # flax names the BiLSTM's cells by creation order: forward first
    e += _lstm_entries("encoder.lstm_fwd", P + ("encoder", "OptimizedLSTMCell_0"), "_l0")
    e += _lstm_entries("encoder.lstm_bwd", P + ("encoder", "OptimizedLSTMCell_1"), "_l0")
    e.append(("unit_embedding.weight", P + ("unit_embedding", "embedding"), "plain"))
    for i in range(2):
        e += _linear_entries(f"prenet.layers.{i}", P + ("prenet", f"fc_{i}"), bias=False)
    cell = P + ("decoder_cell",)
    e += _lstm_entries("decoder_cell.attention_rnn", cell + ("attention_rnn",))
    att = cell + ("attention_layer",)
    e += _linear_entries("decoder_cell.attention_layer.query_layer", att + ("query_layer",),
                         bias=False)
    e.append(("decoder_cell.attention_layer.location_conv.weight",
              att + ("location_conv", "kernel"), "conv"))
    e += _linear_entries("decoder_cell.attention_layer.location_dense",
                         att + ("location_dense",), bias=False)
    e += _linear_entries("decoder_cell.attention_layer.v", att + ("v",), bias=False)
    e += _lstm_entries("decoder_cell.decoder_rnn", cell + ("decoder_rnn",))
    e += _linear_entries("decoder_cell.linear_projection", cell + ("linear_projection",))
    e += _linear_entries("decoder_cell.final_proj", cell + ("final_proj",))
    e += _linear_entries("memory_layer", P + ("memory_layer",), bias=False)
    return e


def tacotron2_entries(n_conv: int = 3, n_postnet: int = 5) -> List[Entry]:
    """flax mel Tacotron2 (`params`, `batch_stats`) <-> the port's: the T2U
    encoder's entries, the prenet, the two cells, the attention, the
    projections and FastSpeech2's PostNet."""
    P, S = ("params",), ("batch_stats",)
    e = [x for x in tacot2u_entries(n_conv) if x[0].startswith("encoder.")]
    for i in range(2):
        e += _linear_entries(f"prenet.layers.{i}", P + ("prenet", f"fc_{i}"), bias=False)
    e += _linear_entries("memory_layer", P + ("memory_layer",), bias=False)
    e += _lstm_entries("attention_rnn", P + ("attention_rnn",))
    att = P + ("attention_layer",)
    e += _linear_entries("attention_layer.query_layer", att + ("query_layer",), bias=False)
    e.append(("attention_layer.location_conv.weight", att + ("location_conv", "kernel"), "conv"))
    e += _linear_entries("attention_layer.location_dense", att + ("location_dense",), bias=False)
    e += _linear_entries("attention_layer.v", att + ("v",), bias=False)
    e += _lstm_entries("decoder_rnn", P + ("decoder_rnn",))
    e += _linear_entries("linear_projection", P + ("linear_projection",))
    e += _linear_entries("gate_layer", P + ("gate_layer",))
    for i in range(n_postnet):
        key = f"postnet.convolutions.{i}"
        e += [(f"{key}.0.conv.weight", P + ("postnet", f"conv_{i}", "kernel"), "conv"),
              (f"{key}.0.conv.bias", P + ("postnet", f"conv_{i}", "bias"), "plain")]
        e += _norm_entries(f"{key}.1", P + ("postnet", f"bn_{i}"))
        e += [(f"{key}.1.running_mean", S + ("postnet", f"bn_{i}", "mean"), "plain"),
              (f"{key}.1.running_var", S + ("postnet", f"bn_{i}", "var"), "plain"),
              (f"{key}.1.num_batches_tracked", (), "count")]
    return e


def tacotron2_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu Tacotron2 variables -> the port's Tacotron2 (strict keys)."""
    return state_dict_from(tacotron2_entries(), variables)


def tacotron2_variables(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's Tacotron2 state dict -> fscl_tpu variables."""
    return variables_from(tacotron2_entries(), sd)


def _block_entries(prefix: str, path: Tuple[str, ...], names) -> List[Entry]:
    e: List[Entry] = []
    for name in names:
        e += _linear_entries(f"{prefix}.{name}", path + (name,))
    return e + _norm_entries(f"{prefix}.ln1", path + ("ln1",)) \
        + _norm_entries(f"{prefix}.ln2", path + ("ln2",))


def downstream_entries(n_blocks: int, codeformer: bool) -> List[Entry]:
    """flax Downstream1 (n_blocks EncoderBlocks) or Downstream2 (n_blocks
    EncoderBlocks + the codeformer) <-> the port's."""
    P = ("params",)
    e: List[Entry] = [("weighted_sum.weight_raw", P + ("weighted_sum", "weight_raw"), "plain")]
    e += _linear_entries("proj", P + ("proj",))
    for i in range(n_blocks):
        e += _block_entries(f"layers.{i}", P + (f"layer_{i}",),
                            ("q", "k", "v", "out", "ff1", "ff2"))
    if codeformer:
        e.append(("codeformer.codebook", P + ("codeformer", "codebook"), "plain"))
        e += _block_entries("codeformer", P + ("codeformer",), ("q", "out", "ff1", "ff2"))
    return e


def da_entries(n_layers: int = 3) -> List[Entry]:
    """flax DA (gradient reversal + UnitDiscriminator) <-> the port's."""
    P = ("params", "discriminator")
    e: List[Entry] = []
    for i in range(n_layers - 1):
        e += [(f"discriminator.convs.{i}.weight", P + (f"conv_{i}", "kernel"), "conv"),
              (f"discriminator.convs.{i}.bias", P + (f"conv_{i}", "bias"), "plain")]
    return e + [("discriminator.conv_out.weight", P + ("conv_out", "kernel"), "conv"),
                ("discriminator.conv_out.bias", P + ("conv_out", "bias"), "plain")]


def _sub(entries: List[Entry], torch_prefix: str, flax_sub: str) -> List[Entry]:
    """Entries of a submodule: torch keys under `torch_prefix.`, flax paths
    under each collection's `flax_sub`."""
    return [(f"{torch_prefix}.{k}", (p[0], flax_sub) + p[1:] if p else p, layout)
            for k, p, layout in entries]


def state_dict_from(entries: List[Entry], variables: Mapping) -> StateDict:
    """flax variables -> torch state dict, by `entries`."""
    sd: StateDict = {}
    for key, path, layout in entries:
        if layout == "count":
            sd[key] = torch.tensor(0, dtype=torch.long)
        elif layout == "zero":
            sd[key] = torch.zeros_like(sd[key.replace("bias_ih", "bias_hh")])
        else:
            sd[key] = _to_torch(layout, _get(variables, path))
    return sd


def variables_from(entries: List[Entry], sd: Mapping[str, torch.Tensor]) -> dict:
    """torch state dict -> flax variables (numpy leaves), by `entries`."""
    tree: dict = {}
    for key, path, layout in entries:
        if layout not in ("count", "zero"):
            _to_flax(layout, sd[key], tree, path)
    return tree


def t2u_entries(variables_or_keys) -> List[Entry]:
    """The entries of a T2U system's parameter tree (TacoT2USystem and its
    tune/E2E/DA subclasses: `embedding` + `model` [+ `da`]; the FSCL-T2U
    systems: `embedding_generator` + `model` [+ `codebook_attention`]),
    read from flax variables or from the keys of a torch state dict. The
    frozen upstream and u2s are not part of it (`hubert_state_dict` and
    `baseline_state_dict` carry them)."""
    if isinstance(variables_or_keys, Mapping) and "params" in variables_or_keys:
        p = variables_or_keys["params"]
        n_conv = sum(1 for k in p["model"]["encoder"] if k.startswith("conv_"))
        tables = list(p.get("embedding", {}))
        gen = p.get("embedding_generator")
        n_blocks = 0 if gen is None else sum(1 for k in gen if k.startswith("layer_"))
        codeformer = gen is not None and "codeformer" in gen
        has = lambda name: name in p
    else:
        keys = list(variables_or_keys)
        n_conv = len({k for k in keys if k.startswith("model.encoder.convs.")
                      and k.endswith(".weight")})
        tables = [k.split(".", 2)[2] for k in keys if k.startswith("embedding_model.tables.")]
        n_blocks = len({k.split(".")[2] for k in keys
                        if k.startswith("embedding_generator.layers.")})
        codeformer = any(k.startswith("embedding_generator.codeformer.") for k in keys)
        prefixes = {k.split(".")[0] for k in keys}
        has = prefixes.__contains__
    e = _sub(tacot2u_entries(n_conv), "model", "model")
    e += [(f"embedding_model.tables.{name}", ("params", "embedding", name), "plain")
          for name in tables]
    if has("embedding_generator"):
        e += _sub(downstream_entries(n_blocks, codeformer), "embedding_generator",
                  "embedding_generator")
    if has("codebook_attention"):
        e += [(f"codebook_attention.{name}", ("params", "codebook_attention", name), "plain")
              for name in ("emb_banks", "att_banks")]
    if has("da"):
        e += _sub(da_entries(), "da", "da")
    return e


def t2u_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu T2U system variables -> the port's system (strict keys but
    for the frozen upstream: `transemb_state_dict`'s `upstream.` keys come
    from `hubert_state_dict` when `frozen` holds it)."""
    sd = state_dict_from(t2u_entries(variables), variables)
    if (variables.get("frozen") or {}).get("upstream") is not None:
        up = hubert_state_dict(variables["frozen"]["upstream"])
        sd.update({f"upstream.{k}": v for k, v in up.items()})
    return sd


def t2u_variables(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's T2U system state dict -> fscl_tpu variables
    (`params` and `batch_stats`; the frozen upstream is left out)."""
    sd = {k: v for k, v in sd.items() if not k.startswith(("upstream.", "u2s_system."))}
    return variables_from(t2u_entries(sd.keys()), sd)


def bilstm_downstream_entries() -> List[Entry]:
    """flax BiLSTMDownstream <-> the port's: the cells in creation order
    (layer 0 forward, layer 0 backward, layer 1 forward, layer 1 backward)."""
    P = ("params",)
    e: List[Entry] = [("weighted_sum.weight_raw", P + ("weighted_sum", "weight_raw"), "plain")]
    e += _linear_entries("proj", P + ("proj",))
    for layer in range(2):
        for j, side in enumerate(("fwd", "bwd")):
            e += _lstm_entries(f"lstm_{side}.{layer}",
                               P + (f"OptimizedLSTMCell_{2 * layer + j}",), "_l0")
    return e


def pr_entries(variables_or_keys) -> List[Entry]:
    """The entries of a PR system's parameter tree (`downstream` + `head`, or
    `downstream` + `head_generator` + `trans_head_bias` for TransHead), read
    off flax variables or the keys of a torch state dict. The frozen upstream
    is not part of it (`hubert_state_dict` carries it)."""
    if isinstance(variables_or_keys, Mapping) and "params" in variables_or_keys:
        p = variables_or_keys["params"]
        ds = p["downstream"]
        kind = ("bilstm" if "OptimizedLSTMCell_0" in ds
                else "d1" if "layer_0" in ds else "linear")
        n_blocks = sum(1 for k in ds if k.startswith("layer_"))
        heads = {sid: ("cluster" if not isinstance(h, Mapping) else "dense")
                 for sid, h in ((k[len("head-"):], v) for k, v in p.get("head", {}).items())}
        has = p.__contains__
    else:
        keys = list(variables_or_keys)
        kind = ("bilstm" if any(k.startswith("downstream.lstm_fwd.") for k in keys)
                else "d1" if any(k.startswith("downstream.layers.") for k in keys)
                else "linear")
        n_blocks = len({k.split(".")[2] for k in keys if k.startswith("downstream.layers.")})
        heads = {}
        for k in keys:
            if k.startswith("head.heads.head-"):
                heads[k.split(".")[2][len("head-"):]] = "dense"
            elif k.startswith("head.centers.head-"):
                heads[k.split(".")[2][len("head-"):]] = "cluster"
        has = {k.split(".")[0] for k in keys}.__contains__
    if kind == "bilstm":
        ds_entries = bilstm_downstream_entries()
    elif kind == "d1":
        ds_entries = downstream_entries(n_blocks, False)
    else:
        ds_entries = [("weighted_sum.weight_raw", ("params", "weighted_sum", "weight_raw"),
                       "plain")] + _linear_entries("proj", ("params", "proj"))
    e = _sub(ds_entries, "downstream", "downstream")
    for sid, head in heads.items():
        if head == "dense":
            e += _linear_entries(f"head.heads.head-{sid}", ("params", "head", f"head-{sid}"))
        else:
            e.append((f"head.centers.head-{sid}", ("params", "head", f"head-{sid}"), "plain"))
    if has("head_generator"):
        g = ("params", "head_generator")
        e += [("head_generator.weighted_sum.weight_raw", g + ("weighted_sum", "weight_raw"),
               "plain")]
        e += [(f"head_generator.codebook.{name}", g + ("codebook", name), "plain")
              for name in ("emb_banks", "att_banks")]
        e.append(("trans_head_bias", ("params", "trans_head_bias"), "plain"))
    return e


def pr_state_dict(variables: Mapping) -> StateDict:
    """fscl_tpu PR system variables -> the port's system state dict (the
    frozen upstream's `upstream.` keys too when `frozen` holds it)."""
    sd = state_dict_from(pr_entries(variables), variables)
    if (variables.get("frozen") or {}).get("upstream") is not None:
        up = hubert_state_dict(variables["frozen"]["upstream"])
        sd.update({f"upstream.{k}": v for k, v in up.items()})
    return sd


def pr_variables(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's PR system state dict -> fscl_tpu `params` (the frozen
    upstream is left out)."""
    sd = {k: v for k, v in sd.items() if not k.startswith("upstream.")}
    return variables_from(pr_entries(sd.keys()), sd)


def tp_shard_state_dict(sd: Mapping[str, torch.Tensor], n_model: int, index: int,
                        spec_fn=None) -> Dict[str, torch.Tensor]:
    """Model rank `index` of `n_model`'s tensor-parallel shard of a converted
    state dict, cut by `spec_fn` (`parallel.tensor_parallel.
    fastspeech2_param_spec` by default; `frozen_spec` or `upstream_param_spec`
    for an upstream's keys): what `tensor_parallel.shard_state` leaves a rank
    of a system loaded with `sd`."""
    from fscl_tpu_torch.parallel.tensor_parallel import fastspeech2_param_spec, shard_tensor
    spec_fn = spec_fn or fastspeech2_param_spec
    return {k: shard_tensor(v, spec_fn(k, v), n_model, index) for k, v in sd.items()}


def stage_state_dict(sd: Mapping[str, torch.Tensor], n_layers: int, n_stages: int,
                     stage: int, prefix: str = "encoder.layers.") -> Dict[str, torch.Tensor]:
    """Pipeline stage `stage` of `n_stages`'s part of an upstream's state
    dict (HF keys, `hubert_state_dict`): its n_layers / n_stages contiguous
    layers and the pre-transformer weights every stage runs; the other
    stages' layers are left out."""
    per = n_layers // n_stages
    keep = range(stage * per, (stage + 1) * per)
    out = {}
    for k, v in sd.items():
        if k.startswith(prefix) and int(k[len(prefix):].split(".")[0]) not in keep:
            continue
        out[k] = v
    return out
