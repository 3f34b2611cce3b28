"""Released SSL checkpoint layouts written from a state dict under HF
HubertModel keys (the port's `models/hubert.py:SSLUpstream` keys), for the
CPU tests and `chip_smoke.py`. Imports torch only, no JAX.

`weight_normed` stores the positional conv as weight norm on dim 2 (HF's
`weight_g` / `weight_v`, or torch's `parametrizations.weight.original0/1`);
`fairseq_keys` renames to fairseq's keys; `layout(name, sd)` gives each of
LAYOUTS.
"""
import numpy as np
import torch

POS = "encoder.pos_conv_embed.conv"
LAYOUTS = ("hf", "hf_weight_g", "hf_parametrizations", "fairseq_keys", "fairseq_container",
           "s3prl_container", "w2v_model_prefix", "hf_state_dict_container")


def weight_normed(sd, seed=1, parametrizations=False):
    """The positional conv as weight norm on dim 2: v the weight scaled by a
    factor per kernel tap drawn from `seed`, g (1, 1, k) the weight's norm
    over dims (0, 1). On the tensors' device."""
    rng = np.random.default_rng(seed)
    sd = dict(sd)
    w = sd.pop(f"{POS}.weight")
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, (1, 1, w.shape[2])).astype(np.float32))
    v = w * scale.to(w.device)
    g = torch.linalg.vector_norm(w.double(), dim=(0, 1), keepdim=True).float()
    if parametrizations:
        sd[f"{POS}.parametrizations.weight.original0"] = g
        sd[f"{POS}.parametrizations.weight.original1"] = v
    else:
        sd[f"{POS}.weight_g"], sd[f"{POS}.weight_v"] = g, v
    return sd


def fairseq_keys(sd):
    """An HF-keyed state dict under fairseq's names (conv blocks by
    Sequential index, `post_extract_proj`, `self_attn`, `fc1` / `fc2`,
    `encoder.pos_conv.0`), with extras fairseq files carry and no loader
    needs (`mask_emb`, `label_embs_concat`, `final_proj`)."""
    layer_mode = "feature_extractor.conv_layers.1.layer_norm.weight" in sd
    dim = sd["feature_projection.projection.weight"].shape[0]
    device = sd["feature_projection.projection.weight"].device
    out = {}
    for k, v in sd.items():
        nk = k
        if k.startswith("feature_extractor.conv_layers."):
            _, _, i, what, leaf = k.split(".")
            mid = "0" if what == "conv" else ("2.1" if layer_mode else "2")
            nk = f"feature_extractor.conv_layers.{i}.{mid}.{leaf}"
        elif k.startswith("feature_projection.layer_norm."):
            nk = k[len("feature_projection."):]
        elif k.startswith("feature_projection.projection."):
            nk = "post_extract_proj." + k.split(".")[-1]
        elif k.startswith(POS + "."):
            nk = "encoder.pos_conv.0." + k[len(POS) + 1:]
        elif k.startswith("encoder.layers."):
            _, _, i, sub = k.split(".", 3)
            sub = ("self_attn_layer_norm." + sub[len("layer_norm."):]
                   if sub.startswith("layer_norm.") else
                   sub.replace("attention.", "self_attn.")
                   .replace("feed_forward.intermediate_dense.", "fc1.")
                   .replace("feed_forward.output_dense.", "fc2."))
            nk = f"encoder.layers.{i}.{sub}"
        out[nk] = v
    out["mask_emb"] = torch.zeros(dim, device=device)
    out["label_embs_concat"] = torch.zeros(4, 8, device=device)
    out["final_proj.weight"] = torch.zeros(8, dim, device=device)
    return out


def layout(name, sd):
    """`sd` written in the layout `name` (one of LAYOUTS)."""
    dim = sd["feature_projection.projection.weight"].shape[0]
    device = sd["feature_projection.projection.weight"].device
    if name == "hf":
        return sd
    if name == "hf_weight_g":
        return {**weight_normed(sd), "masked_spec_embed": torch.zeros(dim, device=device)}
    if name == "hf_parametrizations":
        return weight_normed(sd, parametrizations=True)
    if name == "hf_state_dict_container":
        return {"state_dict": {**sd, "quantizer.codevectors": torch.zeros(1, 4, 8)}}
    fairseq = fairseq_keys(weight_normed(sd))
    if name == "fairseq_keys":
        return fairseq
    if name == "fairseq_container":
        return {"model": fairseq, "cfg": {"model": {"_name": "hubert"}}}
    if name == "s3prl_container":
        return {"model_weight": fairseq}
    if name == "w2v_model_prefix":
        return {f"w2v_model.{k}": v for k, v in fairseq.items()}
    raise ValueError(f"layout {name!r}")
