"""Mixed-precision helpers (port of `fscl_tpu/train/precision.py`).

`cast_params_bf16` casts a module's floating parameters to bf16 except the
normalisation layers' (kept in f32 for numerical stability); the optimizer's
master copy stays f32 wherever it lives. `cast_floating` casts every
floating tensor of a nested structure.

The JAX package picks the norm leaves by their flax path (`_is_norm_path`,
`:18-22`): a path containing `layer_norm`, or a key `bn_*`, `ln1` or `ln2`.
The port's parameters carry the reference torch names, where a BatchNorm is
`postnet.convolutions.{i}.1` or `encoder.norms.{i}`, so it picks them by the
module that owns them: a LayerNorm, a BatchNorm or a GroupNorm. One
exception keeps the two sets equal: HuBERT's feature-extractor norms are
`conv_ln_{i}` / `group_norm` in flax, which the JAX predicate does not
match, so they are cast there, and here too (`is_norm_parameter`).
"""
from __future__ import annotations

from typing import Any, Dict, Set

import torch
from torch import nn

_NORMS = (nn.LayerNorm, nn.modules.batchnorm._BatchNorm, nn.GroupNorm)


def norm_parameter_names(module: nn.Module) -> Set[str]:
    """Names (as `named_parameters` gives them) of the parameters that
    `cast_params_bf16` keeps in f32."""
    from fscl_tpu_torch.models.hubert import ConvFeatureExtractor

    extractors = [name for name, m in module.named_modules()
                  if isinstance(m, ConvFeatureExtractor)]
    keep: Set[str] = set()
    for name, m in module.named_modules():
        if not isinstance(m, _NORMS) or any(
                e == "" or name.startswith(e + ".") for e in extractors):
            continue
        prefix = f"{name}." if name else ""
        keep.update(prefix + p for p, _ in m.named_parameters(recurse=False))
    return keep


def cast_params_bf16(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the module's parameters, floating ones cast to bf16
    except the norm layers' (`norm_parameter_names`); others untouched."""
    keep = norm_parameter_names(module)
    return {name: (p if name in keep or not p.is_floating_point()
                   else p.to(torch.bfloat16))
            for name, p in module.named_parameters()}


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of a nested dict / list / tuple (named tuples
    included) cast to `dtype`; anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, cast_floating(v, dtype)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_floating(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree
