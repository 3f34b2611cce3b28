"""System factory: algorithm type + configs -> a built system (port of
`fscl_tpu/systems/factory.py:build_system`, `:32`).

Bridges the registry and the T2U and PR systems' constructors, so that the
CLI's generic path builds a T2U or PR key from (model config, optimizer
config, data configs); a PR system takes the data configs' id2symbols
(fscl_tpu's `:85-86`). The other ported keys raise `ValueError` here:
`train` builds baseline and FSCL on its main path
(`cli/train_cmd.py:_main_path`) and `tune` fscl-tune and fscl-orig-tune.
Keys the port does not have yet raise `NotImplementedError` from the
registry, naming their ROADMAP item; a key fscl_tpu registers nowhere
(`pr-ssl-codebook-cluster`, named by
config/algorithm/phoneme_recognition/ssl-codebook-cluster.yaml) raises
KeyError, as in fscl_tpu.

Two faults of fscl_tpu's factory are kept, and pinned by
tests/test_torch_t2u_data.py (ROADMAP Queue 3): the T2U keys take
`T2UConfig`'s defaults unless `t2u_cfg` is passed (fscl_tpu's `train` never
passes it, so a model YAML's `tacotron2:` block is not read), and the E2E
keys raise unless a loaded u2s comes in `u2s_system` (`train` passes none).
"""
from __future__ import annotations

from typing import Optional, Sequence

from fscl_tpu_torch.core.config import AlgorithmConfig, DataConfig, ModelConfig, OptimConfig
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.data.datamodules import build_id2symbols
from fscl_tpu_torch.frontend import n_symbols
from fscl_tpu_torch.models.tacotron2_t2u import T2UConfig

_TACOT2U_KEYS = ("tacot2u", "fscl-t2u-tune", "fscl-t2u-orig-tune", "fscl-t2u-da-tune")


def _n_units(data_configs: Sequence[DataConfig]) -> int:
    for dc in data_configs:
        if dc.unit_name:
            return n_symbols(dc.unit_name)
    raise ValueError("no data config carries a unit target")


def build_system(
    algorithm_type: str,
    model_cfg: ModelConfig,
    optim_cfg: OptimConfig,
    data_configs: Sequence[DataConfig],
    algo_cfg: Optional[AlgorithmConfig] = None,
    t2u_cfg: Optional[T2UConfig] = None,
    device=None,
    **extra,
):
    """The T2U or PR system registered under `algorithm_type`, on `device`."""
    cls = SYSTEMS.get(algorithm_type)
    t = algorithm_type
    if t.startswith("pr-"):
        return cls(model_cfg, build_id2symbols(data_configs), device=device,
                   optim_cfg=optim_cfg, **extra)
    if not t.startswith(("tacot2u", "fscl-t2u")):
        raise ValueError(f"{t}: the factory builds the T2U and PR keys only; `train` builds baseline, "
                         "baseline-tune, fscl and fscl-orig on its main path "
                         "(cli/train_cmd.py:_main_path), and `tune` fscl-tune and fscl-orig-tune")
    id2symbols = build_id2symbols(data_configs)
    kw = dict(extra, device=device, optim_cfg=optim_cfg)
    tcfg = t2u_cfg or T2UConfig(n_units=_n_units(data_configs))
    if t in _TACOT2U_KEYS:
        return cls(model_cfg, id2symbols, tcfg, **kw)
    if "e2e" in t:
        if "u2s_system" not in extra:
            raise ValueError("e2e tune systems need a loaded u2s (systems.model_cards)")
        return cls(model_cfg, id2symbols, tcfg, **kw)
    return cls(model_cfg, max(n for _, n in id2symbols), tcfg, **kw)
