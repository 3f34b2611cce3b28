"""System factory: algorithm type + configs -> a built system (port of
`fscl_tpu/systems/factory.py:build_system`, `:32`).

Bridges the registry and the T2U and PR systems' constructors, so that the
CLI's generic path builds a T2U or PR key from (model config, optimizer
config, data configs); a PR system takes the data configs' id2symbols
(fscl_tpu's `:85-86`), and the meta-learning keys (`:47-71`): the ADA
keys' stage from their suffix, MAML's and iMAML's inner learning rate and
steps (at least 1) from the algorithm config's `adapt` block, iMAML's CG
steps and regularisation from its `imaml:` block. The main path's keys
raise `ValueError` here: `train` builds baseline and FSCL on its main path
(`cli/train_cmd.py:_main_path`) and `tune` fscl-tune and fscl-orig-tune.
A key fscl_tpu registers nowhere
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

_MAML_KEYS = ("fscl-orig2", "maml", "meta", "imaml")
_META_KEYS = _MAML_KEYS + ("fscl-ada", "fscl-ada1", "fscl-ada2", "fscl-ssl_ada", "fscl-ssl_ada1",
                           "fscl-ssl_ada2", "semi-fscl", "semi-fscl-tune")
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
    """The system registered under `algorithm_type`, on `device`."""
    cls = SYSTEMS.get(algorithm_type)
    t = algorithm_type
    if t == "conti-ae":
        return cls(model_cfg, device=device, optim_cfg=optim_cfg, **extra)
    if t in _META_KEYS:
        n_symbols = max(n for _, n in build_id2symbols(data_configs))
        kw = dict(extra, device=device, optim_cfg=optim_cfg)
        if "ada" in t:
            kw.setdefault("ada_stage", "unsup_tuning" if t.endswith("ada2") else "matching")
        if t in _MAML_KEYS and algo_cfg is not None:
            kw.setdefault("adaptation_lr", algo_cfg.adapt.adaptation_lr)
            kw.setdefault("adaptation_steps", max(algo_cfg.adapt.adaptation_steps, 1))
            if t == "imaml":
                kw.setdefault("cg_steps", algo_cfg.imaml_cg_steps)
                kw.setdefault("reg_param", algo_cfg.imaml_reg_param)
        return cls(model_cfg, n_symbols, **kw)
    if t.startswith("pr-"):
        return cls(model_cfg, build_id2symbols(data_configs), device=device,
                   optim_cfg=optim_cfg, **extra)
    if not t.startswith(("tacot2u", "fscl-t2u")):
        raise ValueError(f"{t}: the factory leaves the main path's keys to `train`, which "
                         "builds baseline, baseline-tune, fscl and fscl-orig on its main path "
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
