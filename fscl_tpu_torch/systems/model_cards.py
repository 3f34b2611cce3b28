"""Model cards: load a pre-trained system from a registry json (port of
`fscl_tpu/systems/model_cards.py`, `:20`, `:25`).

A card maps a model name to {"ckpt": <checkpoint dir>, "config_paths":
[<data config.yaml>, ...], "model_config": <model yaml, optional>}, so that
the E2E tune systems rebuild a frozen u2s BaselineSystem from another run's
checkpoint (TransEmbE2ETune.py:56-68).
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import torch

from fscl_tpu_torch.core.checkpoint import CheckpointManager
from fscl_tpu_torch.core.config import (
    ModelConfig, OptimConfig, model_config_from_yaml, read_data_config,
)
from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS


def load_model_cards(path: str) -> Dict[str, dict]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_model_card(path: str, name: str, card: dict) -> None:
    """Add (or replace) `name` in the card registry at `path`."""
    try:
        cards = load_model_cards(path)
    except FileNotFoundError:
        cards = {}
    cards[name] = card
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cards, f, indent=1)


def load_baseline_from_card(card: dict, optim_cfg: Optional[OptimConfig] = None,
                            device=None):
    """A BaselineSystem rebuilt from a card on `device`, its parameters and
    buffers (the PostNet's BatchNorm statistics) from the card's latest
    checkpoint. The data configs' symbol sets must be known
    (`frontend.register_unit_symbols` for a unit inventory)."""
    from fscl_tpu_torch.systems.baseline import BaselineSystem

    data_configs = [read_data_config(p) for p in card["config_paths"]]
    model_cfg = (model_config_from_yaml(card["model_config"])
                 if card.get("model_config") else ModelConfig())
    id2symbols = tuple((dc.symbol_id, len(LANG_ID2SYMBOLS[dc.symbol_id]))
                       for dc in data_configs)
    system = BaselineSystem(model_cfg, id2symbols, device=device,
                            optim_cfg=optim_cfg or OptimConfig())
    mgr = CheckpointManager(card["ckpt"])
    mgr.restore_into(system)
    buffers = mgr.restore()["buffers"]
    with torch.no_grad():
        for name, b in system.named_buffers():
            if name in buffers:
                b.copy_(buffers[name])
    return system
