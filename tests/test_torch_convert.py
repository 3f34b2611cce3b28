"""Weights carried between fscl_tpu and the port.

Route 1: fscl_tpu variables -> fscl_tpu_torch.convert -> port state_dict.
Route 2: that state_dict -> benchmarks/convert_reference.py (the reference
torch key names) -> flax params. Route 2 must give back route 1's input bit
for bit, which pins every key name and layout.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import (
    ID2SYMBOLS, init_jax_variables, jax_cfg, torch_cfg, torch_system,
)
from fscl_tpu_torch.convert import baseline_state_dict
from fscl_tpu_torch.systems.baseline import BaselineSystem

_spec = importlib.util.spec_from_file_location(
    "convert_reference", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "convert_reference.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)
convert_fastspeech2_state_dict = _mod.convert_fastspeech2_state_dict


@pytest.fixture(scope="module")
def variables():
    return init_jax_variables(jax_cfg())[1]


def _model_sd(sd):
    return {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_state_dict_loads_strict(variables):
    system = torch_system(torch_cfg(), variables)
    assert set(system.state_dict()) == set(baseline_state_dict(variables))


def test_round_trip_through_reference_converter_is_exact(variables):
    system = torch_system(torch_cfg(), variables)
    sd = _model_sd(system.state_dict())
    back = convert_fastspeech2_state_dict(sd, enc_layers=2, dec_layers=2)
    _assert_trees_equal(back["params"], variables["params"]["model"])
    _assert_trees_equal(back["batch_stats"], variables["batch_stats"]["model"])
    np.testing.assert_array_equal(
        system.embedding_model.tables["table-en"].detach().numpy(),
        variables["params"]["embedding"]["table-en"])


def test_random_port_weights_convert_to_the_flax_tree(variables):
    """A freshly initialised port system has every key the reference
    converter reads, with the flax shapes."""
    torch.manual_seed(0)
    system = BaselineSystem(torch_cfg(), ID2SYMBOLS, device="cpu")
    back = convert_fastspeech2_state_dict(_model_sd(system.state_dict()),
                                          enc_layers=2, dec_layers=2)
    shapes = lambda t: jax.tree.map(lambda a: a.shape, t)  # noqa: E731
    assert shapes(back["params"]) == shapes(variables["params"]["model"])
    assert shapes(back["batch_stats"]) == shapes(variables["batch_stats"]["model"])
