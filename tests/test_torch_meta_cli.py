"""The meta-learning keys through the factory and `train`'s generic path, on
the CPU at a tiny width, against fscl_tpu.

`systems/factory.py:build_system` builds every one of the 13 keys that
fscl_tpu's factory builds from the algorithm YAMLs (`:47-71`) with the same
settings (ADA stage, inner rate and steps, iMAML's CG steps and
regularisation) in both packages; `train --system <key>` runs one or two
steps of each through the port's `cli.main` on two corpora of
tests/torch_corpus.py; and the two reference faults the port copies are
pinned in both packages (ROADMAP Queue 3): `meta` and `imaml` are missing
from `_EPISODIC_KEYS`, so their algorithm YAMLs' shots never reach the
datamodule, and no datamodule builds the `SemiEpisode` that `semi-fscl`
reads, so `train --system semi-fscl` fails at its first episode.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu.systems  # noqa: F401 (registers fscl_tpu's systems)
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.cli.__main__ import main as jax_main
from fscl_tpu.data import datamodules as jdm
from fscl_tpu.systems import factory as jfactory
from fscl_tpu_torch.cli.__main__ import main
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.data import datamodules as pdm
from fscl_tpu_torch.systems import factory as pfactory

from torch_corpus import FSCL_MODEL_YAML, write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGO = os.path.join(REPO, "config", "algorithm", "language")
META_KEYS = ("fscl-orig2", "maml", "meta", "imaml", "fscl-ada", "fscl-ada1", "fscl-ada2",
             "fscl-ssl_ada", "fscl-ssl_ada1", "fscl-ssl_ada2", "conti-ae", "semi-fscl",
             "semi-fscl-tune")
SEMI_KEYS = ("semi-fscl", "semi-fscl-tune")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two corpora (en 10 + 2, zh 6 + 2 utterances), a tiny model YAML
    (custom upstream of dim 32, a 2-row speaker table) and a train overlay
    (batch 2, no warm-up, log every step)."""
    root = tmp_path_factory.mktemp("meta")
    cfgs = [write_corpus(str(root), "en", "en", 0, seed=11, n_train=10, n_val=2),
            write_corpus(str(root), "zh", "zh", 1, seed=12, n_train=6, n_val=2)]
    model = root / "model.yaml"
    model.write_text(FSCL_MODEL_YAML)
    overlay = root / "overlay.yaml"
    overlay.write_text("optimizer:\n  batch_size: 2\n  warm_up_step: 1\n  anneal_steps: []\n"
                       "step:\n  log_step: 1\n  save_step: 100\n")
    return {"root": root, "cfgs": cfgs, "model": str(model), "overlay": str(overlay)}


def _algo(key):
    """The algorithm YAML of `key` where config/algorithm/language has one."""
    path = os.path.join(ALGO, f"{key}.yaml")
    return path if os.path.isfile(path) else None


def _algo_cfg(C, key):
    path = _algo(key)
    return C.read_algorithm_config(path) if path else C.AlgorithmConfig(type=key)


@pytest.mark.parametrize("key", META_KEYS)
def test_factory_builds_each_meta_key_as_fscl_tpu_does(world, key):
    C = (torch_config, jax_config)
    pdcs, jdcs = ([c.read_data_config(p) for p in world["cfgs"]] for c in C)
    pmc, jmc = (c.model_config_from_yaml(world["model"]) for c in C)
    psys = pfactory.build_system(key, pmc, torch_config.OptimConfig(), pdcs,
                                 _algo_cfg(torch_config, key), device="cpu")
    jsys = jfactory.build_system(key, jmc, jax_config.OptimConfig(), jdcs,
                                 _algo_cfg(jax_config, key))
    assert type(psys) is SYSTEMS.get(key) and type(psys).__name__ == type(jsys).__name__
    for attr in ("n_symbols", "ada_stage", "adaptation_lr", "adaptation_steps", "first_order",
                 "cg_steps", "reg_param", "unsup_weight", "layer_idx", "ssl_layer_idx"):
        assert hasattr(psys, attr) == hasattr(jsys, attr), attr
        if hasattr(jsys, attr):
            assert getattr(psys, attr) == getattr(jsys, attr), attr
    if key == "imaml":
        assert (psys.adaptation_steps, psys.cg_steps, psys.reg_param) == (50, 5, 1.0)


TINY_ALGO = ("name: tiny\ntype: {key}\nadapt:\n  shots: 4\n  queries: 2\n"
             "  adaptation_lr: 0.001\n  adaptation_steps: 2\n  imaml:\n    K: 2\n"
             "    reg_param: 1.0\n")


@pytest.mark.parametrize("key", [k for k in META_KEYS if k not in SEMI_KEYS])
def test_train_each_meta_key_through_the_cli(world, tmp_path, key):
    """`train --system <key>` on the generic path with a small algorithm
    YAML (episodes of 4 + 2, 2 inner steps, 2 CG steps): two steps, or one
    for `meta` and `imaml`, whose episodes stay 32 + 8 (the fault below);
    finite losses, a checkpoint without the frozen upstream."""
    algo = tmp_path / "algo.yaml"
    algo.write_text(TINY_ALGO.format(key=key))
    steps = 1 if key in ("meta", "imaml") else 2
    system, state = main(["train", "--system", key, "--data_config", world["cfgs"][0],
                          "--data_config", world["cfgs"][1], "--model_config", world["model"],
                          "--train_config", world["overlay"], "--algorithm_config", str(algo),
                          "--exp_dir", str(tmp_path / "exp"), "--total_step", str(steps),
                          "--device", "cpu"])
    assert type(system) is SYSTEMS.get(key) and state.step == steps
    if key in ("imaml", "maml", "meta", "fscl-orig2"):
        assert (system.adaptation_steps, system.adaptation_lr) == (2, 0.001)
    with open(tmp_path / "exp" / "log" / "log.txt") as f:
        losses = [float(line.split("Total Loss: ")[1].split()[0]) for line in f
                  if "Total Loss" in line]
    assert len(losses) == steps and np.isfinite(losses).all()
    saved = torch.load(tmp_path / "exp" / "ckpt" / f"step_{steps:08d}" / "state.pt",
                       weights_only=True)
    assert not any(k.startswith("upstream.") for k in saved["params"])


def _first_episode(dm_mod, C, world, key):
    tcfg = dataclasses.replace(C.TrainConfig(seed=3))
    dcs = [C.read_data_config(p) for p in world["cfgs"]]
    mc = C.model_config_from_yaml(world["model"])
    algo = _algo_cfg(C, key)
    dm = dm_mod.get_datamodule(key)(dcs, mc, tcfg, exp_dir=str(world["root"] / "dm"),
                                    **dm_mod.datamodule_kwargs_for(key, algo))
    dm.setup()
    return next(dm.train_batches())


@pytest.mark.parametrize("key", ["meta", "imaml"])
def test_meta_and_imaml_episodes_ignore_their_yaml_shots_as_fscl_tpu_does(world, key):
    """ROADMAP Queue 3: `_EPISODIC_KEYS` leaves out `meta` and `imaml`, so the
    datamodule keeps its default 32 + 8 where imaml.yaml says 20 + 5 (and
    meta.yaml 32 + 8, the same numbers by chance), in both packages."""
    pa, ja = _algo_cfg(torch_config, key), _algo_cfg(jax_config, key)
    want_shots = {"meta": (32, 8), "imaml": (20, 5)}[key]
    assert (pa.adapt.shots, pa.adapt.queries) == want_shots
    assert pdm.datamodule_kwargs_for(key, pa) == jdm.datamodule_kwargs_for(key, ja) == {
        "with_sup_batch": True}
    for mod, C in ((pdm, torch_config), (jdm, jax_config)):
        ep = _first_episode(mod, C, world, key)
        assert (len(ep.sup.wavs), len(ep.qry.texts), len(ep.sup_batch.texts)) == (32, 8, 32)


@pytest.mark.parametrize("key", SEMI_KEYS)
def test_train_semi_fscl_fails_at_its_first_episode_as_fscl_tpu_does(world, tmp_path, key):
    """ROADMAP Queue 3: `semi-fscl` is registered on FSCLDataModule, which
    yields an `Episode`, and the system reads `episode.sup_episode`: both
    packages raise the same AttributeError before a step is taken."""
    args = ["train", "--system", key, "--data_config", world["cfgs"][0], "--model_config",
            world["model"], "--train_config", world["overlay"], "--algorithm_config",
            _algo(key), "--total_step", "1"]
    for run, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        with pytest.raises(AttributeError, match="'Episode' object has no attribute 'sup_episode'"):
            run(args + ["--exp_dir", str(tmp_path / run.__module__)] + extra)
