"""The PR family's data side and generic `train` path against fscl_tpu, on
the CPU: `PRDataset` item for item, `PRDataModule` and
`PREpisodicDataModule` batch for batch (the store path and, after
`pack --fscl`, the shard path), the factory building each `pr-*` key, the
reference faults the port copies (ROADMAP Queue 3), and `train --system
pr-ssl-protonet` through the port's `cli.main` at a tiny width.

Batches are compared exactly (`torch_parity.same`).
"""
import dataclasses
import os
import shutil

import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu.systems  # noqa: F401 (registers fscl_tpu's systems)
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.cli.__main__ import main as jax_main
from fscl_tpu.data import datamodules as jdm
from fscl_tpu.data import datasets as jds
from fscl_tpu.data.feature_store import FeatureStore as JStore
from fscl_tpu.systems import factory as jfactory
from fscl_tpu_torch.cli.__main__ import main
from fscl_tpu_torch.core.checkpoint import CheckpointManager
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.data import datamodules as pdm
from fscl_tpu_torch.data import datasets as pds
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.systems import factory as pfactory

from torch_corpus import FSCL_MODEL_YAML, write_corpus
from torch_parity import same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PR_KEYS = sorted(k for k in SYSTEMS.keys() if k.startswith("pr-"))
EPISODIC_KEYS = ("pr-ssl-protonet", "pr-fscl", "pr-fscl-tune", "pr-trans-head",
                 "pr-trans-head-tune")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two corpora (en 10 + 2, zh 6 + 2 utterances with 16 kHz wavs and MFA
    segments) and a tiny model YAML (custom upstream of dim 32, 3 layers)."""
    root = tmp_path_factory.mktemp("pr")
    cfgs = [write_corpus(str(root), "en", "en", 0, seed=7, n_train=10, n_val=2),
            write_corpus(str(root), "zh", "zh", 1, seed=8, n_train=6, n_val=2)]
    model = root / "model.yaml"
    model.write_text(FSCL_MODEL_YAML)
    return {"root": root, "cfgs": cfgs, "model": str(model)}


def _train_cfgs(seed=5, batch_size=3):
    out = []
    for C in (torch_config, jax_config):
        t = C.TrainConfig(seed=seed)
        out.append(dataclasses.replace(t, optim=dataclasses.replace(t.optim,
                                                                     batch_size=batch_size)))
    return out


def test_pr_dataset_matches(world):
    for cfg in world["cfgs"]:
        pdc, jdc = torch_config.read_data_config(cfg), jax_config.read_data_config(cfg)
        split = pdc.subset_path("train")
        got = pds.PRDataset(split, FeatureStore(pdc.data_dir), pdc)
        want = jds.PRDataset(split, JStore(jdc.data_dir), jdc)
        assert len(got) == len(want)
        for i in range(len(got)):
            same(got[i], want[i], f"{pdc.name}[{i}]")


def _modules(world, key, cfgs, **kw):
    ptrain, jtrain = _train_cfgs()
    pdcs = [torch_config.read_data_config(c) for c in cfgs]
    jdcs = [jax_config.read_data_config(c) for c in cfgs]
    pm = pdm.get_datamodule(key)(pdcs, torch_config.ModelConfig(), ptrain, exp_dir="unused",
                                 **kw)
    jm = jdm.get_datamodule(key)(jdcs, jax_config.ModelConfig(), jtrain, exp_dir="unused",
                                 **{k: v for k, v in kw.items() if k != "native_io"})
    assert type(pm).__name__ == type(jm).__name__
    pm.setup()
    jm.setup()
    return pm, jm


def _first(pm, jm, n, what):
    for i, (got, want) in enumerate(zip(pm.train_batches(), jm.train_batches())):
        same(got, want, f"{what} {i}")
        if i == n - 1:
            break


@pytest.mark.parametrize("key", ["pr-ssl-linear", "pr-ssl-protonet"])
def test_pr_datamodules_match_on_the_store(world, key):
    """Both corpora: a dataset drawn per batch (or episode), then its
    utterances; episodes split by phoneme coverage."""
    pm, jm = _modules(world, key, world["cfgs"])
    _first(pm, jm, 4, key)


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_pr_episodic_datamodule_takes_the_shard_path(world, tmp_path, native):
    """After `pack --fscl` (the port's), the episodic PR loader reads its
    episodes from the shard: equal to fscl_tpu's reading of the same shard
    and to the store path's episodes."""
    shutil.copytree(world["root"] / "en", tmp_path / "en")
    cfg = str(tmp_path / "en" / "data.yaml")
    store_path = _modules(world, "pr-fscl", [cfg], shots=4, queries=2)
    main(["pack", "--data_config", cfg, "--fscl"])
    pm, jm = _modules(world, "pr-fscl", [cfg], shots=4, queries=2, native_io=native)
    assert pm.datasets[0][2] is not None and pm.datasets[0][2].native == native
    assert jm.datasets[0][2] is not None
    _first(pm, jm, 3, "shard")
    _first(pm, store_path[1], 3, "shard vs store")


@pytest.mark.parametrize("key", PR_KEYS)
def test_build_system_builds_each_pr_key(world, key):
    """Every PR key resolves through the factory to the class fscl_tpu's
    factory builds, on the asked device, with the data configs' id2symbols."""
    pdcs = [torch_config.read_data_config(c) for c in world["cfgs"]]
    mc = torch_config.model_config_from_yaml(world["model"])
    system = pfactory.build_system(key, mc, torch_config.OptimConfig(), pdcs, device="cpu")
    assert type(system).__name__ == jfactory.SYSTEMS.get(key).__name__
    assert type(system) is SYSTEMS.get(key) and system.device.type == "cpu"
    assert system.id2symbols == pdm.build_id2symbols(pdcs)


def test_faults_copied_from_fscl_tpu(world, tmp_path):
    """ROADMAP Queue 3: (1) the episodic PR keys are not in _EPISODIC_KEYS,
    so the generic path drops the algorithm YAML's shots (pr-fscl.yaml and
    ssl-protonet.yaml say 32 + 8; episodes are 4 + 2); (2) `train` opens every
    corpus as a FastSpeech2Dataset first, so a PR corpus without a
    speakers.json raises before any training, in both packages."""
    for name in ("pr-fscl.yaml", "ssl-protonet.yaml"):
        path = os.path.join(REPO, "config", "algorithm", "phoneme_recognition", name)
        pa, ja = torch_config.read_algorithm_config(path), jax_config.read_algorithm_config(path)
        assert (pa.adapt.shots, pa.adapt.queries) == (32, 8)
        assert pdm.datamodule_kwargs_for(pa.type, pa) == jdm.datamodule_kwargs_for(ja.type, ja) == {}
    pm, _ = _modules(world, "pr-ssl-protonet", world["cfgs"][:1])
    episode = next(pm.train_batches())
    assert (len(episode.sup.wavs), len(episode.qry.wavs)) == (4, 2)

    shutil.copytree(world["root"] / "zh", tmp_path / "zh")
    os.remove(tmp_path / "zh" / "features" / "speakers.json")
    cfg = str(tmp_path / "zh" / "data.yaml")
    text = open(cfg).read().replace(str(world["root"] / "zh" / "features"),
                                    str(tmp_path / "zh" / "features"))
    open(cfg, "w").write(text)
    for run, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        with pytest.raises(FileNotFoundError, match="speakers.json"):
            run(["train", "--system", "pr-ssl-linear", "--data_config", cfg,
                 "--model_config", world["model"], "--exp_dir", str(tmp_path / "exp")] + extra)


def test_train_pr_ssl_protonet_through_the_cli(world, tmp_path):
    """`train --system pr-ssl-protonet` on the generic path: episodes of
    4 + 2 from PREpisodicDataModule, finite losses, and a checkpoint without
    the frozen upstream (fscl_tpu keeps it outside the saved state)."""
    overlay = tmp_path / "overlay.yaml"
    overlay.write_text("optimizer:\n  batch_size: 2\n  warm_up_step: 1\n  anneal_steps: []\n"
                       "step:\n  log_step: 1\n  save_step: 3\n")
    system, state = main(["train", "--system", "pr-ssl-protonet", "--data_config",
                          world["cfgs"][0], "--model_config", world["model"], "--train_config",
                          str(overlay), "--exp_dir", str(tmp_path / "exp"), "--total_step", "3",
                          "--device", "cpu"])
    assert type(system).__name__ == "SSLProtoNetSystem" and state.step == 3
    mgr = CheckpointManager(str(tmp_path / "exp" / "ckpt"))
    saved = torch.load(os.path.join(mgr.directory, "step_00000003", "state.pt"),
                       weights_only=True)
    assert saved["params"] and not any(k.startswith("upstream.") for k in saved["params"])
    assert any(k.startswith("upstream.") for k in system.state_dict())
