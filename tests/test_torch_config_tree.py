"""The port's config readers against fscl_tpu's on the shipped config tree.

Every YAML under config/ loads in both packages through the reader that
reads it, and the two `to_dict` results are equal (exactly: the same YAML
values in the same frozen dataclasses). The model YAMLs of the T2U family
load through `model_config_from_yaml` here; their `tacotron2:` block, read by
`t2u_config_from_yaml` alone, is held in tests/test_torch_t2u_data.py. The registry
keys of every algorithm YAML resolve in the port, or raise naming the
ROADMAP item that ports their system.
"""
import glob
import os

import pytest

import fscl_tpu.core.config as J
import fscl_tpu_torch.core.config as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "config")


def _files(sub):
    out = sorted(glob.glob(os.path.join(CFG, sub, "**", "*.yaml"), recursive=True))
    assert out, f"no YAMLs under config/{sub}"
    return out


ALGOS, MODELS, TRAINS = _files("algorithm"), _files("model"), _files("train")
PREPS, DATAS = _files("preprocess"), _files("data")
OUTPUTS = [p for p in TRAINS if p.endswith("-output.yaml")]
OVERLAYS = [(os.path.join(CFG, "train", base), out)
            for base in ("baseline.yaml", "fscl.yaml") for out in OUTPUTS]
_id = lambda p: os.path.relpath(p, CFG)


def test_tree_is_the_whole_config_directory():
    every = set(glob.glob(os.path.join(CFG, "**", "*.yaml"), recursive=True))
    assert every == set(ALGOS + MODELS + TRAINS + PREPS + DATAS)
    assert (len(ALGOS), len(MODELS), len(TRAINS), len(PREPS)) >= (51, 10, 25, 30)


@pytest.mark.parametrize("path", MODELS, ids=_id)
def test_model_config_matches(path):
    assert P.to_dict(P.model_config_from_yaml(path)) == J.to_dict(J.model_config_from_yaml(path))


@pytest.mark.parametrize("path", TRAINS, ids=_id)
def test_train_config_matches(path):
    assert P.to_dict(P.train_config_from_yaml(path)) == J.to_dict(J.train_config_from_yaml(path))


@pytest.mark.parametrize("paths", OVERLAYS, ids=lambda ps: "+".join(map(_id, ps)))
def test_train_overlay_matches(paths):
    got = P.train_config_from_yaml(list(paths))
    assert P.to_dict(got) == J.to_dict(J.train_config_from_yaml(list(paths)))
    assert got.ckpt_path is not None      # the overlay's path block landed


@pytest.mark.parametrize("path", ALGOS, ids=_id)
def test_algorithm_config_matches(path):
    got = P.read_algorithm_config(path)
    assert P.to_dict(got) == J.to_dict(J.read_algorithm_config(path))
    assert P.to_json(got) == J.to_json(J.read_algorithm_config(path))


@pytest.mark.parametrize("path", PREPS, ids=_id)
def test_preprocess_config_matches(path):
    assert P.to_dict(P.read_preprocess_config(path)) == J.to_dict(J.read_preprocess_config(path))


@pytest.mark.parametrize("path", DATAS, ids=_id)
def test_data_config_matches(path):
    got = P.read_data_config(path)
    assert P.to_dict(got) == J.to_dict(J.read_data_config(path))
    want = J.read_data_config(path)
    for split in ("train", "val", "test", "missing"):
        assert got.subset_path(split) == want.subset_path(split)


@pytest.mark.parametrize("raw", [
    "name: a\nlang_id: 1\nsubsets:\n  train: t.txt\n",
    "lang_id: 0\ntarget:\n  unit_name: hubert-unit-64\n",
    "symbol_id: zh\ndata_dir: /x\ntext_cleaners: [english_cleaners]\n",
], ids=["inferred_symbol_id", "unit_target", "explicit"])
def test_data_config_inference_matches(tmp_path, raw):
    """symbol_id inferred from lang_id or a unit target, the name from the
    directory, data_dir defaulting to it."""
    path = tmp_path / "corpus" / "config.yaml"
    path.parent.mkdir()
    path.write_text(raw)
    assert P.to_dict(P.read_data_config(str(path))) == J.to_dict(J.read_data_config(str(path)))


def test_defaults_match():
    for cls in ("AdaptConfig", "PhonemeEmbConfig", "AlgorithmConfig", "DataConfig",
                "PreprocessConfig", "ModelConfig", "TrainConfig"):
        assert P.to_dict(getattr(P, cls)()) == J.to_dict(getattr(J, cls)()), cls
    assert P.DATASET2PARSER == J.DATASET2PARSER


@pytest.mark.parametrize("path", ALGOS, ids=_id)
def test_algorithm_type_resolves_or_names_its_roadmap_item(path):
    import fscl_tpu.data.mix_datamodules  # noqa: F401 (registers)
    import fscl_tpu.systems  # noqa: F401 (registers)
    import fscl_tpu_torch.data.datamodules  # noqa: F401 (registers)
    import fscl_tpu_torch.systems  # noqa: F401 (registers)
    from fscl_tpu.core.registry import DATAMODULES as JDM
    from fscl_tpu.core.registry import SYSTEMS as JSYS
    from fscl_tpu_torch.core.registry import DATAMODULES, SYSTEMS

    cfg = P.read_algorithm_config(path)
    if cfg.deprecated:
        return
    for port, jax_registry in ((SYSTEMS, JSYS), (DATAMODULES, JDM)):
        assert cfg.type in jax_registry
        port.get(cfg.type)


def test_every_fscl_tpu_key_is_ported_or_waits():
    import fscl_tpu.data.mix_datamodules  # noqa: F401
    import fscl_tpu.systems  # noqa: F401
    import fscl_tpu_torch.data.datamodules  # noqa: F401
    import fscl_tpu_torch.systems  # noqa: F401
    from fscl_tpu.core.registry import DATAMODULES as JDM
    from fscl_tpu.core.registry import SYSTEMS as JSYS
    from fscl_tpu_torch.core.registry import DATAMODULES, SYSTEMS

    for port, jax_registry in ((SYSTEMS, JSYS), (DATAMODULES, JDM)):
        assert set(port.keys()) == set(jax_registry.keys())
    assert {"baseline", "baseline-tune", "fscl", "fscl-orig", "fscl-orig-tune",
            "fscl-tune"} <= set(SYSTEMS.keys())
    with pytest.raises(KeyError, match="Unknown system 'nope'"):
        SYSTEMS.get("nope")
