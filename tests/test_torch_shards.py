"""The native readers and packed shards against fscl_tpu, on the CPU: `pack`
and `pack --fscl` through each package's `cli.main` on two copies of one
store write the same bytes; each package reads the other's shard; every
collate (`PackedShard.collate`, `collate_episode`, `collate_fscl_sup`,
`collate_pr_episode`, `sample`, `MultiShardCollate`, `NativeCollate`) gives
fscl_tpu's batch, through the port's C++ reader and its numpy reader alike;
`shard_compatible` rejects the shards fscl_tpu rejects; the supervised
datamodule takes the shard (or the native) path and gives fscl_tpu's
batches; `clean` writes and prints what fscl_tpu does.

Batches are compared exactly (`torch_parity.same`): both packages read the
same bytes into the same dtypes.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

import fscl_tpu.core.config as jax_config
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.cli.__main__ import main as jax_main
from fscl_tpu.core.stats import DEFAULT_STATS as JSTATS
from fscl_tpu.data import datamodules as jdm
from fscl_tpu.data import native_loader as jnl
from fscl_tpu.data import shards as jsh
from fscl_tpu.data.feature_store import FeatureStore as JStore
from fscl_tpu_torch.cli.__main__ import main
from fscl_tpu_torch.core.stats import DEFAULT_STATS, GlobalStats
from fscl_tpu_torch.data import datamodules as pdm
from fscl_tpu_torch.data import native_loader as pnl
from fscl_tpu_torch.data import shards as psh
from fscl_tpu_torch.data.feature_store import FeatureStore, read_queries_from_txt
from fscl_tpu_torch.frontend import n_symbols

from torch_corpus import write_corpus
from torch_parity import same

FRAME_LEVEL = "pitch:\n  feature: frame_level\nenergy:\n  feature: frame_level\n"
READERS = [True, False]          # the C++ reader, then numpy


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two corpora (en: 10 + 2 utterances, zh: 6 + 2; frame-level pitch and
    energy too) written twice from the same seeds: fscl_tpu packs copy `a`,
    the port copy `b`, each `train` split both ways (.shard, .fscl.shard)."""
    root = tmp_path_factory.mktemp("shards")
    frame_yaml = root / "frame.yaml"
    frame_yaml.write_text(FRAME_LEVEL)
    cfgs = {}
    for side in "ab":
        cfgs[side] = [write_corpus(str(root / side), "en", "en", 0, seed=3, n_train=10,
                                   n_val=2, unit_name="u8"),
                      write_corpus(str(root / side), "zh", "zh", 1, seed=4, n_train=6,
                                   n_val=2, unit_name="u8")]
    out = {}
    for cfg in cfgs["a"]:
        jax_main(["pack", "--data_config", cfg])
        jax_main(["pack", "--data_config", cfg, "--fscl"])
    for cfg in cfgs["b"]:
        out[cfg] = main(["pack", "--data_config", cfg])
        main(["pack", "--data_config", cfg, "--fscl"])
    return {"root": root, "cfgs": cfgs, "frame_yaml": str(frame_yaml), "packed": out}


def _split(world, side, lang="en"):
    return os.path.join(world["root"], side, lang, "splits", "train.txt")


@pytest.mark.parametrize("suffix", [".shard", ".fscl.shard"])
def test_pack_writes_the_bytes_fscl_tpu_writes(world, suffix):
    for lang in ("en", "zh"):
        with open(_split(world, "a", lang) + suffix, "rb") as f:
            want = f.read()
        with open(_split(world, "b", lang) + suffix, "rb") as f:
            got = f.read()
        assert got == want, (lang, suffix)
    packed = world["packed"][world["cfgs"]["b"][0]]["train"]
    assert packed["bytes"] == os.path.getsize(packed["path"]) and packed["seconds"] > 0


def test_pack_and_read_frame_level_and_each_others_shards(world, tmp_path):
    """A frame-level shard packed by each package; each reads the other's."""
    paths = {}
    for side, run in (("a", jax_main), ("b", main)):
        dst = tmp_path / side
        shutil.copytree(world["root"] / side / "en", dst)
        cfg = dst / "data.yaml"
        cfg.write_text(cfg.read_text().replace(str(world["root"] / side / "en" / "splits"),
                                               str(dst / "splits")))
        run(["pack", "--data_config", str(cfg), "--model_config", world["frame_yaml"]])
        paths[side] = str(dst / "splits" / "train.txt.shard")
    assert open(paths["a"], "rb").read() == open(paths["b"], "rb").read()
    kw = dict(pitch_feature="frame_level", energy_feature="frame_level")
    for native in READERS:
        same(psh.PackedShard(paths["a"], native=native).collate([3, 0, 7], **kw),
             jsh.PackedShard(paths["b"]).collate([3, 0, 7], **kw), "frame level")


@pytest.mark.parametrize("native", READERS, ids=["cpp", "numpy"])
def test_shard_collates_match(world, native):
    """Every collate of a shard the port packed, read by the port's reader,
    against fscl_tpu's read of the same file."""
    sup, fscl = (_split(world, "b") + ".shard", _split(world, "b") + ".fscl.shard")
    p, j = psh.PackedShard(sup, native=native), jsh.PackedShard(sup)
    assert p.lengths() == j.lengths() and len(p) == len(j) == 10
    same(p.collate([4, 1, 9]), j.collate([4, 1, 9]), "collate")
    same(p.collate([2, 3], L=128, T=512, id_offset=7, speaker_offset=2),
         j.collate([2, 3], L=128, T=512, id_offset=7, speaker_offset=2), "collate offsets")
    pf, jf = psh.PackedShard(fscl, native=native), jsh.PackedShard(fscl)
    idxs = np.array([5, 2, 8, 0, 9, 3])
    same(pf.collate_episode(idxs, 4, 2), jf.collate_episode(idxs, 4, 2), "collate_episode")
    same(pf.collate_episode(idxs, 4, 2, wav_dtype="int16"),
         jf.collate_episode(idxs, 4, 2, wav_dtype="int16"), "collate_episode int16")
    same(pf.collate_fscl_sup(idxs, 4, 2), jf.collate_fscl_sup(idxs, 4, 2), "collate_fscl_sup")
    same(pf.collate_pr_episode(idxs, 4, 2, "en", n_symbols("en")),
         jf.collate_pr_episode(idxs, 4, 2, "en", n_symbols("en")), "collate_pr_episode")
    same(pf.sample(3), jf.sample(3), "sample")
    with pytest.raises(ValueError, match="not an FSCL shard"):
        p.collate_pr_episode(idxs, 4, 2)


@pytest.mark.parametrize("native", READERS, ids=["cpp", "numpy"])
def test_multi_shard_collate_matches(world, native):
    """A joint batch over the en and zh shards, re-id and speaker offsets at
    collate, rows stitched back in order."""
    shards = [psh.PackedShard(_split(world, "b", lang) + ".shard", native=native)
              for lang in ("en", "zh")]
    jshards = [jsh.PackedShard(_split(world, "b", lang) + ".shard") for lang in ("en", "zh")]
    got = psh.MultiShardCollate(shards, [0, 152], [0, 2])
    want = jsh.MultiShardCollate(jshards, [0, 152], [0, 2])
    assert len(got) == len(want) == 16 and got.lengths() == want.lengths()
    for idxs in ([12, 3, 15, 0], [1, 2], [11, 10]):
        same(got.collate(idxs), want.collate(idxs), f"multi {idxs}")


@pytest.mark.parametrize("level", ["phoneme", "frame"])
def test_native_collate_matches(world, level):
    """NativeCollate over the store against fscl_tpu's, and both against the
    Python dataset + collate path."""
    from fscl_tpu.data.batch import collate_batch as jcollate
    from fscl_tpu.data.datasets import FastSpeech2Dataset as JDataset
    path = world["cfgs"]["b"][0]
    pdc, jdc = torch_config.read_data_config(path), jax_config.read_data_config(path)
    if level == "frame":
        pmc = torch_config.model_config_from_yaml(world["frame_yaml"])
        jmc = jax_config.model_config_from_yaml(world["frame_yaml"])
    else:
        pmc, jmc = torch_config.ModelConfig(), jax_config.ModelConfig()
    pstore, jstore = FeatureStore(pdc.data_dir), JStore(jdc.data_dir)
    queries = read_queries_from_txt(_split(world, "b"))
    got = pnl.NativeCollate(pstore, pdc, pmc, DEFAULT_STATS, id_offset=3, speaker_offset=1)
    want = jnl.NativeCollate(jstore, jdc, jmc, JSTATS, id_offset=3, speaker_offset=1)
    for idxs in ([0, 4, 7], [9], [1, 2, 3, 5]):
        qs = [queries[i] for i in idxs]
        same(got.collate(qs), want.collate(qs), f"native {idxs}")
    ds = JDataset(_split(world, "b"), jstore, jdc, jmc, id_offset=3, speaker_offset=1)
    v = jmc.variance
    native = got.collate(queries[:4])[1]
    python = jcollate([ds[i] for i in range(4)], pitch_feature=v.pitch_feature,
                      energy_feature=v.energy_feature)[1]
    # the Python path normalises pitch and energy in f32, the native one in
    # f64 before its f32 store: one rounding apart
    for name in native._fields:
        np.testing.assert_allclose(getattr(native, name), getattr(python, name), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_shard_compatible_rejects_what_fscl_tpu_rejects(world):
    """Stale by variance level, by normalisation flag and by statistics."""
    p = psh.PackedShard(_split(world, "b") + ".shard")
    j = jsh.PackedShard(_split(world, "b") + ".shard")
    moved = GlobalStats.from_flat([x + 1.0 for x in DEFAULT_STATS.as_flat()])
    cases = []
    for C, stats in ((torch_config, DEFAULT_STATS), (jax_config, JSTATS)):
        frame = C.model_config_from_yaml(world["frame_yaml"])
        base = C.ModelConfig()
        no_norm = dataclasses.replace(base, variance=dataclasses.replace(
            base.variance, pitch_normalization=False))
        cases.append([(base, stats), (frame, stats), (no_norm, stats)])
    verdicts = [psh.shard_compatible(p, m, s) for m, s in cases[0]]
    verdicts.append(psh.shard_compatible(p, torch_config.ModelConfig(), moved))
    want = [jsh.shard_compatible(j, m, s) for m, s in cases[1]]
    want.append(jsh.shard_compatible(
        j, jax_config.ModelConfig(), type(JSTATS).from_flat(moved.as_flat())))
    assert verdicts == want == [True, False, False, False]


def _datamodules(world, cfgs, **kw):
    pdcs = [torch_config.read_data_config(c) for c in cfgs]
    jdcs = [jax_config.read_data_config(c) for c in cfgs]
    ptrain, jtrain = torch_config.TrainConfig(seed=4), jax_config.TrainConfig(seed=4)
    ptrain = dataclasses.replace(ptrain, optim=dataclasses.replace(ptrain.optim, batch_size=3))
    jtrain = dataclasses.replace(jtrain, optim=dataclasses.replace(jtrain.optim, batch_size=3))
    p = pdm.FastSpeech2DataModule(pdcs, torch_config.ModelConfig(), ptrain,
                                  exp_dir="unused", **kw)
    j = jdm.FastSpeech2DataModule(jdcs, jax_config.ModelConfig(), jtrain, exp_dir="unused",
                                  **kw)
    p.setup()
    j.setup()
    return p, j


@pytest.mark.parametrize("corpora", ["en", "en+zh"])
def test_supervised_datamodule_takes_the_shard_path(world, corpora):
    """With fresh shards beside the splits the supervised datamodule reads
    them (one shard, or several stitched): batches and the full train
    batch equal fscl_tpu's; `native_io=False` reads the store in Python."""
    cfgs = world["cfgs"]["b"][:1 if corpora == "en" else 2]
    p, j = _datamodules(world, cfgs)
    kind = psh.PackedShard if corpora == "en" else psh.MultiShardCollate
    assert isinstance(p._shard, kind) and type(j._shard).__name__ == kind.__name__
    for i, (got, want) in enumerate(zip(p.train_batches(), j.train_batches())):
        same(got, want, f"batch {i}")
        if i == 3:
            break
    same(p.full_train_batch(), j.full_train_batch(), "full train batch")
    p, j = _datamodules(world, cfgs, native_io=False)
    assert p._shard is None and p._native is None
    same(next(p.train_batches()), next(j.train_batches()), "python path")


def test_supervised_datamodule_skips_a_stale_shard(world, tmp_path):
    """A shard packed from fewer utterances than the split is stale: the
    store is read through NativeCollate, as fscl_tpu does."""
    shutil.copytree(world["root"] / "b" / "en", tmp_path / "en")
    cfg = tmp_path / "en" / "data.yaml"
    cfg.write_text(cfg.read_text().replace(str(world["root"] / "b" / "en" / "splits"),
                                           str(tmp_path / "en" / "splits")))
    split = tmp_path / "en" / "splits" / "train.txt"
    lines = split.read_text().splitlines(keepends=True)
    short = tmp_path / "short.txt"
    short.write_text("".join(lines[:5]))
    dc = torch_config.read_data_config(str(cfg))
    psh.pack_split_from_store(str(short), FeatureStore(dc.data_dir), dc,
                              torch_config.ModelConfig(), str(split) + ".shard")
    p, j = _datamodules(world, [str(cfg)])
    assert p._shard is None and isinstance(p._native, pnl.NativeCollate)
    assert j._shard is None and j._native is not None
    same(next(p.train_batches()), next(j.train_batches()), "native path")


def test_clean_matches_fscl_tpu(world, tmp_path, capsys):
    """`clean` over a store with an utterance of each fault: too short, a
    NaN feature, an unknown token, a missing mel; the kept list and the
    printed summary equal fscl_tpu's."""
    stores = {}
    for side in "ab":
        shutil.copytree(world["root"] / side / "en" / "features", tmp_path / side)
        stores[side] = FeatureStore(str(tmp_path / side))
    rng = np.random.default_rng(0)
    queries = stores["a"].load_metadata()
    for i, q in enumerate(queries):
        n = stores["a"].mfa_duration.read_from_query(q).shape[0]
        T = stores["a"].mel.read_from_query(q).shape[0]
        secs = 0.5 if i == 1 else 1.5
        pitch = rng.normal(size=T).astype(np.float32)
        if i == 2:
            pitch[3] = np.nan
        for s in stores.values():
            s.wav_trim_22050.save(np.zeros(int(secs * 22050), np.float32), q)
            s.pitch.save(pitch, q)
            if i == 3:
                s.phoneme.save(" ".join(["AA"] * (n - 1) + ["spn"]), q)
            if i == 4:
                os.remove(s.mel.path(q))
    for s in stores.values():
        s.flush()
    printed = {}
    for side, run in (("a", jax_main), ("b", main)):
        run(["clean", str(tmp_path / side)])
        printed[side] = capsys.readouterr().out.replace(str(tmp_path / side), "<dir>")
    assert printed["a"] == printed["b"] and "kept 8/12" in printed["b"]
    read = lambda side: (tmp_path / side / "data_info-clean.json").read_text()
    assert read("a") == read("b")
