"""The T2U family's data side and command line against fscl_tpu, on the CPU:
k-means and DPDP, pseudo-unit discovery (`make-units` through each
package's `cli.main` on copies of one corpus), the SSL feature extractor,
the unit datasets and the five T2U datamodules (batch for batch), the
factory and its registry keys, the reference faults the port keeps
(ROADMAP Queue 3), and `train --system tacot2u|fscl-t2u` through the
port's `cli.main`.

Tolerances: k-means centroids 1e-5 absolute (means of the same f32 rows);
the extractor's hidden states 1e-4 absolute (a conv stack and two
transformer layers in another summation order); make-units' cost matrices
1e-5 absolute, its unit strings, durations and segments exactly (the
distances' rounding differs by about 1e-6 relative, far from DPDP's
decisions on this corpus). Batches are compared exactly.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu.data.mix_datamodules  # noqa: F401 (registers fscl_tpu's T2U datamodules)
import fscl_tpu.frontend as jfrontend
import fscl_tpu.systems  # noqa: F401 (registers fscl_tpu's systems)
import fscl_tpu_torch.core.config as torch_config
import fscl_tpu_torch.data.ssl_units as pssl
import fscl_tpu_torch.frontend as pfrontend
from fscl_tpu.cli.__main__ import main as jax_main
from fscl_tpu.data import datamodules as jdm
from fscl_tpu.data import datasets as jds
from fscl_tpu.data import ssl_units as jssl
from fscl_tpu.data.feature_store import FeatureStore as JStore
from fscl_tpu.eval import dpdp as jdpdp
from fscl_tpu.nn.phoneme_embedding import kmeans as jax_kmeans
from fscl_tpu.systems import factory as jfactory
from fscl_tpu_torch import convert
from fscl_tpu_torch.cli.__main__ import main
from fscl_tpu_torch.core.registry import DATAMODULES, SYSTEMS
from fscl_tpu_torch.data import datamodules as pdm
from fscl_tpu_torch.data import datasets as pds
from fscl_tpu_torch.data.feature_store import FeatureStore
from fscl_tpu_torch.eval import dpdp as pdpdp
from fscl_tpu_torch.nn.phoneme_embedding import kmeans
from fscl_tpu_torch.systems import factory as pfactory
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.systems.t2u import TacoT2USystem

from torch_corpus import FSCL_MODEL_YAML, write_corpus
from torch_parity import make_cfg, same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNITS, N_UNITS = "u8", 8
CENTROID_ATOL, HIDDEN_ATOL, MATRIX_ATOL = 1e-5, 1e-4, 1e-5
CPU = ["--device", "cpu"]
T2U_KEYS = sorted(k for k in SYSTEMS.keys() if k.startswith(("tacot2u", "fscl-t2u")))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_init_idx(x, k, seed=0):
    """The rows fscl_tpu's k-means starts from."""
    return torch.from_numpy(np.array(jax.random.choice(
        jax.random.PRNGKey(seed), x.shape[0], (k,), replace=False)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One corpus (12 utterances, frame-level pitch and energy), two copies
    of it: `make-units` through fscl_tpu's CLI into one, through the port's
    (on fscl_tpu's k-means seeds) into the other. The unit inventory is
    registered in both frontends."""
    root = tmp_path_factory.mktemp("t2u")
    cfg = write_corpus(str(root / "a"), "en", "en", 0, seed=3, n_train=10, n_val=2,
                       unit_name=UNITS)
    shutil.copytree(root / "a", root / "b")
    feats = {s: str(root / s / "en" / "features") for s in "ab"}
    jax_main(["make-units", feats["a"], "--unit_name", UNITS, "--n_units", str(N_UNITS)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pssl, "kmeans", lambda x, k, seed=0: kmeans(
            x, k, seed=seed, init_idx=_jax_init_idx(x, k, seed)))
        out = main(["make-units", feats["b"], "--unit_name", UNITS, "--n_units",
                    str(N_UNITS)] + CPU)
    jfrontend.register_unit_symbols(UNITS, N_UNITS)
    pfrontend.register_unit_symbols(UNITS, N_UNITS)
    return {"root": root, "features": feats, "made": out,
            "data": {s: cfg.replace(str(root / "a"), str(root / s)) for s in "ab"},
            "t2u": {s: os.path.join(root, s, "en", "t2u.yaml") for s in "ab"}}


def test_kmeans_matches_from_shared_seeds():
    rng = np.random.default_rng(0)
    centers = 4.0 * rng.normal(size=(5, 6))
    x = (centers[rng.integers(0, 5, 300)] + rng.normal(size=(300, 6))).astype(np.float32)
    want_c, want_a = jax_kmeans(jnp.asarray(x), 5, seed=3)
    got_c, got_a = kmeans(torch.from_numpy(x), 5, init_idx=_jax_init_idx(x, 5, 3))
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=CENTROID_ATOL, rtol=0)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    again_c, _ = kmeans(torch.from_numpy(x), 5, seed=3)          # the port's own seeds
    assert torch.equal(again_c, kmeans(torch.from_numpy(x), 5, seed=3)[0])


@pytest.mark.parametrize("lam", [0.0, 1.5])
def test_dpdp_and_label_propagation_match(lam):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(60, 6)) * 3
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    want = jdpdp.merge_repeats(*jdpdp.dpdp_decode(logp, lam=lam, max_segment_len=20))
    got = pdpdp.merge_repeats(*pdpdp.dpdp_decode(logp, lam=lam, max_segment_len=20))
    assert got == want
    assert pdpdp.dpdp_segment_to_time(got[0]) == jdpdp.dpdp_segment_to_time(want[0])
    probs = np.exp(logp).astype(np.float32)
    np.testing.assert_array_equal(pssl.label_propagate(probs), jssl.label_propagate(probs))


def test_make_units_matches_fscl_tpu(world):
    """Both CLIs' ssl_units/<name> stores: units, durations, segments, the
    duration-averaged pitch and energy, the cost matrices and the attrs."""
    assert world["made"]["utterances"] == 12
    assert set(world["made"]["seconds"]) == {"upstream", "kmeans", "units"}
    ja = JStore(world["features"]["a"]).get_ssl_unit_store(UNITS)
    pb = FeatureStore(world["features"]["b"]).get_ssl_unit_store(UNITS)
    assert pb.load_attrs() == ja.load_attrs() == {"n_units": N_UNITS, "fp": 256 / 22050}
    for q in FeatureStore(world["features"]["b"]).load_metadata():
        assert pb.phoneme.read_from_query(q) == ja.phoneme.read_from_query(q)
        assert pb.segment.read_from_query(q) == ja.segment.read_from_query(q)
        for name in ("duration", "duration_avg_pitch", "duration_avg_energy"):
            np.testing.assert_array_equal(getattr(pb, name).read_from_query(q),
                                          getattr(ja, name).read_from_query(q), err_msg=name)
        for name in ("alignment_matrix", "lp_matrix"):
            np.testing.assert_allclose(getattr(pb, name).read_from_query(q),
                                       getattr(ja, name).read_from_query(q),
                                       atol=MATRIX_ATOL, err_msg=name)


def test_batched_ssl_extractor_matches(world):
    """One layer of a tiny custom upstream over the corpus's 16 kHz wavs in
    buckets of 8, from fscl_tpu's params converted to HF keys."""
    store = FeatureStore(world["features"]["b"])
    queries = store.load_metadata()
    up_cfg = jax_config.UpstreamConfig(name="custom", dim=64, n_layers=3)
    from fscl_tpu.models.hubert import make_upstream
    params = jax.jit(make_upstream("custom", up_cfg).init)(jax.random.PRNGKey(1),
                                                           jnp.zeros((1, 32000)))
    want = jssl.batched_ssl_extractor(JStore(world["features"]["b"]), queries, "custom",
                                      layer=-2, params=params, cfg=up_cfg)
    got = pssl.batched_ssl_extractor(
        store, queries, "custom", layer=-2, device="cpu",
        cfg=torch_config.UpstreamConfig(name="custom", dim=64, n_layers=3),
        state_dict=convert.hubert_state_dict(jax.tree.map(np.asarray, params)))
    for q in queries:
        w, g = np.asarray(want(q)), got(q)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=HIDDEN_ATOL, rtol=0)


def test_batched_ssl_extractor_keeps_one_layer_on_host(world):
    """The extractor's table holds one layer per batch in host memory: each
    entry is a view of its batch's (DEVICE_BATCH, T', D) buffer, never of
    the upstream's stack of every layer, and equals that layer of one
    upstream call on the padded batch."""
    from fscl_tpu_torch.data.batch import bucket_len
    from fscl_tpu_torch.models.hubert import make_upstream, ssl_num_frames
    from fscl_tpu_torch.ops.masking import length_mask
    store = FeatureStore(world["features"]["b"])
    queries = store.load_metadata()
    cfg = torch_config.UpstreamConfig(name="custom", dim=64, n_layers=3)
    torch.manual_seed(3)
    upstream = make_upstream("custom", cfg).eval()
    sd = {k: v.clone() for k, v in upstream.state_dict().items()}
    extract = pssl.batched_ssl_extractor(store, queries, "custom", layer=1, state_dict=sd,
                                         cfg=cfg, device="cpu")
    q = queries[0]
    got = extract(q)
    wav = np.asarray(store.wav_trim_16000.read_from_query(q)).astype(np.float32)
    bucket = bucket_len(len(wav), pssl.SSL_WAV_BUCKETS)
    T = ssl_num_frames(bucket)
    assert got.device.type == "cpu" and got.is_contiguous()
    assert got.untyped_storage().nbytes() == pssl.DEVICE_BATCH * T * cfg.dim * 4
    padded = torch.zeros(1, bucket)
    padded[0, :len(wav)] = torch.from_numpy(wav)
    with torch.no_grad():
        hidden = upstream(padded, length_mask(torch.tensor([len(wav)]), bucket))[0]
    want = hidden[0, :ssl_num_frames(len(wav)), 1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=HIDDEN_ATOL, rtol=0)


def _split(world, side="b"):
    return os.path.join(world["root"], side, "en", "splits", "train.txt")


def test_unit_datasets_match(world):
    jdc = jax_config.read_data_config(world["t2u"]["b"])
    pdc = torch_config.read_data_config(world["t2u"]["b"])
    jstore, pstore = JStore(jdc.data_dir), FeatureStore(pdc.data_dir)
    pairs = [(pds.UnitDataset(_split(world), pstore, pdc),
              jds.UnitDataset(_split(world), jstore, jdc)),
             (pds.UnitFSCLDataset(_split(world), pstore, pdc, torch_config.ModelConfig(),
                                  unit_name=UNITS),
              jds.UnitFSCLDataset(_split(world), jstore, jdc, jax_config.ModelConfig(),
                                  unit_name=UNITS))]
    for got, want in pairs:
        assert len(got) == len(want) == 10
        for i in range(len(got)):
            same(got[i], want[i], f"{type(got).__name__}[{i}]")
    assert pairs[0][0][0]["units"][-1] == 8          # <eos>


DATAMODULE_KEYS = ["tacot2u", "fscl-t2u", "fscl-t2u-e2e-tune", "fscl-t2u-da-tune",
                   "fscl-t2u-da-e2e-tune"]


@pytest.mark.parametrize("key", DATAMODULE_KEYS)
def test_t2u_datamodules_match(world, key):
    """The first three batches (episodes) of each T2U datamodule class."""
    jdc = [jax_config.read_data_config(world["t2u"]["b"])]
    pdc = [torch_config.read_data_config(world["t2u"]["b"])]
    jtrain = jax_config.TrainConfig(seed=5)
    ptrain = torch_config.TrainConfig(seed=5)
    jtrain = dataclasses.replace(jtrain, optim=dataclasses.replace(jtrain.optim, batch_size=3))
    ptrain = dataclasses.replace(ptrain, optim=dataclasses.replace(ptrain.optim, batch_size=3))
    jm = jdm.get_datamodule(key)(jdc, jax_config.ModelConfig(), jtrain, exp_dir="unused")
    pm = pdm.get_datamodule(key)(pdc, torch_config.ModelConfig(), ptrain, exp_dir="unused")
    assert type(pm).__name__ == type(jm).__name__
    jm.setup()
    pm.setup()
    for i, (got, want) in enumerate(zip(pm.train_batches(), jm.train_batches())):
        same(got, want, f"{key} batch {i}")
        if i == 2:
            break


def test_episodic_shard_raises_until_item_5(world, tmp_path):
    """A `.fscl.shard` beside the split is read since item 5: a file that is
    not a shard raises in setup, in both packages."""
    shutil.copytree(world["root"] / "b", tmp_path / "c")
    cfg = torch_config.read_data_config(str(tmp_path / "c" / "en" / "t2u.yaml"))
    cfg = dataclasses.replace(cfg, data_dir=str(tmp_path / "c" / "en" / "features"))
    (tmp_path / "c" / "en" / "splits" / "train.txt.fscl.shard").write_bytes(b"")
    dm = DATAMODULES.get("fscl-t2u")([cfg], torch_config.ModelConfig(),
                                     torch_config.TrainConfig(), exp_dir="unused")
    with pytest.raises(ValueError, match="not a packed shard"):
        dm.setup()
    jcfg = jax_config.read_data_config(str(tmp_path / "c" / "en" / "t2u.yaml"))
    jcfg = dataclasses.replace(jcfg, data_dir=cfg.data_dir)
    jm = jdm.get_datamodule("fscl-t2u")([jcfg], jax_config.ModelConfig(),
                                         jax_config.TrainConfig(), exp_dir="unused")
    with pytest.raises(ValueError, match="not a packed shard"):
        jm.setup()


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_t2u_episodic_datamodule_reads_the_support_from_a_shard(world, tmp_path, native):
    """With `pack --fscl` beside the split, T2UEpisodicDataModule serves the
    support side from the shard (C++ or numpy reader): episodes equal
    fscl_tpu's, whose loader reads the same shard."""
    shutil.copytree(world["root"] / "b", tmp_path / "c")
    t2u = str(tmp_path / "c" / "en" / "t2u.yaml")
    main(["pack", "--data_config", t2u, "--fscl"])
    pdc, jdc = torch_config.read_data_config(t2u), jax_config.read_data_config(t2u)
    pm = DATAMODULES.get("fscl-t2u")([pdc], torch_config.ModelConfig(),
                                     torch_config.TrainConfig(seed=2), exp_dir="unused",
                                     native_io=native)
    jm = jdm.get_datamodule("fscl-t2u")([jdc], jax_config.ModelConfig(),
                                         jax_config.TrainConfig(seed=2), exp_dir="unused")
    pm.setup()
    jm.setup()
    assert pm.pairs[0][2] is not None and pm.pairs[0][2].native == native
    assert jm.pairs[0][3] is not None
    for i, (got, want) in enumerate(zip(pm.train_batches(), jm.train_batches())):
        same(got, want, f"episode {i}")
        if i == 2:
            break


def _tiny_model_cfg(C):
    return dataclasses.replace(make_cfg(C), upstream=C.UpstreamConfig(
        name="custom", dim=64, n_layers=3), codebook=C.CodebookConfig(size=6, num_heads=2))


@pytest.mark.parametrize("key", T2U_KEYS)
def test_build_system_builds_each_t2u_key(world, key):
    """Every T2U key resolves through the factory to the class fscl_tpu's
    factory builds, on the asked device, with T2UConfig's defaults over
    the data's unit inventory."""
    pdc = [torch_config.read_data_config(world["t2u"]["b"])]
    extra = {}
    if "e2e" in key:
        extra["u2s_system"] = BaselineSystem(make_cfg(torch_config), ((UNITS, N_UNITS),),
                                             device="cpu")
    with torch.device("cpu"):
        system = pfactory.build_system(key, _tiny_model_cfg(torch_config),
                                       torch_config.OptimConfig(), pdc, device="cpu", **extra)
    assert type(system).__name__ == jfactory.SYSTEMS.get(key).__name__
    assert type(system) is SYSTEMS.get(key) and system.device.type == "cpu"
    assert system.t2u_cfg == pfactory.T2UConfig(n_units=len(pfrontend.LANG_ID2SYMBOLS[UNITS]))


@pytest.mark.parametrize("key", ["baseline", "fscl", "fscl-tune"])
def test_build_system_leaves_main_path_keys_to_train(world, key):
    """The factory builds the T2U keys only: the keys `train` builds on its
    main path raise, naming it."""
    dc = torch_config.read_data_config(world["data"]["b"])
    with pytest.raises(ValueError, match="_main_path"):
        pfactory.build_system(key, _tiny_model_cfg(torch_config), torch_config.OptimConfig(),
                              [dc], device="cpu")


def test_t2u_config_from_yaml_matches():
    for name in ("tacot2u.yaml", "fscl-t2u.yaml", "fscl-t2u-e2e.yaml"):
        path = os.path.join(REPO, "config", "model", name)
        got = torch_config.t2u_config_from_yaml(path, n_units=77)
        assert got._asdict() == jax_config.t2u_config_from_yaml(path, n_units=77)._asdict()
    assert got.encoder_embedding_dim != pfactory.T2UConfig().encoder_embedding_dim


def test_faults_copied_from_fscl_tpu(world):
    """ROADMAP Queue 3: (1) the factory's T2U keys ignore the model YAML's
    `tacotron2:` block (the CLI passes no t2u_cfg): encoder 512 where
    tacot2u.yaml says 256; (2) the E2E keys raise without a loaded u2s, and
    `train` passes none; (3) the FSCL-T2U systems build Downstream1 with
    its defaults (2 heads, d_ff 1024, dropout 0.1), not fscl-t2u.yaml's
    `downstream.transformer` block (nhead 4, ff 256, dropout 0.2)."""
    yaml = os.path.join(REPO, "config", "model", "tacot2u.yaml")
    jdc = [jax_config.read_data_config(world["t2u"]["b"])]
    pdc = [torch_config.read_data_config(world["t2u"]["b"])]
    jsys = jfactory.build_system("tacot2u", jax_config.model_config_from_yaml(yaml),
                                 jax_config.OptimConfig(), jdc)
    psys = pfactory.build_system("tacot2u", torch_config.model_config_from_yaml(yaml),
                                 torch_config.OptimConfig(), pdc, device="cpu")
    assert psys.t2u_cfg._asdict() == jsys.t2u_cfg._asdict()
    assert psys.t2u_cfg.encoder_embedding_dim == 512
    assert torch_config.t2u_config_from_yaml(yaml).encoder_embedding_dim == 256

    for key in ("fscl-t2u-e2e-tune", "fscl-t2u-da-e2e-tune"):
        with pytest.raises(AssertionError, match="need a loaded u2s"):
            jfactory.build_system(key, jax_config.ModelConfig(), jax_config.OptimConfig(), jdc)
        with pytest.raises(ValueError, match="need a loaded u2s"):
            pfactory.build_system(key, torch_config.ModelConfig(), torch_config.OptimConfig(),
                                  pdc, device="cpu")
        with pytest.raises(AssertionError, match="need a loaded u2s"):
            jax_main(["train", "--system", key, "--data_config", world["t2u"]["a"],
                      "--exp_dir", str(world["root"] / "unused")])
        with pytest.raises(ValueError, match="need a loaded u2s"):
            main(["train", "--system", key, "--data_config", world["t2u"]["b"],
                  "--exp_dir", str(world["root"] / "unused")] + CPU)

    fscl_yaml = os.path.join(REPO, "config", "model", "fscl-t2u.yaml")
    jcfg = jax_config.model_config_from_yaml(fscl_yaml)
    pcfg = torch_config.model_config_from_yaml(fscl_yaml)
    from fscl_tpu.systems.t2u import TransEmbT2USystem as J
    gen = J(jcfg, jax_config.OptimConfig(), 40, jsys.t2u_cfg).embedding_generator
    assert (gen.n_head, tuple(gen.d_ff), gen.dropout) == (2, (1024, 1024), 0.1)
    pcfg = dataclasses.replace(pcfg, upstream=dataclasses.replace(
        pcfg.upstream, name="custom", dim=64))
    with torch.device("cpu"):
        p = pfactory.build_system("fscl-t2u", pcfg, torch_config.OptimConfig(), pdc,
                                  device="cpu").embedding_generator
    assert [(b.n_head, b.ff1.out_features, b.dropout.p) for b in p.layers] == \
        [(2, 1024, 0.1)] * 2


def test_train_tacot2u_and_fscl_t2u_through_the_cli(world, tmp_path):
    """`train --system tacot2u` (T2UConfig's full-width defaults) and
    `train --system fscl-t2u` (a tiny custom upstream) through the port's
    cli.main on the CPU: two steps each, finite losses, a checkpoint (the
    FSCL one without the frozen upstream)."""
    overlay = tmp_path / "train.yaml"
    overlay.write_text("optimizer:\n  batch_size: 2\n  warm_up_step: 2\n"
                       "step:\n  total_step: 2\n  log_step: 1\n  save_step: 2\n")
    model = tmp_path / "fscl.yaml"
    model.write_text(FSCL_MODEL_YAML)
    runs = {"tacot2u": [], "fscl-t2u": ["--model_config", str(model)]}
    for key, extra in runs.items():
        exp = tmp_path / key
        system, state = main(["train", "--system", key, "--data_config", world["t2u"]["b"],
                              "--train_config", str(overlay), "--exp_dir", str(exp)]
                             + extra + CPU)
        assert type(system) is SYSTEMS.get(key) and state.step == 2
        with open(exp / "log" / "log.txt") as f:
            log = f.read()
        assert "step 2" in log and "nan" not in log.lower()
        saved = torch.load(exp / "ckpt" / "step_00000002" / "state.pt", weights_only=True)
        assert not any(k.startswith("upstream.") for k in saved["params"])
        assert any(k.startswith("model.decoder_cell.") for k in saved["params"])


def test_alignment_saver_writes_a_heatmap(world, tmp_path):
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.obs.t2u_saver import T2UAlignmentSaver
    pdc = [torch_config.read_data_config(world["t2u"]["b"])]
    dm = pdm.T2UDataModule(pdc, torch_config.ModelConfig(), torch_config.TrainConfig())
    dm.setup()
    tiny = pfactory.T2UConfig(n_units=len(pfrontend.LANG_ID2SYMBOLS[UNITS]), d_unit=8,
                              symbols_embedding_dim=8, encoder_embedding_dim=8, prenet_dim=8,
                              attention_rnn_dim=8, decoder_rnn_dim=8, attention_dim=4)
    system = TacoT2USystem(torch_config.ModelConfig(), pdm.build_id2symbols(pdc), tiny,
                           device="cpu")
    saver = T2UAlignmentSaver(str(tmp_path), system, synth_step=10)
    saver.on_validation_sample(20, None, to_device(next(dm.train_batches()), "cpu"))
    assert os.path.getsize(tmp_path / "step20_alignment.png") > 0


def test_fscl_t2u_episodes_keep_4_plus_2_through_the_generic_path(world):
    """ROADMAP Queue 3: `datamodule_kwargs_for` passes no shots or queries
    for the T2U keys, so `train --system fscl-t2u` episodes are 4 + 2 in
    both packages whatever config/algorithm/t2u/fscl.yaml says (32 + 8)."""
    path = os.path.join(REPO, "config", "algorithm", "t2u", "fscl.yaml")
    for C, dm_mod in ((jax_config, jdm), (torch_config, pdm)):
        algo = C.read_algorithm_config(path)
        assert (algo.adapt.shots, algo.adapt.queries) == (32, 8)
        kw = dm_mod.datamodule_kwargs_for("fscl-t2u", algo)
        assert kw == {}
        dm = dm_mod.get_datamodule("fscl-t2u")(
            [C.read_data_config(world["t2u"]["b"])], C.ModelConfig(), C.TrainConfig(),
            exp_dir="unused", **kw)
        assert (dm.shots, dm.queries) == (4, 2)


def test_serve_t2u_batches_chains_units_into_the_u2s(world):
    """Text -> units -> mel: each batch's units (0 from <eos> on), their
    counts and the u2s mels over them, in batches of up to 8 lines."""
    from fscl_tpu_torch.serve import serve_t2u_batches
    n_unit_symbols = len(pfrontend.LANG_ID2SYMBOLS[UNITS])
    tiny = pfactory.T2UConfig(n_units=n_unit_symbols, d_unit=8, symbols_embedding_dim=8,
                              encoder_embedding_dim=8, prenet_dim=8, attention_rnn_dim=8,
                              decoder_rnn_dim=8, attention_dim=4)
    torch.manual_seed(0)
    t2u = TacoT2USystem(torch_config.ModelConfig(), (("en", len(pfrontend.LANG_ID2SYMBOLS["en"])),),
                        tiny, device="cpu")
    u2s = BaselineSystem(make_cfg(torch_config), ((UNITS, n_unit_symbols),), device="cpu")
    lines = ["Hello there.", "A journey of a thousand miles.", "Yes."] * 3
    batches = list(serve_t2u_batches(t2u, u2s, lines, UNITS, max_steps=20))
    assert [b.lines for b in batches] == [list(range(8)), [8]]
    for b in batches:
        B = len(b.lines)
        assert b.units.shape == (B, 20) and b.postnet_mel.shape[0] == B
        for row in range(B):
            assert (b.units[row, b.n_units[row]:] == 0).all()
        assert torch.isfinite(b.postnet_mel).all() and (b.mel_len >= 0).all()


def test_serve_t2u_batches_chains_a_long_line(world):
    """A two-sentence line (over 128 symbols, so the L bucket 256) decodes
    all 10 L = 2560 unit positions and the u2s runs over them; the attention
    kernel's wrapper takes that length (it refuses the CPU tensors only)."""
    from fscl_tpu_torch.frontend import text_to_sequence
    from fscl_tpu_torch.ops import attention as tattn
    from fscl_tpu_torch.serve import CLEANERS, serve_t2u_batches
    n_unit_symbols = len(pfrontend.LANG_ID2SYMBOLS[UNITS])
    tiny = pfactory.T2UConfig(n_units=n_unit_symbols, d_unit=8, symbols_embedding_dim=8,
                              encoder_embedding_dim=8, prenet_dim=8, attention_rnn_dim=8,
                              decoder_rnn_dim=8, attention_dim=4)
    torch.manual_seed(1)
    t2u = TacoT2USystem(torch_config.ModelConfig(), (("en", len(pfrontend.LANG_ID2SYMBOLS["en"])),),
                        tiny, device="cpu")
    u2s = BaselineSystem(make_cfg(torch_config), ((UNITS, n_unit_symbols),), device="cpu")
    line = ("The committee will meet again on the 3rd of May to review the budget. "
            "Dr. Smith said the results were better than anyone had expected.")
    assert len(text_to_sequence(line, list(CLEANERS), "en")) > 128
    (b,) = serve_t2u_batches(t2u, u2s, [line], UNITS)
    assert b.units.shape == (1, 2560) and (b.units[0, b.n_units[0]:] == 0).all()
    assert b.postnet_mel.shape[0] == 1 and torch.isfinite(b.postnet_mel).all()
    q = torch.zeros(1, 2, 2560, 128)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tattn.attention_cuda(q, q, q, torch.ones(1, 2560, dtype=torch.bool))


def test_t2u_entry_points_ask_for_the_card(world):
    """Without `--device cpu` / `device="cpu"` the T2U entry points ask for
    the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="cuda"):
        TacoT2USystem(torch_config.ModelConfig(), (("en", 8),), pfactory.T2UConfig(n_units=8))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["make-units", world["features"]["b"], "--unit_name", "x", "--n_units", "4"])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["train", "--system", "tacot2u", "--data_config", world["t2u"]["b"],
              "--exp_dir", str(world["root"] / "unused")])
