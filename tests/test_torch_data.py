"""Parity of the port's data layer with fscl_tpu, on the CPU.

Two kinds of store: one written with numpy through the port's FeatureStore
(tests/torch_corpus.py: two corpora, `en` and `zh`, two speakers each), and
one built by fscl_tpu's own preprocessing (`dsp/preprocess.py:
preprocess_utterance` over synthetic wavs and TextGrids, as the fixture of
tests/test_cli_train_synth.py builds it). Each package reads both.

Exact, with no tolerance: every dataset item, the samplers' index lists,
datamodule batches (fscl_tpu with `native_io=False`, the path the port
ports), episodes, task descriptions, the symbol tables and offsets. The same
numpy reads and the same host arithmetic give the same bytes.

The slice as a whole: both packages' datamodules feed both trainers from
the same weights (fscl_tpu's init through `convert.py`) for 3 steps
(FastSpeech2DataModule into the BaselineSystems; FSCLDataModule's episodes,
table speakers, into the TransEmbSystems with their upstream), every
dropout off (flax's Dropout replaced by the identity in this module, the
port's PostNet dropout at 0; JAX's dropout draws cannot be reproduced), at
lr 1e-4 and eps 1e-3 (tests/test_torch_train.py's reasons); the losses held
to that file's bars, 1e-5 relative at step 1 and 1e-3 after. Then the
port's checkpoint restored into a fresh system synthesizes the mel of
fscl_tpu's trained system within 1e-3 (card vs CPU's bar: the same f32
forward in another summation order, after parameters that moved by
rounding-level amounts apart).
"""
import dataclasses
import itertools
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as JC
import fscl_tpu_torch.core.config as PC
from fscl_tpu.data import datamodules as jdm
from fscl_tpu.data import datasets as jds
from fscl_tpu.data import episodic as jep
from fscl_tpu.data import feature_store as jfs
from fscl_tpu.data import samplers as jsam
from fscl_tpu.data.batch import Batch as JaxBatch
from fscl_tpu.data.batch import collate_batch as jax_collate_batch
from fscl_tpu.systems.baseline import BaselineSystem as JaxBaseline
from fscl_tpu_torch.convert import baseline_state_dict
from fscl_tpu_torch.core.checkpoint import CheckpointManager
from fscl_tpu_torch.data import datamodules as pdm
from fscl_tpu_torch.data import datasets as pds
from fscl_tpu_torch.data import episodic as pep
from fscl_tpu_torch.data import feature_store as pfs
from fscl_tpu_torch.data import samplers as psam
from fscl_tpu_torch.dsp import audio_io as paudio
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.train.trainer import Trainer

from torch_corpus import write_corpus
from torch_parity import ID2SYMBOLS, Losses, NoDropout, init_jax_variables, make_cfg, same

FIRST_RTOL, LATER_RTOL = 1e-5, 1e-3
MEL_ATOL = 1e-3
SHOTS, QUERIES = 4, 2


@pytest.fixture(scope="module", autouse=True)
def _no_dropout_few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", NoDropout)
        yield
    torch.set_num_threads(before)


# -- stores -------------------------------------------------------------------------

PHONES = ["HH", "AY1", "W", "ER1", "L", "D"]


def synth_textgrid(phones, seg_dur=0.12, lead=0.05):
    """An ooTextFile long-format TextGrid (tests/test_cli_train_synth.py)."""
    xmax = lead + len(phones) * seg_dur + 0.05
    intervals = [(0.0, lead, "")]
    t = lead
    for p in phones:
        intervals.append((t, t + seg_dur, p))
        t += seg_dur
    intervals.append((t, xmax, ""))
    body = "".join(
        f"        intervals [{i+1}]:\n            xmin = {a}\n            xmax = {b}\n"
        f"            text = \"{p}\"\n" for i, (a, b, p) in enumerate(intervals))
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
            f"xmin = 0\nxmax = {xmax}\ntiers? <exists>\nsize = 1\nitem []:\n"
            "    item [1]:\n        class = \"IntervalTier\"\n        name = \"phones\"\n"
            f"        xmin = 0\n        xmax = {xmax}\n"
            f"        intervals: size = {len(intervals)}\n" + body)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two numpy-written corpora (port FeatureStore): en and zh."""
    root = str(tmp_path_factory.mktemp("torch_data"))
    return (write_corpus(root, "en-mini", "en", 0, 11, n_train=12, n_val=5),
            write_corpus(root, "zh-mini", "zh", 1, 12, n_train=10, n_val=4))


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """A corpus preprocessed by fscl_tpu (wavs + TextGrids through
    `preprocess_utterance`), with its data config."""
    from fscl_tpu.dsp.audio_io import save_wav
    from fscl_tpu.dsp.preprocess import (
        compute_stats, prepare_initial_features, preprocess_utterance,
    )
    root = tmp_path_factory.mktemp("jax_corpus")
    store = jfs.FeatureStore(str(root / "features"))
    rng = np.random.default_rng(0)
    sr = 22050
    queries, samples = [], []
    for i in range(3):
        phones = [PHONES[int(j)] for j in rng.integers(0, len(PHONES), 5)]
        t = np.arange(int(sr * (0.05 + 5 * 0.12 + 0.05))) / sr
        wav = (0.4 * np.sin(2 * np.pi * (150 + 20 * i) * t)
               + 0.05 * rng.normal(size=len(t))).astype(np.float32)
        save_wav(str(root / f"u{i}.wav"), wav, sr)
        with open(root / f"u{i}.TextGrid", "w") as f:
            f.write(synth_textgrid(phones))
        q = {"spk": "spk0", "basename": f"u{i}"}
        prepare_initial_features(store, q, str(root / f"u{i}.wav"), "dummy")
        samples.append(preprocess_utterance(store, q, str(root / f"u{i}.TextGrid")))
        queries.append(q)
    compute_stats(samples, store)
    store.save_speakers(["spk0"])
    store.save_metadata(queries)
    store.flush()
    jfs.write_queries_to_txt(store, queries, str(root / "splits" / "train.txt"))
    with open(root / "data.yaml", "w") as f:
        f.write(f"name: jax-mini\nlang_id: 0\nsymbol_id: en\ndata_dir: {store.root}\n"
                "text_cleaners: [basic_cleaners]\nsubsets:\n  train: splits/train.txt\n")
    return str(root / "data.yaml")


def _dc(path):
    return JC.read_data_config(path), PC.read_data_config(path)


def _model_cfgs(**kw):
    return JC.ModelConfig(**kw.get("jax", {})), PC.ModelConfig(**kw.get("port", {}))


# -- feature store and audio IO ----------------------------------------------------

@pytest.mark.parametrize("which", ["numpy_written", "fscl_tpu_preprocessed"])
def test_feature_store_reads_the_same_in_both_packages(corpora, jax_store, which):
    path = corpora[0] if which == "numpy_written" else jax_store
    dc = JC.read_data_config(path)
    js, ps = jfs.FeatureStore(dc.data_dir), pfs.FeatureStore(dc.data_dir)
    same(ps.load_metadata(), js.load_metadata(), "data_info")
    same(ps.load_speakers(), js.load_speakers(), "speakers")
    queries = pfs.read_queries_from_txt(dc.subset_path("train"))
    same(queries, jfs.read_queries_from_txt(dc.subset_path("train")), "queries")
    for q in queries:
        for name in pfs.ARRAY_FEATURES:
            feat = getattr(ps, name)
            assert feat.exists(q) == getattr(js, name).exists(q), name
            if feat.exists(q):
                same(feat.read_from_query(q), getattr(js, name).read_from_query(q), name)
        for name in pfs.JSON_FEATURES:
            same(getattr(ps, name).read_from_query(q), getattr(js, name).read_from_query(q), name)
    assert pfs.ARRAY_FEATURES == jfs.ARRAY_FEATURES and pfs.JSON_FEATURES == jfs.JSON_FEATURES


def test_feature_store_writes_what_fscl_tpu_reads(tmp_path):
    rng = np.random.default_rng(3)
    ps = pfs.FeatureStore(str(tmp_path / "s"))
    q = {"spk": "a", "basename": "b"}
    mel = rng.normal(size=(7, 80)).astype(np.float32)
    ps.mel.save(mel, q)
    ps.phoneme.save("AA1 B", q)
    units = ps.get_ssl_unit_store("u8")
    units.duration.save(np.arange(3), q)
    units.phoneme.save("1 2 3", q)
    units.save_attrs({"n_units": 8})
    ps.flush()
    js = jfs.FeatureStore(str(tmp_path / "s"))
    same(js.mel.read_from_query(q), mel)
    assert js.phoneme.read_from_query(q) == "AA1 B"
    ju = js.get_ssl_unit_store("u8")
    same(ju.duration.read_from_query(q), np.arange(3))
    assert ju.phoneme.read_from_query(q) == "1 2 3" and ju.load_attrs() == {"n_units": 8}


def test_audio_io_matches(tmp_path):
    from fscl_tpu.dsp import audio_io as jaudio
    wav = (0.5 * np.sin(np.arange(4000) / 7.0)).astype(np.float32)
    paudio.save_wav(str(tmp_path / "p.wav"), wav, 22050)
    jaudio.save_wav(str(tmp_path / "j.wav"), wav, 22050)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    for sr in (22050, 16000):
        same(paudio.load_wav(str(tmp_path / "j.wav"), sr), jaudio.load_wav(str(tmp_path / "p.wav"), sr))
    same(paudio.wav_normalization(wav), jaudio.wav_normalization(wav))


# -- datasets ------------------------------------------------------------------------

def _pair(cls_name, path, model_kw=None, **kw):
    jdc, pdc = _dc(path)
    jm = JC.ModelConfig(**(model_kw or {}))
    pm = PC.ModelConfig(**{k: getattr(PC, type(v).__name__)(**dataclasses.asdict(v))
                           for k, v in (model_kw or {}).items()})
    jstore, pstore = jfs.FeatureStore(jdc.data_dir), pfs.FeatureStore(pdc.data_dir)
    split = jdc.subset_path("train")
    return (getattr(pds, cls_name)(split, pstore, pdc, pm, **kw),
            getattr(jds, cls_name)(split, jstore, jdc, jm, **kw))


FRAME_LEVEL = {"variance": JC.VarianceConfig(pitch_feature="frame_level",
                                             energy_feature="frame_level")}


@pytest.mark.parametrize("cls_name,store,model_kw,kw", [
    ("FastSpeech2Dataset", "numpy", None, {}),
    ("FastSpeech2Dataset", "numpy", None, {"spk_refer_wav": True}),
    ("FastSpeech2Dataset", "numpy", None, {"id_offset": 152, "speaker_offset": 2}),
    ("FastSpeech2Dataset", "preprocessed", None, {}),
    ("FastSpeech2Dataset", "preprocessed", FRAME_LEVEL, {}),
    ("FSCLDataset", "numpy", None, {}),
    ("FSCLDataset", "numpy", None, {"spk_refer_wav": True}),
    ("FSCLDataset", "numpy", None, {"upstream": "mel"}),
    ("FSCLDataset", "preprocessed", None, {"spk_refer_wav": True}),
], ids=["fs2", "fs2_spk_refer_wav", "fs2_offsets", "fs2_preprocessed",
        "fs2_preprocessed_frame_level", "fscl", "fscl_spk_refer_wav", "fscl_mel_upstream",
        "fscl_preprocessed"])
def test_dataset_items_match(corpora, jax_store, cls_name, store, model_kw, kw):
    path = corpora[0] if store == "numpy" else jax_store
    port, ref = _pair(cls_name, path, model_kw, **kw)
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        same(port[i], ref[i], f"{cls_name}[{i}]")


def test_concat_and_text_datasets_match(corpora):
    ports, refs = zip(*(_pair("FastSpeech2Dataset", p) for p in corpora))
    port, ref = pds.ConcatDataset(ports), jds.ConcatDataset(refs)
    assert len(port) == len(ref) == 22
    for i in range(len(ref)):
        same(port[i], ref[i], f"concat[{i}]")
    jdc, pdc = _dc(corpora[1])
    split = jdc.subset_path("val")
    tp, tj = pds.TextDataset(split, pdc), jds.TextDataset(split, jdc)
    for i in range(len(tj)):
        same(tp[i], tj[i], f"text[{i}]")


def test_segment_to_duration_matches():
    rng = np.random.default_rng(1)
    seg = np.cumsum(rng.uniform(0.005, 0.2, 40))
    segment = list(zip(np.concatenate([[0.0], seg[:-1]]), seg))
    for fp in (0.02, 256 / 22050):
        assert pds.segment_to_duration(segment, fp) == jds.segment_to_duration(segment, fp)


# -- samplers and episodes ----------------------------------------------------------------

@pytest.mark.parametrize("bs,drop_last,seed", [(4, False, 43), (3, True, 7), (16, False, 0)])
def test_group_batch_sampler_matches(bs, drop_last, seed):
    lengths = np.random.default_rng(seed).integers(5, 200, 77).tolist()
    p = psam.GroupBatchSampler(lengths, bs, seed=seed, drop_last=drop_last)
    j = jsam.GroupBatchSampler(lengths, bs, seed=seed, drop_last=drop_last)
    for _ in range(2):       # two epochs from one rng
        assert list(p) == list(j)
    assert len(p) == len(j)
    assert psam.maybe_distribute(p) is p


def test_episodic_sampler_matches():
    labels = [0] * 9 + [1] * 4 + ["x"] * 12
    p, j = pep.EpisodicSampler(labels, 3, 2, seed=5), jep.EpisodicSampler(labels, 3, 2, seed=5)
    assert p.labels == j.labels
    assert [p.sample_task() for _ in range(6)] == [j.sample_task() for _ in range(6)]
    pi, ji = p.infinite(), j.infinite()
    assert [next(pi) for _ in range(5)] == [next(ji) for _ in range(5)]
    assert p.fixed_tasks(3) == j.fixed_tasks(3)
    assert pep.WAV_BUCKETS == jep.WAV_BUCKETS


def test_descriptions_written_by_one_package_load_in_the_other(tmp_path):
    labels = [0] * 10 + [1] * 10
    tasks = pep.get_or_create_tasks(pep.EpisodicSampler(labels, 2, 1, seed=3), 2,
                                    str(tmp_path / "p" / "val_descriptions.json"))
    assert jep.load_descriptions(str(tmp_path / "p" / "val_descriptions.json")) == tasks
    jtasks = jep.get_or_create_tasks(jep.EpisodicSampler(labels, 2, 1, seed=9), 2,
                                     str(tmp_path / "j" / "val_descriptions.json"))
    # an existing file wins over the sampler in both packages
    assert pep.get_or_create_tasks(pep.EpisodicSampler(labels, 2, 1, seed=1), 2,
                                   str(tmp_path / "j" / "val_descriptions.json")) == jtasks
    assert tasks == pep.EpisodicSampler(labels, 2, 1, seed=3).fixed_tasks(2)
    assert pep.load_descriptions(str(tmp_path / "none.json")) is None
    ids = [f"u{i}" for i in range(20)]
    assert pep.build_sqids(tasks, ids, str(tmp_path / "p" / "SQids.json")) == \
        jep.build_sqids(tasks, ids)


def test_collates_and_symbol_tables_match(corpora):
    port, ref = _pair("FSCLDataset", corpora[0], spk_refer_wav=True)
    rng = np.random.default_rng(4)
    for _ in range(3):
        idxs = rng.choice(len(ref), SHOTS + QUERIES, replace=False)
        ps, js = [port[int(i)] for i in idxs], [ref[int(i)] for i in idxs]
        assert pep.split_sup_qry(ps, SHOTS, QUERIES) == jep.split_sup_qry(js, SHOTS, QUERIES)
        for wav_dtype in ("float32", "int16"):
            same(pep.collate_sup_info(ps, wav_dtype=wav_dtype),
                 jep.collate_sup_info(js, wav_dtype=wav_dtype), "sup_info")
        same(pep.collate_episode(ps, SHOTS, QUERIES), jep.collate_episode(js, SHOTS, QUERIES),
             "episode")
        kw = {"pitch_feature": "phoneme_level", "energy_feature": "phoneme_level"}
        same(pep.collate_episode(ps, SHOTS, QUERIES, var_kw=kw, bucket=False),
             jep.collate_episode(js, SHOTS, QUERIES, var_kw=kw, bucket=False), "episode")
        for flags in ({"with_sup_batch": True}, {"with_qry_wavs": True},
                      {"with_sup_batch": True, "with_qry_wavs": True}):
            got = pep.collate_episode(ps, SHOTS, QUERIES, var_kw=kw, **flags)
            same(got, jep.collate_episode(js, SHOTS, QUERIES, var_kw=kw, **flags),
                 f"episode {flags}")
            assert type(got).__name__ == ("SSLEpisode" if "with_qry_wavs" in flags else "Episode")
    dcs = [PC.read_data_config(p) for p in corpora + corpora[:1]]
    jdcs = [JC.read_data_config(p) for p in corpora + corpora[:1]]
    id2symbols = pdm.build_id2symbols(dcs)
    assert id2symbols == jdm.build_id2symbols(jdcs) == (("en", 152), ("zh", 225))
    assert pdm.symbol_offsets(id2symbols) == jdm.symbol_offsets(id2symbols)
    pm, jm = pep.ReIdMapper(id2symbols), jep.ReIdMapper(id2symbols)
    assert pm.n_symbols == jm.n_symbols and pm.increment == jm.increment
    ph = np.arange(1, 9)
    same(pm(ph, "zh"), jm(ph, "zh"))


# -- datamodules ----------------------------------------------------------------------

def _train_cfgs(bs=4, seed=43):
    return (JC.TrainConfig(optim=JC.OptimConfig(batch_size=bs), seed=seed),
            PC.TrainConfig(optim=PC.OptimConfig(batch_size=bs), seed=seed))


@pytest.mark.parametrize("speaker", ["table", "dvec"])
def test_fastspeech2_datamodule_matches(corpora, tmp_path, speaker):
    jdcs = [JC.read_data_config(p) for p in corpora]
    pdcs = [PC.read_data_config(p) for p in corpora]
    jt, pt = _train_cfgs()
    jmc = JC.ModelConfig(speaker=JC.SpeakerConfig(emb_type=speaker, n_speakers=4))
    pmc = PC.ModelConfig(speaker=PC.SpeakerConfig(emb_type=speaker, n_speakers=4))
    j = jdm.FastSpeech2DataModule(jdcs, jmc, jt, exp_dir=str(tmp_path / "j"), native_io=False)
    p = pdm.FastSpeech2DataModule(pdcs, pmc, pt, exp_dir=str(tmp_path / "p"))
    j.setup()
    p.setup()
    assert p.id2symbols == j.id2symbols and p.offsets == j.offsets
    jb, pb = j.train_batches(), p.train_batches()
    for i in range(5):     # 22 utterances at B = 4: the second epoch starts at batch 6
        same(next(pb), next(jb), f"train batch {i}")
    same(p.full_train_batch(), j.full_train_batch(), "full_train_batch")
    same(p.full_train_batch(max_utts=8), j.full_train_batch(max_utts=8), "over max_utts")
    jv, pv = j.val_batches(), p.val_batches()
    assert len(pv) == len(jv) == 3
    same(pv, jv, "val_batches")
    assert isinstance(pdm.get_datamodule("fscl-tune"), type) and \
        pdm.get_datamodule("baseline") is pdm.FastSpeech2DataModule


def _fscl_dms(corpora, tmp_path, speaker="table"):
    jdcs = [JC.read_data_config(p) for p in corpora]
    pdcs = [PC.read_data_config(p) for p in corpora]
    jt, pt = _train_cfgs(seed=5)
    jmc = JC.ModelConfig(speaker=JC.SpeakerConfig(emb_type=speaker, n_speakers=4))
    pmc = PC.ModelConfig(speaker=PC.SpeakerConfig(emb_type=speaker, n_speakers=4))
    kw = dict(shots=SHOTS, queries=QUERIES, n_tasks_per_label=2)
    j = jdm.FSCLDataModule(jdcs, jmc, jt, exp_dir=str(tmp_path / "j"), **kw)
    p = pdm.FSCLDataModule(pdcs, pmc, pt, exp_dir=str(tmp_path / "p"), **kw)
    j.setup()
    p.setup()
    return j, p


def test_fscl_datamodule_episodes_match(corpora, tmp_path):
    j, p = _fscl_dms(corpora, tmp_path)
    jb, pb = j.train_batches(), p.train_batches()
    for i in range(4):
        same(next(pb), next(jb), f"train episode {i}")
    pv, jv = p.val_batches(), j.val_batches()
    assert len(pv) == len(jv) == 4
    same(pv, jv, "val episodes")
    # each package replays the other's persisted val tasks
    assert jep.load_descriptions(str(tmp_path / "p" / "val_descriptions.json")) == \
        pep.load_descriptions(str(tmp_path / "j" / "val_descriptions.json"))
    kw = pdm.datamodule_kwargs_for("maml", PC.read_algorithm_config(
        os.path.join(os.path.dirname(__file__), "..", "config", "algorithm", "language",
                     "fscl.yaml")))
    assert kw == jdm.datamodule_kwargs_for("maml", JC.read_algorithm_config(
        os.path.join(os.path.dirname(__file__), "..", "config", "algorithm", "language",
                     "fscl.yaml")))


def test_fscl_datamodule_gives_dvec_models_their_reference_slices(corpora, tmp_path):
    """A repair against fscl_tpu: under `speaker_emb: dvec` its FSCL episodes
    carry speaker ids, which its TransEmbSystem cannot embed; the port's carry
    the reference mel slices, as fscl_tpu's collate_batch pads them for the
    same query samples. Everything else in the episode is fscl_tpu's."""
    j, p = _fscl_dms(corpora, tmp_path, speaker="dvec")
    pe, je = next(p.train_batches()), next(j.train_batches())
    same(pe.sup, je.sup, "sup")
    assert np.asarray(je.qry.speaker_args).ndim == 1       # fscl_tpu: ids
    same(pe.qry._replace(speaker_args=None), je.qry._replace(speaker_args=None), "qry")
    idxs = jep.EpisodicSampler(
        [d.config.lang_id for d in j.train_set.datasets for _ in range(len(d))], SHOTS, QUERIES,
        seed=5).sample_task()
    jset = jds.ConcatDataset([jds.FSCLDataset(d.config.subset_path("train"), d.store, d.config,
                                              d.model_cfg, spk_refer_wav=True)
                              for d in j.train_set.datasets])
    samples = [jset[i] for i in idxs]
    _, qry_ids = jep.split_sup_qry(samples, SHOTS, QUERIES)
    want = jax_collate_batch([samples[i] for i in qry_ids], dvec_slices=10)[1].speaker_args
    same(pe.qry.speaker_args, want, "DvecRefs")


# -- the slice as a whole ----------------------------------------------------------------

def _slice_cfg(C):
    cfg = make_cfg(C)
    return dataclasses.replace(
        cfg, max_seq_len=256,
        transformer=dataclasses.replace(cfg.transformer, encoder_dropout=0.0, decoder_dropout=0.0),
        variance_predictor=dataclasses.replace(cfg.variance_predictor, dropout=0.0))


def test_datamodules_train_and_synthesize_like_fscl_tpu(corpora, tmp_path):
    from fscl_tpu.train.trainer import Trainer as JaxTrainer

    kw = dict(lr=1e-4, eps=1e-3, warmup_step=2, anneal_steps=(), batch_size=3)
    jcfg, pcfg = _slice_cfg(JC), _slice_cfg(PC)
    jtrain = JC.TrainConfig(optim=JC.OptimConfig(**kw), total_step=3, log_step=1,
                            val_step=10**9, save_step=10**9, seed=3)
    ptrain = PC.TrainConfig(optim=PC.OptimConfig(**kw), total_step=3, log_step=1,
                            val_step=10**9, save_step=10**9, seed=3)
    jdc, pdc = _dc(corpora[0])
    j = jdm.FastSpeech2DataModule([jdc], jcfg, jtrain, exp_dir=str(tmp_path), native_io=False)
    p = pdm.FastSpeech2DataModule([pdc], pcfg, ptrain, exp_dir=str(tmp_path))
    j.setup()
    p.setup()

    _, variables = init_jax_variables(jcfg)
    jsys = JaxBaseline(jcfg, jtrain.optim, ID2SYMBOLS)
    state = jsys.init_state(jax.random.PRNGKey(0), next(j.train_batches()))
    state = state.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    jrec = Losses()
    state = JaxTrainer(jsys, jtrain, callbacks=[jrec]).fit(state, j.train_batches())

    psys = BaselineSystem(pcfg, ID2SYMBOLS, device="cpu", optim_cfg=ptrain.optim)
    psys.load_state_dict(baseline_state_dict(variables), strict=True)
    psys.model.postnet.dropout.p = 0.0
    prec = Losses()
    pstate = Trainer(psys, ptrain, [prec]).fit(psys.init_state(), p.train_batches())
    assert pstate.step == int(state.step) == 3
    np.testing.assert_allclose(prec.losses[0], jrec.losses[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(prec.losses[1:], jrec.losses[1:], rtol=LATER_RTOL)

    # warm start from the port's checkpoint (what `synth` restores), both
    # systems on their fresh BatchNorm statistics
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(pstate.step, psys, pstate)
    fresh = BaselineSystem(pcfg, ID2SYMBOLS, device="cpu")
    mgr.restore_into(fresh)
    for k, v in psys.named_parameters():
        assert torch.equal(dict(fresh.named_parameters())[k], v), k
    batch = next(j.train_batches())
    T = 128
    fresh_stats = jsys.init_variables(jax.random.PRNGKey(1), JaxBatch(*map(jnp.asarray, batch)))
    jout = jsys.synthesize(state.params, fresh_stats["batch_stats"], jnp.asarray(batch.texts),
                           jnp.asarray(batch.src_lens), T, jnp.asarray(batch.speaker_args),
                           jnp.asarray(batch.lang_ids), symbol_id="en")
    pout = fresh.synthesize(batch.texts, batch.src_lens, T, batch.speaker_args, batch.lang_ids,
                            symbol_id="en")
    np.testing.assert_array_equal(pout.mel_len.numpy(), np.asarray(jout.mel_len))
    np.testing.assert_allclose(pout.postnet_mel.numpy(), np.asarray(jout.postnet_mel),
                               atol=MEL_ATOL, rtol=0)


def _fscl_slice_cfg(C):
    return dataclasses.replace(
        _slice_cfg(C), speaker=C.SpeakerConfig(emb_type="table", n_speakers=4),
        codebook=C.CodebookConfig(size=8, num_heads=2, dim=64),
        upstream=C.UpstreamConfig(name="custom", dim=32, n_layers=3))


def test_fscl_datamodule_trains_like_fscl_tpu(corpora, tmp_path):
    """FSCLDataModule's episodes (table speakers, two languages) through
    both packages' TransEmbSystem and Trainer for 3 episodes, from
    fscl_tpu's init (upstream included) carried by `convert.py`."""
    from fscl_tpu.systems.fscl import TransEmbSystem as JaxTransEmb
    from fscl_tpu.train.trainer import Trainer as JaxTrainer
    from fscl_tpu_torch.convert import transemb_state_dict
    from fscl_tpu_torch.systems.fscl import TransEmbSystem

    kw = dict(lr=1e-4, eps=1e-3, warmup_step=2, anneal_steps=())
    steps = dict(total_step=3, log_step=1, val_step=10**9, save_step=10**9, seed=5)
    jtrain = JC.TrainConfig(optim=JC.OptimConfig(**kw), **steps)
    ptrain = PC.TrainConfig(optim=PC.OptimConfig(**kw), **steps)
    jcfg, pcfg = _fscl_slice_cfg(JC), _fscl_slice_cfg(PC)
    dm_kw = dict(shots=SHOTS, queries=QUERIES)
    j = jdm.FSCLDataModule([JC.read_data_config(c) for c in corpora], jcfg, jtrain,
                           exp_dir=str(tmp_path / "j"), **dm_kw)
    p = pdm.FSCLDataModule([PC.read_data_config(c) for c in corpora], pcfg, ptrain,
                           exp_dir=str(tmp_path / "p"), **dm_kw)
    j.setup()
    p.setup()
    episodes = j.train_batches()      # the sampler is shared: one stream, its first
    example = next(episodes)          # episode initialises the system and trains first
    n_symbols = example.sup.n_symbols
    jsys = JaxTransEmb(jcfg, jtrain.optim, n_symbols)
    state = jsys.init_state(jax.random.PRNGKey(0), example)
    variables = jax.tree.map(np.array, {"params": state.params, "batch_stats": state.batch_stats,
                                        "frozen": state.frozen})
    jrec = Losses()
    JaxTrainer(jsys, jtrain, callbacks=[jrec]).fit(state, itertools.chain([example], episodes))

    psys = TransEmbSystem(pcfg, n_symbols, device="cpu", optim_cfg=ptrain.optim)
    psys.load_state_dict(transemb_state_dict(variables), strict=True)
    psys.model.postnet.dropout.p = 0.0
    prec = Losses()
    pstate = Trainer(psys, ptrain, [prec]).fit(psys.init_state(), p.train_batches())
    assert pstate.step == 3 and len(prec.losses) == len(jrec.losses) == 3
    np.testing.assert_allclose(prec.losses[0], jrec.losses[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(prec.losses[1:], jrec.losses[1:], rtol=LATER_RTOL)
