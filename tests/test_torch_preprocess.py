"""The port's preprocessing (ops/stft.py, dsp/preprocess.py, the `preprocess`
command) and `synth --ref_wav` against fscl_tpu's, on the CPU in float32.

STFT and mel: `stft_magnitude` and `mel_spectrogram` against
`fscl_tpu.ops.stft` at B = 3 in the 2 s and 4 s wav buckets (a zero tail in
one row): magnitude max |d| <= 1e-5 of the peak magnitude (the FFT's
rounding on bins near zero is no relative measure; measured 2.1e-7), log-mel
atol 1e-4 (measured 3.8e-6), energy rtol 1e-5 (measured 1.4e-7); the
d-vector 40-mel at the log-mel bar.

Stage 2 end to end: a raw LJSpeech-layout corpus written from a seed (6
utterances of 1.2-3.6 s across the 2 s and 4 s buckets, with TextGrids,
`tests/torch_corpus.py:write_raw_corpus`) through `fscl_tpu.cli.main
(["preprocess", ...])` and the port's `cli.main([... "--device", "cpu"])`,
for each pitch method. Metadata, speakers, text, phonemes, segments,
`mfa_duration`, the trims and the splits equal exactly; mel, energy and
`spk_ref_mel_slices` within atol 1e-4 (measured 7.6e-6, 6.1e-5 at energies up
to 226, 1.2e-5); for the host methods (`world`, `yin`: the same C++ in both)
pitch, interpolated pitch and the duration-averaged pitch exactly equal,
`stats.json` within rtol 1e-5; for the device methods the F0 bars of
tests/test_torch_pitch.py. `preprocess_utterances_batched` equals
`preprocess_utterance` within atol 1e-5, as tests/test_dsp.py holds
fscl_tpu's.

The chain: `train` 3 steps from the port-written store against `train`
from the fscl_tpu-written store (the parity setup of tests/test_torch_cli.py:
fscl_tpu's initial weights, dropout off, lr 1e-4, eps 1e-3): losses within
1e-5 relative at step 1 and 1e-3 after. `synth --text --ref_wav` with a
d-vector model from the same weights in both packages: mels within atol
1e-3.
"""
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fscl_tpu.ops import stft as jstft
from fscl_tpu_torch.cli import main
from fscl_tpu_torch.data.feature_store import FeatureStore, read_queries_from_txt
from fscl_tpu_torch.dsp import preprocess as pp
from fscl_tpu_torch.ops import stft as pstft

from torch_corpus import MODEL_YAML, write_raw_corpus

SR = 22050
MAG_REL_PEAK, MEL_ATOL, ENERGY_RTOL = 1e-5, 1e-4, 1e-5
STORE_ATOL = 1e-4
STATS_RTOL = 1e-5
VOICING_AGREE, F0_MEDIAN_REL, F0_MAX_REL = 0.99, 1e-6, 1e-4
BATCHED_ATOL = 1e-5
FIRST_RTOL, LATER_RTOL = 1e-5, 1e-3
SYNTH_ATOL = 1e-3
METHODS = ("world", "yin", "world_device", "yin_device")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _wavs(seconds, seed, sr=SR):
    w = (0.3 * np.random.default_rng(seed).standard_normal((3, seconds * sr))).astype(np.float32)
    w[1, seconds * sr // 3:] = 0.0
    return w


@pytest.mark.parametrize("seconds", [2, 4])
def test_stft_and_mel_match_fscl_tpu(seconds):
    w = _wavs(seconds, seconds)
    mag = pstft.stft_magnitude(torch.from_numpy(w)).numpy()
    jmag = np.asarray(jstft.stft_magnitude(jnp.asarray(w)))
    assert mag.shape == jmag.shape == (3, 1 + seconds * SR // 256, 513)
    assert np.abs(mag - jmag).max() <= MAG_REL_PEAK * jmag.max()
    mel, energy = (t.numpy() for t in pstft.mel_spectrogram(torch.from_numpy(w)))
    jmel, jenergy = (np.asarray(t) for t in jstft.mel_spectrogram(jnp.asarray(w)))
    np.testing.assert_allclose(mel, jmel, atol=MEL_ATOL, rtol=0)
    np.testing.assert_allclose(energy, jenergy, rtol=ENERGY_RTOL, atol=0)
    assert (energy[1, -5:] == 0).all()
    np.testing.assert_allclose(pstft.hann_window(1024).numpy(),
                               np.asarray(jstft.hann_window(1024)), atol=1e-7, rtol=0)


@pytest.mark.parametrize("seconds", [2, 4])
def test_dvec_mel_matches_fscl_tpu(seconds):
    from fscl_tpu.dsp import preprocess as jpp
    w = _wavs(seconds, 10 + seconds, sr=16000)
    got = pp.dvec_mel(torch.from_numpy(w)).numpy()
    want = np.asarray(jpp._get_dvec_fn(w.shape[1])(jnp.asarray(w)))
    assert got.shape == want.shape == (3, 1 + seconds * 16000 // 160, 40)
    np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)
    slices = pp.dvec_mel_slices(w[0, :23456], device="cpu")
    np.testing.assert_allclose(slices, jpp.dvec_mel_slices(w[0, :23456]), atol=MEL_ATOL, rtol=0)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    return write_raw_corpus(str(root / "LJSpeech"), 6, 3, seconds=(1.2, 3.6))


@pytest.fixture(scope="module")
def stores(raw, tmp_path_factory):
    """method -> (fscl_tpu's store root, the port's), built at first use:
    both command lines on the same raw corpus."""
    from fscl_tpu.cli.__main__ import main as jmain
    corpus, tg = raw
    out = tmp_path_factory.mktemp("stores")
    built = {}

    def build(method):
        if method not in built:
            argv = ["preprocess", corpus, None, "--parser", "LJSpeech", "--parse_raw",
                    "--preprocess", "--create_dataset", "--textgrid_dir", tg,
                    "--pitch_method", method, "--n_workers", "1"]
            roots = str(out / f"jax-{method}"), str(out / f"port-{method}")
            jmain(argv[:2] + [roots[0]] + argv[3:])
            result = main(argv[:2] + [roots[1]] + argv[3:] + ["--device", "cpu"])
            assert result["n_ok"] == result["n_queries"] == 6
            built[method] = roots
        return built[method]
    return build


def _f0_held(got, want):
    agree = ((got > 0) == (want > 0)).mean()
    both = (got > 0) & (want > 0)
    rel = np.abs(got[both] - want[both]) / want[both]
    assert agree >= VOICING_AGREE and both.sum() > 0.3 * got.size, agree
    assert np.median(rel) <= F0_MEDIAN_REL and rel.max() <= F0_MAX_REL, (np.median(rel),
                                                                         rel.max())


@pytest.mark.parametrize("method", METHODS)
def test_store_matches_fscl_tpu(stores, method):
    jroot, proot = stores(method)
    J, P = FeatureStore(jroot), FeatureStore(proot)
    queries = J.load_metadata()
    assert queries == P.load_metadata() and len(queries) == 6
    assert J.load_speakers() == P.load_speakers() == ["LJSpeech"]
    for split in ("train", "val", "test"):
        assert (read_queries_from_txt(os.path.join(jroot, "splits", f"{split}.txt"))
                == read_queries_from_txt(os.path.join(proot, "splits", f"{split}.txt")))
    host = method in ("world", "yin")
    f0s = {"pitch": ([], []), "interpolate_pitch": ([], [])}
    for q in queries:
        for name in ("text", "phoneme", "mfa_segment"):
            assert getattr(P, name).read_from_query(q) == getattr(J, name).read_from_query(q)
        for name in ("mfa_duration", "wav_22050", "wav_16000", "wav_trim_22050",
                     "wav_trim_16000"):
            np.testing.assert_array_equal(getattr(P, name).read_from_query(q),
                                          getattr(J, name).read_from_query(q))
        for name in ("mel", "energy", "spk_ref_mel_slices", "mfa_duration_avg_energy"):
            got, want = getattr(P, name).read_from_query(q), getattr(J, name).read_from_query(q)
            assert got.shape == want.shape and got.dtype == want.dtype, name
            np.testing.assert_allclose(got, want, atol=STORE_ATOL, rtol=0, err_msg=name)
        for name in ("pitch", "interpolate_pitch", "mfa_duration_avg_pitch"):
            got, want = getattr(P, name).read_from_query(q), getattr(J, name).read_from_query(q)
            assert got.shape == want.shape, name
            if host:
                np.testing.assert_array_equal(got, want, err_msg=name)
            elif name in f0s:
                f0s[name][0].append(got)
                f0s[name][1].append(want)
    with open(J.stats_path) as f, open(P.stats_path) as g:
        jstats, pstats = json.load(f), json.load(g)
    if host:
        for key in ("pitch", "energy"):
            np.testing.assert_allclose(pstats[key], jstats[key], rtol=STATS_RTOL)
    else:
        _f0_held(np.concatenate(f0s["pitch"][0]), np.concatenate(f0s["pitch"][1]))


def test_batched_equals_per_utterance(stores, raw, tmp_path):
    """The batched stage 2 against the per-utterance one, both the port's,
    world_device (the device pass on every feature)."""
    _, proot = stores("world_device")
    src = FeatureStore(proot)
    queries = src.load_metadata()
    stores_ab = [FeatureStore(str(tmp_path / n)) for n in ("a", "b")]
    for st in stores_ab:
        for q in queries:
            st.wav_22050.save(src.wav_22050.read_from_query(q), q)
            st.wav_16000.save(src.wav_16000.read_from_query(q), q)
    items = [(q, os.path.join(raw[1], q["spk"], q["basename"] + ".TextGrid"))
             for q in queries]
    samples, ok = pp.preprocess_utterances_batched(stores_ab[0], items, pitch_method="world_device",
                                                   device="cpu", device_batch=4)
    assert ok == queries
    for q, path in items:
        pp.preprocess_utterance(stores_ab[1], q, path, pitch_method="world_device", device="cpu")
    a, b = stores_ab
    for q in queries:
        for name in ("mel", "energy", "pitch", "spk_ref_mel_slices", "mfa_duration"):
            np.testing.assert_allclose(getattr(a, name).read_from_query(q),
                                       getattr(b, name).read_from_query(q),
                                       atol=BATCHED_ATOL, rtol=0, err_msg=name)


def _data_yaml(root, tmp_path, name):
    path = tmp_path / f"{name}.yaml"
    path.write_text(f"name: {name}\nlang_id: 0\nsymbol_id: en\ndata_dir: {root}\n"
                    "text_cleaners: [basic_cleaners]\n"
                    f"subsets:\n  train: {root}/splits/train.txt\n  val: {root}/splits/val.txt\n")
    return str(path)


def test_train_from_port_store_matches_fscl_tpu_store(stores, tmp_path):
    from test_torch_cli import PARITY_TRAIN_YAML, _held, _run_jax, _run_port
    from torch_parity import NoDropout
    import flax.linen

    jroot, proot = stores("world")
    model = tmp_path / "model.yaml"
    model.write_text(MODEL_YAML)
    train = tmp_path / "train.yaml"
    train.write_text(PARITY_TRAIN_YAML.replace("batch_size: 4", "batch_size: 2"))
    args = ["train", "--system", "baseline", "--model_config", str(model),
            "--train_config", str(train)]
    with mock.patch.object(flax.linen, "Dropout", NoDropout):
        jrec = _run_jax(args + ["--data_config", _data_yaml(jroot, tmp_path, "j"),
                                "--exp_dir", str(tmp_path / "jax")])
        prec = _run_port(args + ["--data_config", _data_yaml(proot, tmp_path, "p"),
                                 "--exp_dir", str(tmp_path / "port")], jrec)
    assert prec["out"][1].step == 3
    for got, want in zip(prec["items"][:3], jrec["items"][:3]):
        np.testing.assert_array_equal(got.texts, np.asarray(want.texts))
        np.testing.assert_array_equal(got.durations, np.asarray(want.durations))
        np.testing.assert_allclose(got.mels, np.asarray(want.mels), atol=STORE_ATOL, rtol=0)
    _held(prec["losses"], jrec["losses"])


DVEC_YAML = MODEL_YAML + "speaker_emb: dvec\n"
LINE = "{HH AY1 W ER1 L D}"


def test_synth_ref_wav_matches_fscl_tpu(stores, raw, tmp_path):
    """The same d-vector weights in both packages (fscl_tpu's init with the
    duration head pinned near 4 frames, carried by convert.py), then
    `synth --text --ref_wav` with each command line."""
    from fscl_tpu.cli.__main__ import main as jmain
    from fscl_tpu.core import config as jconfig
    from fscl_tpu.core.checkpoint import CheckpointManager as JCheckpoint
    from fscl_tpu.data.batch import Batch, DvecRefs as JDvecRefs
    from fscl_tpu.systems.baseline import BaselineSystem as JBaseline
    from fscl_tpu_torch.convert import baseline_state_dict
    from fscl_tpu_torch.core import config as pconfig
    from fscl_tpu_torch.core.checkpoint import CheckpointManager
    from fscl_tpu_torch.systems.baseline import BaselineSystem

    _, proot = stores("world")
    model = tmp_path / "dvec.yaml"
    model.write_text(DVEC_YAML)
    jcfg = jconfig.model_config_from_yaml(str(model))
    id2symbols = (("en", 152),)
    L, T = 6, 64
    dummy = Batch(
        speaker_args=JDvecRefs(np.zeros((1, 10, 160, 40), np.float32),
                               np.ones((1, 10), np.float32)),
        texts=np.ones((1, L), np.int32), src_lens=np.asarray([L], np.int32),
        mels=np.zeros((1, T, 80), np.float32), mel_lens=np.asarray([T], np.int32),
        pitches=np.zeros((1, L), np.float32), energies=np.zeros((1, L), np.float32),
        durations=np.ones((1, L), np.int32), lang_ids=np.zeros(1, np.int32))
    state = JBaseline(jcfg, jconfig.OptimConfig(), id2symbols).init_state(
        jax.random.PRNGKey(3), dummy)
    params = jax.tree.map(np.array, state.params)
    lin = params["model"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    lin["bias"] = (lin["bias"] + np.log(4.0)).astype(np.float32)
    lin["kernel"] = (lin["kernel"] * 0.25).astype(np.float32)
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    JCheckpoint(str(tmp_path / "jckpt")).save(0, state)
    system = BaselineSystem(pconfig.model_config_from_yaml(str(model)), id2symbols,
                            device="cpu")
    system.load_state_dict(baseline_state_dict(
        {"params": params, "batch_stats": jax.tree.map(np.array, state.batch_stats)}),
        strict=True)
    CheckpointManager(str(tmp_path / "pckpt")).save(0, system, system.init_state())

    ref = os.path.join(raw[0], "wavs", FeatureStore(proot).load_metadata()[2]["basename"]
                       + ".wav")
    data = _data_yaml(proot, tmp_path, "d")
    common = ["synth", "--data_config", data, "--model_config", str(model), "--text", LINE,
              "--ref_wav", ref]
    seen = []
    import fscl_tpu.audio_out.vocoder as jvocoder
    with mock.patch.object(jvocoder, "griffin_lim",
                           lambda mel: seen.append(np.asarray(mel)) or np.zeros(256)):
        jmain(common + ["--ckpt_dir", str(tmp_path / "jckpt"), "--output",
                        str(tmp_path / "j.wav")])
    (mel,) = main(common + ["--ckpt_dir", str(tmp_path / "pckpt"), "--output",
                            str(tmp_path / "p.wav"), "--device", "cpu"])
    (want,) = seen
    assert want.shape == mel.shape and mel.shape[0] > 6 and np.isfinite(mel).all()
    np.testing.assert_allclose(mel, want, atol=SYNTH_ATOL, rtol=0)
    with pytest.raises(ValueError, match="--ref_wav"):
        main(common[:-2] + ["--ckpt_dir", str(tmp_path / "pckpt"), "--device", "cpu"])


def test_prepare_mfa_stage_matches_fscl_tpu(raw, tmp_path):
    from fscl_tpu.cli.__main__ import main as jmain
    corpus, _ = raw
    for name, run, extra in (("j", jmain, []), ("p", main, ["--device", "cpu"])):
        run(["preprocess", corpus, str(tmp_path / f"{name}-store"), "--parse_raw",
             "--prepare_mfa", str(tmp_path / f"{name}-mfa"), "--n_workers", "1"] + extra)
    jfiles = sorted(os.listdir(tmp_path / "j-mfa" / "LJSpeech"))
    assert jfiles == sorted(os.listdir(tmp_path / "p-mfa" / "LJSpeech")) and len(jfiles) == 12
    for f in jfiles:
        assert ((tmp_path / "j-mfa" / "LJSpeech" / f).read_bytes()
                == (tmp_path / "p-mfa" / "LJSpeech" / f).read_bytes())


def test_preprocess_asks_for_what_it_needs(raw, tmp_path):
    corpus, _ = raw
    with pytest.raises(ValueError, match="textgrid_dir"):
        main(["preprocess", corpus, str(tmp_path / "s"), "--preprocess", "--device", "cpu"])
    with pytest.raises(ValueError, match="output_dir"):
        main(["preprocess", "--parse_raw", "--device", "cpu"])
    with pytest.raises(ValueError, match="pitch method"):
        pp.preprocess_utterances_batched(FeatureStore(str(tmp_path / "s")), [],
                                         pitch_method="crepe", device="cpu")
