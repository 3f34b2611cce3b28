"""Observability of the port against fscl_tpu's `obs/`, on the CPU.

- `ExperimentTracker`: the same calls in both packages write the same
  files (meta.json without its timestamp, metrics.jsonl, the assets' names
  and bytes), resume under the same key (`resumed` counts), and hand the
  sink the same scalars.
- `SynthSaver` (Griffin-Lim) on the same weights and batch: the same file
  names; the reconstructed and synthesized mels within 1e-5 and their
  de-normalised pitch / energy overlays within 1e-4 (f32 forwards of the
  2 + 2 layer trunk, as tests/test_torch_fastspeech2.py holds them); the
  wavs within 2e-3 after 16-bit PCM (one LSB is 3e-5).
- `FSCLSaver` on the same TransEmbSystem: the same file names, the codebook
  attention per head within 1e-6 and the layer weights within 1e-6.
- `CodebookAnalyzer`: the transfer table and the cross-lingual similarity
  equal to fscl_tpu's on the same arrays (similarity 1e-6).
- the figures write PNGs; `write_figures=False` writes none and still does
  the device work (chip_smoke.py's path where matplotlib is missing).
"""
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import fscl_tpu.core.config as jax_config
import fscl_tpu.obs.synth_saver as jsynth
import fscl_tpu_torch.core.config as torch_config
from fscl_tpu.data.batch import Batch as JaxBatch
from fscl_tpu.data.batch import SupInfo as JaxSupInfo
from fscl_tpu.models.hubert import SSLUpstream as JaxUpstream
from fscl_tpu.obs.codebook_analysis import CodebookAnalyzer as JaxAnalyzer
from fscl_tpu.obs.fscl_saver import FSCLSaver as JaxFSCLSaver
from fscl_tpu.obs.tracking import ExperimentTracker as JaxTracker
from fscl_tpu.obs.tracking import read_metrics as jax_read_metrics
from fscl_tpu.systems.fscl import Episode as JaxEpisode
from fscl_tpu.systems.fscl import TransEmbSystem as JaxTransEmb
from fscl_tpu_torch.convert import transemb_state_dict
from fscl_tpu_torch.data.batch import Batch, SupInfo
from fscl_tpu_torch.models.hubert import SSLUpstream
from fscl_tpu_torch.obs import (
    CodebookAnalyzer, SynthSaver, plot_attention, plot_layer_weights, plot_mel,
)
from fscl_tpu_torch.obs.figures import have_matplotlib
from fscl_tpu_torch.obs.fscl_saver import FSCLSaver
from fscl_tpu_torch.obs.tracking import ExperimentTracker, read_metrics
from fscl_tpu_torch.systems.fscl import Episode, TransEmbSystem
from torch_parity import init_jax_variables, make_cfg, make_texts, to_jax, torch_system

MEL_ATOL, OVERLAY_ATOL, WAV_ATOL, ATTN_ATOL, LAYER_ATOL = 1e-5, 1e-4, 2e-3, 1e-6, 1e-6
N_SYM = 8


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# -- the tracker ---------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.calls = []

    def log_metrics(self, metrics, step):
        self.calls.append((metrics, step))


def _track(cls, root, sink):
    t = cls(root, name="fscl", exp_key="k0", params={"lr": 1e-3, "system": "fscl",
                                                      "shape": (1, 2)}, sink=sink)
    t.on_log(100, {"Total Loss": 3.5, "Mel Loss": 1.25})
    t.on_validation(100, {"Total Loss": 4.0})
    t.log_text("transcript", "HH AH0 L OW1", step=5)
    t.log_audio("sample", np.linspace(-0.5, 0.5, 2205).astype(np.float32), step=5)
    t.close()
    t2 = cls(root, name="fscl", exp_key="k0", params={"batch_size": 16})
    t2.on_log(200, {"Total Loss": 3.0})
    t2.close()
    t3 = cls(root, name="fscl", exp_key="k0")
    t3.close()
    return t3.dir


def test_tracker_writes_what_fscl_tpu_writes(tmp_path):
    sinks = [_Sink(), _Sink()]
    dirs = [_track(cls, str(tmp_path / name), sink)
            for cls, name, sink in ((ExperimentTracker, "port", sinks[0]),
                                    (JaxTracker, "jax", sinks[1]))]
    assert _files(dirs[0]) == _files(dirs[1]) == [
        "assets/00000005_sample.wav", "assets/00000005_transcript.txt", "meta.json",
        "metrics.jsonl"]
    metas = []
    for d in dirs:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        assert meta.pop("created")
        metas.append(meta)
    assert metas[0] == metas[1]
    assert metas[0]["resumed"] == 2 and metas[0]["exp_key"] == "k0"
    assert metas[0]["params"] == {"lr": 1e-3, "system": "fscl", "batch_size": 16}
    for name in ("metrics.jsonl", "assets/00000005_transcript.txt", "assets/00000005_sample.wav"):
        with open(os.path.join(dirs[0], name), "rb") as a, open(os.path.join(dirs[1], name),
                                                               "rb") as b:
            assert a.read() == b.read(), name
    assert read_metrics(dirs[0]) == jax_read_metrics(dirs[1])
    assert [r["step"] for r in read_metrics(dirs[0])] == [100, 100, 100, 200]
    assert sinks[0].calls == sinks[1].calls and len(sinks[0].calls) == 2


@pytest.mark.skipif(not have_matplotlib(), reason="matplotlib is not installed")
def test_tracker_logs_a_figure_as_fscl_tpu_does(tmp_path):
    from fscl_tpu.obs.figures import plot_mel as jax_plot_mel
    names = []
    for cls, plot, sub in ((ExperimentTracker, plot_mel, "port"), (JaxTracker, jax_plot_mel,
                                                                    "jax")):
        t = cls(str(tmp_path / sub), exp_key="k")
        path = t.log_figure("mel", plot(np.zeros((10, 4))), step=3)
        t.close()
        assert os.path.getsize(path) > 0
        names.append(os.path.relpath(path, str(tmp_path / sub)))
    assert names[0] == names[1] == os.path.join("k", "assets", "00000003_mel.png")


# -- SynthSaver ------------------------------------------------------------------

def _val_batch(seed=2, B=2, L=12, T=48):
    rng = np.random.default_rng(seed)
    texts, lens = make_texts(rng, [12, 8], L)
    dur = rng.integers(1, 5, (B, L)).astype(np.int32)
    dur[texts == 0] = 0
    return dict(speaker_args=np.array([1, 2], np.int32), texts=texts, src_lens=lens,
                mels=rng.normal(size=(B, T, 80)).astype(np.float32),
                mel_lens=np.minimum(dur.sum(1), T).astype(np.int32),
                pitches=rng.normal(size=(B, L)).astype(np.float32),
                energies=rng.normal(size=(B, L)).astype(np.float32),
                durations=dur, lang_ids=np.zeros(B, np.int32))


def _read_wav(path):
    sr, x = wavfile.read(path)
    return x.astype(np.float32) / 32767.0


@pytest.mark.parametrize("figures", [True, False], ids=["figures", "no_figures"])
def test_synth_saver_matches_fscl_tpu(tmp_path, monkeypatch, figures):
    if figures and not have_matplotlib():
        pytest.skip("matplotlib is not installed")
    jsys, variables = init_jax_variables(make_cfg(jax_config))
    tsys = torch_system(make_cfg(torch_config), variables)
    b = _val_batch()
    seen = []
    plot = jsynth.plot_mel
    monkeypatch.setattr(jsynth, "plot_mel", lambda mel, pitch, energy, title, path: (
        seen.append((title, np.asarray(mel), pitch, energy)), plot(mel, pitch, energy, title,
                                                                  path)))
    jstate = types.SimpleNamespace(params=to_jax(variables["params"]),
                                   batch_stats=to_jax(variables["batch_stats"]))
    jsynth.SynthSaver(str(tmp_path / "jax"), jsys, synth_step=5).on_validation_sample(
        10, jstate, JaxBatch(**b))
    saver = SynthSaver(str(tmp_path / "port"), tsys, synth_step=5, write_figures=figures)
    saver.on_validation_sample(10, None, Batch(**b))
    saver.on_validation_sample(11, None, Batch(**b))          # off the cadence: nothing
    want_files = _files(str(tmp_path / "jax"))
    assert want_files == ["step10-recon.png", "step10-recon.wav", "step10-synth.png",
                          "step10-synth.wav"]
    got_files = _files(str(tmp_path / "port"))
    assert got_files == (want_files if figures else
                         [f for f in want_files if f.endswith(".wav")])
    assert [t for t, *_ in seen] == ["recon", "synth"]
    for tag, mel, pitch, energy in seen:
        got = saver.last[tag]
        assert got["mel"].shape == mel.shape, tag
        np.testing.assert_allclose(got["mel"], mel, atol=MEL_ATOL, rtol=0, err_msg=tag)
        np.testing.assert_allclose(got["pitch"], np.asarray(pitch), atol=OVERLAY_ATOL, rtol=1e-6)
        np.testing.assert_allclose(got["energy"], np.asarray(energy), atol=OVERLAY_ATOL,
                                   rtol=1e-6)
        w_got = _read_wav(str(tmp_path / "port" / f"step10-{tag}.wav"))
        w_want = _read_wav(str(tmp_path / "jax" / f"step10-{tag}.wav"))
        assert w_got.shape == w_want.shape == (mel.shape[0] * 256,)
        np.testing.assert_allclose(w_got, w_want, atol=WAV_ATOL, rtol=0)
        np.testing.assert_allclose(_read_wav(str(tmp_path / "port" / f"step10-{tag}.wav")),
                                   np.clip(got["wav"], -1, 1), atol=1e-4)


# -- FSCLSaver -------------------------------------------------------------------

def _fscl_cfg(C):
    cfg = make_cfg(C)
    return dataclasses.replace(
        cfg, transformer=dataclasses.replace(
            cfg.transformer, encoder_layer=1, decoder_layer=1, encoder_hidden=32,
            decoder_hidden=32, conv_filter_size=32),
        codebook=C.CodebookConfig(size=4, num_heads=2, dim=32),
        upstream=C.UpstreamConfig(name="tiny", dim=16, n_layers=2),
        max_seq_len=16, speaker=C.SpeakerConfig(n_speakers=2))


def _fscl_episode(rng):
    sup = dict(wavs=(0.3 * rng.normal(size=(2, 8000))).astype(np.float32),
               wav_lens=np.array([8000, 6400], np.int32),
               avg_frames=rng.integers(1, 4, (2, 5)).astype(np.int32),
               phonemes=rng.integers(1, N_SYM, (2, 5)).astype(np.int32))
    dur = rng.integers(1, 3, (2, 5)).astype(np.int32)
    qry = dict(speaker_args=np.zeros(2, np.int32),
               texts=rng.integers(1, N_SYM, (2, 5)).astype(np.int32),
               src_lens=np.full((2,), 5, np.int32),
               mels=rng.normal(size=(2, 12, 80)).astype(np.float32),
               mel_lens=np.minimum(dur.sum(1), 12).astype(np.int32),
               pitches=rng.normal(size=(2, 5)).astype(np.float32),
               energies=rng.normal(size=(2, 5)).astype(np.float32),
               durations=dur, lang_ids=np.zeros(2, np.int32))
    return sup, qry


@pytest.mark.parametrize("figures", [True, False], ids=["figures", "no_figures"])
def test_fscl_saver_matches_fscl_tpu(tmp_path, monkeypatch, figures):
    if figures and not have_matplotlib():
        pytest.skip("matplotlib is not installed")
    import fscl_tpu.obs.codebook_analysis as jca
    sup, qry = _fscl_episode(np.random.default_rng(0))
    jep = JaxEpisode(sup=JaxSupInfo(**sup, n_symbols=N_SYM), qry=JaxBatch(**qry))
    upstream = dict(dim=16, n_layers=1, n_heads=2, ffn_dim=32, pos_conv_kernel=4,
                    pos_conv_groups=2)
    jsys = JaxTransEmb(_fscl_cfg(jax_config), jax_config.OptimConfig(), N_SYM,
                       upstream=JaxUpstream(**upstream))
    state = jsys.init_state(jax.random.PRNGKey(0), jep)
    # a learned (not uniform) layer weighting
    cb = dict(state.params["codebook"])
    cb["weight_raw"] = jnp.asarray(np.random.default_rng(1).normal(
        size=np.shape(cb["weight_raw"])).astype(np.float32))
    state = state.replace(params={**state.params, "codebook": cb})
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats,
                                          "frozen": state.frozen})
    tsys = TransEmbSystem(_fscl_cfg(torch_config), N_SYM, device="cpu",
                          upstream=SSLUpstream(**upstream))
    tsys.load_state_dict(transemb_state_dict(variables), strict=True)

    heads = []
    plot = jca.plot_attention
    monkeypatch.setattr(jca, "plot_attention", lambda attn, title, path: (
        heads.append((title, np.asarray(attn))), plot(attn, title=title, path=path)))
    layer_w = []
    import fscl_tpu.obs.fscl_saver as jfs
    plot_lw = jfs.plot_layer_weights
    monkeypatch.setattr(jfs, "plot_layer_weights", lambda w, title, path: (
        layer_w.append(np.asarray(w)), plot_lw(w, title=title, path=path)))
    JaxFSCLSaver(str(tmp_path / "jax"), jsys, synth_step=5).on_validation_sample(5, state, jep)
    saver = FSCLSaver(str(tmp_path / "port"), tsys, synth_step=5, write_figures=figures)
    saver.on_validation_sample(5, None, Episode(sup=SupInfo(**sup, n_symbols=N_SYM),
                                                qry=Batch(**qry)))
    want_files = _files(str(tmp_path / "jax"))
    assert want_files == ["matching-5-step5-head-0.png", "matching-5-step5-head-1.png",
                          "step5-layer-weights.png"]
    assert _files(str(tmp_path / "port")) == (want_files if figures else [])
    attn = saver.last["attn"]
    assert attn.shape == (2, N_SYM, 4)
    for h, (title, want) in enumerate(heads):
        assert title == f"step5-head-{h}"
        np.testing.assert_allclose(attn[h], want, atol=ATTN_ATOL, rtol=0)
    np.testing.assert_allclose(saver.last["layer_weights"], layer_w[0], atol=LAYER_ATOL, rtol=0)
    assert abs(layer_w[0].std()) > 1e-3                      # not uniform


# -- CodebookAnalyzer and the figures ------------------------------------------

def test_codebook_analyzer_matches_fscl_tpu(tmp_path):
    rng = np.random.default_rng(3)
    attn = rng.dirichlet(np.ones(6), size=(2, 5)).astype(np.float32)
    symbols = ["a", "b", "c", "d", "e"]
    port, ref = CodebookAnalyzer(str(tmp_path / "p"), write_figures=False), \
        JaxAnalyzer(str(tmp_path / "j"))
    for a in (attn, attn[0]):
        assert port.phoneme_transfer_table(a, symbols, 2) == ref.phoneme_transfer_table(
            a, symbols, 2)
    ta, tb = rng.normal(size=(5, 8)), rng.normal(size=(4, 8))
    got = port.cross_lingual_similarity(ta, tb, symbols, symbols[:4], step=2)
    want = ref.cross_lingual_similarity(ta, tb, symbols, symbols[:4], step=2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    infos, rinfos = port.heads_to_infos(attn, symbols), ref.heads_to_infos(attn, symbols)
    assert [(i.title, i.y_labels, i.x_labels) for i in infos] == \
        [(i.title, i.y_labels, i.x_labels) for i in rinfos]
    infos[1].quantized = True
    assert [os.path.basename(p) for p in port.plot_matching(infos, step=4)] == \
        ["matching-4-head-0.png", "matching-4-head-1.png"]
    assert _files(str(tmp_path / "p")) == []                  # write_figures=False


@pytest.mark.skipif(not have_matplotlib(), reason="matplotlib is not installed")
def test_figures_write_pngs(tmp_path):
    rng = np.random.default_rng(4)
    plot_mel(rng.normal(size=(30, 80)), rng.normal(size=30), rng.normal(size=30), "m",
             str(tmp_path / "a" / "mel.png"))
    plot_attention(rng.random((5, 7)), "att", str(tmp_path / "att.png"))
    plot_layer_weights(rng.random(25), path=str(tmp_path / "lw.png"))
    analyzer = CodebookAnalyzer(str(tmp_path / "cb"))
    infos = analyzer.heads_to_infos(rng.random((2, 5, 6)), list("abcde"))
    infos[0].quantized = True
    paths = analyzer.plot_matching(infos, step=1)
    analyzer.cross_lingual_similarity(rng.normal(size=(5, 8)), rng.normal(size=(3, 8)),
                                      list("abcde"), list("xyz"))
    for p in [tmp_path / "a" / "mel.png", tmp_path / "att.png", tmp_path / "lw.png",
              tmp_path / "cb" / "xling-0.png", *paths]:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
