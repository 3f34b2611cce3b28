"""Parity of the port's FastSpeech2 modules and BaselineSystem with fscl_tpu.

Same weights (fscl_tpu's init carried over by fscl_tpu_torch.convert), same
numpy inputs, both on the CPU in float32. Modules are held at atol 1e-5;
whole-system mels at atol 1e-4 (ten stacked blocks of f32 arithmetic taken
in another order); durations and mel lengths exactly.
"""
import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.frontend as jfront
from fscl_tpu.core.config import OptimConfig
from fscl_tpu.core.config import model_config_from_yaml as jax_model_config_from_yaml
from fscl_tpu.core.stats import DEFAULT_STATS as JAX_STATS
from fscl_tpu.frontend.define import LANG_NAME2ID
from fscl_tpu.nn import fft_block as jfft
from fscl_tpu.nn import variance_adaptor as jva
from fscl_tpu.systems.baseline import BaselineSystem as JaxBaseline
from fscl_tpu_torch.convert import baseline_state_dict
from fscl_tpu_torch.core.config import model_config_from_yaml
from fscl_tpu_torch.core.stats import DEFAULT_STATS
from fscl_tpu_torch.nn.variance_adaptor import variance_bins
from fscl_tpu_torch.serve import serve

from torch_parity import (
    ID2SYMBOLS, N_SPEAKERS, init_jax_variables, jax_cfg, make_texts, to_jax, torch_cfg,
    torch_system,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE_ATOL = 1e-5
SYSTEM_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jsys, variables = init_jax_variables(jax_cfg())
    return jsys, variables, torch_system(torch_cfg(), variables)


def _np(t):
    return t.detach().numpy()


def _inputs(seed, B=3, L=12, D=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    valid = np.arange(L)[None, :] < np.array([L, L - 4, 3])[:, None]
    return x, valid


@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_fft_block(pair, stack):
    _, variables, tsys = pair
    x, valid = _inputs(0)
    p = variables["params"]["model"][stack]["stack"]["layer_1"]
    want, _ = jfft.FFTBlock(64, 2, 128).apply({"params": to_jax(p)},
                                              jnp.asarray(x), jnp.asarray(valid))
    got, _ = getattr(tsys.model, stack).layer_stack[1](torch.from_numpy(x),
                                                       torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODULE_ATOL)


@pytest.mark.parametrize("L", [12, 80])   # 80 > max_seq_len: PE recomputed
def test_encoder(pair, L):
    _, variables, tsys = pair
    x, valid = _inputs(1, L=L)
    enc = jfft.Encoder(2, 64, 2, 128, max_seq_len=64)
    want = enc.apply({"params": to_jax(variables["params"]["model"]["encoder"])},
                     jnp.asarray(x), jnp.asarray(valid))
    got = tsys.model.encoder(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODULE_ATOL)


def test_decoder(pair):
    _, variables, tsys = pair
    x, valid = _inputs(2, L=40)
    dec = jfft.Decoder(2, 64, 2, 128, max_seq_len=64)
    want = dec.apply({"params": to_jax(variables["params"]["model"]["decoder"])},
                     jnp.asarray(x), jnp.asarray(valid))
    got = tsys.model.decoder(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODULE_ATOL)


def test_postnet_eval_batchnorm(pair):
    _, variables, tsys = pair
    x = np.random.default_rng(3).normal(size=(2, 24, 80)).astype(np.float32)
    want = jfft.PostNet(80).apply(
        {"params": to_jax(variables["params"]["model"]["postnet"]),
         "batch_stats": to_jax(variables["batch_stats"]["model"]["postnet"])},
        jnp.asarray(x))
    got = tsys.model.postnet(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODULE_ATOL)


@pytest.mark.parametrize("name", ["duration_predictor", "pitch_predictor"])
def test_variance_predictor(pair, name):
    _, variables, tsys = pair
    x, valid = _inputs(4)
    p = variables["params"]["model"]["variance_adaptor"][name]
    want = jva.VariancePredictor(64, 3).apply(
        {"params": to_jax(p)}, jnp.asarray(x), jnp.asarray(valid))
    got = getattr(tsys.model.variance_adaptor, name)(torch.from_numpy(x),
                                                     torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODULE_ATOL)


def test_variance_bins_match():
    for a, b in zip(jva.variance_bins(JAX_STATS, jax_cfg()),
                    variance_bins(DEFAULT_STATS, torch_cfg())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("controls", [
    {}, {"p_control": 1.3, "e_control": 0.8, "d_control": 1.5}])
@pytest.mark.parametrize("level", ["phoneme_level", "frame_level"])
def test_variance_adaptor(pair, controls, level):
    _, variables, _ = pair
    jcfg = jax_cfg(pitch_feature=level, energy_feature=level)
    tsys = torch_system(torch_cfg(pitch_feature=level, energy_feature=level), variables)
    x, valid = _inputs(5)
    T = 64
    want = jva.VarianceAdaptor(jcfg, JAX_STATS).apply(
        {"params": to_jax(variables["params"]["model"]["variance_adaptor"])},
        jnp.asarray(x), jnp.asarray(valid), T, **controls)
    got = tsys.model.variance_adaptor(torch.from_numpy(x), torch.from_numpy(valid),
                                      T, **controls)
    np.testing.assert_array_equal(_np(got.duration_rounded),
                                  np.asarray(want.duration_rounded))
    np.testing.assert_array_equal(_np(got.mel_len), np.asarray(want.mel_len))
    np.testing.assert_array_equal(_np(got.mel_valid), np.asarray(want.mel_valid))
    for field in ("x", "pitch_prediction", "energy_prediction",
                  "log_duration_prediction"):
        np.testing.assert_allclose(_np(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   atol=MODULE_ATOL, err_msg=field)
    assert int(want.mel_len.max()) > 0


def _synth_inputs(seed):
    rng = np.random.default_rng(seed)
    texts, src_lens = make_texts(rng, [14, 9, 5], 16)
    spk = rng.integers(0, N_SPEAKERS, 3).astype(np.int32)
    lang = np.array([0, 1, 0], np.int32)
    return texts, src_lens, spk, lang


@pytest.mark.parametrize("level,controls", [
    ("phoneme_level", {}),
    ("phoneme_level", {"p_control": 1.2, "d_control": 0.7}),
    ("frame_level", {"d_control": 1.3, "e_control": 0.9}),
])
def test_synthesize(pair, level, controls):
    _, variables, _ = pair
    jsys = JaxBaseline(jax_cfg(pitch_feature=level), OptimConfig(), ID2SYMBOLS)
    tsys = torch_system(torch_cfg(pitch_feature=level), variables)
    texts, src_lens, spk, lang = _synth_inputs(6)
    T = 128
    want = jsys.synthesize(to_jax(variables["params"]),
                           to_jax(variables["batch_stats"]), jnp.asarray(texts),
                           jnp.asarray(src_lens), T, jnp.asarray(spk),
                           jnp.asarray(lang), **controls)
    got = tsys.synthesize(texts, src_lens, T, spk, lang, **controls)
    np.testing.assert_array_equal(_np(got.duration_rounded),
                                  np.asarray(want.duration_rounded))
    np.testing.assert_array_equal(_np(got.mel_len), np.asarray(want.mel_len))
    for field in ("mel", "postnet_mel"):
        np.testing.assert_allclose(_np(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   atol=SYSTEM_ATOL, err_msg=field)
    assert 0 < int(want.mel_len.max()) < T


def test_synthesize_bucketed_same_bucket(pair):
    jsys, variables, tsys = pair
    texts, src_lens, spk, lang = _synth_inputs(7)
    buckets = (16, 32, 64, 128)
    args = (jnp.asarray(texts), jnp.asarray(src_lens), jnp.asarray(spk),
            jnp.asarray(lang))
    want = jsys.synthesize_bucketed(to_jax(variables["params"]),
                                    to_jax(variables["batch_stats"]), *args,
                                    mel_buckets=buckets)
    got = tsys.synthesize_bucketed(texts, src_lens, spk, lang, mel_buckets=buckets)
    T = want.mel.shape[1]
    assert T not in (buckets[0], buckets[-1])
    assert tuple(got.mel.shape) == tuple(want.mel.shape)
    np.testing.assert_array_equal(_np(got.mel_len), np.asarray(want.mel_len))
    np.testing.assert_allclose(_np(got.postnet_mel), np.asarray(want.postnet_mel),
                               atol=SYSTEM_ATOL)


def test_bucketed_pass_one_uses_d_control(pair):
    """The port predicts pass-1 lengths with the caller's d_control, so the
    bucket covers the lengths pass 2 produces (fscl_tpu's pass 1 uses 1.0)."""
    _, _, tsys = pair
    texts, src_lens, spk, lang = _synth_inputs(7)
    base = tsys.pick_mel_bucket(texts, src_lens, spk, lang, mel_buckets=(16, 32, 64, 128))
    out = tsys.synthesize_bucketed(texts, src_lens, spk, lang,
                                   mel_buckets=(16, 32, 64, 128), d_control=2.0)
    assert out.mel.shape[1] > base
    full = tsys.synthesize(texts, src_lens, 128, spk, lang, d_control=2.0)
    np.testing.assert_array_equal(_np(out.mel_len), _np(full.mel_len))


def test_serve_matches_jax_bucketed_synthesis(pair):
    """`serve` (text lines -> mels, batches of 8, L buckets) against the
    same lines batched as cli/synth_cmd.py:_run_batch does and synthesized
    by fscl_tpu's `synthesize_bucketed`."""
    jsys, variables, _ = pair
    # ten lines: two batches, both in the L = 32 bucket (one compile each side)
    lines = ["Hello world.", "A longer line, 12 words.", "Short one.",
             "{HH AH0 L OW1} there!", "Numbers: 1, 2 and 30.", "The end?",
             "Mr. Smith went home.", "Yes.", "Two more lines to go,",
             "in a second batch."]
    got = serve(lines, baseline_state_dict(variables), model_cfg=torch_cfg(), device="cpu")
    assert len(got) == len(lines)
    seqs = [jfront.text_to_sequence(l, ["english_cleaners"], "en") for l in lines]
    params, bstats = to_jax(variables["params"]), to_jax(variables["batch_stats"])
    for start in range(0, len(seqs), 8):
        group = seqs[start:start + 8]
        L = next(b for b in (16, 32, 64, 128, 256) if max(map(len, group)) <= b)
        texts = np.zeros((len(group), L), np.int32)
        for i, s in enumerate(group):
            texts[i, :len(s)] = s
        want = jsys.synthesize_bucketed(
            params, bstats, jnp.asarray(texts),
            jnp.asarray([len(s) for s in group], jnp.int32),
            jnp.zeros(len(group), jnp.int32),
            jnp.full(len(group), LANG_NAME2ID["en"], jnp.int32), symbol_id="en")
        for i in range(len(group)):
            mel, n = got[start + i]
            assert n == int(want.mel_len[i]) > 0
            np.testing.assert_allclose(_np(mel), np.asarray(want.postnet_mel[i, :n]),
                                       atol=SYSTEM_ATOL)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "config", "model", "*.yaml"))),
                         ids=os.path.basename)
def test_model_config_from_yaml_matches(path):
    assert dataclasses.asdict(model_config_from_yaml(path)) == \
        dataclasses.asdict(jax_model_config_from_yaml(path))
