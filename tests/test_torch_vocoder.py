"""Parity of the port's vocoder tail (`fscl_tpu_torch/models/melgan.py`,
`audio_out/vocoder.py`, `audio_out/streaming.py`, `audio_out/pipeline.py`
and `serve.serve_wav`) with fscl_tpu, on the CPU.

Tolerances: MelGAN in float32 at atol 1e-5 (measured below 1e-6: plain
convs summed in another order); every HiFiGAN waveform at the f32 generator
bars of tests/test_hifigan_fused.py (mean |d| < 1e-4, max < 2e-2); chunked
against full vocoding inside the port at atol 2e-5, the bar of
tests/test_streaming.py; Griffin-Lim (numpy in both packages) and mel
lengths exactly.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fscl_tpu.audio_out import pipeline as jpipeline
from fscl_tpu.audio_out import streaming as jstreaming
from fscl_tpu.audio_out import vocoder as jvocoder
from fscl_tpu.models import hifigan as jhifigan
from fscl_tpu.models import melgan as jmelgan
from fscl_tpu_torch.audio_out import pipeline as tpipeline
from fscl_tpu_torch.audio_out import streaming as tstreaming
from fscl_tpu_torch.audio_out import vocoder as tvocoder
from fscl_tpu_torch.convert import baseline_state_dict, hifigan_state_dict, melgan_state_dict
from fscl_tpu_torch.core.config import VocoderConfig
from fscl_tpu_torch.models import hifigan as thifigan
from fscl_tpu_torch.models import melgan as tmelgan
from fscl_tpu_torch.serve import serve_wav

from torch_parity import (
    init_jax_variables, jax_cfg, make_texts, to_jax, torch_cfg, torch_system,
)

MELGAN_ATOL = 1e-5
GEN_MEAN, GEN_MAX = 1e-4, 2e-2
CHUNK_ATOL = 2e-5
# the narrow vocoders of tests/test_pipeline.py and tests/test_streaming.py
PIPELINE_VOCODER = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                        upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                        resblock_dilations=((1, 2),))
STREAMING_VOCODER = dict(n_mels=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                         upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                         resblock_dilations=((1, 3),))


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one host: torch's default of one
    thread per core in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mel(seed, T=8, B=2, n_mels=80):
    return np.random.default_rng(seed).normal(size=(B, T, n_mels)).astype(np.float32)


def _close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.mean() < GEN_MEAN and err.max() < GEN_MAX


def test_melgan_matches_jax():
    gen = jmelgan.MelGANGenerator()
    variables = _np(gen.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 80))))
    mel = _mel(3)
    want = np.asarray(gen.apply(variables, jnp.asarray(mel)))
    port = tmelgan.MelGANGenerator().eval()
    port.load_state_dict(melgan_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 8 * 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=MELGAN_ATOL)


def _weight_norm_checkpoint(sd):
    """A port state_dict as an official float32 weight-norm checkpoint."""
    out = {}
    for key, value in sd.items():
        if key.endswith(".weight"):
            stem = key[:-len("weight")]
            out[stem + "weight_v"] = value
            out[stem + "weight_g"] = torch.linalg.vector_norm(
                value.reshape(value.shape[0], -1), dim=1).reshape(-1, 1, 1)
        else:
            out[key] = value
    return out


@pytest.mark.parametrize("kind", ["HifiGAN", "MelGAN"])
def test_vocoder_from_checkpoint_matches_jax(tmp_path, kind):
    """The same official-layout .pt file through both packages' Vocoder;
    MelGAN gets mel / ln(10) in both."""
    if kind == "MelGAN":
        jgen, convert = jmelgan.MelGANGenerator(), melgan_state_dict
    else:
        jgen, convert = jhifigan.HiFiGANGenerator(), hifigan_state_dict
    variables = _np(jgen.init(jax.random.PRNGKey(4), jnp.zeros((1, 8, 80))))
    ckpt = _weight_norm_checkpoint(convert(variables))
    path = str(tmp_path / "generator.pt")
    torch.save({"generator": ckpt} if kind == "HifiGAN" else ckpt, path)
    mel = _mel(5, T=6, B=1)[0] - 4.0          # a natural-log mel
    want = jvocoder.Vocoder.from_checkpoint(path, kind=kind, fused=False).infer(mel)
    voc = tvocoder.Vocoder.from_checkpoint(path, kind=kind, device="cpu")
    got = voc.infer(mel)
    assert got.shape == want.shape == (6 * 256,) and got.dtype == np.float32
    assert voc.scale == (math.log(10.0) if kind == "MelGAN" else 1.0)
    _close(got, want)


def test_vocoder_refuses_other_files_and_kinds(tmp_path):
    with pytest.raises(ValueError, match="torch checkpoint"):
        tvocoder.Vocoder.from_checkpoint(str(tmp_path / "params.pkl"), device="cpu")
    with pytest.raises(ValueError, match="not a generator"):
        tvocoder.build_generator("GriffinLim")


def test_griffin_lim_equals_jax():
    log_mel = _mel(6, T=12, B=1)[0] * 0.5 - 3.0
    want = jvocoder.griffin_lim(log_mel, n_iter=4)
    got = tvocoder.griffin_lim(log_mel, n_iter=4)
    assert got.dtype == np.float32 and got.shape == (12 * 256,)
    np.testing.assert_array_equal(got, want)


class _NoConfig:
    pass


@pytest.mark.parametrize("config", [{}, PIPELINE_VOCODER, STREAMING_VOCODER, None],
                         ids=["v1", "pipeline", "streaming", "no_config"])
def test_generator_halo_and_hop_equal_jax(config):
    if config is None:
        jgen = tgen = _NoConfig()
    else:
        jgen = jhifigan.HiFiGANGenerator(**config)
        tgen = thifigan.HiFiGANGenerator(**config)
    assert tstreaming.generator_halo(tgen) == jstreaming.generator_halo(jgen)
    assert tstreaming.generator_hop(tgen) == jstreaming.generator_hop(jgen)


@pytest.fixture(scope="module")
def v1_port():
    torch.manual_seed(0)
    return thifigan.HiFiGANGenerator().eval()


@pytest.mark.parametrize("T", [56, 53])
def test_chunked_vocode_equals_full_vocode(v1_port, T):
    """T = 56 > the 38-frame window: clamped edge windows and centred
    interior ones; T = 53 checks the right-padding contract."""
    mel = _mel(7, T=T, B=1)
    Tp = -(-T // 8) * 8
    padded = np.pad(mel, ((0, 0), (0, Tp - T), (0, 0)))
    with torch.no_grad():
        full = v1_port(torch.from_numpy(padded)).numpy()
    parts = list(tstreaming.chunked_vocode(v1_port, mel, chunk=8, device="cpu"))
    assert [s for s, _ in parts] == [i * 8 * 256 for i in range(Tp // 8)]
    wav = np.concatenate([w for _, w in parts], axis=1)
    assert wav.shape == full.shape == (1, Tp * 256)
    np.testing.assert_allclose(wav, full, rtol=0, atol=CHUNK_ATOL)


def test_chunked_vocode_rejects_a_wrong_hop(v1_port):
    with pytest.raises(ValueError, match="window\\*hop"):
        list(tstreaming.chunked_vocode(v1_port, _mel(8, T=16, B=1), chunk=8, hop=128,
                                       device="cpu"))


def _pipeline_pair():
    """The narrow FastSpeech2 and vocoder of tests/test_pipeline.py, in both
    packages, with the same weights."""
    jsys, variables = init_jax_variables(jax_cfg())
    tsys = torch_system(torch_cfg(), variables)
    jvoc = jhifigan.HiFiGANGenerator(**PIPELINE_VOCODER)
    vv = _np(jvoc.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 80))))
    tvoc = thifigan.HiFiGANGenerator(**PIPELINE_VOCODER)
    tvoc.load_state_dict(hifigan_state_dict(vv), strict=True)
    return jsys, variables, tsys, jvoc, vv, tvoc


def test_make_text2wav_matches_jax():
    jsys, variables, tsys, jvoc, vv, tvoc = _pipeline_pair()
    rng = np.random.default_rng(9)
    texts, src_lens = make_texts(rng, [7, 5], 8)
    spk, lang = np.zeros(2, np.int32), np.zeros(2, np.int32)
    state = types.SimpleNamespace(params=to_jax(variables["params"]),
                                  batch_stats=to_jax(variables["batch_stats"]))
    T = 32
    want_wav, want_len = jpipeline.make_text2wav(jsys, state, jvoc, to_jax(vv), max_mel_len=T,
                                                 fused_vocoder=False)(
        jnp.asarray(texts), jnp.asarray(src_lens), jnp.asarray(spk), jnp.asarray(lang))
    f = tpipeline.make_text2wav(tsys, tvoc, max_mel_len=T, device="cpu")
    got_wav, got_len = f(texts, src_lens, spk, lang)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert int(got_len.min()) > 0
    assert tuple(got_wav.shape) == tuple(want_wav.shape) == (2, T * 16)
    _close(got_wav.numpy(), want_wav)


def test_make_streaming_text2wav_equals_full_pipeline():
    _, _, tsys, _, _, tvoc = _pipeline_pair()
    rng = np.random.default_rng(10)
    texts, src_lens = make_texts(rng, [7, 6], 8)
    args = (texts, src_lens, np.zeros(2, np.int32), np.zeros(2, np.int32))
    full, mel_len = tpipeline.make_text2wav(tsys, tvoc, max_mel_len=32, device="cpu")(*args)
    stream = tstreaming.make_streaming_text2wav(tsys, tvoc, max_mel_len=32, chunk=8,
                                                device="cpu")
    parts = list(stream(*args))
    np.testing.assert_array_equal(parts[0][2], mel_len.numpy())
    wav = np.concatenate([w for _, w, _ in parts], axis=1)
    np.testing.assert_allclose(wav, full.numpy(), rtol=0, atol=CHUNK_ATOL)


def test_pipeline_refuses_a_system_on_another_device():
    _, _, tsys, _, _, tvoc = _pipeline_pair()
    with pytest.raises(ValueError, match="lives on cpu"):
        tpipeline.make_text2wav(tsys, tvoc, 32, device="meta")


@pytest.mark.parametrize("kind", ["HifiGAN", "MelGAN"])
def test_serve_wav_on_cpu(kind):
    """Text -> wav at the narrow FastSpeech2 with a full-width vocoder: one
    wav per line of max(mel_len, 1) * 256 samples, finite, in [-1, 1]."""
    cfg = torch_cfg()
    cfg = type(cfg)(**{**cfg.__dict__, "vocoder": VocoderConfig(model=kind)})
    _, variables = init_jax_variables(jax_cfg())
    torch.manual_seed(1)
    voc = tvocoder.build_generator(kind)
    lines = ["Hello world.", "A short line.", "Yes."]
    got = serve_wav(lines, baseline_state_dict(variables), voc.state_dict(), model_cfg=cfg,
                    device="cpu", mel_buckets=(16, 32, 64))
    assert len(got) == len(lines)
    for wav, n in got:
        assert wav.dtype == np.float32 and wav.shape == (max(n, 1) * 256,)
        assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    assert all(n > 0 for _, n in got)
