"""Parity of the port's SSL upstream with fscl_tpu's, on the CPU.

Each case builds a small `SSLUpstream` in both packages from the same
arguments (dim 64 in 2 heads, 2 layers, the full 7-layer conv extractor),
initialises the JAX one with flax's init and carries its params to the port
with `fscl_tpu_torch.convert.hubert_state_dict`. Both run the same wavs: a
ragged `wav_valid` (one utterance of a few frames), so the frame mask, the
zeroing before the positional conv and the key mask of every layer are
exercised. Covered: both extractor modes, pre- and post-LN, an even
positional kernel (whose last frame is dropped) and an odd one, int16 wavs
dequantised on the way in, the bf16 storage cast, the scan layout, and the
port's state dict read back by the JAX package's own
`convert_torch_checkpoint`.

Tolerances: float32 hidden states max |d| <= 1e-5 (the same f32 math, sums
in another order; hidden states are O(1) after the LayerNorms); frame_valid
exact. bfloat16: both packages run the whole forward in bf16, but round at
different places (flax's LayerNorm and XLA's fused products against
PyTorch's kernels; XLA's attention rounds P to bf16 before P V, the port's
keeps it in f32), so the hidden states are held to 4e-2 of each layer's max
|f32 value| (about five bf16 roundings, 2^-8 each, through two layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.core.config as jax_config
import fscl_tpu.models.hubert as jh
import fscl_tpu_torch.core.config as torch_config
import fscl_tpu_torch.models.hubert as th
from fscl_tpu_torch.convert import hubert_state_dict
from fscl_tpu_torch.ops.masking import length_mask

F32_ATOL = 1e-5
BF16_REL = 4e-2
B, T_WAV = 3, 4000
LENS = [4000, 2500, 700]         # 12, 7 and 2 valid frames of 12
SMALL = dict(dim=64, n_layers=2, n_heads=2, ffn_dim=128, pos_conv_groups=4)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _wavs(seed=0):
    rng = np.random.default_rng(seed)
    wav = (0.3 * rng.normal(size=(B, T_WAV))).astype(np.float32)
    valid = np.arange(T_WAV)[None, :] < np.array(LENS)[:, None]
    return np.where(valid, wav, 0.0).astype(np.float32), valid


def _pair(seed=0, **kw):
    """(JAX module, its params as numpy, the port's module with them)."""
    kw = {**SMALL, **kw}
    jmod = jh.SSLUpstream(**kw)
    wav, valid = _wavs()
    params = jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(seed),
                                                         jnp.asarray(wav), jnp.asarray(valid)))
    kw.pop("scan_layers", None)
    tmod = th.SSLUpstream(**kw).eval()
    p = params["params"]
    if "layers" in p:
        p = jh.unstack_layer_params(p)
    tmod.load_state_dict(hubert_state_dict(p), strict=True)
    return jmod, params, tmod


CASES = {
    "group_norm-postLN-even": dict(extractor_mode="group_norm", layer_norm_first=False,
                                   pos_conv_kernel=16),
    "layer_norm-preLN-odd": dict(extractor_mode="layer_norm", layer_norm_first=True,
                                 pos_conv_kernel=15),
    "layer_norm-postLN-even": dict(extractor_mode="layer_norm", layer_norm_first=False,
                                   pos_conv_kernel=16),
    "scan-layout": dict(extractor_mode="layer_norm", layer_norm_first=True,
                        pos_conv_kernel=16, scan_layers=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_hidden_states_match(case):
    jmod, params, tmod = _pair(**CASES[case])
    wav, valid = _wavs(1)
    want_h, want_v = jax.jit(jmod.apply)(params, jnp.asarray(wav), jnp.asarray(valid))
    with torch.no_grad():
        got_h, got_v = tmod(torch.from_numpy(wav), torch.from_numpy(valid))
    n_frames = th.ssl_num_frames(T_WAV)
    assert got_h.shape == (B, n_frames, SMALL["n_layers"] + 1, SMALL["dim"])
    assert n_frames == jh.ssl_num_frames(T_WAV)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.sum(1).tolist() == [n // 320 for n in LENS]
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=F32_ATOL, rtol=0)


def test_no_wav_valid_means_every_frame_valid():
    """Without wav_valid every frame is valid (the JAX package's ones), and
    the forward equals the one with an all-True wav_valid."""
    torch.manual_seed(0)
    tmod = th.SSLUpstream(**SMALL, **CASES["layer_norm-preLN-odd"]).eval()
    wav, _ = _wavs(2)
    with torch.no_grad():
        got_h, got_v = tmod(torch.from_numpy(wav))
        want_h, _ = tmod(torch.from_numpy(wav), torch.ones(wav.shape, dtype=torch.bool))
    assert bool(got_v.all()) and got_v.shape == (B, th.ssl_num_frames(T_WAV))
    torch.testing.assert_close(got_h, want_h, rtol=0, atol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_frozen_forward_int16_and_storage_cast(compute_dtype):
    """`frozen_upstream_features` on int16 PCM: dequantised on the device,
    cast to the storage dtype (bf16 weights cast once, as `storage_cast`),
    hidden states back in f32."""
    jmod, params, tmod = _pair(seed=3, **CASES["layer_norm-preLN-odd"])
    wav, valid = _wavs(3)
    pcm = np.round(wav * 32767).astype(np.int16)
    want, want_v = jax.jit(lambda p, w, v: jh.frozen_upstream_features(
        jmod, p, w, v, compute_dtype))(
        jh.storage_cast(jax.tree.map(jnp.asarray, params), compute_dtype),
        jnp.asarray(pcm), jnp.asarray(valid))
    want = np.asarray(want)
    tmod.to({"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype])
    got, got_v = th.frozen_upstream_features(tmod, torch.from_numpy(pcm),
                                             length_mask(torch.tensor(LENS), T_WAV))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert not got.requires_grad
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    if compute_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    else:
        scale = np.abs(want).max(axis=(0, 1, 3), keepdims=True)
        err = np.abs(got.numpy() - want) / scale
        assert err.max() <= BF16_REL, err.max(axis=(0, 1, 3))


@pytest.mark.parametrize("case", ["group_norm-postLN-even", "layer_norm-preLN-odd"])
def test_state_dict_round_trips_through_convert_torch_checkpoint(case):
    """The port's HF-keyed state dict is what the JAX package's own
    checkpoint converter reads: it gives back the original params."""
    _, params, tmod = _pair(**CASES[case])
    back = jh.convert_torch_checkpoint(tmod.state_dict(),
                                       layer_norm_first=CASES[case]["layer_norm_first"])
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), v, err_msg=str(k))


@pytest.mark.parametrize("name,cfg", [
    ("hubert_large_ll60k", None), ("hubert", None), ("wav2vec2", None),
    ("custom", dict(name="custom", dim=80, n_layers=4)),
    ("custom", dict(name="custom", dim=192, n_layers=1))], ids=str)
def test_make_upstream_shapes_match(name, cfg):
    """The released shapes by name and the custom-dim branch (n_layers - 1
    layers, max(dim // 64, 2) heads, ffn 4 dim), compared without building
    the modules' weights."""
    jcfg = jax_config.UpstreamConfig(**cfg) if cfg else None
    tcfg = torch_config.UpstreamConfig(**cfg) if cfg else None
    want = jh.make_upstream(name, jcfg)
    with torch.device("meta"):
        got = th.make_upstream(name, tcfg)
    layer = got.encoder.layers[0]
    assert (got.dim, got.n_layers, got.n_heads, layer.feed_forward.intermediate_dense.out_features,
            got.layer_norm_first) == (want.dim, want.n_layers, want.n_heads, want.ffn_dim,
                                      want.layer_norm_first)
    assert got.encoder.pos_conv_embed.conv.kernel_size[0] == want.pos_conv_kernel
    assert got.encoder.pos_conv_embed.conv.groups == want.pos_conv_groups
    biased = got.feature_extractor.conv_layers[0].conv.bias is not None
    assert biased == (want.extractor_mode == "layer_norm")


def test_large_upstream_parameter_count():
    """HuBERT-large: 24 layers of 1024 in 16 heads of 64, 317 M parameters,
    counted on the meta device."""
    with torch.device("meta"):
        up = th.make_upstream("hubert_large_ll60k")
    n = sum(p.numel() for p in up.parameters())
    assert 3.1e8 < n < 3.2e8 and up.dim // up.n_heads == 64 and up.n_layers == 24


def test_upstream_config_for_fscl_yaml():
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "config", "model", "fscl-fastspeech2.yaml")
    got = torch_config.model_config_from_yaml(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_config.model_config_from_yaml(path))
    assert got.speaker.emb_type == "dvec" and got.codebook.size == 128
    assert got.codebook.num_heads == 4 and got.upstream.n_layers == 25


def test_init_random_draws_from_the_generator():
    torch.manual_seed(0)
    up = th.SSLUpstream(**SMALL)
    th.init_random_(up, torch.Generator().manual_seed(5))
    a = {k: v.clone() for k, v in up.state_dict().items()}
    th.init_random_(up, torch.Generator().manual_seed(5))
    for k, v in up.state_dict().items():
        assert torch.equal(v, a[k]), k
    w = up.encoder.layers[0].attention.q_proj.weight
    assert abs(float(w.std()) - SMALL["dim"] ** -0.5) < 0.02
    assert float(up.encoder.layers[0].layer_norm.weight.min()) == 1.0
    assert float(up.encoder.layers[0].attention.q_proj.bias.abs().max()) == 0.0
