"""Released SSL checkpoint layouts into the port's upstream, against
fscl_tpu's converter, on the CPU.

Two tiny upstreams (dim 32 in 2 heads, 2 layers, the full 7-layer conv
extractor, a 16-tap positional conv in 4 groups) stand for the two released
families: the base one (one GroupNorm after conv 0, post-LN, `encoder.
layer_norm` after the positional conv) and the large one (a LayerNorm and a
bias on every conv, pre-LN, `encoder.layer_norm` after the last layer, which
the s3prl hidden states leave out). Their weights are drawn with numpy from a
seed; `ssl_layouts.layout` writes from them each layout fscl_tpu's
`convert_torch_checkpoint` reads (HF keys, the positional conv weight-normed
as `weight_g` / `weight_v` or as `parametrizations`, fairseq keys, fairseq
and s3prl containers, the `w2v_model.` prefix, the keys neither family
needs), read by
the port's `models.hubert.load_torch_checkpoint` and by fscl_tpu's
converter, and both forwards run the same ragged wavs.

Tolerance: hidden states within 1e-5 of each layer's largest |value| (the
same float32 math, sums in another order; the weight-norm fold is float64 in
the port, float32 in fscl_tpu); frame masks exact.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fscl_tpu.models.hubert as jh
import fscl_tpu_torch.models.hubert as th
from fscl_tpu_torch import convert
from fscl_tpu_torch.systems.fscl import FrozenUpstream

from ssl_layouts import LAYOUTS, POS, fairseq_keys, layout, weight_normed

REL = 1e-5
B, T_WAV = 2, 4000
LENS = (4000, 1700)
TINY = dict(dim=32, n_layers=2, n_heads=2, ffn_dim=64, pos_conv_kernel=16, pos_conv_groups=4)
FAMILIES = {
    "base": dict(extractor_mode="group_norm", layer_norm_first=False),
    "large": dict(extractor_mode="layer_norm", layer_norm_first=True),
}


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


def _port(family):
    return th.SSLUpstream(**TINY, **FAMILIES[family]).eval()


def _drawn(family, seed=0):
    """The port module's state dict drawn with numpy: matrices and kernels
    normal / sqrt(fan_in), biases normal 0.1, norm scales 1 + normal 0.1."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in _port(family).state_dict().items():
        if p.dim() >= 2:
            x = rng.normal(size=p.shape) / np.sqrt(p[0].numel())
        elif "norm" in name and name.endswith("weight"):
            x = 1.0 + 0.1 * rng.normal(size=p.shape)
        else:
            x = 0.1 * rng.normal(size=p.shape)
        sd[name] = torch.from_numpy(x.astype(np.float32))
    if family == "large":       # a released pre-LN file's final LayerNorm
        sd["encoder.layer_norm.weight"] = torch.from_numpy(
            (1.0 + 0.1 * rng.normal(size=TINY["dim"])).astype(np.float32))
        sd["encoder.layer_norm.bias"] = torch.from_numpy(
            (0.1 * rng.normal(size=TINY["dim"])).astype(np.float32))
    return sd


_JIT = {}


def _jax_hidden(family, layout_sd, wav, valid):
    """fscl_tpu's converter and forward (one jitted apply per family)."""
    if family not in _JIT:
        _JIT[family] = jax.jit(jh.SSLUpstream(**TINY, **FAMILIES[family]).apply)
    variables = jh.convert_torch_checkpoint(
        layout_sd, layer_norm_first=FAMILIES[family]["layer_norm_first"])
    h, v = _JIT[family](variables, jnp.asarray(wav), jnp.asarray(valid))
    return np.asarray(h), np.asarray(v)


def _port_hidden(module, wav, valid):
    with torch.no_grad():
        h, v = module(torch.from_numpy(wav), torch.from_numpy(valid))
    return h.numpy(), v.numpy()


def _assert_layers_close(got, want):
    for layer in range(want.shape[2]):
        err = float(np.abs(got[:, :, layer] - want[:, :, layer]).max())
        bar = REL * float(np.abs(want[:, :, layer]).max())
        assert err <= bar, f"layer {layer}: max |d| {err:.3g} > {bar:.3g}"


@pytest.mark.parametrize("layout_name", LAYOUTS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_layout_loads_and_matches_fscl_tpu(family, layout_name):
    """Each layout loads strictly into the port and gives fscl_tpu's hidden
    states from the same file."""
    sd = layout(layout_name, _drawn(family))
    module = _port(family)
    module.load_state_dict(th.load_torch_checkpoint(sd, module), strict=True)
    wav, valid = _wavs(1)
    got, got_v = _port_hidden(module, wav, valid)
    want, want_v = _jax_hidden(family, sd, wav, valid)
    np.testing.assert_array_equal(got_v, want_v)
    assert got.shape == (B, th.ssl_num_frames(T_WAV), TINY["n_layers"] + 1, TINY["dim"])
    _assert_layers_close(got, want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_encoder_layer_norm_follows_the_ln_order(family):
    """A post-LN module keeps the file's `encoder.layer_norm` (applied after
    the positional conv); a pre-LN one drops it (the layout tests hold the
    hidden states of both)."""
    sd = _drawn(family)
    module = _port(family)
    loaded = th.load_torch_checkpoint(sd, module)
    assert ("encoder.layer_norm.weight" in loaded) == (family == "base")
    assert "encoder.layer_norm.weight" in sd


def test_weight_norm_fold_is_over_dims_0_and_1():
    """The fold gives back the drawn weight in both formats (g per kernel
    tap), where HiFi-GAN's fold (norm over all but dim 0) would not."""
    from fscl_tpu_torch.models.hifigan import fold_weight_norm
    sd = _drawn("large")
    module = _port("large")
    for parametrizations in (False, True):
        normed = weight_normed(sd, parametrizations=parametrizations)
        got = th.load_torch_checkpoint(normed, module)[f"{POS}.weight"]
        np.testing.assert_allclose(got.numpy(), sd[f"{POS}.weight"].numpy(), rtol=1e-6,
                                   atol=1e-7)
    wrong = fold_weight_norm({k: v for k, v in weight_normed(sd).items()
                              if k.startswith(POS)})[f"{POS}.weight"]
    assert not np.allclose(wrong.numpy(), sd[f"{POS}.weight"].numpy(), atol=1e-3)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_transformers_model_loads(family, monkeypatch):
    """A `transformers` HubertModel of the tiny config (its own init, its
    own weight-norm format) loads into the port and matches fscl_tpu's
    conversion of the same state dict. (`USE_TF=0`: the torch model needs no
    TensorFlow, whose import takes about 10 s.)"""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(4)
    cfg = transformers.HubertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        conv_dim=[512] * 7, conv_stride=[5, 2, 2, 2, 2, 2, 2],
        conv_kernel=[10, 3, 3, 3, 3, 2, 2], num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, layerdrop=0.0,
        do_stable_layer_norm=family == "large",
        feat_extract_norm="layer" if family == "large" else "group",
        conv_bias=family == "large")
    sd = transformers.HubertModel(cfg).eval().state_dict()
    assert "masked_spec_embed" in sd and "encoder.layer_norm.weight" in sd
    module = _port(family)
    module.load_state_dict(th.load_torch_checkpoint(sd, module), strict=True)
    wav, valid = _wavs(2)
    got, _ = _port_hidden(module, wav, valid)
    want, _ = _jax_hidden(family, sd, wav, valid)
    _assert_layers_close(got, want)


def test_scan_layout_params_carry_through_hubert_state_dict():
    """fscl_tpu's scan-layout upstream (`scan_layers=True`, one stacked
    `layers` collection) carries to the port with no call into the JAX
    package, and gives its hidden states."""
    jmod = jh.SSLUpstream(**TINY, **FAMILIES["large"], scan_layers=True)
    wav, valid = _wavs(3)
    params = jax.tree.map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(5), jnp.asarray(wav), jnp.asarray(valid)))
    assert "layers" in params["params"]
    split = th.unstack_layer_params(params["params"])
    want_split = jh.unstack_layer_params(params["params"])
    assert jax.tree.structure(split) == jax.tree.structure(want_split)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, split, want_split)))
    module = _port("large")
    module.load_state_dict(convert.hubert_state_dict(params), strict=True)
    got, _ = _port_hidden(module, wav, valid)
    want, _ = jax.jit(jmod.apply)(params, jnp.asarray(wav), jnp.asarray(valid))
    _assert_layers_close(got, np.asarray(want))


class _Holder(FrozenUpstream, torch.nn.Module):
    """The frozen-upstream mixin alone, as every SSL system carries it."""

    def __init__(self, compute_dtype):
        torch.nn.Module.__init__(self)
        self.device = torch.device("cpu")
        self.model_cfg = types.SimpleNamespace(
            upstream=types.SimpleNamespace(compute_dtype=compute_dtype))
        self.attach_upstream(_port("large"), 0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_load_upstream_takes_a_fairseq_container(compute_dtype):
    """`load_upstream` of a fairseq container installs what it installs from
    HF keys, in the storage dtype."""
    sd = _drawn("large")
    a, b = _Holder(compute_dtype), _Holder(compute_dtype)
    a.load_upstream(sd)
    b.load_upstream({"model": fairseq_keys(weight_normed(sd)), "cfg": {}})
    want, got = a.upstream.state_dict(), b.upstream.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == getattr(torch, compute_dtype)
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7, msg=k)
    assert not any(p.requires_grad for p in b.upstream.parameters())


def _missing(sd):
    return {k: v for k, v in sd.items() if k != "encoder.layers.1.feed_forward.output_dense.bias"}


def _reshaped(sd):
    return {**sd, "feature_projection.projection.weight": torch.zeros(16, 512)}


def _extra_layer(sd):
    return {**sd, "encoder.layers.2.final_layer_norm.bias": torch.zeros(TINY["dim"])}


@pytest.mark.parametrize("fault,module_family,error,match", [
    (_missing, "large", KeyError, "encoder.layers.1.feed_forward.output_dense.bias"),
    (lambda sd: sd, "base", ValueError, "'layer_norm'.*'group_norm'"),
    (_reshaped, "large", ValueError, r"feature_projection.projection.weight.*\(16, 512\)"),
    (_extra_layer, "large", ValueError, "encoder.layers.2.final_layer_norm.bias"),
], ids=["missing_key", "extractor_mode", "shape", "extra_layer"])
def test_faults_raise_naming_the_key(fault, module_family, error, match):
    with pytest.raises(error, match=match):
        th.load_torch_checkpoint(fault(_drawn("large")), _port(module_family))
