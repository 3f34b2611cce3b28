"""Parity of the port's HiFiGAN (`fscl_tpu_torch/models/hifigan.py`, the MRF
stage of `fscl_tpu_torch/ops/mrf_stage.py`, the converters) with fscl_tpu.

Inputs are made with numpy from a seed; weights come from fscl_tpu's own
init and are carried over by `fscl_tpu_torch.convert`. Both sides run on the
CPU; the port's stage runs its plain version there, the JAX stage its Pallas
kernel in interpret mode.

Tolerances:
- stage in float64: atol 5e-7, the bar tests/test_hifigan_fused.py holds the
  interpret-mode kernel to against the ResBlock1 modules;
- stage with bf16 compute: both sides round the same operands to bf16 and
  sum in f32, but in another order, which can round an intermediate to the
  neighbouring bf16 value (2^-8 relative); mean |d| < 1e-4 and
  max |d| < 1e-2 relative to max |want| (measured 7e-6 / 3e-4 without post
  and 6e-5 / 4e-3 with it; float32 compute misses the mean bar by 3x-12x);
- generator in float64 (the flax module built with dtype=float64): the
  flax module casts its last conv's output to float32 before tanh, so the
  bar is a few float32 ulps of the output: max |d| <= 1e-6 * max |want|;
- generator in float32: mean |d| < 1e-4 and max < 2e-2, the bars of
  tests/test_hifigan_fused.py (a leaky-ReLU input near 0 can flip sign
  under another summation order and carry a small band of error).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fscl_tpu.models import hifigan as jhifigan
from fscl_tpu.models import melgan as jmelgan
from fscl_tpu.ops.hifigan_fused import fused_mrf_stage
from fscl_tpu_torch.convert import hifigan_state_dict, melgan_state_dict
from fscl_tpu_torch.models import hifigan as thifigan
from fscl_tpu_torch.models import melgan as tmelgan
from fscl_tpu_torch.ops import mrf_stage as tmrf

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
STAGE_F64_ATOL = 5e-7
STAGE_BF16_MEAN, STAGE_BF16_MAX = 1e-4, 1e-2
GEN_F64_REL = 1e-6
GEN_MEAN, GEN_MAX = 1e-4, 2e-2


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one host: torch's default of one
    thread per core in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(params):
    return jax.tree.map(np.asarray, params)


def _stage_params(C, seed=0):
    """fscl_tpu's init of one stage: three ResBlock1 and a conv_post."""
    x0 = jnp.zeros((1, 64, C))
    res = [_np(jhifigan.ResBlock1(C, k, DS[j]).init(jax.random.PRNGKey(seed + j), x0)["params"])
           for j, k in enumerate(KS)]
    rng = np.random.default_rng(seed)
    post = {"kernel": (rng.normal(size=(7, C, 1)) * 0.1).astype(np.float32),
            "bias": rng.normal(size=(1,)).astype(np.float32)}
    return res, post


def _torch_stage(res, post, dtype=torch.float32):
    """The same stage as port modules, through the converter's key names."""
    C = res[0]["convs1_0"]["kernel"].shape[1]
    blocks = [thifigan.ResBlock1(C, k, DS[j]) for j, k in enumerate(KS)]
    sd = hifigan_state_dict({"params": {
        "conv_pre": {"kernel": np.zeros((7, 80, 2 * C), np.float32),
                     "bias": np.zeros(2 * C, np.float32)},
        "ups_0": {"kernel": np.zeros((4, C, 2 * C), np.float32), "bias": np.zeros(C, np.float32)},
        **{f"resblock_0_{j}": p for j, p in enumerate(res)},
        "conv_post": post}})
    for j, rb in enumerate(blocks):
        rb.load_state_dict({k[len(f"resblocks.{j}."):]: v for k, v in sd.items()
                            if k.startswith(f"resblocks.{j}.")})
        rb.to(dtype)
    conv_post = torch.nn.Conv1d(C, 1, 7, padding=3)
    conv_post.load_state_dict({"weight": sd["conv_post.weight"], "bias": sd["conv_post.bias"]})
    return blocks, conv_post.to(dtype)


def _jax_stage(x_btc, res, post, compute_dtype, tile, with_post):
    return np.asarray(fused_mrf_stage(
        jnp.asarray(x_btc), res, KS, DS, compute_dtype=compute_dtype,
        post_params=post if with_post else None, tile=tile, interpret=True))


def _torch_stage_out(x_btc, blocks, conv_post, compute_dtype, with_post):
    x = torch.from_numpy(x_btc).transpose(1, 2).contiguous()
    with torch.no_grad():
        out = tmrf.mrf_stage(x, blocks, conv_post if with_post else None, compute_dtype)
    return out.numpy() if with_post else out.transpose(1, 2).numpy()


@pytest.mark.parametrize("C,T,tile,with_post", [
    (32, 300, 128, False), (128, 200, 128, False), (32, 300, 128, True)])
def test_stage_matches_fused_mrf_stage_f64(C, T, tile, with_post):
    res, post = _stage_params(C)
    x = np.random.default_rng(1).normal(size=(2, T, C))
    with jax.enable_x64(True):
        res64 = jax.tree.map(lambda a: a.astype(np.float64), res)
        post64 = jax.tree.map(lambda a: a.astype(np.float64), post)
        want = _jax_stage(x, res64, post64, jnp.float64, tile, with_post)
    blocks, conv_post = _torch_stage(res, post, torch.float64)
    got = _torch_stage_out(x, blocks, conv_post, None, with_post)
    assert got.shape == want.shape == ((2, T) if with_post else (2, T, C))
    np.testing.assert_allclose(got, want, rtol=0, atol=STAGE_F64_ATOL)


@pytest.mark.parametrize("with_post", [False, True])
def test_stage_bf16_compute_matches_interpret_kernel(with_post):
    C, T = 32, 300
    res, post = _stage_params(C, seed=3)
    x = np.random.default_rng(4).normal(size=(2, T, C)).astype(np.float32)
    want = _jax_stage(x, res, post, jnp.bfloat16, 128, with_post)
    blocks, conv_post = _torch_stage(res, post)
    got = _torch_stage_out(x, blocks, conv_post, torch.bfloat16, with_post)
    err, scale = np.abs(got - want), np.abs(want).max()
    assert err.mean() < STAGE_BF16_MEAN * scale and err.max() < STAGE_BF16_MAX * scale
    # and the rounding is really there: bf16 compute differs from f32 compute
    f32 = _torch_stage_out(x, blocks, conv_post, None, with_post)
    assert np.abs(f32 - got).max() > 1e-4 * scale


def test_resblock_module_matches_jax():
    res, post = _stage_params(64, seed=5)
    blocks, _ = _torch_stage(res, post)
    x = np.random.default_rng(6).normal(size=(2, 40, 64)).astype(np.float32)
    want = np.asarray(jhifigan.ResBlock1(64, 7, DS[1]).apply({"params": res[1]}, jnp.asarray(x)))
    with torch.no_grad():
        got = blocks[1](torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def v1():
    """fscl_tpu's init of full-width HiFiGAN V1, as numpy."""
    gen = jhifigan.HiFiGANGenerator(n_mels=80)
    return _np(gen.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 80))))


def _port_v1(variables, **kw):
    gen = thifigan.HiFiGANGenerator(**kw).eval()
    gen.load_state_dict(hifigan_state_dict(variables), strict=True)
    return gen


def _mel(seed, T=8, B=2):
    return np.random.default_rng(seed).normal(size=(B, T, 80)).astype(np.float32)


def test_generator_matches_jax_f64(v1):
    mel = _mel(11)
    with jax.enable_x64(True):
        gen = jhifigan.HiFiGANGenerator(n_mels=80, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v1)
        want = np.asarray(gen.apply(v64, jnp.asarray(mel, jnp.float64)))
    with torch.no_grad():
        got = _port_v1(v1).double()(torch.from_numpy(mel).double()).numpy()
    assert got.shape == want.shape == (2, 8 * 256)
    assert np.abs(got - want).max() <= GEN_F64_REL * np.abs(want).max()


@pytest.mark.parametrize("upsample_impl", ["conv_transpose", "subpixel"])
def test_generator_matches_jax_f32(v1, upsample_impl):
    mel = _mel(5)
    gen = jhifigan.HiFiGANGenerator(n_mels=80, upsample_impl=upsample_impl)
    want = np.asarray(gen.apply(v1, jnp.asarray(mel)))
    with torch.no_grad():
        got = _port_v1(v1, upsample_impl=upsample_impl)(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 8 * 256)
    err = np.abs(got - want)
    assert err.mean() < GEN_MEAN and err.max() < GEN_MAX


def test_generator_rejects_unknown_upsample_impl():
    with pytest.raises(ValueError, match="upsample_impl"):
        thifigan.HiFiGANGenerator(upsample_impl="pixel_shuffle")


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g, np.float32), w)


def _weight_norm_pairs(sd, key_filter=lambda k: True):
    """A port state_dict written as weight-norm pairs (v = w, g = ||v|| over
    all but dim 0, torch's weight_norm dim=0), in float64 so that the fold
    g * v / ||v|| returns w exactly once rounded to float32."""
    out = {}
    for key, value in sd.items():
        if key.endswith(".weight") and key_filter(key):
            v = value.double()
            out[key[:-len("weight")] + "weight_v"] = v
            out[key[:-len("weight")] + "weight_g"] = torch.linalg.vector_norm(
                v.reshape(v.shape[0], -1), dim=1).reshape(-1, 1, 1)
        else:
            out[key] = value
    return out


def test_hifigan_conversion_routes_agree_exactly(v1):
    """Route 1: flax params -> convert.hifigan_state_dict -> port. Route 2:
    that state_dict as weight-norm pairs -> fscl_tpu's
    convert_torch_checkpoint -> flax params, which must be route 1's input."""
    sd = hifigan_state_dict(v1)
    assert set(sd) == set(thifigan.HiFiGANGenerator().state_dict())
    back = jhifigan.convert_torch_checkpoint(_weight_norm_pairs(sd))
    _assert_trees_equal(back["params"], v1["params"])


def test_melgan_conversion_routes_agree_exactly():
    gen = jmelgan.MelGANGenerator()
    variables = _np(gen.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 80))))
    sd = melgan_state_dict(variables)
    assert set(sd) == set(tmelgan.MelGANGenerator().state_dict())
    back = jmelgan.convert_torch_checkpoint(_weight_norm_pairs(sd))
    _assert_trees_equal(back["params"], variables["params"])


def _packagings(pairs):
    """The same weight-norm checkpoint in each packaging the loader takes."""
    reparam = {}
    for key, value in pairs.items():
        key = key.replace(".weight_g", ".parametrizations.weight.original0")
        reparam[key.replace(".weight_v", ".parametrizations.weight.original1")] = value
    return {
        "flat": pairs,
        "generator_wrapper": {"generator": pairs},
        "generator_prefix": {f"generator.{k}": v for k, v in pairs.items()},
        "module_prefix": {f"module.{k}": v for k, v in pairs.items()},
        "parametrizations": reparam,
    }


@pytest.mark.parametrize("packaging", ["flat", "generator_wrapper", "generator_prefix",
                                       "module_prefix", "parametrizations"])
def test_torch_checkpoint_loader_folds_like_jax(v1, packaging):
    """Official checkpoints are float32 weight-norm pairs: the port's fold
    and fscl_tpu's give the same weights to float32 rounding."""
    pairs = {k: v.float() for k, v in _weight_norm_pairs(hifigan_state_dict(v1)).items()}
    ckpt = _packagings(pairs)[packaging]
    got = thifigan.load_torch_checkpoint(ckpt)
    want = hifigan_state_dict(jhifigan.convert_torch_checkpoint(ckpt))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7)
    gen = thifigan.HiFiGANGenerator()
    gen.load_state_dict(got, strict=True)


def test_loader_passes_a_port_state_dict_through(v1):
    sd = hifigan_state_dict(v1)
    got = thifigan.load_torch_checkpoint(sd)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_stage_refuses_what_the_kernel_cannot_run():
    """The CUDA wrapper checks shapes before it looks at the device."""
    res, post = _stage_params(32)
    blocks, conv_post = _torch_stage(res, post)
    x = torch.zeros(1, 32, 10)
    with pytest.raises(ValueError, match="multiple of 32"):
        tmrf.mrf_stage_cuda(torch.zeros(1, 48, 10), blocks)
    with pytest.raises(ValueError, match="float32"):
        tmrf.mrf_stage_cuda(x.double(), blocks)
    with pytest.raises(ValueError, match="compute dtype"):
        tmrf.mrf_stage_cuda(x, blocks, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="kernel 5"):
        tmrf.mrf_stage_cuda(x, [thifigan.ResBlock1(32, 5, (1,))])
    with pytest.raises(ValueError, match="reaches past"):
        tmrf.mrf_stage_cuda(x, [thifigan.ResBlock1(32, 11, (7,))])
    for post_k in (5, 8):                       # conv_post is k = 7 only
        with pytest.raises(ValueError, match="post conv"):
            tmrf.mrf_stage_cuda(x, blocks, torch.nn.Conv1d(32, 1, post_k))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmrf.mrf_stage_cuda(x, blocks, conv_post)
    # the dispatcher takes the plain version for CPU tensors only
    assert tmrf.mrf_stage(x, blocks, conv_post).shape == (1, 10)


@pytest.mark.parametrize("round_bf16", [False, True], ids=["f32", "bf16"])
def test_packed_weights_are_kept_until_the_weight_changes(round_bf16):
    """The kernel's fragment-order weights (`_pack_weight`; the layout is
    pinned in tests/test_torch_mrf_split.py) are packed once per conv and
    packed again after the weight or the bias changes in place or is
    replaced."""
    conv = torch.nn.Conv1d(32, 32, 3)
    w, b = tmrf._packed(conv, round_bf16)
    want = tmrf._pack_weight(conv.weight.detach().clone(), round_bf16)
    torch.testing.assert_close(w, want, rtol=0, atol=0)
    torch.testing.assert_close(b, conv.bias.detach(), rtol=0, atol=0)
    assert tmrf._packed(conv, round_bf16)[0] is w
    with torch.no_grad():
        conv.weight.mul_(2.0)
    w2, _ = tmrf._packed(conv, round_bf16)
    assert w2 is not w
    torch.testing.assert_close(w2, tmrf._pack_weight(conv.weight.detach().clone(), round_bf16),
                               rtol=0, atol=0)
    torch.testing.assert_close(w2.float(), 2.0 * w.float(), rtol=0, atol=0)
    with torch.no_grad():
        conv.bias.add_(1.0)
    torch.testing.assert_close(tmrf._packed(conv, round_bf16)[1], conv.bias.detach(),
                               rtol=0, atol=0)
    conv.load_state_dict({"weight": torch.zeros(32, 32, 3), "bias": torch.zeros(32)})
    assert not tmrf._packed(conv, round_bf16)[0].any()
