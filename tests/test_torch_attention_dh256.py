"""The attention kernel's CUDA route at head dims above 128 (the wide route).

`csrc/attention.cu` computes head dims above 128 on its wide route: the
wrapper zero-pads them to a multiple of 64 (200 to 256, 257 to 320), with
the temperature kept at sqrt(the true Dh), and a block owns one 128-wide
slice of O's columns, accumulating S = Q K^T over the head dim in 64-wide
chunks (each 16 columns in a fresh accumulator added to S). There is no upper
head dim, where the JAX package computes with `xla_attention`. Held here on
the CPU:

- the wide route's f32 arithmetic (split TF32, `cvt.rna` rounding; S by
  16-column parts, O slice by slice) emulated in torch on the padded head
  dim, within the f32 bar (2e-5) of the plain version at the true head dim;
  one TF32 product per f32 product misses it;
- the wrapper's routing, with the launch swapped for a stand-in that records
  the shape and temperature it is given and, at small sizes, computes the
  plain version; shapes past the earlier 16384-key and 65535-block limits
  pass the wrapper's checks on tensors with no storage;
- the port's plain version at Dh 192, 320 and 512 against fscl_tpu's
  `xla_attention` on the same inputs (f32 1e-5; bf16 within one bf16
  rounding of the output, as tests/test_torch_attention.py holds the other
  head dims);
- a FastSpeech2 at 512 wide with 1 head (head dim 512) against fscl_tpu's,
  through the converter, at tests/test_torch_fastspeech2.py's system bar.

The kernel itself is held at these head dims on the card by
tests/test_torch_cuda.py and chip_smoke.py phase 3.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fscl_tpu.core.config import OptimConfig
from fscl_tpu.ops import attention as jattn
from fscl_tpu.systems.baseline import BaselineSystem as JaxBaseline
from fscl_tpu_torch.ops import attention as tattn
from test_torch_attention_split import F32_ATOL, split_matmul
from torch_parity import (
    ID2SYMBOLS, N_SPEAKERS, init_jax_variables, jax_cfg, make_texts, to_jax, torch_cfg,
    torch_system,
)

B, H, L = 2, 2, 64
LENS = [64, 40]
SYSTEM_ATOL = 1e-4          # tests/test_torch_fastspeech2.py: whole-system mels
CHUNK, SLICE = 64, 128      # csrc/attention.cu WideCfg


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # tier-1 runs several test processes at once
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _inputs(dh, seed=0, lens=LENS):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(a) for a in rng.normal(size=(3, len(lens), H, L, dh))
               .astype(np.float32))
    valid = torch.from_numpy(np.arange(L)[None, :] < np.array(lens)[:, None])
    return q, k, v, valid


def wide_route(q, k, v, valid, dh, passes):
    """The wide route's f32 arithmetic on the zero-padded head dim: S summed
    over 16-column parts (each a fresh accumulator of `passes` TF32
    products), the unnormalised P, then O slice by slice of 128 columns,
    divided by the row sums; the output sliced back to the true head dim."""
    padded = tattn.padded_head_dim(dh)
    assert padded % CHUNK == 0
    qp, kp, vp = (torch.nn.functional.pad(t, (0, padded - dh)) for t in (q, k, v))
    scores = torch.zeros(q.shape[:-1] + (k.shape[-2],))
    for c in range(0, padded, 16):
        scores = scores + split_matmul(qp[..., c:c + 16], kp[..., c:c + 16].transpose(-1, -2),
                                       passes)
    # the kernel's temperature is sqrt(the true Dh), not of the padded one
    scores = (scores / dh ** 0.5).masked_fill(~valid[:, None, None, :], tattn.NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = torch.cat([split_matmul(p, vp[..., c:c + SLICE], passes)
                     for c in range(0, padded, SLICE)], dim=-1)
    return (out / p.sum(-1, keepdim=True))[..., :dh]


@pytest.mark.parametrize("dh", [192, 256, 320, 512])
def test_split_tf32_route_at_head_dim_256_holds_the_f32_bar(dh):
    q, k, v, valid = _inputs(dh)
    want = tattn.attention_reference(q, k, v, valid)
    split_err = float((wide_route(q, k, v, valid, dh, 3) - want).abs().max())
    one_pass_err = float((wide_route(q, k, v, valid, dh, 1) - want).abs().max())
    assert split_err <= F32_ATOL, split_err
    assert one_pass_err > F32_ATOL, one_pass_err


@pytest.fixture
def launches(monkeypatch):
    """The kernel launch runs the wrapper's checks, records the head dim and
    temperature it is given, and computes the plain version."""
    seen = []

    def plain_launch(q, k, v, key_valid, temperature, key_split, stats=None):
        tattn._check_launch(q, k, v, key_valid, key_split)
        seen.append((q.shape[-1], temperature))
        return tattn.attention_reference(q, k, v, key_valid, temperature)

    monkeypatch.setattr(tattn, "_launch_kernel", plain_launch)
    return seen


@pytest.mark.parametrize("dh,padded", [(129, 192), (192, 192), (255, 256), (256, 256)])
def test_wrapper_pads_head_dims_up_to_256(launches, dh, padded):
    q, k, v, valid = _inputs(dh, seed=1)
    got = tattn.attention_cuda(q, k, v, valid)
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, valid), atol=1e-5, rtol=0)
    want_temp = None if dh == padded else pytest.approx(dh ** 0.5)
    assert launches == [(padded, want_temp)]


def test_wrapper_pads_192_at_every_key_split(launches):
    q, k, v, valid = _inputs(192, seed=2)
    for split in tattn.KEY_SPLITS:
        torch.testing.assert_close(tattn._launch(q, k, v, valid, None, split),
                                   tattn.attention_reference(q, k, v, valid), atol=1e-5, rtol=0)
    # 192 is a multiple of 64: the wide route takes it as it is
    assert launches == [(192, None)] * len(tattn.KEY_SPLITS)


@pytest.mark.parametrize("dh,padded", [(129, 192), (192, 192), (200, 256), (256, 256),
                                       (257, 320), (320, 320), (512, 512), (1024, 1024)])
def test_wrapper_routes_every_head_dim_above_128(launches, dh, padded):
    """Every head dim above 128 goes to the wide route, padded to a multiple
    of 64 at the true temperature (or the caller's); the output is the
    plain version's at the true head dim."""
    q, k, v, valid = _inputs(dh, seed=3)
    got = tattn.attention_cuda(q, k, v, valid)
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, valid), atol=1e-5, rtol=0)
    got = tattn.attention_cuda(q, k, v, valid, temperature=3.0)
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, valid, 3.0),
                               atol=1e-5, rtol=0)
    want_temp = None if dh == padded else pytest.approx(dh ** 0.5)
    assert launches == [(padded, want_temp), (padded, 3.0)]
    assert tattn.choose_key_split((B, H, L, dh), torch.float32, 132, False) in tattn.KEY_SPLITS


@pytest.mark.parametrize("B_,H_,Lq,Lk,Dh", [(1, 2, 16385, 16385, 64), (1, 2, 20000, 20000, 128),
                                            (1, 2, 100, 16385, 512), (35000, 2, 16, 16, 64)],
                         ids=["Lk16385", "Lk20000", "Lk16385-Dh512", "BH70000"])
def test_wrapper_takes_long_keys_and_many_heads(monkeypatch, B_, H_, Lq, Lk, Dh):
    """Keys past 16384 and B * H past 65535 (the earlier limits) pass the
    wrapper's checks and reach the launch, on tensors with no storage; the
    stand-in computes nothing."""
    seen = []

    def recording(q, k, v, key_valid, temperature, key_split, stats=None):
        tattn._check_launch(q, k, v, key_valid, key_split)
        seen.append((*q.shape, k.shape[2], key_split))
        return torch.empty_like(q)

    monkeypatch.setattr(tattn, "_launch_kernel", recording)
    q = torch.empty(B_, H_, Lq, Dh, device="meta")
    k = v = torch.empty(B_, H_, Lk, Dh, device="meta")
    valid = torch.empty(B_, Lk, dtype=torch.bool, device="meta")
    for split in (None, *tattn.key_splits(Dh)):
        out = tattn._launch(q, k, v, valid, None, split)
        assert out.shape == q.shape
    assert seen == [(B_, H_, Lq, Dh, Lk, s) for s in (None, *tattn.key_splits(Dh))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_at_head_dim_192_matches_xla_attention(dtype):
    _plain_vs_xla(192, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [320, 512])
def test_plain_version_above_head_dim_256_matches_xla_attention(dh, dtype):
    _plain_vs_xla(dh, dtype)


def _plain_vs_xla(dh, dtype):
    q, k, v, valid = _inputs(dh, seed=4, lens=[64, 0])
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = tattn.attention_reference(q, k, v, valid).float().numpy()
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) for t in (q, k, v))
    want = np.asarray(jattn.xla_attention(jq, jk, jv, jnp.asarray(valid.numpy()))
                      .astype(jnp.float32))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol if dtype == torch.bfloat16 else 0)


def _wide(cfg, width=512, heads=1):
    """The test configuration with each stack one layer `width` wide at
    `heads` heads."""
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, encoder_layer=1, decoder_layer=1, encoder_hidden=width,
        decoder_hidden=width, encoder_head=heads, decoder_head=heads))


def test_fastspeech2_at_head_dim_512_matches_fscl_tpu():
    """FastSpeech2 at 512 wide with 1 head and 1 layer per stack: the port
    (its plain attention on the CPU, the function the kernel's wide route
    computes on the card) against fscl_tpu with the same weights, carried
    over by the converter: durations and lengths exactly, mels at 1e-4."""
    jsys, variables = init_jax_variables(_wide(jax_cfg()))
    tsys = torch_system(_wide(torch_cfg()), variables)
    assert tsys.model.encoder.layer_stack[0].slf_attn.n_head == 1
    rng = np.random.default_rng(7)
    texts, src_lens = make_texts(rng, [14, 9, 5], 16)
    spk = rng.integers(0, N_SPEAKERS, 3).astype(np.int32)
    lang = np.array([0, 1, 0], np.int32)
    T = 128
    jsys = JaxBaseline(_wide(jax_cfg()), OptimConfig(), ID2SYMBOLS)
    want = jsys.synthesize(to_jax(variables["params"]), to_jax(variables["batch_stats"]),
                           jnp.asarray(texts), jnp.asarray(src_lens), T, jnp.asarray(spk),
                           jnp.asarray(lang))
    got = tsys.synthesize(texts, src_lens, T, spk, lang)
    np.testing.assert_array_equal(got.duration_rounded.numpy(), np.asarray(want.duration_rounded))
    np.testing.assert_array_equal(got.mel_len.numpy(), np.asarray(want.mel_len))
    for field in ("mel", "postnet_mel"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)), atol=SYSTEM_ATOL,
                                   err_msg=field)
    assert 0 < int(want.mel_len.max()) < T
