"""The attention kernel's CUDA route at head dims 129-256.

`csrc/attention.cu` has head-dim-256 instances, and the wrapper zero-pads
head dims 129-255 to 256 (a 384-wide FFT block at 2 heads has 192), with the
temperature kept at sqrt(the true Dh); above 256 it raises, where the JAX
package computes with `xla_attention`. Held here on the CPU:

- the kernel's f32 route (split TF32, `cvt.rna` rounding; at Dh 256 each
  warp splits the raw K and V it reads, the same three products) emulated in
  torch on the zero-padded head dim, within the f32 bar (2e-5) of the plain
  version at the true head dim; one TF32 product per f32 product misses it;
- the wrapper's pad rule, with the launch swapped for the plain version
  (which must see head dim 256);
- the port's plain version at Dh 192 against fscl_tpu's `xla_attention` on
  the same inputs (f32 1e-5; bf16 within one bf16 rounding of the output,
  as tests/test_torch_attention.py holds the other head dims).

The kernel itself is held at Dh 192 and 256 on the card by
tests/test_torch_cuda.py and chip_smoke.py phase 3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fscl_tpu.ops import attention as jattn
from fscl_tpu_torch.ops import attention as tattn
from test_torch_attention_split import F32_ATOL, split_matmul

B, H, L = 2, 2, 64
LENS = [64, 40]


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


@pytest.mark.parametrize("dh", [192, 256])
def test_split_tf32_route_at_head_dim_256_holds_the_f32_bar(dh):
    q, k, v, valid = _inputs(dh)
    want = tattn.attention_reference(q, k, v, valid)
    qp, kp, vp = (torch.nn.functional.pad(t, (0, 256 - dh)) for t in (q, k, v))

    def emulate(passes):
        # the kernel's temperature is sqrt(the true Dh), not of the padded one
        scores = split_matmul(qp, kp.transpose(-1, -2), passes) / dh ** 0.5
        scores = scores.masked_fill(~valid[:, None, None, :], tattn.NEG_INF)
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        return (split_matmul(p, vp, passes) / p.sum(-1, keepdim=True))[..., :dh]

    split_err = float((emulate(3) - want).abs().max())
    one_pass_err = float((emulate(1) - want).abs().max())
    assert split_err <= F32_ATOL, split_err
    assert one_pass_err > F32_ATOL, one_pass_err


@pytest.fixture
def launches(monkeypatch):
    """The kernel launch runs the plain version and records each head dim."""
    seen = []

    def plain_launch(q, k, v, key_valid, temperature, key_split):
        assert q.shape[-1] in tattn.HEAD_DIMS and q.shape == k.shape == v.shape
        seen.append((q.shape[-1], temperature))
        return tattn.attention_reference(q, k, v, key_valid, temperature)

    monkeypatch.setattr(tattn, "_launch_kernel", plain_launch)
    return seen


@pytest.mark.parametrize("dh,padded", [(129, 256), (192, 256), (255, 256), (256, 256)])
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
    assert launches == [(256, pytest.approx(192 ** 0.5))] * len(tattn.KEY_SPLITS)


@pytest.mark.parametrize("dh", [257, 384])
def test_wrapper_raises_above_256(launches, dh):
    q, k, v, valid = _inputs(dh, seed=3)
    with pytest.raises(ValueError, match=r"head dim %d above 256" % dh):
        tattn.attention_cuda(q, k, v, valid)
    assert launches == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_at_head_dim_192_matches_xla_attention(dtype):
    q, k, v, valid = _inputs(192, seed=4, lens=[64, 0])
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = tattn.attention_reference(q, k, v, valid).float().numpy()
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) for t in (q, k, v))
    want = np.asarray(jattn.xla_attention(jq, jk, jv, jnp.asarray(valid.numpy()))
                      .astype(jnp.float32))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol if dtype == torch.bfloat16 else 0)
