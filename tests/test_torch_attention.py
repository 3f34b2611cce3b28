"""The port's attention against fscl_tpu's.

`attention_reference` (the plain version of the CUDA kernel) is held
against `xla_attention` and against the TPU kernel `_attn_kernel` run in
interpret mode, as tests/test_ops.py runs it: f32 at atol 2e-5 (the bar the
JAX package holds its kernel to), bf16 at atol 1e-2 (one bf16 rounding of
the output). The CUDA kernel itself is checked on the card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fscl_tpu.ops import attention as jattn
from fscl_tpu_torch.ops import attention as tattn

F32_ATOL = 2e-5
BF16_ATOL = 1e-2


def _inputs(seed, B, H, L, Dh):
    rng = np.random.default_rng(seed)
    q, k, v = rng.normal(size=(3, B, H, L, Dh)).astype(np.float32)
    # ragged lengths, a full row, and one sample with no valid key
    lens = np.array([max(1, L - L // 3), L, 0])[:B]
    valid = np.arange(L)[None, :] < lens[:, None]
    return q, k, v, valid


def _interpret_kernel(q, k, v, valid):
    """fscl_tpu's `_attn_kernel` through pallas_call in interpret mode."""
    B, H, L, Dh = q.shape
    qf, kf, vf = (t.reshape(B * H, L, Dh) for t in (q, k, v))
    mask = jnp.repeat(valid.astype(jnp.int32), H, axis=0)[:, None, :]
    spec = pl.BlockSpec((1, L, Dh), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(jattn._attn_kernel, temp=Dh ** 0.5),
        grid=(B * H,),
        in_specs=[spec, spec, spec, pl.BlockSpec((1, 1, L), lambda i: (i, 0, 0))],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((B * H, L, Dh), q.dtype),
        interpret=True,
    )(qf, kf, vf, mask).reshape(B, H, L, Dh)


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) if a.dtype != bool else torch.from_numpy(a)
            for a in arrays]


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("L", [40, 128])
def test_reference_matches_xla_attention(Dh, L):
    q, k, v, valid = _inputs(0, 3, 2, L, Dh)
    want = jattn.xla_attention(*map(jnp.asarray, (q, k, v, valid)))
    got = tattn.attention_reference(*_torch(q, k, v, valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("L", [40, 128])
def test_reference_matches_tpu_kernel_interpret(Dh, L):
    q, k, v, valid = _inputs(1, 3, 2, L, Dh)
    want = _interpret_kernel(*map(jnp.asarray, (q, k, v, valid)))
    got = tattn.attention_reference(*_torch(q, k, v, valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    # the sample with no valid key gets uniform weights: the mean of V
    np.testing.assert_allclose(got[2].numpy(),
                               np.broadcast_to(v[2].mean(axis=1, keepdims=True), v[2].shape),
                               atol=F32_ATOL)


@pytest.mark.parametrize("Dh", [64, 128])
def test_reference_bf16_matches_tpu_kernel_interpret(Dh):
    q, k, v, valid = _inputs(2, 3, 2, 128, Dh)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = _interpret_kernel(jq, jk, jv, jnp.asarray(valid))
    got = tattn.attention_reference(*_torch(q, k, v, dtype=torch.bfloat16),
                                    torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=BF16_ATOL)


def test_attend_cpu_uses_plain_version_and_returns_weights():
    q, k, v, valid = _inputs(3, 3, 2, 24, 64)
    before = tattn.LAUNCHES
    got, w = tattn.attend(*_torch(q, k, v, valid), temperature=5.0, return_weights=True)
    want, w_want = jattn.xla_attention(*map(jnp.asarray, (q, k, v, valid)),
                                       temperature=5.0, return_weights=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_want), atol=F32_ATOL)
    assert tattn.LAUNCHES == before


@pytest.mark.parametrize("bad,reason", [
    ("cpu", "takes CUDA tensors"), ("shape", "Lq == Lk"), ("dh", "head dim"),
    ("length", "outside"), ("mask", "key_valid"), ("layout", "contiguous"),
    ("dtype", "not supported"), ("offset", "16-byte")])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(bad, reason):
    q, k, v, valid = _torch(*_inputs(4, 2, 2, 16, 64))
    if bad == "shape":
        k = k[:, :, :8].contiguous()
    elif bad == "dh":
        q, k, v = (t[..., :32].contiguous() for t in (q, k, v))
    elif bad == "length":
        q, k, v = (torch.zeros(1, 1, 2049, 64) for _ in range(3))
        valid = torch.ones(1, 2049, dtype=torch.bool)
    elif bad == "mask":
        valid = valid.int()
    elif bad == "layout":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    elif bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "offset":
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(ValueError, match=reason):
        tattn.attention_cuda(q, k, v, valid)
