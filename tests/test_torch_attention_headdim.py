"""The attention kernel's CUDA route at head dims it has no instance for.

The kernel has instances for head dims 64, 128 and 256. `attention_cuda`
(and so `attend` on the card, `AttentionFunction`'s forward and its vmap
rule) zero-pads any other head dim up to 256 to the next instance and slices the
output back, keeping the temperature at sqrt(the true Dh), where the JAX
package sends such shapes to XLA. There is no card here, so the launch
itself (`_launch_kernel`) is swapped for the plain version, which must see
only the padded head dims; the padding, the slicing and the Function's
recompute backward on the unpadded tensors run as they do on the card.
Each result is held to `attention_reference` at the true head dim, atol 1e-5
in float32 (the same f32 products; the padded columns add exact zeros), with
a ragged mask and a sample with no valid key. JAX-free.
"""
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from fscl_tpu_torch.ops import attention as tattn

ATOL = 1e-5
B, H, L = 3, 2, 11
LENS = [11, 5, 0]             # full, ragged, no valid key
HEAD_DIMS = pytest.mark.parametrize("dh", [40, 48, 80])


@pytest.fixture
def launches(monkeypatch):
    """The kernel launch runs the plain version and records each head dim."""
    seen = []

    def plain_launch(q, k, v, key_valid, temperature, key_split, stats=None):
        assert q.shape[-1] in tattn.HEAD_DIMS and q.shape == k.shape == v.shape
        seen.append((q.shape[-1], temperature))
        return tattn.attention_reference(q, k, v, key_valid, temperature)

    monkeypatch.setattr(tattn, "_launch_kernel", plain_launch)
    return seen


def _inputs(dh, seed=0, tasks=None):
    rng = np.random.default_rng(seed)
    lead = () if tasks is None else (tasks,)
    q, k, v, w = (torch.from_numpy(rng.normal(size=lead + (B, H, L, dh)).astype(np.float32))
                  for _ in range(4))
    valid = torch.from_numpy(np.arange(L)[None, :] < np.array(LENS)[:, None])
    if tasks is not None:
        valid = torch.stack([valid.roll(t, dims=0) for t in range(tasks)])
    return q, k, v, valid, w


def _function(q, k, v, valid):
    return tattn.AttentionFunction.apply(q, k, v, valid, None)[0]


@HEAD_DIMS
def test_padded_forward_matches_plain_version(launches, dh):
    q, k, v, valid, _ = _inputs(dh)
    got = tattn.attention_cuda(q, k, v, valid)
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v, valid), atol=ATOL, rtol=0)
    # the sample with no valid key: the mean of V over all keys
    torch.testing.assert_close(got[2], v[2].mean(dim=1, keepdim=True).expand(H, L, dh),
                               atol=ATOL, rtol=0)
    padded = 64 if dh <= 64 else 128
    assert launches == [(padded, pytest.approx(dh ** 0.5))]
    # every key split goes through the same padding
    for split in tattn.key_splits(dh):
        torch.testing.assert_close(tattn._launch(q, k, v, valid, 3.0, split),
                                   tattn.attention_reference(q, k, v, valid, 3.0),
                                   atol=ATOL, rtol=0)
    assert launches[-1] == (padded, 3.0)


@HEAD_DIMS
def test_padded_function_gradient_matches_plain_version(launches, dh):
    q, k, v, valid, w = _inputs(dh, seed=1)

    def grads(attn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad((attn(*leaves, valid) * w).sum(), leaves)

    got = grads(_function)
    want = grads(tattn.attention_reference)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == (B, H, L, dh), name
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=f"d{name}")
    assert len(launches) == 1


@HEAD_DIMS
def test_padded_function_under_vmap_matches_plain_version(launches, dh):
    """Four tasks folded into one padded launch, the forward and each task's
    gradient under vmap(grad)."""
    tasks = 4
    q, k, v, valid, w = _inputs(dh, seed=2, tasks=tasks)
    torch.testing.assert_close(vmap(_function)(q, k, v, valid),
                               vmap(tattn.attention_reference)(q, k, v, valid),
                               atol=ATOL, rtol=0)
    padded = 64 if dh <= 64 else 128
    assert launches == [(padded, pytest.approx(dh ** 0.5))]

    def task_grads(attn):
        def loss(q_, k_, v_, valid_, w_):
            return (attn(q_, k_, v_, valid_) * w_).sum()
        return vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v, valid, w)

    for name, a, b in zip("qkv", task_grads(_function), task_grads(tattn.attention_reference)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=f"vmap(grad) d{name}")


def test_head_dims_above_128_still_raise():
    """Above 128 the wrapper pads to a multiple of 64 for the kernel's wide
    route (160 to 192, 300 to 320), and the real launch then refuses CPU
    tensors: no head dim is refused for its size
    (tests/test_torch_attention_dh256.py holds the pad rule)."""
    for dh in (160, 300):
        q, k, v, valid, _ = _inputs(dh)
        with pytest.raises(ValueError, match="attention_cuda takes CUDA tensors"):
            tattn.attention_cuda(q, k, v, valid)
