"""The attention Function under second-order autograd and `torch.func`.

`fscl_tpu_torch.ops.attention.AttentionFunction` carries the CUDA kernel
under autograd; its backward recomputes the weights with torch products.
The JAX custom VJP it ports (`fscl_tpu/ops/attention.py:106-130`) can be
differentiated again and vmapped, so the Function must allow the same: a
double backward, `torch.func.grad` (twice, as second-order MAML does) and
`torch.func.vmap` over a task axis (as the tune flow's many-task
adaptation does). There is no card here, so the Function's forward is
swapped for the plain version (`attention_cuda` replaced by
`attention_reference`); the backward, the `setup_context` form and the vmap
rule are the Function's own. Each transform is held to the same transform
through `attention_reference` at atol 1e-5 (both compute in f32 whatever
the input dtype), in float64 and float32, with a ragged mask and a sample
with no valid key. JAX-free, so it also runs where only the port is
installed.
"""
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from fscl_tpu_torch.ops import attention as tattn

ATOL = 1e-5
B, H, L, DH = 3, 2, 9, 8
LENS = [9, 4, 0]             # full, ragged, no valid key


@pytest.fixture(autouse=True)
def plain_forward(monkeypatch):
    """The Function's forward runs the plain version on CPU tensors."""
    monkeypatch.setattr(tattn, "attention_cuda",
                        lambda q, k, v, key_valid, temperature=None:
                        tattn.attention_reference(q, k, v, key_valid, temperature))


def _inputs(dtype, seed=0, tasks=None):
    rng = np.random.default_rng(seed)
    lead = () if tasks is None else (tasks,)
    q, k, v, w = (torch.from_numpy(rng.normal(size=lead + (B, H, L, DH))).to(dtype)
                  for _ in range(4))
    valid = torch.from_numpy(np.arange(L)[None, :] < np.array(LENS)[:, None])
    if tasks is not None:        # each task its own mask: rotate the lengths
        valid = torch.stack([valid.roll(t, dims=0) for t in range(tasks)])
    return q, k, v, valid, w


def _function(q, k, v, valid):
    return tattn.AttentionFunction.apply(q, k, v, valid, None)


def _reference(q, k, v, valid):
    return tattn.attention_reference(q, k, v, valid)


def _close(got, want, what):
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == b.dtype, (what, name)
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=f"{what} d{name}")


DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])


@DTYPES
def test_double_backward_matches_plain_version(dtype):
    """d/d(q, k, v) of <grad_qkv(<attention, w>), u>: the backward's own
    gradient, as `torch.autograd.grad(..., create_graph=True)` gives it."""
    q, k, v, valid, w = _inputs(dtype)
    us = [u.to(dtype) for u in _inputs(torch.float64, seed=1)[:3]]

    def second(attn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        first = torch.autograd.grad((attn(*leaves, valid) * w).sum(), leaves, create_graph=True)
        inner = sum((d * u).sum() for d, u in zip(first, us))
        return [d.detach() for d in first], torch.autograd.grad(inner, leaves)

    got_first, got = second(_function)
    want_first, want = second(_reference)
    _close(got_first, want_first, "first order")
    _close(got, want, "second order")
    assert max(float(d.abs().max()) for d in want) > 1e-2     # not trivially zero


@DTYPES
def test_func_grad_and_grad_of_grad_match_plain_version(dtype):
    q, k, v, valid, w = _inputs(dtype)

    def loss(attn):
        return lambda q_, k_, v_: (attn(q_, k_, v_, valid) * w).sum()

    _close(grad(loss(_function), argnums=(0, 1, 2))(q, k, v),
           grad(loss(_reference), argnums=(0, 1, 2))(q, k, v), "func.grad")

    def hvp_norm(attn):          # a scalar of the first gradient, differentiated again
        g = grad(loss(attn), argnums=(0, 1, 2))
        return lambda q_, k_, v_: sum((d ** 2).sum() for d in g(q_, k_, v_))

    _close(grad(hvp_norm(_function), argnums=(0, 1, 2))(q, k, v),
           grad(hvp_norm(_reference), argnums=(0, 1, 2))(q, k, v), "func.grad of func.grad")


@DTYPES
def test_func_vmap_over_tasks_matches_plain_version(dtype):
    """Four tasks: the forward with one shared mask (key_valid not vmapped)
    and with a mask per task, and each task's gradient under vmap(grad)."""
    tasks = 4
    q, k, v, valid, w = _inputs(dtype, seed=2, tasks=tasks)
    shared = valid[0]
    torch.testing.assert_close(
        vmap(_function, in_dims=(0, 0, 0, None))(q, k, v, shared),
        vmap(_reference, in_dims=(0, 0, 0, None))(q, k, v, shared), atol=ATOL, rtol=0)
    torch.testing.assert_close(vmap(_function)(q, k, v, valid),
                               vmap(_reference)(q, k, v, valid), atol=ATOL, rtol=0)

    def task_grads(attn):
        def loss(q_, k_, v_, valid_, w_):
            return (attn(q_, k_, v_, valid_) * w_).sum()
        return vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v, valid, w)

    got, want = task_grads(_function), task_grads(_reference)
    _close(got, want, "vmap(grad)")
    for t in range(tasks):       # the same as each task on its own
        leaves = [x[t].clone().requires_grad_() for x in (q, k, v)]
        one = torch.autograd.grad((_reference(*leaves, valid[t]) * w[t]).sum(), leaves)
        _close([g[t] for g in got], one, f"task {t}")


def test_vmap_rule_folds_tasks_into_one_call(monkeypatch):
    """Under vmap the Function's forward runs once, on (N * B, H, L, Dh)."""
    calls = []
    plain = tattn.attention_cuda

    def recording(q, k, v, key_valid, temperature=None):
        calls.append((tuple(q.shape), tuple(key_valid.shape)))
        return plain(q, k, v, key_valid, temperature)

    monkeypatch.setattr(tattn, "attention_cuda", recording)
    q, k, v, valid, _ = _inputs(torch.float32, seed=3, tasks=5)
    vmap(_function, in_dims=(0, 0, 0, None))(q, k, v, valid[0])
    assert calls == [((5 * B, H, L, DH), (5 * B, L))]


def test_first_order_backward_stays_in_place():
    """With grad mode off (a first-order backward) attention_bwd updates its
    (L, L) temporaries in place and gives the out-of-place path's values."""
    q, k, v, valid, g = _inputs(torch.float32, seed=4)
    with torch.no_grad():
        fast = tattn.attention_bwd(q, k, v, valid, None, g)
    with torch.enable_grad():
        graph = tattn.attention_bwd(q, k, v, valid, None, g)
    for a, b in zip(fast, graph):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert float(fast[1][2].abs().max()) == 0.0     # no gradient to invalid keys
