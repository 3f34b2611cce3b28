"""The attention backward: the plain recompute against JAX, and the Hopper
backward kernel's algorithm emulated in torch.

`fscl_tpu_torch.ops.attention.attention_bwd` is the plain version of the
backward; its gradients are held to `jax.vjp` of fscl_tpu's `xla_attention`
(what `_pallas_attention_bwd` differentiates) on the same numpy-seeded
inputs. `csrc/attention_bwd.cu` cannot run here, so its arithmetic is
emulated: the forward's scores (and the kernel's, the same bits: a wgmma
k-step adds the same products to the same bits as the forward's mma.sync
one, which chip_smoke.py probes on the card) and g V^T with the forward's
k-steps (columns 16j + 4t + 2h and + 1 of a 16) and a fresh accumulator
every 16 columns, the forward's row max m and sum l, P = exp2(S - m) times
1 / l, D = rowsum(P * dP) from those bits summed as the kernel sums it (P
taken as 0 at invalid keys, where dS is 0), split TF32 products rounded as
`cvt.rna` rounds (three passes, a pass dropped where an operand is a bf16
value; bf16 scores and dP on the bf16 tensor cores as the forward's), each
mma adding its exact products into its accumulator and truncating, dQ = ((P * dP) K - D (P K)) / temp and dK summed from a fresh
accumulator per 32-row tile (the kernel's streamed tile) into the whole
sum, rounded to nearest, and dV = P^T g summed by f32 FMAs one query row
after the other. The emulation is held to `attention_bwd` within
the f32 gradient bar (1e-5, chip_smoke.py's GRAD_ATOL); with one valid key
its dv is the ascending f32 sum of g (cuBLAS's order on the card); the
same algorithm with m + log2 l folded into one f32 number breaks the
sample with no valid key; and through the Functions' vmap rules, tasks
folded into one kernel call give each task the same bits as its call alone.
The card holds the kernel itself to the plain version (tests/test_torch_cuda.py,
chip_smoke.py phases 8 and 17).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from fscl_tpu.ops.attention import xla_attention
from fscl_tpu_torch.ops import attention as tattn

GRAD_ATOL = 1e-5
LOG2E = 1.4426950408889634
FILL_LOG2 = np.float32(-1e9) * np.float32(LOG2E)      # csrc/attention*.cu MASK_FILL_LOG2
KEY_TILE = 32                                         # csrc/attention_bwd.cu TILE


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # tier-1 runs several test processes at once
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, B, H, Lq, Lk, Dh, lens=None):
    """q, g (B, H, Lq, Dh), k, v (B, H, Lk, Dh) float32 from numpy; keys
    valid up to `lens` (default: all, ragged, none)."""
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, H, Lq, Dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, H, Lk, Dh)).astype(np.float32) for _ in range(2))
    lens = lens if lens is not None else [Lk, max(1, Lk // 3), 0][:B]
    valid = np.arange(Lk)[None, :] < np.array(lens)[:, None]
    return q, k, v, valid, g


# -- attention_bwd against JAX -------------------------------------------------

@pytest.mark.parametrize("Lq,Lk", [(33, 33), (20, 45)])
@pytest.mark.parametrize("Dh", [64, 128, 40])
def test_attention_bwd_matches_jax_vjp(Dh, Lq, Lk):
    """Ragged keys and a sample with no valid key (uniform P, no gradient to
    its keys), Lq = Lk and the sequence-parallel Lq != Lk."""
    q, k, v, valid, g = _inputs(Dh + Lq, 3, 2, Lq, Lk, Dh)
    _, vjp = jax.vjp(lambda q_, k_, v_: xla_attention(q_, k_, v_, jnp.asarray(valid)),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = tattn.attention_bwd(*map(torch.from_numpy, (q, k, v, valid)), None, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")
    assert float(got[1][2].abs().max()) == 0.0     # no gradient to the dead sample's keys


# -- the kernel's algorithm, emulated -----------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits), to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _rz(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero: a truncating accumulator's result."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


# The forward's k-steps over a 16-column pair (csrc/attention.cu scores_tf32):
# k-step 2j + h takes columns 16j + 4t + 2h and + 1 for t < 4.
HEAD_DIM_STEPS = [4 * t + 2 * h + e for h in range(2) for e in range(2) for t in range(4)]


def mma_product(a: torch.Tensor, b: torch.Tensor, chunk: int, a_split: bool = True,
                b_split: bool = True, head_dim_steps: bool = False,
                k_step: int = 8) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) in f32 as the kernel takes it: k-steps of
    `k_step` contraction columns (8 for TF32, 16 for bf16 operands), each
    TF32 pass (small*big, big*small, big*big; a pass whose small part is zero
    skipped) one mma that adds its exact products into its accumulator and
    truncates; a fresh accumulator every `chunk` columns from 0, added to the
    result rounded to nearest. With `head_dim_steps`, the k-steps take the
    columns of each 16 in the forward's order. K is zero-padded to whole
    chunks, as the kernel's ragged tile comes in zero-filled."""
    pad = -a.shape[-1] % chunk
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b.transpose(-1, -2), (0, pad)).transpose(-1, -2)
    if head_dim_steps:
        order = torch.tensor([16 * j + c for j in range(a.shape[-1] // 16) for c in HEAD_DIM_STEPS])
        a, b = a[..., order], b[..., order, :]
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    passes = ([(a_small, b_big)] if a_split else []) + ([(a_big, b_small)] if b_split else []) \
        + [(a_big, b_big)]
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for c0 in range(0, a.shape[-1], chunk):
        fresh = torch.zeros_like(out)
        for k0 in range(c0, c0 + chunk, k_step):
            ks = slice(k0, k0 + k_step)
            for x, y in passes:
                fresh = _rz(fresh.double() + x[..., ks].double() @ y[..., ks, :].double())
        out = out + fresh
    return out


def row_sum_in_lanes(e: torch.Tensor) -> torch.Tensor:
    """rowsum(e) (..., Lk) -> (..., 1) in f32 as the kernel sums D: the lane
    t of a quad adds its keys 8i + 2t and + 1 one after the other in
    ascending order, then the quad's four sums are added as (0 + 1) + (2 +
    3)."""
    e = torch.nn.functional.pad(e.float(), (0, -e.shape[-1] % 8))
    keys = e.reshape(*e.shape[:-1], -1, 4, 2)          # (..., 8-key group i, lane t, c)
    lanes = torch.zeros(*e.shape[:-1], 4)
    for i in range(keys.shape[-3]):
        for c in range(2):
            lanes = lanes + keys[..., i, :, c]
    return ((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3]))[..., None]


def scores_log2(q, k, valid, temperature=None, exact=False):
    """The forward kernel's scores in log2 units (and the backward kernel's,
    the same bits), times log2(e) / temperature, invalid keys at the -1e9
    fill: f32 Q K^T by split TF32 with the forward's k-steps and a fresh
    accumulator every 16 columns (exact: one pass); bf16 on the bf16 tensor
    cores, k-steps of 16 columns all into one accumulator."""
    temp = temperature if temperature is not None else q.shape[-1] ** 0.5
    scale = np.float32(LOG2E / temp)
    s = bf16_product(q, k.transpose(-1, -2)) if q.dtype == torch.bfloat16 else \
        mma_product(q.float(), k.float().transpose(-1, -2), 16, not exact, not exact,
                    head_dim_steps=True)
    return torch.where(valid[:, None, None, :], s * scale, torch.tensor(FILL_LOG2))


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) of bf16 values as the forward's and the
    backward's bf16 scores take it: k-steps of 16 into one accumulator."""
    return mma_product(a.float(), b.float(), a.shape[-1], False, False, k_step=16)


def forward_row_stats(q, k, valid, temperature=None):
    """The forward kernel's (m, l) as `attention_cuda(..., stats)` writes
    them: each row's max of its scores in log2 units and its sum of
    exp2(score - max). (B, H, Lq, 2) float32."""
    x = scores_log2(q, k, valid, temperature)
    m = x.amax(-1)
    return torch.stack([m, torch.exp2(x - m[..., None]).sum(-1)], -1)


def sequential_fma(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """p^T g for p (..., Lq, Lk), g (..., Lq, Dh) by f32 FMAs over the query
    rows one after the other in ascending order (each step rounded once)."""
    acc = torch.zeros(*p.shape[:-2], p.shape[-1], g.shape[-1], dtype=torch.float64)
    for r in range(p.shape[-2]):
        acc = (acc + p[..., r, :, None].double() * g[..., r, None, :].double()).float().double()
    return acc.float()


def emulated_bwd(q, k, v, valid, temperature, g, stats, fold_lse=False, one_pass=False):
    """(dq, dk, dv) by the kernel's algorithm on float32 or bfloat16 inputs
    (computed in f32, gradients in the input dtype), with the forward's row
    stats. fold_lse: take the weights as exp2(S - (m + log2 l)) with the sum
    folded into one f32 number, the design the kernel does not use.
    one_pass: every product by one TF32 pass (big * big), the split
    dropped."""
    dtype = q.dtype
    exact = dtype == torch.bfloat16 or one_pass    # a bf16 value is exact in TF32
    x = scores_log2(q, k, valid, temperature, exact)
    dp = bf16_product(g, v.transpose(-1, -2)) if dtype == torch.bfloat16 else \
        mma_product(g, v.transpose(-1, -2), 16, not exact, not exact, head_dim_steps=True)
    q, k, v, g = (t.float() for t in (q, k, v, g))
    temp = temperature if temperature is not None else q.shape[-1] ** 0.5
    ok = valid[:, None, None, :]
    m, l = stats[..., :1], stats[..., 1:]
    p = torch.exp2(x - (m + torch.log2(l))) if fold_lse else torch.exp2(x - m) * (1.0 / l)
    p_ok = torch.where(ok, p, torch.zeros(()))     # dS is 0 at invalid keys
    e = p_ok * dp
    D = row_sum_in_lanes(e)
    ds = torch.where(ok, p * (dp - D), torch.zeros(()))
    inv_temp = np.float32(1.0 / temp)
    a = mma_product(e, k, KEY_TILE, not one_pass, not exact)
    b = mma_product(p_ok, k, KEY_TILE, not one_pass, not exact)
    dq = (a.double() - D.double() * b.double()).float() * inv_temp
    dk = mma_product(ds.transpose(-1, -2), q, KEY_TILE, not one_pass, not exact) * inv_temp
    dv = sequential_fma(p, g)
    return tuple(d.to(dtype) for d in (dq, dk, dv))



def float64_bwd(q, k, v, valid, g):
    """The exact gradients (float64 throughout), temperature sqrt(Dh)."""
    q, k, v, g = (t.double() for t in (q, k, v, g))
    temp = q.shape[-1] ** 0.5
    invalid = ~valid[:, None, None, :]
    p = torch.softmax((q @ k.transpose(-1, -2) / temp).masked_fill(invalid, -1e9), -1)
    dp = g @ v.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).masked_fill(invalid, 0.0) / temp
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ g


@pytest.mark.parametrize("B,H,Lq,Lk,Dh", [(3, 2, 96, 96, 64), (3, 2, 40, 70, 128),
                                         (3, 2, 65, 130, 64)])
def test_emulated_kernel_holds_the_f32_bar(B, H, Lq, Lk, Dh):
    q, k, v, valid, g = map(torch.from_numpy, _inputs(B * Lq + Dh, B, H, Lq, Lk, Dh))
    got = emulated_bwd(q, k, v, valid, None, g, forward_row_stats(q, k, valid))
    want = tattn.attention_bwd(q, k, v, valid, None, g)
    exact = float64_bwd(q, k, v, valid, g)
    for name, a, b, e in zip("qkv", got, want, exact):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0, msg=f"d{name}")
        torch.testing.assert_close(a.double(), e, atol=GRAD_ATOL, rtol=0, msg=f"d{name} vs f64")
    assert float(got[1][2].abs().max()) == 0.0     # the dead sample's keys get none


def test_one_valid_key_weights_are_exactly_one_and_dv_sums_g_in_order():
    """One valid key: the recomputed score is the forward's max bit for bit,
    so every query's weight there is exp2(0) / 1 = 1 exactly and 0 at the
    other keys, and dv of that key is g summed over the query rows in
    ascending f32 order, the bits of the plain version's product on the card
    (cuBLAS sums one row after the other), tens at these lengths, where any
    other order lands past the 1e-5 bar; D is that key's dP, so dS and dk
    are exactly 0 there, as the plain version's. Three valid keys: dq and dk
    within the bar of the plain version, dv within it of float64."""
    q, k, v, valid, g = map(torch.from_numpy, _inputs(384, 2, 2, 160, 160, 64, [1, 3]))
    stats = forward_row_stats(q, k, valid)
    assert torch.equal(stats[0, ..., 1], torch.ones(2, 160))
    got = emulated_bwd(q, k, v, valid, None, g, stats)
    assert float(got[1][0].abs().max()) == 0.0
    in_order = torch.zeros(2, 64)
    for r in range(160):
        in_order = in_order + g[0, :, r]
    assert float(in_order.abs().max()) > 30
    assert torch.equal(got[2][0, :, 0], in_order)
    assert float(got[2][0, :, 1:].abs().max()) == 0.0
    plain = tattn.attention_bwd(q, k, v, valid, None, g)
    exact = float64_bwd(q, k, v, valid, g)
    for name, a, b in zip("qk", got, plain):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0, msg=f"d{name}")
    torch.testing.assert_close(got[2][1].double(), exact[2][1], atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("L", [1, 40])
def test_bf16_one_valid_key_weights_are_exactly_one(L):
    """In bf16 too the recomputed scores are the forward's bits (both on the
    bf16 tensor cores, k-steps of 16 into one sum): with one valid key the
    weight there is exactly 1, so dS and dk are exactly 0, as the plain
    version's are. dq = ((P * dP) K - D (P K)) / temp is a difference of two
    rounded products, within GRAD_ATOL of the plain version's 0."""
    q, k, v, valid, g = (torch.from_numpy(a) for a in _inputs(13 + L, 2, 2, L, L, 64, [1, 1]))
    q, k, v, g = (t.to(torch.bfloat16) for t in (q, k, v, g))
    stats = forward_row_stats(q, k, valid)
    assert torch.equal(stats[..., 1], torch.ones(2, 2, L))
    got = emulated_bwd(q, k, v, valid, None, g, stats)
    assert float(got[1].float().abs().max()) == 0.0
    plain = tattn.attention_bwd(q, k, v, valid, None, g)
    assert float(plain[0].float().abs().max()) == 0.0
    assert float(got[0].float().abs().max()) <= GRAD_ATOL
    assert torch.equal(got[2], plain[2]) if L == 1 else \
        float((got[2].float() - plain[2].float()).abs().max()) <= 1e-2 * float(
            plain[2].float().abs().max())


def test_one_tf32_pass_misses_the_f32_bar():
    """The premise of the three passes: with one TF32 product per f32
    product (no split), the same algorithm misses the bar."""
    q, k, v, valid, g = map(torch.from_numpy, _inputs(7, 3, 2, 96, 96, 64))
    want = tattn.attention_bwd(q, k, v, valid, None, g)
    stats = forward_row_stats(q, k, valid)
    split = emulated_bwd(q, k, v, valid, None, g, stats)
    one_pass = emulated_bwd(q, k, v, valid, None, g, stats, one_pass=True)
    assert max(float((a - b).abs().max()) for a, b in zip(split, want)) <= GRAD_ATOL
    assert max(float((a - b).abs().max()) for a, b in zip(one_pass, want)) > GRAD_ATOL


def test_bf16_inputs_take_the_exact_pass_and_hold_the_bf16_bar():
    """bf16 inputs: S and dP on the bf16 tensor cores (the forward's sums),
    products with P or dS two TF32 passes (a bf16 value is exact in TF32);
    the gradients, rounded to bf16, within 1e-2 of each one's max of the
    plain version (chip_smoke.py's BF16_GRAD_REL)."""
    q, k, v, valid, g = (torch.from_numpy(a) for a in _inputs(11, 3, 2, 64, 64, 64))
    q, k, v, g = (t.to(torch.bfloat16) for t in (q, k, v, g))
    got = emulated_bwd(q, k, v, valid, None, g, forward_row_stats(q, k, valid))
    want = tattn.attention_bwd(q, k, v, valid, None, g)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        rel = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert rel <= 1e-2, (name, rel)


def test_folded_log_sum_exp_breaks_the_all_invalid_sample():
    """A row with no valid key has m = -1e9 log2(e), where the f32 ulp is
    128: m + log2 l' rounds back to m, every key gets the weight 1 instead of
    1 / Lk, and dv of that sample is Lk times too large. Kept apart, m and
    l give the plain version's dv."""
    Lk = 64
    q, k, v, valid, g = map(torch.from_numpy, _inputs(5, 3, 2, 48, Lk, 64))
    stats = forward_row_stats(q, k, valid)
    assert float(stats[2, ..., 0].max()) == float(FILL_LOG2)
    want = tattn.attention_bwd(q, k, v, valid, None, g)[2][2]
    apart = emulated_bwd(q, k, v, valid, None, g, stats)[2][2]
    folded = emulated_bwd(q, k, v, valid, None, g, stats, fold_lse=True)[2]
    torch.testing.assert_close(apart, want, atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(folded[2], want * Lk, atol=1e-4, rtol=1e-5)
    # the samples with valid keys are not affected by the fold
    torch.testing.assert_close(folded[:2], tattn.attention_bwd(q, k, v, valid, None, g)[2][:2],
                               atol=GRAD_ATOL, rtol=0)


# -- the Functions with the kernels replaced by plain stand-ins ---------------

@pytest.fixture
def kernel_path(monkeypatch):
    """The Function takes its kernel route on CPU tensors: the forward
    stand-in computes the plain output and fills `stats` as the forward
    kernel does, the backward stand-in is `emulated_bwd`; each backward call
    is recorded with its q's shape."""
    calls = []

    def forward_kernel(q, k, v, key_valid, temperature=None, stats=None):
        if stats is not None:
            stats.copy_(forward_row_stats(q, k, key_valid, temperature))
        return tattn.attention_reference(q, k, v, key_valid, temperature)

    def backward(q, k, v, key_valid, temperature, g, stats):
        assert stats.shape == (*q.shape[:3], 2) and stats.dtype == torch.float32
        calls.append(tuple(q.shape))
        return emulated_bwd(q, k, v, key_valid, temperature, g, stats)

    monkeypatch.setattr(tattn, "kernel_backward", lambda q: True)
    monkeypatch.setattr(tattn, "attention_cuda", forward_kernel)
    monkeypatch.setattr(tattn, "attention_bwd_cuda", backward)
    return calls


def _function(q, k, v, valid):
    return tattn.AttentionFunction.apply(q, k, v, valid, None)[0]


def _reference(q, k, v, valid):
    return tattn.attention_reference(q, k, v, valid)


def _close(got, want, what, atol=GRAD_ATOL):
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=f"{what} d{name}")


def test_function_first_order_takes_the_kernel(kernel_path):
    q, k, v, valid, g = map(torch.from_numpy, _inputs(21, 3, 2, 40, 40, 64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(_function(*leaves, valid), leaves, g)
    assert kernel_path == [(3, 2, 40, 64)]
    _close(got, tattn.attention_bwd(q, k, v, valid, None, g), "first order")


def test_function_double_backward_is_the_plain_recompute_s(kernel_path):
    """Second order (MAML's create_graph): the first-order gradients come
    from the kernel, their derivative from the plain recompute's VJP."""
    q, k, v, valid, w = map(torch.from_numpy, _inputs(22, 3, 2, 24, 24, 64))
    us = _inputs(27, 3, 2, 24, 24, 64)[:3]

    def second(attn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        first = torch.autograd.grad((attn(*leaves, valid) * w).sum(), leaves, create_graph=True)
        inner = sum((d * torch.from_numpy(u)).sum() for d, u in zip(first, us))
        return [d.detach() for d in first], torch.autograd.grad(inner, leaves)

    got_first, got = second(_function)
    want_first, want = second(_reference)
    assert kernel_path == [(3, 2, 24, 64)]
    _close(got_first, want_first, "first order")
    _close(got, want, "second order")
    assert max(float(d.abs().max()) for d in want) > 1e-2


def test_function_grad_of_grad_and_vmap_fold_tasks_into_one_call(kernel_path):
    """`torch.func.grad` twice (second-order MAML), and `vmap(grad)` over 4
    tasks (the vmapped adaptation): one backward call for all tasks."""
    q, k, v, valid, w = map(torch.from_numpy, _inputs(23, 3, 2, 16, 16, 64))

    def loss(attn):
        return lambda q_, k_, v_: (attn(q_, k_, v_, valid) * w).sum()

    us = [torch.from_numpy(u) for u in _inputs(28, 3, 2, 16, 16, 64)[:3]]

    def hvp(attn):             # the first gradient against u, differentiated again
        g_ = grad(loss(attn), argnums=(0, 1, 2))
        return lambda q_, k_, v_: sum((d * u).sum() for d, u in zip(g_(q_, k_, v_), us))

    _close(grad(hvp(_function), argnums=(0, 1, 2))(q, k, v),
           grad(hvp(_reference), argnums=(0, 1, 2))(q, k, v), "grad of grad")
    tasks = 4
    rng = np.random.default_rng(24)
    qs, ks, vs, ws = (torch.from_numpy(rng.normal(size=(tasks, 3, 2, 16, 64)).astype(np.float32))
                      for _ in range(4))
    valids = torch.stack([valid.roll(t, dims=0) for t in range(tasks)])

    def task_grads(attn):
        def task_loss(q_, k_, v_, m_, w_):
            return (attn(q_, k_, v_, m_) * w_).sum()
        return vmap(grad(task_loss, argnums=(0, 1, 2)))(qs, ks, vs, valids, ws)

    kernel_path.clear()
    got = task_grads(_function)
    assert kernel_path == [(tasks * 3, 2, 16, 64)]
    _close(got, task_grads(_reference), "vmap(grad)")


def test_folded_tasks_get_the_same_bits_as_each_task_alone(kernel_path):
    """The kernel's tiles do not depend on B * H: N tasks folded into B by
    the vmap rules give each task the bits of its own call."""
    tasks = 3
    rng = np.random.default_rng(25)
    qs, ks, vs, gs = (torch.from_numpy(rng.normal(size=(tasks, 2, 2, 40, 64)).astype(np.float32))
                      for _ in range(4))
    valid = torch.from_numpy(np.arange(40)[None, :] < np.array([[40, 7], [0, 40], [13, 2]])[..., None])
    stats = torch.stack([forward_row_stats(q, k, m) for q, k, m in zip(qs, ks, valid)])

    def call(q, k, v, m, g, st):
        return tattn.AttentionGradFunction.apply(q, k, v, m, None, g, st)

    folded = vmap(call)(qs, ks, vs, valid, gs, stats)
    assert kernel_path == [(tasks * 2, 2, 40, 64)]
    for t in range(tasks):
        alone = call(qs[t], ks[t], vs[t], valid[t], gs[t], stats[t])
        for a, b in zip(folded, alone):
            assert torch.equal(a[t], b)


# -- the wrappers' checks (no card here) ---------------------------------------

def test_function_takes_the_plain_backward_on_cpu_tensors(monkeypatch):
    """Without a card the Function's stats are a (B, H, Lq, 0) placeholder
    and its backward is `attention_bwd`."""
    monkeypatch.setattr(tattn, "attention_cuda",
                        lambda q, k, v, key_valid, temperature=None:
                        tattn.attention_reference(q, k, v, key_valid, temperature))
    monkeypatch.setattr(tattn, "attention_bwd_cuda", None)     # never reached
    q, k, v, valid, g = map(torch.from_numpy, _inputs(26, 3, 2, 12, 12, 64))
    assert not tattn.kernel_backward(q)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, stats = tattn.AttentionFunction.apply(*leaves, valid, None)
    assert stats.shape == (3, 2, 12, 0) and not stats.requires_grad
    _close(torch.autograd.grad(out, leaves, g), tattn.attention_bwd(q, k, v, valid, None, g),
           "plain backward")


@pytest.mark.parametrize("bad,reason", [
    ("cpu", "takes CUDA tensors"), ("wide", "head dims up to 128"),
    ("stats_shape", "stats must be"), ("g_dtype", "g must be")])
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(bad, reason):
    q = torch.zeros(2, 2, 16, 64)
    valid = torch.ones(2, 16, dtype=torch.bool)
    g, stats = torch.zeros_like(q), torch.zeros(2, 2, 16, 2)
    if bad == "wide":
        q = g = torch.zeros(2, 2, 16, 192)
    elif bad == "stats_shape":
        stats = torch.zeros(2, 2, 16)
    elif bad == "g_dtype":
        g = g.double()
    with pytest.raises(ValueError, match=reason):
        tattn.attention_bwd_cuda(q, q, q, valid, None, g, stats)


def test_forward_wrapper_writes_stats_on_the_narrow_route_only():
    q = torch.zeros(1, 2, 16, 192)
    valid = torch.ones(1, 16, dtype=torch.bool)
    with pytest.raises(ValueError, match="narrow route"):
        tattn.attention_cuda(q, q, q, valid, None, torch.zeros(1, 2, 16, 2))
