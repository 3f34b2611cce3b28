"""The numerical premise of the CUDA attention kernel's f32 route.

`csrc/attention.cu` takes f32 products on the TF32 tensor cores by split
TF32: each f32 operand x is split into big = tf32(x) and small =
tf32(x - big), rounded to nearest with ties away from zero as
`cvt.rna.tf32.f32` does, and a product is taken as small*big + big*small +
big*big, with products exact and sums in f32. Emulated here in torch for
Q K^T and P V, with the kernel's unnormalised P divided by its row sum at the
end, it must stay within the f32 bar (2e-5) of `attention_reference`; one
TF32 product per f32 product must not. This runs on the CPU; the kernel
itself is held to the same bar on the card by tests/test_torch_cuda.py and
chip_smoke.py. Also pinned here: the wrapper's choice of key split, on the
narrow route from the query length, the caller's head dim and row stats
(`narrow_split`), on the wide route
(how many of a block's warps share the key loop) from B * H, L and the SM
count.
"""
import numpy as np
import pytest
import torch

from fscl_tpu_torch.ops import attention as tattn

F32_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # tier-1 runs several test processes at once
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits), to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def emulated_attention(q, k, v, valid, passes):
    scores = split_matmul(q, k.transpose(-1, -2), passes) / q.shape[-1] ** 0.5
    scores = scores.masked_fill(~valid[:, None, None, :], tattn.NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    return split_matmul(p, v, passes) / p.sum(-1, keepdim=True)


def test_tf32_rounding_is_rna():
    one = 1.0 + 2.0 ** -10                  # a TF32 value: unchanged
    half_up = 1.0 + 2.0 ** -11              # a tie: away from zero
    below = 1.0 + 2.0 ** -11 - 2.0 ** -23   # below the tie: down
    x = torch.tensor([one, half_up, below, -half_up, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one, 1.0, -one, 3.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)


def test_split_tf32_attention_holds_the_f32_bar():
    B, H, L, Dh = 2, 2, 1000, 128
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(a) for a in rng.normal(size=(3, B, H, L, Dh)).astype(np.float32))
    valid = torch.from_numpy(np.arange(L)[None, :] < np.array([L - L // 3, L])[:, None])
    want = tattn.attention_reference(q, k, v, valid)
    split_err = float((emulated_attention(q, k, v, valid, 3) - want).abs().max())
    one_pass_err = float((emulated_attention(q, k, v, valid, 1) - want).abs().max())
    assert split_err <= F32_ATOL, split_err
    assert one_pass_err > F32_ATOL, one_pass_err


# The narrow route's key split (head dims up to 128): 2, the two consumer
# warpgroups of a block split the key loop of one 64-row tile, up to
# NARROW_SPLIT_MAX_L query rows (by the caller's head dim: up to 48, 64, up
# to 128; serving or with row stats); 1, a 128-row tile, above. Query
# length, head dim and row stats decide, in both types. The padded head
# dims' rows are the choices chip_ab.py's sweep measured faster at (8, 2,
# L, 40 | 48): split 2 up to L = 256, split 1 at 399 and above.
@pytest.mark.parametrize("dtype,L,dh,stats,want", [
    (torch.float32, 1, 128, False, 2), (torch.float32, 64, 128, False, 2),
    (torch.float32, 256, 128, False, 2), (torch.float32, 512, 128, False, 2),
    (torch.float32, 513, 128, False, 1), (torch.float32, 1000, 128, False, 1),
    (torch.float32, 128, 128, True, 2), (torch.float32, 129, 128, True, 1),
    (torch.float32, 512, 128, True, 1), (torch.float32, 199, 64, False, 1),
    (torch.float32, 64, 64, False, 2), (torch.float32, 2048, 64, True, 1),
    (torch.bfloat16, 128, 128, True, 2), (torch.bfloat16, 512, 128, False, 2),
    (torch.bfloat16, 1000, 128, False, 1), (torch.bfloat16, 199, 64, False, 1),
    (torch.bfloat16, 1000, 64, False, 1), (torch.float32, 77, 40, False, 2),
    (torch.bfloat16, 1280, 80, False, 1), (torch.float32, 500, 80, False, 2),
    (torch.float32, 199, 40, False, 2), (torch.bfloat16, 199, 40, False, 2),
    (torch.float32, 199, 48, True, 2), (torch.bfloat16, 256, 48, False, 2),
    (torch.float32, 257, 40, False, 1), (torch.bfloat16, 399, 40, True, 1),
    (torch.float32, 65, 64, False, 1), (torch.bfloat16, 64, 64, True, 2)])
def test_narrow_split_rule(dtype, L, dh, stats, want):
    assert tattn.narrow_split(L, dh, stats) == want
    # the wrapper's choice on the narrow route is the same rule, whatever B,
    # H and the card's SM count: a sample's output does not depend on the
    # batch, nor on how its heads are split over ranks
    for B, H in ((1, 1), (8, 2), (32, 16), (35000, 2)):
        for n_sm in (132, 114):
            assert tattn.choose_key_split((B, H, L, dh), dtype, n_sm, stats) == want


# Work items of one narrow launch (ops/attention.py:narrow_items) at the
# wrapper's split: the shapes csrc/attention.cu's header and PERF.md name, a
# 64-row tile per item at key split 2, 128 rows at 1.
@pytest.mark.parametrize("batch_heads,L,stats,want", [
    (16, 64, False, 16), (16, 128, False, 32), (16, 256, False, 64), (32, 128, True, 64),
    (8, 128, True, 16), (16, 512, False, 128), (16, 1000, False, 128), (32, 512, True, 128),
    (64, 256, True, 128)])
def test_narrow_items_at_the_wrapper_s_split(batch_heads, L, stats, want):
    split = tattn.narrow_split(L, 128, stats)
    assert tattn.narrow_items(batch_heads, L, split) == want


def test_key_splits_by_route():
    assert tattn.key_splits(64) == tattn.key_splits(128) == tattn.key_splits(40) == (1, 2)
    assert tattn.key_splits(192) == tattn.key_splits(512) == (1, 2, 4)


# The wide route (head dims above 128): each query tile is one block per
# 128 columns of the padded head dim, which count toward the grid as query
# tiles do.
@pytest.mark.parametrize("dtype,batch_heads,L,dh,want", [
    (torch.float32, 16, 256, 192, 2), (torch.float32, 16, 256, 512, 1),
    (torch.float32, 16, 512, 256, 1), (torch.float32, 2, 64, 1024, 4),
    (torch.bfloat16, 16, 256, 200, 1), (torch.bfloat16, 16, 64, 320, 2),
    (torch.bfloat16, 1, 16, 512, 4), (torch.float32, 16, 256, 128, 2)])
def test_key_split_rule_counts_the_wide_route_s_slices(dtype, batch_heads, L, dh, want):
    assert tattn.choose_key_split((batch_heads, 1, L, dh), dtype, 132, False) == want
    if dh > 128:
        assert tattn.wide_split(batch_heads, L, 132, dtype, dh) == want


def test_cuda_wrapper_refuses_an_unknown_key_split():
    q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="key_split"):
        tattn._launch(q, q, q, torch.ones(1, 16, dtype=torch.bool), None, 3)
    # the wide route's 4 is not the narrow route's
    with pytest.raises(ValueError, match="key_split"):
        tattn._check_launch(q, q, q, torch.ones(1, 16, dtype=torch.bool), 4)


def _rz(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero: a truncating accumulator's result."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _pv_truncating(p, v, fresh_per_tile: bool, tile: int = 32):
    """P V (rows x keys times keys x columns) by split TF32, each mma of 8
    keys (its 8 products exact) added into its accumulator with truncation,
    as the kernel's tensor cores do: either every product into o (the
    earlier design) or each key tile's into a fresh accumulator added to o
    rounded to nearest (`csrc/attention.cu:weighted_values`)."""
    p_big, v_big = tf32_rna(p), tf32_rna(v)
    p_small, v_small = tf32_rna(p - p_big), tf32_rna(v - v_big)
    o = torch.zeros(p.shape[0], v.shape[1], dtype=torch.float32)
    d = o.clone()
    for k0 in range(0, p.shape[1], 8):
        ks = slice(k0, k0 + 8)
        acc = d if fresh_per_tile else o
        for a, b in ((p_small, v_big), (p_big, v_small), (p_big, v_big)):
            acc = _rz(acc.double() + a[:, ks].double() @ b[ks].double())
        if not fresh_per_tile:
            o = acc
        elif (k0 + 8) % tile == 0 or k0 + 8 >= p.shape[1]:
            o, d = o + acc, torch.zeros_like(d)
        else:
            d = acc
    return o


@pytest.mark.parametrize("L", [1024, 18000])
def test_fresh_accumulators_per_key_tile_hold_long_keys_with_a_common_value(L):
    """Under that truncating-accumulator model, L keys whose V has a common
    part (V = 1 + 0.1 N(0, 1), as features have): accumulated into o, the
    truncations grow with L, within the f32 bar at 1024 keys (though in
    training, where the errors compound over steps, no longer close enough)
    and past it at 18000; one fresh accumulator per key tile, added rounded
    to nearest, stays far within it (the design of both routes'
    `weighted_values` and `pv_f32` at every length; chip_smoke.py phase 3
    and the 360 s upstream forward hold the kernel so on the card)."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.uniform(0.0, 1.0, (16, L)).astype(np.float32))
    v = torch.from_numpy((1.0 + 0.1 * rng.normal(size=(L, 8))).astype(np.float32))
    want = (p.double() @ v.double()) / p.double().sum(-1, keepdim=True)
    l = p.sum(-1, keepdim=True)
    direct = float(((_pv_truncating(p, v, False) / l).double() - want).abs().max())
    fresh = float(((_pv_truncating(p, v, True) / l).double() - want).abs().max())
    assert fresh <= F32_ATOL / 4, fresh
    if L <= 1024:
        assert direct <= F32_ATOL / 2, direct
    else:
        assert direct > F32_ATOL, direct
