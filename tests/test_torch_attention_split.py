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
chip_smoke.py. Also pinned here: the wrapper's choice of key split (how many
of a block's warps share the key loop) from B * H, L and the SM count.
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


# The wrapper's key split (warps of a block that share the key loop) on a
# 132-SM card, as chip_smoke.py timed it: full query tiles where they give a
# block for every two SMs, else a split.
@pytest.mark.parametrize("dtype,batch_heads,L,want", [
    (torch.float32, 16, 1000, 1), (torch.float32, 16, 512, 2), (torch.float32, 16, 256, 4),
    (torch.float32, 16, 16, 4), (torch.float32, 128, 1000, 1),
    (torch.bfloat16, 16, 1000, 1), (torch.bfloat16, 16, 512, 1), (torch.bfloat16, 16, 256, 2),
    (torch.bfloat16, 16, 64, 4), (torch.bfloat16, 128, 1000, 1)])
def test_key_split_rule(dtype, batch_heads, L, want):
    assert tattn.choose_key_split(batch_heads, L, 132, dtype) == want


# The wide route (head dims above 128): each query tile is one block per
# 128 columns of the padded head dim, which count toward the grid as query
# tiles do.
@pytest.mark.parametrize("dtype,batch_heads,L,dh,want", [
    (torch.float32, 16, 256, 192, 2), (torch.float32, 16, 256, 512, 1),
    (torch.float32, 16, 512, 256, 1), (torch.float32, 2, 64, 1024, 4),
    (torch.bfloat16, 16, 256, 200, 1), (torch.bfloat16, 16, 64, 320, 2),
    (torch.bfloat16, 1, 16, 512, 4), (torch.float32, 16, 256, 128, 4)])
def test_key_split_rule_counts_the_wide_route_s_slices(dtype, batch_heads, L, dh, want):
    assert tattn.choose_key_split(batch_heads, L, 132, dtype, dh) == want


def test_cuda_wrapper_refuses_an_unknown_key_split():
    q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="key_split"):
        tattn._launch(q, q, q, torch.ones(1, 16, dtype=torch.bool), None, 3)


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
    truncations grow with L, within the f32 bar up to the 1024 keys the
    kernel sums so (`Cfg::DIRECT_TILES`) and past it at 18000; one fresh
    accumulator per key tile, added rounded to nearest, stays far within it
    (the design of `weighted_values`; chip_smoke.py phase 3 and the 360 s
    upstream forward hold the kernel so on the card)."""
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
