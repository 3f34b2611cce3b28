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


def test_cuda_wrapper_refuses_an_unknown_key_split():
    q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="key_split"):
        tattn._launch(q, q, q, torch.ones(1, 16, dtype=torch.bool), None, 3)
