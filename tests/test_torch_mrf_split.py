"""The numerical premise of the CUDA MRF stage kernel's f32 route, and the
layout of its packed weights.

`csrc/mrf_stage.cu` takes every f32 conv product on the TF32 tensor cores by
split TF32: each operand x (the activation after leaky, and the weight) is
split into big = tf32(x) and small = tf32(x - big), rounded to nearest with
ties away from zero as `cvt.rna.tf32.f32` does, and a product is taken as
small*big + big*small + big*big, with products exact and sums in f32.
Emulated here in torch for a whole HiFiGAN V1 stage (three ResBlock1 with
kernels 3, 7, 11 and dilations 1, 3, 5; conv_post, which the kernel takes on
the f32 FMA units, in plain f32), it must stay within the f32 stage bars of
`mrf_stage_reference` (mean |d| < 1e-5, max < 5e-3: the bars
tests/test_hifigan_fused.py holds the TPU kernel to); one TF32 product per
f32 product must miss the mean bar. This runs on the CPU; the kernel itself
is held to the same bars on the card by tests/test_torch_cuda.py and
chip_smoke.py.

The weights reach the kernel packed once on the host in its mma.sync
fragment order (`_pack_weight`; in f32 the kernel splits them in registers);
unpacked here by the fragment layouts of m16n8k8 (TF32) and m16n8k16 (bf16)
A operands, the f32 packing gives back the weight exactly and the bf16
packing exactly the bf16-rounded weight.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fscl_tpu_torch.models.hifigan import ResBlock1
from fscl_tpu_torch.ops import mrf_stage as tmrf

STAGE_F32_MEAN, STAGE_F32_MAX = 1e-5, 5e-3


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


def emulated_conv(h, conv, dilation, passes):
    """conv(leaky(h)) as the kernel takes it: split-TF32 products (passes = 3)
    or one TF32 product (passes = 1), exact, summed in f32; bias after."""
    a, w = F.leaky_relu(h, tmrf.SLOPE), conv.weight
    a_big, w_big = tf32_rna(a), tf32_rna(w)
    kw = dict(padding=(w.shape[-1] - 1) // 2 * dilation, dilation=dilation)
    y = F.conv1d(a_big, w_big, **kw)
    if passes == 3:
        y = (F.conv1d(tf32_rna(a - a_big), w_big, **kw) + F.conv1d(a_big, tf32_rna(w - w_big), **kw)
             + y)
    return y + conv.bias[:, None]


def emulated_stage(x, resblocks, post, passes):
    acc = None
    for rb in resblocks:
        h = x
        for d, c1, c2 in zip(rb.dilations, rb.convs1, rb.convs2):
            h = h + emulated_conv(emulated_conv(h, c1, d, passes), c2, 1, passes)
        acc = h if acc is None else acc + h
    y = acc * (1.0 / len(resblocks))
    if post is None:
        return y
    return torch.tanh(F.conv1d(F.leaky_relu(y, tmrf.SLOPE), post.weight, post.bias, padding=3))[:, 0]


def _stage(C, post, seed):
    torch.manual_seed(seed)
    rbs = [ResBlock1(C, k, (1, 3, 5)) for k in (3, 7, 11)]
    return rbs, (torch.nn.Conv1d(C, 1, 7, padding=3) if post else None)


def test_tf32_split_keeps_f32_within_2_22():
    """big + small, both TF32 (13 low bits zero), give back x within 2^-22
    relative: the dropped small*small term is below f32's own rounding."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=10000).astype(np.float32))
    big = tf32_rna(x)
    small = tf32_rna(x - big)
    assert ((big.view(torch.int32) & 0x1fff) == 0).all() and ((small.view(torch.int32) & 0x1fff) == 0).all()
    assert ((big + small - x).abs() <= 2.0 ** -22 * x.abs()).all()


# The widest V1 stage and the narrowest, which carries conv_post.
@pytest.mark.parametrize("C,T,post", [(256, 256, False), (32, 1024, True)],
                         ids=["C256", "C32_post"])
def test_split_tf32_stage_holds_the_f32_bars(C, T, post):
    rbs, conv_post = _stage(C, post, seed=C)
    x = torch.from_numpy(np.random.default_rng(C).normal(size=(2, C, T)).astype(np.float32))
    with torch.no_grad():
        want = tmrf.mrf_stage_reference(x, rbs, conv_post)
        split = (emulated_stage(x, rbs, conv_post, 3) - want).abs()
        one_pass = (emulated_stage(x, rbs, conv_post, 1) - want).abs()
    assert split.mean() < STAGE_F32_MEAN and split.max() < STAGE_F32_MAX, (split.mean(), split.max())
    assert one_pass.mean() > STAGE_F32_MEAN, one_pass.mean()


def unpack_f32(packed, c_out, c_in, k):
    """Invert the m16n8k8 TF32 A fragments: lane (g, t) = (lane // 4,
    lane % 4) holds a[r] = W[16m + g + 8 (r % 2), 8c + t + 4 (r // 2), i]."""
    assert packed.shape == (c_out // 16, c_in // 8, k, 32, 4)
    assert packed.dtype == torch.float32
    w = torch.full((c_out, c_in, k), float("nan"))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r in range(4):
            co, ci = g + 8 * (r % 2), t + 4 * (r // 2)
            w[co::16, ci::8] = packed[:, :, :, lane, r]
    return w


def unpack_bf16(packed, c_out, c_in, k):
    """Invert the m16n8k16 bf16 A fragments: lane (g, t) holds in register r
    the pair W[16m + g + 8 (r % 2), 16c + 2t + 8 (r // 2) + (0, 1), i], the
    lower k in the low half."""
    assert packed.shape == (c_out // 16, c_in // 16, k, 32, 4, 2)
    assert packed.dtype == torch.bfloat16
    w = torch.zeros(c_out, c_in, k, dtype=torch.bfloat16)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r in range(4):
            co, ci = g + 8 * (r % 2), 2 * t + 8 * (r // 2)
            for e in range(2):
                w[co::16, ci + e::16] = packed[:, :, :, lane, r, e]
    return w


@pytest.mark.parametrize("C,k", [(32, 3), (64, 11), (96, 7)])
def test_f32_packing_is_the_weight_in_fragment_order(C, k):
    w = torch.from_numpy(np.random.default_rng(k).normal(size=(C, C, k)).astype(np.float32))
    assert torch.equal(unpack_f32(tmrf._pack_weight(w, False), C, C, k), w)


@pytest.mark.parametrize("C,k", [(32, 3), (64, 11), (96, 7)])
def test_bf16_packing_is_the_rounded_weight_in_fragment_order(C, k):
    w = torch.from_numpy(np.random.default_rng(k + 1).normal(size=(C, C, k)).astype(np.float32))
    got = unpack_bf16(tmrf._pack_weight(w, True), C, C, k)
    assert torch.equal(got, w.to(torch.bfloat16))
