"""The numerical premise of the CUDA MRF stage kernel's f32 route, the
layout of its packed weights, and the passes that layout follows.

`csrc/mrf_stage.cu` takes every f32 conv product on the TF32 tensor cores by
split TF32: each operand x (the activation after leaky, and the weight) is
split into big = tf32(x) and small = tf32(x - big), rounded to nearest with
ties away from zero as `cvt.rna.tf32.f32` does, and a product is taken as
small*big + big*small + big*big, with products exact and sums in f32.
Emulated here in torch for a whole HiFiGAN V1 stage (three ResBlock1 with
kernels 3, 7, 11 and dilations 1, 3, 5; conv_post, which the kernel takes on
the f32 FMA units, in plain f32), on the weight parts the host packs for the
kernel, it must stay within the f32 stage bars of `mrf_stage_reference`
(mean |d| < 1e-5, max < 5e-3: the bars tests/test_hifigan_fused.py holds the
TPU kernel to); one TF32 product per f32 product must miss the mean bar.
This runs on the CPU; the kernel itself is held to the same bars on the card
by tests/test_torch_cuda.py and chip_smoke.py.

The weights reach the kernel packed once on the host in its wgmma B operand
layout (`_pack_weight`: per pass, k-step and tap a contiguous chunk of
16-byte rows of input channels, one row per output channel; in f32 as TF32
big and small parts). Unpacked here by that layout, the f32 parts give back
the weight within 2^-22 of each element and are both TF32, and the bf16
packing gives back exactly the bf16-rounded weight. `pass_width` (NP, the
output channels a pass, which the layout follows) is pinned at the widths
that set it.
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
    or one TF32 product (passes = 1), exact, summed in f32 as the kernel
    issues them (small*big, big*small, then big*big); bias after. The
    weight's parts are the ones the host packs for the kernel."""
    a, w = F.leaky_relu(h, tmrf.SLOPE), conv.weight
    C, _, k = w.shape
    w_big, w_small = unpack_f32(tmrf._pack_weight(w, False), C, C, k)
    a_big = tf32_rna(a)
    kw = dict(padding=(w.shape[-1] - 1) // 2 * dilation, dilation=dilation)
    y = F.conv1d(a_big, w_big, **kw)
    if passes == 3:
        y = (F.conv1d(tf32_rna(a - a_big), w_big, **kw) + F.conv1d(a_big, w_small, **kw)) + y
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
    """Invert the f32 packing: [p, s, i, part, kg, n, e] holds part (0 big,
    1 small) of W[p NP + n, 8 s + 4 kg + e, i]. Returns (big, small)."""
    np_ = tmrf.pass_width(c_out)
    assert packed.shape == (c_out // np_, c_in // 8, k, 2, 2, np_, 4)
    assert packed.dtype == torch.float32
    parts = packed.permute(3, 0, 5, 1, 4, 6, 2).reshape(2, c_out, c_in, k)
    return parts[0], parts[1]


def unpack_bf16(packed, c_out, c_in, k):
    """Invert the bf16 packing: [p, s, i, kg, n, e] holds
    W[p NP + n, 16 s + 8 kg + e, i]."""
    np_ = tmrf.pass_width(c_out)
    assert packed.shape == (c_out // np_, c_in // 16, k, 2, np_, 8)
    assert packed.dtype == torch.bfloat16
    return packed.permute(0, 4, 1, 3, 5, 2).reshape(c_out, c_in, k)


# NP = 32 (C = 32, 96: three passes), 64 and 128 (C = 256: two passes)
PACK_CASES = [(32, 3), (64, 11), (96, 7), (128, 3), (256, 11)]


@pytest.mark.parametrize("C,k", PACK_CASES)
def test_f32_packing_is_the_weight_in_fragment_order(C, k):
    """The packed parts, read back by the layout the kernel's B descriptor
    reads, are TF32 (13 low bits zero), the big part is the weight rounded as
    cvt.rna.tf32.f32 rounds, and big + small is the weight within 2^-22."""
    w = torch.from_numpy(np.random.default_rng(k).normal(size=(C, C, k)).astype(np.float32))
    big, small = unpack_f32(tmrf._pack_weight(w, False), C, C, k)
    for part in (big, small):
        assert ((part.contiguous().view(torch.int32) & 0x1fff) == 0).all()
    assert torch.equal(big, tf32_rna(w))
    assert torch.equal(small, tf32_rna(w - big))
    assert ((big + small - w).abs() <= 2.0 ** -22 * w.abs()).all()


@pytest.mark.parametrize("C,k", PACK_CASES)
def test_bf16_packing_is_the_rounded_weight_in_fragment_order(C, k):
    w = torch.from_numpy(np.random.default_rng(k + 1).normal(size=(C, C, k)).astype(np.float32))
    got = unpack_bf16(tmrf._pack_weight(w, True), C, C, k)
    assert torch.equal(got, w.to(torch.bfloat16))


# C -> NP, the output channels a pass (wgmma's N): the largest of 128, 64
# and 32 dividing C. The packing's layout follows it; the tile height and
# whether a pair is fused are the library's (pinned on the card by
# tests/test_torch_cuda.py::test_mrf_stage_route_is_the_rule).
PASS_WIDTHS = [(32, 32), (64, 64), (96, 32), (128, 128), (160, 32), (192, 64), (224, 32),
               (256, 128), (288, 32), (320, 64), (384, 128), (448, 64), (512, 128),
               (544, 32), (640, 128), (736, 32), (832, 64), (1024, 128)]


@pytest.mark.parametrize("C,np_", PASS_WIDTHS)
def test_pass_width_rule(C, np_):
    assert tmrf.pass_width(C) == np_
    w = torch.zeros(C, C, 3)
    assert tmrf._pack_weight(w, False).shape[0] == tmrf._pack_weight(w, True).shape[0] == C // np_


@pytest.mark.parametrize("C", [0, 16, 48, 100])
def test_pass_width_refuses_widths_the_kernel_cannot_take(C):
    with pytest.raises(ValueError, match="multiple of 32"):
        tmrf.pass_width(C)


@pytest.mark.parametrize("T,ld", [(1, 4), (4, 4), (5, 8), (255, 256), (256, 256), (8000, 8000),
                                  (3 * 2 ** 24 + 100, 3 * 2 ** 24 + 100)])
def test_row_pitch_is_t_rounded_up_to_4(T, ld):
    assert tmrf.row_pitch(T) == ld
