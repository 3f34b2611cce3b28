"""The MRF stage wrapper's batch split (JAX-free).

The stage kernel's grid takes at most 65535 samples; `mrf_stage_cuda` splits
any batch into launches within it (`batch_splits`), as fscl_tpu's XLA
HiFi-GAN computes any batch. The kernel's offsets are 64-bit, so the number
of elements of a sample or a launch does not split it. There is no card
here, so the launch (`_launch_stage`) is swapped for a stand-in that records
each launch's shape and, at small sizes, writes the plain version of its
samples into its slice of the output; the limit is made small so that the
split runs at a size the CPU computes quickly. The whole result must equal
the plain version on the whole batch. One split launch, and one sample of
more than 2^31 elements in one launch, are held on the card by
chip_smoke.py phase 3.
"""
import pytest
import torch

from fscl_tpu_torch.models.hifigan import ResBlock1
from fscl_tpu_torch.ops import mrf_stage as tmrf


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # tier-1 runs several test processes at once
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("B,C,T,want", [
    (1, 32, 8, [(0, 1)]),
    (65535, 32, 8, [(0, 65535)]),
    (65540, 32, 8, [(0, 65535), (65535, 65540)]),
    (140000, 32, 4, [(0, 65535), (65535, 131070), (131070, 140000)]),
    # B * C * T past 2^31 (5 x 2 GiB, 3 x 4 GiB of f32): one launch, the
    # offsets being 64-bit
    (5, 256, 2 ** 21, [(0, 5)]),
    (3, 512, 2 ** 21, [(0, 3)])])
def test_batch_splits_keep_each_launch_within_the_kernel(B, C, T, want):
    got = tmrf.batch_splits(B, C, T)
    assert got == want
    for b0, b1 in got:
        assert 1 <= b1 - b0 <= tmrf.MAX_BATCH


def test_a_sample_past_2_31_elements_is_one_launch():
    """One sample of 256 x 2^23 = 2^31 elements (8 GiB of f32), which the
    kernel once refused, is one launch."""
    assert tmrf.batch_splits(1, 256, 2 ** 23) == [(0, 1)]


def _stage(C, post, seed=0):
    torch.manual_seed(seed)
    rbs = [ResBlock1(C, k, d) for k, d in ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))]
    conv_post = torch.nn.Conv1d(C, 1, 7, padding=3) if post else None
    return rbs, conv_post


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("max_batch,launches", [     # the grid's limit, made small
    (3, [(3, 32, 20), (3, 32, 20), (1, 32, 20)]),
    (2, [(2, 32, 20), (2, 32, 20), (2, 32, 20), (1, 32, 20)])])
def test_wrapper_splits_the_batch_into_launches(monkeypatch, post, max_batch, launches):
    rbs, conv_post = _stage(32, post)
    x = torch.randn(7, 32, 20, generator=torch.Generator().manual_seed(1))
    seen = []

    def plain_launch(xs, out, ks, n_dil, dils, packed, post_w, post_b, round_bf16):
        assert xs.shape[0] <= tmrf.MAX_BATCH
        assert out.shape[0] == xs.shape[0] and (post_w is not None) == post
        seen.append(tuple(xs.shape))
        out.copy_(tmrf.mrf_stage_reference(xs, rbs, conv_post))

    monkeypatch.setattr(tmrf, "MAX_BATCH", max_batch)
    monkeypatch.setattr(tmrf, "_launch_stage", plain_launch)
    with torch.no_grad():
        got = tmrf.mrf_stage_cuda(x, rbs, conv_post)
        want = tmrf.mrf_stage_reference(x, rbs, conv_post)
    assert seen == launches
    assert got.shape == want.shape == ((7, 20) if post else (7, 32, 20))
    # the CPU's convs may sum in another order at another batch size
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_cpu_tensors_are_still_refused_at_the_launch():
    rbs, conv_post = _stage(32, True)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tmrf.mrf_stage_cuda(torch.zeros(2, 32, 10), rbs, conv_post)


def test_a_time_axis_past_the_kernel_s_int_range_is_refused():
    """T is an int in the kernel, up to MAX_T (a window's last row, T plus
    its halo and a tile, must still fit); the check runs before any
    allocation, on a tensor with no storage."""
    rbs, conv_post = _stage(32, True)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        tmrf.mrf_stage_cuda(torch.empty(1, 32, tmrf.MAX_T + 1, device="meta"), rbs, conv_post)
