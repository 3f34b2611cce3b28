"""The port's masking, bucketize and length-regulator ops against fscl_tpu's,
on the same numpy inputs. Integer results exactly, float results at 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fscl_tpu.ops import bucketize as jb
from fscl_tpu.ops import length_regulator as jlr
from fscl_tpu.ops import masking as jm
from fscl_tpu_torch.ops import bucketize as tb
from fscl_tpu_torch.ops import length_regulator as tlr
from fscl_tpu_torch.ops import masking as tm


def test_length_mask():
    lens = np.array([0, 3, 7, 9])
    np.testing.assert_array_equal(tm.length_mask(torch.from_numpy(lens), 7).numpy(),
                                  np.asarray(jm.length_mask(jnp.asarray(lens), 7)))


@pytest.mark.parametrize("fill", [0.0, -2.5])
def test_mask_fill(fill):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3)).astype(np.float32)
    valid = rng.random((2, 5)) > 0.4
    np.testing.assert_array_equal(
        tm.mask_fill(torch.from_numpy(x), torch.from_numpy(valid), fill).numpy(),
        np.asarray(jm.mask_fill(jnp.asarray(x), jnp.asarray(valid), fill)))


@pytest.mark.parametrize("shape", [(2, 6), (2, 6, 4)])
def test_masked_mean(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    valid = np.arange(6)[None, :] < np.array([4, 2])[:, None]
    got = float(tm.masked_mean(torch.from_numpy(x), torch.from_numpy(valid)))
    want = float(jm.masked_mean(jnp.asarray(x), jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_masked_mean_all_invalid_is_zero():
    x = torch.ones(2, 3)
    assert float(tm.masked_mean(x, torch.zeros(2, 3, dtype=torch.bool))) == 0.0


def test_digitize_including_values_on_edges():
    edges = np.linspace(-1.0, 1.0, 9).astype(np.float32)
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(-2, 2, 49).astype(np.float32), edges,
                        np.float32([-5.0, 5.0])]).reshape(3, -1)
    got = tb.digitize(torch.from_numpy(x), torch.from_numpy(edges)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jb.digitize(jnp.asarray(x), jnp.asarray(edges))))
    np.testing.assert_array_equal(got, np.digitize(x, edges))


def test_searchsorted_right_including_ties():
    csum = np.cumsum(np.array([[2, 0, 3, 1], [0, 0, 4, 4]]), axis=1)
    t = np.arange(12)
    got = tb.searchsorted_right(torch.from_numpy(csum), torch.from_numpy(t)[None, :]).numpy()
    want = np.asarray(jb.searchsorted_right(jnp.asarray(csum), jnp.asarray(t)[None, :]))
    np.testing.assert_array_equal(got, want)
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.searchsorted(csum[b], t, side="right"))


@pytest.mark.parametrize("T", [40, 12])    # 12: totals overflow and are cut
def test_regulate_lengths(T):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    dur = rng.integers(0, 6, size=(3, 7))
    dur[2] = 0                              # a sample with no frames
    got, got_len = tlr.regulate_lengths(torch.from_numpy(x), torch.from_numpy(dur), T)
    want, want_len = jlr.regulate_lengths(jnp.asarray(x), jnp.asarray(dur), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_regulate_lengths_overflow_keeps_raw_total():
    out, mel_len = tlr.regulate_lengths(torch.ones(1, 4, 2), torch.tensor([[5, 5, 5, 5]]), 8)
    assert tuple(out.shape) == (1, 8, 2)
    assert int(mel_len[0]) == 20            # raw total; the caller clips it
