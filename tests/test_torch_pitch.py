"""The port's pitch trackers and TextGrid reader against fscl_tpu's, on the CPU.

Host (numpy, f64 as in fscl_tpu): `yin_f0`, `dio_f0`, `interpolate_f0` and
`textgrid_to_segments_and_phonemes` equal fscl_tpu's exactly; the port's
own builds of `cpp/pitch.cc` and `cpp/world_pitch.cc` (`dsp/cpp_bindings.py`,
into `fscl_tpu_torch/_build/`) give exactly fscl_tpu's `cpp_yin_f0` and
`cpp_world_f0`.

Batched (torch, f32): `yin_f0_batched` and `world_f0_batched` against
fscl_tpu's on the tones and segmented signals of tests/test_pitch_device.py
and tests/test_world_device.py and on a batch with an all-padding row:
voicing equal on at least 99 % of the valid frames; on frames voiced in
both, relative F0 difference median <= 1e-6 and max <= 1e-4 (measured:
median 8.5e-8, max 3.7e-6 for YIN and 8.3e-7 for DIO, well inside); padding
frames exactly 0.
DIO's contour fix (`ops/dio_contour.py`) is held to a numpy transcript of
fscl_tpu's `fix_step` exactly.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fscl_tpu.dsp import cpp_bindings as jcpp
from fscl_tpu.dsp import pitch as jpitch
from fscl_tpu.dsp import textgrid as jtg
from fscl_tpu.dsp.pitch_device import yin_f0_batched as jax_yin
from fscl_tpu.dsp.world_device import world_f0_batched as jax_world
from fscl_tpu_torch.dsp import cpp_bindings as pcpp
from fscl_tpu_torch.dsp import pitch as ppitch
from fscl_tpu_torch.dsp import textgrid as ptg
from fscl_tpu_torch.dsp.pitch_device import yin_f0_batched
from fscl_tpu_torch.dsp.world_device import world_f0_batched
from fscl_tpu_torch.ops import dio_contour as dc

from test_pitch_device import _segmented_signal as yin_segmented, _tone as yin_tone
from test_world_device import _segmented_signal as dio_segmented, _tone as dio_tone
from torch_corpus import textgrid

SR, HOP = 22050, 256
VOICING_AGREE = 0.99
F0_MEDIAN_REL, F0_MAX_REL = 1e-6, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _noise(seconds, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(int(seconds * SR))
            ).astype(np.float32)


@pytest.mark.parametrize("fn", ["yin_f0", "dio_f0"])
def test_host_trackers_equal_fscl_tpu(fn):
    for wav in (dio_tone(180.0, 0.5, seed=2), dio_segmented()[:SR // 2], _noise(0.3, 1)):
        np.testing.assert_array_equal(getattr(ppitch, fn)(wav, SR, HOP),
                                      getattr(jpitch, fn)(wav, SR, HOP))


def test_interpolate_f0_equals_fscl_tpu():
    f0 = jpitch.dio_f0(dio_segmented(), SR, HOP)
    for x in (f0, np.zeros(5, np.float32), np.array([0, 120.0, 0, 0, 180.0, 0], np.float32)):
        got, want = ppitch.interpolate_f0(x), jpitch.interpolate_f0(x)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("fn", ["cpp_yin_f0", "cpp_world_f0"])
def test_cpp_builds_equal_fscl_tpu(fn):
    for wav in (dio_tone(140.0, 0.8, seed=4), dio_segmented(seed=6), _noise(0.5, 2)):
        np.testing.assert_array_equal(getattr(pcpp, fn)(wav, SR, HOP),
                                      getattr(jcpp, fn)(wav, SR, HOP))
    name = "pitch" if fn == "cpp_yin_f0" else "world_pitch"
    lib = pcpp.build(name)
    assert pcpp.BUILD_DIR in Path(lib._name).parents


def test_extract_pitch_methods():
    wav = dio_tone(200.0, 0.6, seed=8)
    np.testing.assert_array_equal(ppitch.extract_pitch(wav), jcpp.cpp_world_f0(wav))
    np.testing.assert_array_equal(ppitch.extract_pitch(wav, method="yin"), jcpp.cpp_yin_f0(wav))
    np.testing.assert_array_equal(ppitch.extract_pitch(wav, use_cpp=False),
                                  jpitch.dio_f0(wav))
    dev = ppitch.extract_pitch(wav, method="world_device", device="cpu")
    assert dev.shape == (1 + len(wav) // HOP,) and (dev > 0).mean() > 0.8
    with pytest.raises(ValueError, match="pitch method"):
        ppitch.extract_pitch(wav, method="crepe")


def test_textgrid_equals_fscl_tpu(tmp_path):
    intervals = [(0.0, 0.1, ""), (0.1, 0.3, "HH"), (0.3, 0.3, "X"), (0.3, 0.5, "sil"),
                 (0.5, 0.7, "<unk>"), (0.7, 0.9, "AY1"), (0.9, 1.2, "sp")]
    path = tmp_path / "a.TextGrid"
    path.write_text(textgrid(intervals, 1.2))
    assert ptg.parse_textgrid(str(path)) == jtg.parse_textgrid(str(path))
    got = ptg.textgrid_to_segments_and_phonemes(str(path))
    assert got == jtg.textgrid_to_segments_and_phonemes(str(path))
    assert got[1] == ["HH", "sp", "spn", "AY1"]


def _batch(wavs, bucket):
    padded = np.zeros((len(wavs), bucket), np.float32)
    lens = np.zeros(len(wavs), np.int32)
    for i, w in enumerate(wavs):
        padded[i, :len(w)] = w
        lens[i] = len(w)
    return padded, lens


def _held(got, want, lens):
    valid = np.arange(got.shape[1])[None, :] < (1 + lens // HOP)[:, None]
    assert (got[~valid] == 0).all()
    agree = ((got > 0) == (want > 0))[valid].mean()
    both = (got > 0) & (want > 0)
    rel = np.abs(got[both] - want[both]) / want[both]
    assert agree >= VOICING_AGREE, agree
    assert both.sum() > 0.4 * valid.sum()
    assert np.median(rel) <= F0_MEDIAN_REL and rel.max() <= F0_MAX_REL, (
        np.median(rel), rel.max())


@pytest.mark.parametrize("tracker", ["yin", "world"])
def test_batched_trackers_match_fscl_tpu(tracker):
    """Tones, a segmented signal and an all-padding row in the 4 s bucket."""
    if tracker == "yin":
        wavs = [yin_tone(110.0, 0.8, seed=1), yin_tone(440.0, 0.8, seed=2),
                yin_segmented(), np.zeros(0, np.float32)]
        port, ref = yin_f0_batched, jax_yin
    else:
        wavs = [dio_tone(110.0, 0.8, seed=1), dio_tone(320.0, 0.8, seed=3),
                dio_segmented(), np.zeros(0, np.float32)]
        port, ref = world_f0_batched, jax_world
    padded, lens = _batch(wavs, 4 * SR)
    got = port(torch.from_numpy(padded), torch.from_numpy(lens)).numpy()
    want = np.asarray(ref(jnp.asarray(padded), jnp.asarray(lens)))
    assert got.shape == want.shape == (len(wavs), 1 + 4 * SR // HOP)
    assert (got[-1] == 0).all()
    _held(got, want, lens)


def test_dio_detail_leaves_f0_unchanged():
    """`detail` reports the refinement's tau_lo and where it fitted a
    parabola, per frame, without changing the F0."""
    padded, lens = _batch([dio_tone(110.0, 0.8, seed=1), dio_segmented()], 4 * SR)
    wavs, lengths = torch.from_numpy(padded), torch.from_numpy(lens)
    det = {}
    got = world_f0_batched(wavs, lengths, detail=det)
    assert torch.equal(got, world_f0_batched(wavs, lengths))
    assert set(det) == {"tau_lo", "fitted"}
    assert det["tau_lo"].shape == det["fitted"].shape == got.shape
    assert det["fitted"].dtype == torch.bool
    voiced = got > 0
    # a steady tone's peaks lie inside the tau range: most frames are fitted
    assert det["fitted"][voiced].float().mean() > 0.5
    # tau_lo is int(0.85 * period) of the fixed F0, so near 0.85 * sr / f0
    period = SR / got[voiced]
    assert ((det["tau_lo"][voiced] - 0.85 * period).abs() < 0.2 * period).all()


def fix_step_numpy(cand: np.ndarray) -> np.ndarray:
    """fscl_tpu's `fix_step` scan (dsp/world_device.py:199-213), transcribed
    in numpy float32."""
    cand = cand.astype(np.float32)
    out = cand.copy()
    jump_ratio = np.float32(0.2)
    for b in range(cand.shape[0]):
        prev = cand[b, 0]
        for t in range(1, cand.shape[1]):
            f = cand[b, t]
            nx = cand[b, t + 1] if t + 1 < cand.shape[1] else np.float32(0)
            keep = nx > 0 and abs(f - nx) < jump_ratio * max(f, np.float32(1e-9))
            jump = f > 0 and prev > 0 and abs(f - prev) > jump_ratio * max(prev, np.float32(1e-9))
            prev = np.float32(0) if (jump and not keep) else f
            out[b, t] = prev
    return out


def test_contour_fix_plain_version_equals_fix_step():
    rng = np.random.default_rng(0)
    base = rng.uniform(80, 300, size=(4, 200)).astype(np.float32)
    # runs of steady F0, 25 % jumps, single-frame spikes, unvoiced gaps, and
    # values on the 20 % edge
    steady = np.repeat(base[:, ::8], 8, axis=1)
    cand = np.where(rng.random((4, 200)) < 0.15, 0.0, steady)
    cand = np.where(rng.random((4, 200)) < 0.1, cand * 1.25, cand)
    cand[:, 50] = cand[:, 49] * np.float32(1.2)
    cand[0] = 0.0
    cand = cand.astype(np.float32)
    got = dc.dio_contour(torch.from_numpy(cand)).numpy()
    np.testing.assert_array_equal(got, fix_step_numpy(cand))
    assert (got != cand).any()
    np.testing.assert_array_equal(dc.dio_contour(torch.from_numpy(cand[:, :1])).numpy(),
                                  cand[:, :1])


@pytest.mark.parametrize("run", [1, 2, 3, 6, 7])
def test_contour_fix_parity_of_jump_runs(run):
    """Runs of frames that each jump against the one before and disagree
    with the next: the scan drops every other one, from the first; the
    plain version reads that off the run's parity."""
    zigzag = np.float32([100, 130] * 8)
    rows = []
    for start in range(4):
        row = np.full(40, 200, np.float32)
        row[start + 5: start + 5 + run + 1] = zigzag[:run + 1]
        row[start + 6 + run:] = row[start + 5 + run]
        rows.append(row)
    cand = np.stack(rows + [np.float32([100, 130, 0, 130, 100, 100, 0, 100] * 5)])
    got = dc.dio_contour(torch.from_numpy(cand)).numpy()
    want = fix_step_numpy(cand)
    np.testing.assert_array_equal(got, want)
    assert (want != cand).sum() >= 4 * ((run + 1) // 2)


def test_contour_fix_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        dc.dio_contour_cuda(torch.zeros(2, 8))
    with pytest.raises(ValueError, match="float32"):
        dc.dio_contour_cuda(torch.zeros(2, 8, dtype=torch.float64))
