"""Batched WORLD-style (DIO) F0 in torch ops, on the tensor's device (the
port of `fscl_tpu/dsp/world_device.py`).

The same DIO-style algorithm as the host tracker (`cpp/world_pitch.cc`,
`dsp/pitch.py:dio_f0`), one batched pass per wav-length bucket, in float32:

  1. anti-alias decimate to fs = sr / deci (Nuttall-windowed sinc),
  2. per octave band (boundary = fmin * sqrt(2) * sqrt(2)^k): low-pass, then
     four zero/peak-crossing interval trackers (y and dy, both signs), each
     linearly interpolated onto frame times; a band's candidate is the mean
     of the four, scored by their normalized standard deviation,
  3. the best-scored in-band candidate per frame; score > 0.12 -> unvoiced,
  4. contour fix: isolated voiced frames dropped, then >20 % jumps against
     the previous FIXED frame dropped unless the next frame agrees:
     `ops/dio_contour.py` (the parity of runs of jumps; a CUDA kernel on
     the card),
  5. refinement: normalized autocorrelation over taus in [0.85, 1.15] x the
     candidate period on the full-rate wav, parabolic peak, r >= 0.3 gate.

Vectorisation as in fscl_tpu: every sample is a potential crossing event
with a validity mask; each tracker becomes a stable sort of the masked event
midpoints (invalid ones at +inf sort to the tail), a row-wise searchsorted at
the frame times and a clamped lerp between two neighbours (np.interp's
semantics). The band filters run as float32 convolutions; the port's entry
points turn TF32 off on the card (`core/device.py`), since a TF32 filter
moves the crossings and with them the voicing decisions. The refinement
streams its R tau offsets in chunks of `REFINE_CHUNK`: each offset gathers a
(B, F, win_max) window, and all R at once would take about 9.7 GB at B = 16
in the 20 s bucket.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fscl_tpu_torch.data.batch import bucket_len
from fscl_tpu_torch.dsp.pitch_device import frame_valid
from fscl_tpu_torch.ops.dio_contour import dio_contour

_SCORE_GATE = 0.12
_REFINE_R_GATE = 0.3
# tau offsets of the refinement per chunk: 12 chunks of the R = 95 offsets at
# 22.05 kHz; a chunk's windows take B * F * 8 * win_max * 4 bytes (0.8 GB at
# B = 16, F = 1723, win_max = 930)
REFINE_CHUNK = 8
INF = float("inf")


def _nuttall_sinc_np(cutoff_hz: float, fs: float) -> np.ndarray:
    """Same kernel as dsp/pitch.py:_nuttall_sinc (host f64, then float32)."""
    half = max(8, int(2.0 * fs / cutoff_hz))
    m = np.arange(-half, half + 1)
    fc = cutoff_hz / fs
    sinc = np.where(m == 0, 2 * fc, np.sin(2 * np.pi * fc * m)
                    / np.where(m == 0, 1.0, np.pi * m))
    t = np.linspace(0, 1, 2 * half + 1)
    w = (0.355768 - 0.487396 * np.cos(2 * np.pi * t)
         + 0.144232 * np.cos(4 * np.pi * t)
         - 0.012604 * np.cos(6 * np.pi * t))
    h = sinc * w
    return (h / h.sum()).astype(np.float32)


def _conv_same(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """(B, N) (*) (k,) 'same' convolution: flipped taps, padding
    ((k - 1) // 2, k // 2), as fscl_tpu's `lax.conv_general_dilated`."""
    k = h.shape[0]
    taps = torch.from_numpy(np.ascontiguousarray(h[::-1])).to(x.device, x.dtype)
    xp = F.pad(x[:, None, :], ((k - 1) // 2, k // 2))
    return F.conv1d(xp, taps[None, None, :])[:, 0, :]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx)


def _interp_track(sig: torch.Tensor, fs: float, negative: bool, t_frames: torch.Tensor):
    """One crossing tracker as np.interp over event midpoints.

    sig: (B, N). Events live at samples i where the signed crossing happens;
    midpoint m_i = t_i + dt_i / 2, value f_i = 1 / dt_i with
    t_i = (i + frac_i) / fs and dt_i the gap to the NEXT crossing
    (dsp/pitch.py:_crossing_track). Returns ((B, F) interpolated track,
    (B,) track_valid with the host's >= 3 crossings requirement).
    """
    B, N = sig.shape
    y0, y1 = sig[:, :-1], sig[:, 1:]
    cross = (y0 > 0) & (y1 <= 0) if negative else (y0 < 0) & (y1 >= 0)
    denom = y0 - y1
    frac = torch.where(denom.abs() > 1e-18, y0 / denom, 0.5)
    times = (torch.arange(N - 1, dtype=torch.float32, device=sig.device) + frac) / fs

    # time of the NEXT crossing after each event: the running minimum of the
    # masked times from the right, shifted by one
    masked_t = torch.where(cross, times, INF)
    next_t = torch.flip(torch.cummin(torch.flip(masked_t, [-1]), dim=1).values, [-1])
    next_t = torch.cat([next_t[:, 1:], torch.full((B, 1), INF, device=sig.device)], dim=-1)
    dt = next_t - times
    ok = cross & torch.isfinite(dt) & (dt > 0)
    mid = torch.where(ok, times + 0.5 * dt, INF)
    freq = torch.where(ok, 1.0 / torch.clamp(dt, min=1e-12), 0.0)
    n_ev = ok.sum(dim=-1)
    # the LAST crossing never yields an interval: >= 2 intervals needs >= 3
    # crossings
    track_valid = n_ev >= 2

    # np.interp over (mid, freq): a stable sort puts the +inf of invalid
    # events at the tail in order, searchsorted finds the frame times
    mid_s, order = torch.sort(mid, dim=-1, stable=True)
    freq_s = _take(freq, order)
    idx = torch.searchsorted(mid_s, t_frames.expand(B, -1).contiguous())
    last = torch.clamp(n_ev - 1, min=0)[:, None]
    hi = torch.minimum(torch.clamp(idx, min=0), last)
    lo = torch.minimum(torch.clamp(idx - 1, min=0), last)
    m_lo, m_hi = _take(mid_s, lo), _take(mid_s, hi)
    f_lo, f_hi = _take(freq_s, lo), _take(freq_s, hi)
    span = m_hi - m_lo
    w = torch.where(span > 1e-12, (t_frames[None, :] - m_lo) / torch.clamp(span, min=1e-12),
                    0.0)
    w = torch.clamp(w, 0.0, 1.0)
    return f_lo + w * (f_hi - f_lo), track_valid


def band_candidates(wavs: torch.Tensor, sr: int, hop_length: int, fmin: float,
                    fmax: float) -> torch.Tensor:
    """Steps 1-3 and the isolated-frame half of step 4: (B, T) wavs ->
    (B, F) candidates, the input of the contour fix (`ops/dio_contour.py`)."""
    B, T = wavs.shape
    n_frames = 1 + T // hop_length
    deci = max(1, int(sr / (8.0 * fmax)))
    fs = sr / deci
    x = _conv_same(wavs, _nuttall_sinc_np(0.4 * fs, sr))[:, ::deci] if deci > 1 else wavs
    x = x.contiguous()
    frame_dt = hop_length / sr
    t_frames = torch.arange(n_frames, dtype=torch.float32, device=wavs.device) * frame_dt

    best_f0 = torch.zeros(B, n_frames, device=wavs.device)
    best_score = torch.full((B, n_frames), INF, device=wavs.device)
    boundary = fmin * np.sqrt(2.0)
    while boundary < fmax * 1.5:
        h = _nuttall_sinc_np(boundary, fs)
        if len(h) < x.shape[1]:
            y = _conv_same(x, h)
            dy = torch.diff(y, dim=-1, append=y[:, -1:])
            ests, valids = [], []
            for sig, neg in ((y, True), (y, False), (dy, True), (dy, False)):
                e, v = _interp_track(sig, fs, neg, t_frames)
                ests.append(e)
                valids.append(v)
            est = torch.stack(ests)                                  # (4, B, F)
            band_ok = torch.stack(valids).all(dim=0)                 # (B,)
            mean = est.mean(dim=0)
            score = (torch.sqrt(((est - mean) ** 2).sum(dim=0) / 3.0)
                     / torch.clamp(mean, min=1e-9))
            b = float(boundary)
            valid = ((mean > b * 0.45) & (mean < b * 1.1) & (mean >= fmin) & (mean <= fmax)
                     & (score < best_score) & band_ok[:, None])
            best_f0 = torch.where(valid, mean, best_f0)
            best_score = torch.where(valid, score, best_score)
        boundary *= np.sqrt(2.0)

    cand = torch.where(best_score > _SCORE_GATE, 0.0, best_f0)
    # contour fix, first half: isolated voiced frames
    prev = F.pad(cand[:, :-1], (1, 0))
    nxt = F.pad(cand[:, 1:], (0, 1))
    return torch.where((cand > 0) & (prev <= 0) & (nxt <= 0), 0.0, cand)


def refine(wavs: torch.Tensor, lengths: torch.Tensor, fixed: torch.Tensor, sr: int,
           hop_length: int, fmin: float, fmax: float, detail=None) -> torch.Tensor:
    """Step 5 on the full-rate wavs: (B, F) fixed F0 -> refined F0 (0 where
    unvoiced), the masked fixed-size windows and tau range of fscl_tpu.

    With a dict `detail`, each frame's `tau_lo` (the first lag tried) and
    `fitted` (a parabola fitted through three finite lags, its shift inside
    (-1, 1)) go there: where `fitted` is False, the refined lag is an
    integer lag or clamped, and a rounding-level change can move it by up
    to one lag."""
    B, T = wavs.shape
    n_frames = fixed.shape[1]
    dev = wavs.device
    tau_abs_max = int(sr / fmin)
    win_max = min(3 * tau_abs_max, T)
    R = int(np.ceil(tau_abs_max * 0.30)) + 2
    period = sr / torch.clamp(fixed, min=1e-9)
    # unvoiced frames (fixed == 0) have a period of about 2e13 samples, past
    # int32; their values are discarded below, so cap them before the casts
    period = torch.clamp(period, max=16.0 * tau_abs_max)
    tau_lo = torch.clamp((period * 0.85).to(torch.int64), min=2)
    tau_hi = torch.clamp((period * 1.15).to(torch.int64) + 1, max=tau_abs_max)
    n = lengths.to(torch.int64)[:, None]
    win = torch.minimum(torch.minimum((3 * period).to(torch.int64), n),
                        torch.full_like(n, win_max))
    frames = torch.arange(n_frames, device=dev)[None, :] * hop_length
    start = torch.minimum(torch.clamp(frames - torch.div(win, 2, rounding_mode="floor"),
                                      min=0),
                          torch.clamp(n - win - tau_hi - 1, min=0))

    # fscl_tpu clips every sample index to T - 1; padding the wavs with their
    # last sample gives the same windows from one strided view
    wp = F.pad(wavs[:, None, :], (0, win_max + tau_abs_max + 16 * tau_abs_max),
               mode="replicate")[:, 0]
    windows = wp.unfold(1, win_max, 1)                               # (B, P, win_max)
    max_pos = windows.shape[1] - 1
    rows = torch.arange(B, device=dev)[:, None]
    wmask = (torch.arange(win_max, device=dev) < win[..., None]).to(torch.float32)
    a = windows[rows, torch.clamp(start, max=max_pos)] * wmask       # (B, F, win_max)
    a_norm = torch.sqrt(torch.sum(a * a, dim=-1))

    r = torch.empty(B, n_frames, R, device=dev)
    ks = torch.arange(R, device=dev)
    for c in range(0, R, REFINE_CHUNK):
        k = ks[c:c + REFINE_CHUNK]
        pos = torch.clamp(start[..., None] + tau_lo[..., None] + k, max=max_pos)
        b = windows[rows[..., None], pos] * wmask[:, :, None, :]      # (B, F, C, win_max)
        num = torch.einsum("bfw,bfcw->bfc", a, b)
        den = a_norm[..., None] * torch.sqrt(torch.sum(b * b, dim=-1)) + 1e-12
        r[..., c:c + REFINE_CHUNK] = num / den
        del b
    taus = tau_lo[..., None] + ks
    r = torch.where(taus <= tau_hi[..., None], r, -INF)
    k_best = torch.argmax(r, dim=-1)
    r_best = _take(r, k_best[..., None])[..., 0]
    km1 = _take(r, torch.clamp(k_best - 1, min=0)[..., None])[..., 0]
    kp1 = _take(r, torch.clamp(k_best + 1, max=R - 1)[..., None])[..., 0]
    interior = (k_best > 0) & (k_best < R - 1) & torch.isfinite(km1) & torch.isfinite(kp1)
    denom = km1 - 2.0 * r_best + kp1
    raw_shift = 0.5 * (km1 - kp1) / denom
    shift = torch.where(interior & (denom.abs() > 1e-12), torch.clamp(raw_shift, -1.0, 1.0),
                        0.0)
    if detail is not None:
        detail.update(tau_lo=tau_lo,
                      fitted=interior & (denom.abs() > 1e-12) & (raw_shift.abs() < 1.0))
    tau_ref = (tau_lo + k_best).to(torch.float32) + shift
    f0r = sr / torch.clamp(tau_ref, min=1e-6)
    refined = torch.where((r_best >= _REFINE_R_GATE) & (f0r >= fmin) & (f0r <= fmax), f0r, 0.0)
    # the host keeps a candidate unrefined when its window is under 16 samples
    return torch.where(fixed > 0, torch.where(win < 16, fixed, refined), 0.0)


def world_f0_batched(wavs: torch.Tensor, lengths: torch.Tensor, sr: int = 22050,
                     hop_length: int = 256, fmin: float = 71.0,
                     fmax: float = 800.0, detail=None) -> torch.Tensor:
    """DIO-style F0 for a batch of wavs; 0.0 where unvoiced.

    wavs: (B, T) float32 zero-padded to the bucket; lengths: (B,) true
    sample counts, on the same device. Returns (B, 1 + T // hop_length)
    float32, valid up to each wav's own frame count and 0 beyond. `detail`
    as in `refine`.
    """
    wavs = wavs.to(torch.float32)
    cand = band_candidates(wavs, sr, hop_length, fmin, fmax)
    fixed = dio_contour(cand)
    out = refine(wavs, lengths, fixed, sr, hop_length, fmin, fmax, detail)
    return torch.where(frame_valid(lengths, out.shape[1], hop_length), out, 0.0)


def world_f0_device(wav: np.ndarray, sr: int = 22050, hop_length: int = 256,
                    device=None) -> np.ndarray:
    """One utterance (a batch of 1, padded to its wav bucket) on `device`
    (default cuda); (1 + len(wav) // hop_length,) float32."""
    from fscl_tpu_torch.core.device import resolve_device
    from fscl_tpu_torch.dsp.preprocess import WAV_BUCKETS

    dev = resolve_device(device)
    n = len(wav)
    padded = np.zeros((1, bucket_len(n, WAV_BUCKETS)), np.float32)
    padded[0, :n] = wav
    out = world_f0_batched(torch.from_numpy(padded).to(dev),
                           torch.tensor([n], device=dev), sr, hop_length)
    return out[0, :1 + n // hop_length].cpu().numpy()
