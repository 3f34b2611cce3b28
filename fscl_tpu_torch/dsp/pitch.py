"""F0 (pitch) extraction + unvoiced interpolation on the host (the port's
own copy of `fscl_tpu/dsp/pitch.py`, numpy in f64 as there).

Capability equivalent of the reference's pyworld (WORLD DIO) usage
(requirements.txt pyworld; Parsers/template.py wav_to_mel_energy_pitch):
frame-synchronous F0 at the mel hop (frame_period = hop/sr), 0 at unvoiced
frames, plus the "interpolate_pitch" variant with linear interpolation
across unvoiced gaps. `yin_f0` is a YIN-style difference-function tracker
and `dio_f0` the numpy mirror of the DIO-style tracker; the C++ trackers of
`cpp/` (bound by `dsp/cpp_bindings.py`) compute the same contract faster.

`extract_pitch` differs from fscl_tpu's in one way: when the C++ build
fails it raises instead of falling back to numpy; `use_cpp=False` asks for
numpy explicitly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def yin_f0(
    wav: np.ndarray,
    sr: int = 22050,
    hop_length: int = 256,
    fmin: float = 71.0,
    fmax: float = 800.0,
    threshold: float = 0.15,
    frame_length: int = 1024,
) -> np.ndarray:
    """Frame-wise F0; 0.0 where unvoiced. len = 1 + len(wav)//hop_length
    (matches the mel frame count with centered STFT)."""
    wav = np.asarray(wav, dtype=np.float64)
    tau_min = max(2, int(sr / fmax))
    tau_max = min(frame_length - 1, int(sr / fmin))
    n_frames = 1 + len(wav) // hop_length
    half = frame_length // 2
    padded = np.pad(wav, (half, half + frame_length))

    # build frame matrix (n_frames, frame_length + tau_max)
    win = frame_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(win + tau_max)[None, :])
    frames = padded[idx]                                  # (F, win+tau_max)

    x0 = frames[:, :win]
    # difference function d(tau) computed via cumulative formulation
    # d(tau) = sum_t (x[t] - x[t+tau])^2
    e0 = np.sum(x0 ** 2, axis=1, keepdims=True)
    d = np.empty((n_frames, tau_max + 1))
    d[:, 0] = 0.0
    # vectorized over tau (tau_max ~ 310 at 22.05k): correlation per shift
    for tau in range(1, tau_max + 1):
        xt = frames[:, tau: tau + win]
        corr = np.einsum("ft,ft->f", x0, xt)
        et = np.sum(xt ** 2, axis=1)
        d[:, tau] = e0[:, 0] + et - 2 * corr
    # cumulative mean normalized difference
    cum = np.cumsum(d[:, 1:], axis=1)
    taus = np.arange(1, tau_max + 1)
    cmnd = d[:, 1:] * taus / np.maximum(cum, 1e-12)
    cmnd = np.concatenate([np.ones((n_frames, 1)), cmnd], axis=1)

    f0 = np.zeros(n_frames)
    for f in range(n_frames):
        row = cmnd[f, tau_min: tau_max + 1]
        below = np.where(row < threshold)[0]
        if len(below):
            tau = below[0] + tau_min
            # walk to local minimum
            while tau + 1 <= tau_max and cmnd[f, tau + 1] < cmnd[f, tau]:
                tau += 1
        else:
            tau = int(np.argmin(row)) + tau_min
            if row.min() > 0.7:     # clearly unvoiced
                continue
        # parabolic interpolation around tau
        if 1 < tau < tau_max:
            a, b, c = cmnd[f, tau - 1], cmnd[f, tau], cmnd[f, tau + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            tau_refined = tau + np.clip(shift, -1, 1)
        else:
            tau_refined = float(tau)
        f0[f] = sr / tau_refined
    f0[(f0 < fmin) | (f0 > fmax)] = 0.0
    return f0.astype(np.float32)


def interpolate_f0(f0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Linear interpolation over unvoiced (0) regions; returns
    (interpolated, voiced_mask). Matches dlhlp_lib's interpolate used for
    the `interpolate_pitch` feature."""
    f0 = np.asarray(f0, dtype=np.float32)
    voiced = f0 > 0
    if not voiced.any():
        return f0.copy(), voiced
    x = np.arange(len(f0))
    interp = np.interp(x, x[voiced], f0[voiced]).astype(np.float32)
    return interp, voiced


def dio_f0(
    wav: np.ndarray,
    sr: int = 22050,
    hop_length: int = 256,
    fmin: float = 71.0,
    fmax: float = 800.0,
) -> np.ndarray:
    """Numpy mirror of cpp/world_pitch.cc (DIO-style multi-band candidates +
    autocorrelation refinement) — the WORLD(pyworld) role in the reference's
    preprocessing. Slower than the C++ path; always available."""
    wav = np.asarray(wav, dtype=np.float64)
    n = len(wav)
    n_frames = 1 + n // hop_length
    out = np.zeros(n_frames, dtype=np.float32)
    if n < sr // 16:
        return out

    deci = max(1, int(sr / (8.0 * fmax)))
    fs = sr / deci
    if deci > 1:
        aa = _nuttall_sinc(0.4 * fs, sr)
        x = np.convolve(wav, aa, mode="same")[::deci]
    else:
        x = wav
    frame_dt = hop_length / sr
    t_frames = np.arange(n_frames) * frame_dt

    best_f0 = np.zeros(n_frames)
    best_score = np.full(n_frames, np.inf)
    boundary = fmin * np.sqrt(2.0)
    while boundary < fmax * 1.5:
        h = _nuttall_sinc(boundary, fs)
        if len(h) < len(x):
            y = np.convolve(x, h, mode="same")
            dy = np.diff(y, append=y[-1])
            ests = []
            for sig, neg in ((y, True), (y, False), (dy, True), (dy, False)):
                tr_t, tr_f = _crossing_track(sig, fs, neg)
                if len(tr_t) < 2:
                    ests = None
                    break
                ests.append(np.interp(t_frames, tr_t, tr_f))
            if ests is not None:
                est = np.stack(ests)                       # (4, F)
                mean = est.mean(0)
                score = np.sqrt(((est - mean) ** 2).sum(0) / 3.0) / np.maximum(
                    mean, 1e-9)
                valid = ((mean > boundary * 0.45) & (mean < boundary * 1.1)
                         & (mean >= fmin) & (mean <= fmax)
                         & (score < best_score))
                best_f0 = np.where(valid, mean, best_f0)
                best_score = np.where(valid, score, best_score)
        boundary *= np.sqrt(2.0)

    best_f0[best_score > 0.12] = 0.0
    # contour fix: isolated voiced frames, >20% jumps
    fixed = best_f0.copy()
    prev = np.concatenate([[0.0], fixed[:-1]])
    nxt = np.concatenate([best_f0[1:], [0.0]])
    fixed[(fixed > 0) & (prev <= 0) & (nxt <= 0)] = 0.0
    for f in range(1, n_frames):
        if fixed[f] <= 0 or fixed[f - 1] <= 0:
            continue
        if abs(fixed[f] - fixed[f - 1]) / fixed[f - 1] > 0.2:
            nx = fixed[f + 1] if f + 1 < n_frames else 0.0
            if not (nx > 0 and abs(fixed[f] - nx) / fixed[f] < 0.2):
                fixed[f] = 0.0

    # refinement: normalized autocorrelation around the candidate period
    for f in range(n_frames):
        f0c = fixed[f]
        if f0c <= 0:
            continue
        period = sr / f0c
        tau_lo = max(2, int(period * 0.85))
        tau_hi = min(int(period * 1.15) + 1, int(sr / fmin))
        win = min(int(3 * period), n)
        start = int(np.clip(f * hop_length - win // 2, 0,
                            max(0, n - win - tau_hi - 1)))
        if win < 16:
            out[f] = f0c
            continue
        a = wav[start: start + win]
        taus = np.arange(tau_lo, tau_hi + 1)
        r = np.array([
            np.dot(a, wav[start + tau: start + tau + win])
            / (np.linalg.norm(a)
               * np.linalg.norm(wav[start + tau: start + tau + win]) + 1e-12)
            for tau in taus])
        k = int(np.argmax(r))
        tau_ref = float(taus[k])
        if 0 < k < len(r) - 1:
            denom = r[k - 1] - 2 * r[k] + r[k + 1]
            if abs(denom) > 1e-12:
                tau_ref += float(np.clip(0.5 * (r[k - 1] - r[k + 1]) / denom,
                                         -1, 1))
        f0r = sr / tau_ref
        out[f] = f0r if (r[k] >= 0.3 and fmin <= f0r <= fmax) else 0.0
    return out


def _nuttall_sinc(cutoff_hz: float, fs: float) -> np.ndarray:
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
    return h / h.sum()


def _crossing_track(y: np.ndarray, fs: float, negative: bool):
    if negative:
        idx = np.where((y[:-1] > 0) & (y[1:] <= 0))[0]
    else:
        idx = np.where((y[:-1] < 0) & (y[1:] >= 0))[0]
    if len(idx) < 3:
        return np.empty(0), np.empty(0)
    denom = y[idx] - y[idx + 1]
    frac = np.where(np.abs(denom) > 1e-18, y[idx] / denom, 0.5)
    times = (idx + frac) / fs
    dt = np.diff(times)
    ok = dt > 0
    return (times[:-1] + 0.5 * dt)[ok], (1.0 / dt)[ok]


PITCH_METHODS = ("world", "yin", "world_device", "yin_device")


def extract_pitch(wav, sr: int = 22050, hop_length: int = 256,
                  use_cpp: bool = True, method: str = "world", device=None):
    """F0 at the mel hop. method="world" (default; DIO-style + refinement,
    the reference's pyworld role), "world_device" (the same DIO algorithm
    batched in torch on `device`, dsp/world_device.py), "yin", or
    "yin_device" (batched YIN in torch, dsp/pitch_device.py). The host
    methods run the C++ trackers (a failed build raises), or numpy with
    `use_cpp=False`."""
    if method == "yin_device":
        from fscl_tpu_torch.dsp.pitch_device import yin_f0_device
        return yin_f0_device(wav, sr, hop_length, device=device)
    if method == "world_device":
        from fscl_tpu_torch.dsp.world_device import world_f0_device
        return world_f0_device(wav, sr, hop_length, device=device)
    if method not in PITCH_METHODS:
        raise ValueError(f"pitch method {method!r} not one of {PITCH_METHODS}")
    if method == "world":
        if use_cpp:
            from fscl_tpu_torch.dsp.cpp_bindings import cpp_world_f0
            return cpp_world_f0(wav, sr, hop_length)
        return dio_f0(wav, sr, hop_length)
    if use_cpp:
        from fscl_tpu_torch.dsp.cpp_bindings import cpp_yin_f0
        return cpp_yin_f0(wav, sr, hop_length)
    return yin_f0(wav, sr, hop_length)
