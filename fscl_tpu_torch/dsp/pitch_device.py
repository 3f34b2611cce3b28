"""Batched YIN F0 in torch ops, on the tensor's device (the port of
`fscl_tpu/dsp/pitch_device.py`).

One batched pass per wav-length bucket, in float32:

  - the difference function d(tau) of every frame through an FFT
    cross-correlation (`torch.fft.rfft` / `irfft`; no per-tau loop),
  - the cumulative-mean-normalized difference (CMND),
  - the decision rule of `dsp/pitch.py:yin_f0` (first threshold crossing,
    walk to the local minimum, argmin fallback with the 0.7 unvoiced gate),
    written with first-True argmaxes over integer masks,
  - parabolic interpolation around the chosen lag.

Frames beyond each wav's own frame count are 0 by the validity mask.
`pitch_method="yin_device"` selects it in preprocessing.
"""
from __future__ import annotations

import numpy as np
import torch

from fscl_tpu_torch.data.batch import bucket_len

# YIN constants shared with dsp/pitch.py:yin_f0
_FRAME_LENGTH = 1024
_THRESHOLD = 0.15


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim (0 when there is none), as
    `jnp.argmax` of a bool array gives it: torch's argmax returns the first
    of equal maxima, so the mask goes in as integers."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def frame_valid(lengths: torch.Tensor, n_frames: int, hop_length: int) -> torch.Tensor:
    """(B, n_frames) bool: frame f lies in a wav of n samples when
    f < 1 + n // hop_length."""
    frames = torch.arange(n_frames, device=lengths.device)
    return frames[None, :] < 1 + lengths.to(torch.int64)[:, None] // hop_length


def yin_f0_batched(wavs: torch.Tensor, lengths: torch.Tensor, sr: int = 22050,
                   hop_length: int = 256, fmin: float = 71.0, fmax: float = 800.0,
                   threshold: float = _THRESHOLD,
                   frame_length: int = _FRAME_LENGTH) -> torch.Tensor:
    """Frame-wise F0 for a batch of wavs; 0.0 where unvoiced.

    wavs: (B, T) float32, zero-padded to the bucket; lengths: (B,) true
    sample counts, on the same device. Returns (B, 1 + T // hop_length)
    float32, valid up to each wav's 1 + n // hop frames and 0 beyond.
    """
    wavs = wavs.to(torch.float32)
    B, T = wavs.shape
    dev = wavs.device
    tau_min = max(2, int(sr / fmax))
    tau_max = min(frame_length - 1, int(sr / fmin))
    n_frames = 1 + T // hop_length
    half = frame_length // 2
    win = frame_length
    span = win + tau_max

    padded = torch.nn.functional.pad(wavs, (half, half + frame_length))
    frames = padded.unfold(1, span, hop_length)[:, :n_frames]      # (B, F, span)

    # d(tau) = e0 + e_tau - 2 c(tau), c by FFT cross-correlation:
    # c(tau) = sum_t x0[t] frames[t + tau], x0 = frames[..., :win]
    nfft = _next_pow2(span)
    fa = torch.fft.rfft(frames, n=nfft)
    fb = torch.fft.rfft(frames[..., :win], n=nfft)
    corr = torch.fft.irfft(torch.conj(fb) * fa, n=nfft)[..., :tau_max + 1]
    del fa, fb

    sq = torch.nn.functional.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))
    # e_tau = sum frames[tau:tau + win]^2 = sq[tau + win] - sq[tau]
    e_tau = sq[..., win:win + tau_max + 1] - sq[..., :tau_max + 1]
    del sq
    d = torch.clamp(e_tau[..., :1] + e_tau - 2.0 * corr, min=0.0)

    # cumulative mean normalized difference; cmnd[0] = 1
    cum = torch.cumsum(d[..., 1:], dim=-1)
    taus = torch.arange(1, tau_max + 1, dtype=torch.float32, device=dev)
    cmnd = torch.cat([torch.ones(B, n_frames, 1, device=dev),
                      d[..., 1:] * taus / torch.clamp(cum, min=1e-12)], dim=-1)

    lag = torch.arange(tau_max + 1, device=dev)
    in_range = (lag >= tau_min) & (lag <= tau_max)

    # the decision rule of yin_f0, vectorised
    below = (cmnd < threshold) & in_range
    any_below = below.any(dim=-1)
    first_below = first_true(below)
    # walk to the local minimum: the first tau >= first_below where
    # cmnd[tau + 1] >= cmnd[tau] (tau_max always stops)
    nxt = torch.cat([cmnd[..., 1:], torch.full((B, n_frames, 1), float("inf"), device=dev)],
                    dim=-1)
    walk = (nxt >= cmnd) & (lag >= first_below[..., None]) & (lag <= tau_max)
    tau_walked = first_true(walk)
    # argmin fallback over [tau_min, tau_max]
    masked = torch.where(in_range, cmnd, float("inf"))
    row_min = masked.amin(dim=-1)
    tau_argmin = torch.argmin(masked, dim=-1)
    clearly_unvoiced = ~any_below & (row_min > 0.7)
    tau = torch.where(any_below, tau_walked, tau_argmin)

    # parabolic interpolation around tau (only for 1 < tau < tau_max)
    tm1 = torch.gather(cmnd, -1, (tau - 1)[..., None])[..., 0]
    t0 = torch.gather(cmnd, -1, tau[..., None])[..., 0]
    tp1 = torch.gather(cmnd, -1, torch.clamp(tau + 1, max=tau_max)[..., None])[..., 0]
    denom = tm1 - 2.0 * t0 + tp1
    shift = torch.where(denom.abs() > 1e-12, 0.5 * (tm1 - tp1) / denom, 0.0)
    shift = torch.clamp(shift, -1.0, 1.0)
    interior = (tau > 1) & (tau < tau_max)
    tau_refined = torch.where(interior, tau + shift, tau.to(torch.float32))

    f0 = sr / torch.clamp(tau_refined, min=1e-6)
    f0 = torch.where(clearly_unvoiced, 0.0, f0)
    f0 = torch.where((f0 < fmin) | (f0 > fmax), 0.0, f0)
    return torch.where(frame_valid(lengths, n_frames, hop_length), f0, 0.0)


def yin_f0_device(wav: np.ndarray, sr: int = 22050, hop_length: int = 256,
                  device=None) -> np.ndarray:
    """One utterance (a batch of 1, padded to its wav bucket) on `device`
    (default cuda); (1 + len(wav) // hop_length,) float32."""
    from fscl_tpu_torch.core.device import resolve_device
    from fscl_tpu_torch.dsp.preprocess import WAV_BUCKETS

    dev = resolve_device(device)
    n = len(wav)
    padded = np.zeros((1, bucket_len(n, WAV_BUCKETS)), np.float32)
    padded[0, :n] = wav
    out = yin_f0_batched(torch.from_numpy(padded).to(dev),
                         torch.tensor([n], device=dev), sr, hop_length)
    return out[0, :1 + n // hop_length].cpu().numpy()
