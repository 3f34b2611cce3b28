"""STFT, log-mel spectrogram and frame energy in torch (the port of
`fscl_tpu/ops/stft.py`).

The reference extracts mel/energy on the host through librosa + dlhlp_lib
(`Parsers/template.py:57-65`, TacotronSTFT-style processing: reflect-padded
centered STFT, Hann window, slaney-normalized mel filterbank, log dynamic
range compression with clamp 1e-5; energy = L2 norm of the magnitude frame).
Here the chain is batched torch ops on the tensor's device: `torch.fft.rfft`
(cuFFT on the card) and one filterbank product, so preprocessing runs on
the card. Every function takes any leading batch dims. `mel_filterbank` is
numpy (Griffin-Lim uses it on the host too).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False default)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, n_fft//2+1).

    Numerically equivalent to librosa.filters.mel(htk=False, norm='slaney'),
    which is what the reference's preprocessing uses.
    """
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, len(fftfreqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


_FB_TENSORS = {}


def mel_filterbank_tensor(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                          device) -> torch.Tensor:
    """`mel_filterbank` as a float32 tensor on `device`, made once per device."""
    key = (sr, n_fft, n_mels, float(fmin), float(fmax), torch.device(device))
    if key not in _FB_TENSORS:
        _FB_TENSORS[key] = torch.from_numpy(
            mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(device)
    return _FB_TENSORS[key]


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The periodic Hann window, computed as fscl_tpu computes it."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def frame_signal(wav: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_fft), reflect-padded when centered."""
    if center:
        lead = wav.shape[:-1]
        wav = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (n_fft // 2, n_fft // 2),
                    mode="reflect").reshape(*lead, -1)
    return wav.unfold(-1, n_fft, hop_length)


def stft_magnitude(
    wav: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    center: bool = True,
) -> torch.Tensor:
    """Magnitude spectrogram (..., n_frames, n_fft//2+1)."""
    frames = frame_signal(wav, n_fft, hop_length, center)
    win = hann_window(win_length, dtype=frames.dtype, device=frames.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = F.pad(win, (lpad, n_fft - win_length - lpad))
    return torch.fft.rfft(frames * win, n=n_fft, dim=-1).abs()


def mel_spectrogram(
    wav: torch.Tensor,
    sr: int = 22050,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float = 8000.0,
    clip_val: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-mel spectrogram + frame energy.

    Returns (mel (..., n_frames, n_mels), energy (..., n_frames)); energy is
    the L2 norm of each magnitude frame, matching the reference's energy
    feature (dlhlp_lib tts_preprocess via Parsers/template.py:57-65).
    """
    mag = stft_magnitude(wav, n_fft, hop_length, win_length)
    fb = mel_filterbank_tensor(sr, n_fft, n_mels, fmin, fmax, mag.device)
    mel = torch.log(torch.clamp(mag @ fb.T, min=clip_val))
    energy = torch.sqrt(torch.sum(mag * mag, dim=-1))
    return mel, energy
