"""Audio IO + resampling (librosa-free); the port's own copy of
`fscl_tpu/dsp/audio_io.py`.

The reference uses librosa.load at 16 k / 22.05 k + wav normalization
(Parsers/template.py:20-27). Here: scipy wavfile read + polyphase
resampling + peak normalization (dlhlp_lib wav_normalization divides by the
max absolute amplitude).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, sr: int) -> np.ndarray:
    """Load a wav file, convert to mono float32 in [-1, 1], resample to sr."""
    orig_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if orig_sr != sr:
        g = math.gcd(orig_sr, sr)
        wav = resample_poly(wav, sr // g, orig_sr // g).astype(np.float32)
    return wav


def save_wav(path: str, wav: np.ndarray, sr: int) -> None:
    wav = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))


def wav_normalization(wav: np.ndarray) -> np.ndarray:
    peak = np.max(np.abs(wav))
    if peak < 1e-8:
        return wav
    return (wav / peak).astype(np.float32)
