"""Vocoder inference (port of `fscl_tpu/audio_out/vocoder.py`): the
generator wrapper and the weights-free Griffin-Lim fallback.

`vocoder_apply` is the one serving forward of a generator, shared by
`Vocoder`, `audio_out/pipeline.py`, `audio_out/streaming.py` and `serve.py`.
A HiFiGANGenerator runs each MRF stage through `ops.mrf_stage` (the Hopper
kernel on the card); a MelGANGenerator runs its plain torch module.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.models import hifigan, melgan
from fscl_tpu_torch.ops.stft import mel_filterbank

CHECKPOINT_SUFFIXES = (".pt", ".pth", ".ckpt")


def vocoder_apply(gen: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """callable(mel (B, T, n_mels)) -> wav (B, T * hop) on the generator's
    device and in its parameters' dtype, without autograd."""
    p = next(gen.parameters())

    @torch.inference_mode()
    def apply(mel) -> torch.Tensor:
        return gen(torch.as_tensor(mel).to(p.device, p.dtype))

    return apply


def build_generator(kind: str = "HifiGAN") -> nn.Module:
    """The generator the model config's `vocoder.model` names (HifiGAN or
    MelGAN), at its published width."""
    if kind.lower() == "melgan":
        return melgan.MelGANGenerator()
    if kind.lower() == "hifigan":
        return hifigan.HiFiGANGenerator()
    raise ValueError(f"vocoder {kind!r} is not a generator (HifiGAN or MelGAN)")


def load_state_dict(kind: str, state_dict) -> dict:
    """An official checkpoint of `kind` (or a port `state_dict`) -> the
    port generator's `state_dict`."""
    if kind.lower() == "melgan":
        return melgan.load_torch_checkpoint(state_dict)
    return hifigan.load_torch_checkpoint(state_dict)


class Vocoder:
    """A generator on `device` (default cuda) in eval mode. `kind` selects
    the architecture like the model YAML's `vocoder.model` key."""

    def __init__(self, model: nn.Module, kind: str = "HifiGAN",
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.kind = kind
        # the reference feeds mel / ln(10) into MelGAN (tool.py:35)
        self.scale = math.log(10.0) if kind.lower() == "melgan" else 1.0
        self._apply = vocoder_apply(self.model)

    @classmethod
    def from_state_dict(cls, state_dict, kind: str = "HifiGAN",
                        device: Optional[Union[str, torch.device]] = None) -> "Vocoder":
        model = build_generator(kind)
        model.load_state_dict(load_state_dict(kind, state_dict), strict=True)
        return cls(model, kind=kind, device=device)

    @classmethod
    def from_checkpoint(cls, path: str, kind: str = "HifiGAN",
                        device: Optional[Union[str, torch.device]] = None) -> "Vocoder":
        """Load a torch generator checkpoint (.pt/.pth/.ckpt): an official
        HiFi-GAN or melgan-neurips one, or a port `state_dict`."""
        if not str(path).endswith(CHECKPOINT_SUFFIXES):
            raise ValueError(f"{path}: expected a torch checkpoint {CHECKPOINT_SUFFIXES}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return cls.from_state_dict(sd, kind=kind, device=device)

    def infer_batch(self, mel) -> torch.Tensor:
        """mel (B, T, n_mels) natural-log mel -> wav (B, T * hop) on the
        vocoder's device."""
        return self._apply(torch.as_tensor(mel).to(self.device) / self.scale)

    def infer(self, mel: np.ndarray) -> np.ndarray:
        """mel (T, n_mels) natural-log mel -> wav (T * hop,)."""
        return self.infer_batch(torch.as_tensor(np.asarray(mel))[None])[0].cpu().numpy()


def griffin_lim(
    log_mel: np.ndarray,
    sr: int = 22050,
    n_fft: int = 1024,
    hop_length: int = 256,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float = 8000.0,
    n_iter: int = 32,
) -> np.ndarray:
    """Invert a log-mel spectrogram to a waveform (weights-free fallback)."""
    mel = np.exp(np.asarray(log_mel, np.float64))         # (T, n_mels)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)    # (n_mels, F)
    # pseudo-inverse mel -> linear magnitude
    mag = np.maximum(mel @ np.linalg.pinv(fb).T, 1e-8)    # (T, F)
    T = mag.shape[0]
    length = T * hop_length

    rng = np.random.default_rng(0)
    angles = np.exp(2j * np.pi * rng.random(mag.shape))
    window = np.hanning(n_fft)

    def istft(spec):
        frames = np.fft.irfft(spec, n=n_fft, axis=1) * window
        out = np.zeros(length + n_fft)
        wsum = np.zeros(length + n_fft)
        for t in range(spec.shape[0]):
            s = t * hop_length
            out[s: s + n_fft] += frames[t]
            wsum[s: s + n_fft] += window ** 2
        out = out / np.maximum(wsum, 1e-8)
        return out[n_fft // 2: n_fft // 2 + length]

    def stft(wav):
        padded = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
        n_frames = 1 + (len(padded) - n_fft) // hop_length
        frames = np.stack([
            padded[t * hop_length: t * hop_length + n_fft] * window
            for t in range(n_frames)])
        return np.fft.rfft(frames, axis=1)

    spec = mag * angles
    for _ in range(n_iter):
        wav = istft(spec)
        new = stft(wav)
        new = new[: mag.shape[0]]
        angles = new / np.maximum(np.abs(new), 1e-8)
        spec = mag * angles
    wav = istft(spec)
    peak = np.max(np.abs(wav))
    return (wav / peak * 0.95 if peak > 0 else wav).astype(np.float32)
