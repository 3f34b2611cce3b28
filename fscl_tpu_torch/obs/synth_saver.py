"""Synthesis saver: validation-time sample synthesis artifacts (port of
`fscl_tpu/obs/synth_saver.py`).

Re-provides the reference saver's synth_step path (callbacks/language/
baseline_saver.py:47-128 + utils/log.py synth_one_sample_with_target):
reconstruction (teacher-forced durations) and synthesis (predicted
durations) of one validation sample, written as wav + mel figure, with
pitch/energy de-normalized for the overlay.

The device work (the eval-mode forward, `synthesize`, the vocoder: HiFi-GAN
through the MRF stage kernel, or Griffin-Lim on the host) does not need
matplotlib; `write_figures=False` skips the PNGs where it is not installed.
Each call keeps what it wrote in `last` ({"recon"|"synth": {"mel", "pitch",
"energy", "wav"}}, numpy), so that a caller can hold the arrays.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from fscl_tpu_torch.core.stats import DEFAULT_STATS, GlobalStats
from fscl_tpu_torch.data.batch import to_device
from fscl_tpu_torch.obs.loggers import Callback


def on_device(batch, device):
    """A batch of numpy arrays copied to `device`; one of tensors as it is."""
    if isinstance(batch.texts, torch.Tensor):
        return batch
    return to_device(batch, device)


def first_row(x):
    """x[:1], field by field for a NamedTuple (a `DvecRefs`)."""
    if isinstance(x, tuple):
        return type(x)(*(first_row(f) for f in x))
    return x[:1]


class SynthSaver(Callback):
    def __init__(self, result_dir: str, system, vocoder=None,
                 stats: GlobalStats = DEFAULT_STATS, sample_rate: int = 22050,
                 synth_step: int = 1000, write_audio: bool = True,
                 write_figures: bool = True):
        self.result_dir = result_dir
        self.system = system
        self.vocoder = vocoder
        self.stats = stats
        self.sample_rate = sample_rate
        self.synth_step = synth_step
        self.write_audio = write_audio
        self.write_figures = write_figures
        self.last: Dict[str, Dict[str, Optional[np.ndarray]]] = {}
        os.makedirs(result_dir, exist_ok=True)

    def _vocode(self, mel: np.ndarray) -> np.ndarray:
        if self.vocoder is not None:
            return self.vocoder.infer(mel)
        from fscl_tpu_torch.audio_out.vocoder import griffin_lim
        return griffin_lim(mel, sr=self.sample_rate, n_iter=8)

    def save_sample(self, step: int, tag: str, mel: np.ndarray,
                    pitch: Optional[np.ndarray] = None,
                    energy: Optional[np.ndarray] = None,
                    write_audio: bool = True):
        """mel (T, n_mels); pitch/energy normalized (de-normalized for the
        figure like utils/log.py:24-33)."""
        if pitch is not None:
            pitch = pitch * self.stats.pitch.std + self.stats.pitch.mean
        if energy is not None:
            energy = energy * self.stats.energy.std + self.stats.energy.mean
        base = os.path.join(self.result_dir, f"step{step}-{tag}")
        if self.write_figures:
            from fscl_tpu_torch.obs.figures import plot_mel
            plot_mel(mel, pitch, energy, title=tag, path=base + ".png")
        wav = None
        if write_audio:
            from fscl_tpu_torch.dsp.audio_io import save_wav
            wav = self._vocode(mel)
            save_wav(base + ".wav", wav, self.sample_rate)
        self.last[tag] = {"mel": mel, "pitch": pitch, "energy": energy, "wav": wav}

    def on_validation_sample(self, step: int, state, batch, symbol_id=None):
        """Reconstruction + synthesis of the first sample in the batch (numpy
        or on the system's device)."""
        if step % self.synth_step != 0:
            return
        system = self.system
        batch = on_device(batch, system.device)
        system.eval()
        with torch.no_grad():
            out = system(batch)
        n = int(out.mel_len[0])
        self.save_sample(
            step, "recon", out.postnet_mel[0, :n].float().cpu().numpy(),
            pitch=batch.pitches[0].cpu().numpy(), energy=batch.energies[0].cpu().numpy(),
            write_audio=self.write_audio)
        synth = system.synthesize(
            batch.texts[:1], batch.src_lens[:1], batch.mels.shape[1],
            first_row(batch.speaker_args), batch.lang_ids[:1], symbol_id=symbol_id)
        m = int(synth.mel_len[0])
        self.save_sample(
            step, "synth", synth.postnet_mel[0, :max(m, 1)].float().cpu().numpy(),
            pitch=synth.pitch_prediction[0].cpu().numpy(),
            energy=synth.energy_prediction[0].cpu().numpy(),
            write_audio=self.write_audio)
