"""T2U alignment saver: validation-time attention plots (port of
`fscl_tpu/obs/t2u_saver.py`, `:20`).

Every `synth_step` steps, one teacher-forced forward of the first
validation batch in eval mode; the first sample's (T_units, L_text)
location-attention alignment is saved as a heatmap PNG (`obs/figures.py`).
"""
from __future__ import annotations

import os

import torch

from fscl_tpu_torch.obs.figures import plot_attention
from fscl_tpu_torch.obs.loggers import Callback


class T2UAlignmentSaver(Callback):
    def __init__(self, result_dir: str, system, synth_step: int = 1000):
        self.result_dir = result_dir
        self.system = system
        self.synth_step = synth_step
        os.makedirs(result_dir, exist_ok=True)

    def on_validation_sample(self, step: int, state, batch):
        """`batch`: a T2UBatch on the system's device."""
        if step % self.synth_step != 0:
            return
        self.system.eval()
        with torch.no_grad():
            _, aligns = self.system(batch)
        a = aligns[0].cpu().numpy()                 # (T_units, L_text)
        tu, ls = int(batch.unit_lens[0]), int(batch.src_lens[0])
        plot_attention(a[:max(tu, 1), :max(ls, 1)], f"T2U alignment @ step {step}",
                       os.path.join(self.result_dir, f"step{step}_alignment.png"))
