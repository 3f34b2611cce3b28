"""FSCL saver: codebook-attention + SSL layer-weight artifacts (port of
`fscl_tpu/obs/fscl_saver.py`).

Re-provides lightning/callbacks/language/fscl_saver.py: at validation time,
plot the episode's codebook attention per head (through CodebookAnalyzer)
and the learned softmax SSL layer weights (TransEmbOrig.py layer-weight
logging). The attention is the codebook's own (`build_embedding_table(...,
need_weights=True)`, plain torch products), not the self-attention kernel's:
the kernel's weights are never needed here. The upstream forward and the
codebook run without matplotlib; `write_figures=False` skips the PNGs, and
`last` keeps the arrays ({"attn": (n_heads, n_symbols, size), "layer_weights":
(n_layers,) or absent}).
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch

from fscl_tpu_torch.data.batch import to_device
from fscl_tpu_torch.obs.codebook_analysis import CodebookAnalyzer
from fscl_tpu_torch.obs.loggers import Callback


class FSCLSaver(Callback):
    def __init__(self, result_dir: str, system, symbols: Sequence[str] = (),
                 synth_step: int = 1000, write_figures: bool = True):
        self.result_dir = result_dir
        self.system = system            # TransEmbSystem (or subclass)
        self.symbols = list(symbols)
        self.synth_step = synth_step
        self.write_figures = write_figures
        self.analyzer = CodebookAnalyzer(result_dir, write_figures)
        self.last: Dict[str, np.ndarray] = {}
        os.makedirs(result_dir, exist_ok=True)

    def on_validation_sample(self, step: int, state, episode):
        """`episode`: an `Episode` (numpy or on the system's device)."""
        if step % self.synth_step != 0:
            return
        self.last = {}
        sup = episode.sup
        if not isinstance(sup.wavs, torch.Tensor):
            sup = to_device(sup, self.system.device)
        with torch.no_grad():
            ssl_hidden, _ = self.system.extract_ssl(sup.wavs, sup.wav_lens)
            _, attn = self.system.build_embedding_table(ssl_hidden, sup, need_weights=True)
        if attn is not None:
            attn = attn[0].float().cpu().numpy()          # (n_heads, n_symbols, size)
            self.last["attn"] = attn
            symbols = (self.symbols if self.symbols
                       else [str(i) for i in range(attn.shape[1])])
            infos = self.analyzer.heads_to_infos(attn, symbols, prefix=f"step{step}-head")
            self.analyzer.plot_matching(infos, step=step)

        # learned SSL layer weights (softmax of weight_raw)
        raw = getattr(self.system.codebook, "weight_raw", None)
        if raw is not None:
            w = raw.detach().float().cpu().numpy().reshape(-1)
            w = np.exp(w - w.max())
            w = w / w.sum()
            self.last["layer_weights"] = w
            if self.write_figures:
                from fscl_tpu_torch.obs.figures import plot_layer_weights
                plot_layer_weights(
                    w, title=f"SSL layer weights @ step {step}",
                    path=os.path.join(self.result_dir, f"step{step}-layer-weights.png"))

