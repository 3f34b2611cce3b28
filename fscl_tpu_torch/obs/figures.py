"""Figure artifacts: mel plots with F0/energy overlays, attention heatmaps,
SSL layer-weight bars (port of `fscl_tpu/obs/figures.py`; lightning/utils/
log.py:15-147, Objects/visualization.py:7-139, callbacks/t2u/plot.py
equivalents).

matplotlib is imported when a figure is drawn, never when this module is
imported, so that the savers' device work (forwards, synthesis, vocoding,
codebook weights) runs where matplotlib is not installed; `have_matplotlib`
says whether figures can be drawn here.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Optional, Sequence

import numpy as np


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(plt, fig, path: Optional[str]) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_mel(mel: np.ndarray, pitch: Optional[np.ndarray] = None,
             energy: Optional[np.ndarray] = None, title: str = "",
             path: Optional[str] = None):
    """Mel spectrogram with optional F0/energy overlays (utils/log.py
    plot_mel)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 3))
    ax.imshow(np.asarray(mel).T, origin="lower", aspect="auto",
              interpolation="none")
    ax.set_title(title)
    ax.set_ylabel("mel bin")
    if pitch is not None:
        ax2 = ax.twinx()
        ax2.plot(np.asarray(pitch), color="white", linewidth=0.8)
        ax2.set_ylabel("F0")
    if energy is not None:
        ax3 = ax.twinx()
        ax3.plot(np.asarray(energy), color="red", linewidth=0.6, alpha=0.6)
        ax3.spines["right"].set_position(("outward", 40))
        ax3.set_ylabel("energy")
    _save(plt, fig, path)
    return fig


def plot_attention(attn: np.ndarray, title: str = "",
                   path: Optional[str] = None):
    """Attention/alignment heatmap (codebook attention, T2U alignments)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(np.asarray(attn), origin="lower", aspect="auto",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    _save(plt, fig, path)
    return fig


def plot_layer_weights(weights: Sequence[float], title: str = "SSL layer weights",
                       path: Optional[str] = None):
    """(TransEmbOrig layer-weight logging)."""
    plt = _plt()
    w = np.asarray(weights).reshape(-1)
    fig, ax = plt.subplots(figsize=(6, 2.5))
    ax.bar(np.arange(len(w)), w)
    ax.set_xlabel("layer")
    ax.set_title(title)
    _save(plt, fig, path)
    return fig
