"""Codebook analysis artifacts (port of `fscl_tpu/obs/codebook_analysis.py`).

Re-provides Objects/visualization.py:7-139 (`MatchingGraphInfo`,
`CodebookAnalyzer`): codebook-attention matching heatmaps per head,
phoneme-transfer tables (which codebook entries each phoneme attends to),
and cross-lingual similarity matrices between generated embedding tables.
The tables and similarities are numpy; only the heatmaps need matplotlib
(`write_figures=False` skips them).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class MatchingGraphInfo:
    """One heatmap spec (Objects/visualization.py MatchingGraphInfo)."""
    title: str
    y_labels: List[str]
    x_labels: List[str]
    attn: np.ndarray               # (len(y), len(x))
    quantized: bool = False


class CodebookAnalyzer:
    def __init__(self, result_dir: str, write_figures: bool = True):
        self.result_dir = result_dir
        self.write_figures = write_figures
        os.makedirs(result_dir, exist_ok=True)

    def _plot(self, attn, title, path):
        if self.write_figures:
            from fscl_tpu_torch.obs.figures import plot_attention
            plot_attention(attn, title=title, path=path)

    def plot_matching(self, infos: Sequence[MatchingGraphInfo], step: int = 0):
        """Codebook attention heatmaps, one figure per head
        (CodebookAnalyzer.visualize_matching); returns their paths."""
        paths = []
        for info in infos:
            path = os.path.join(self.result_dir, f"matching-{step}-{info.title}.png")
            attn = info.attn
            if info.quantized:
                attn = (attn == attn.max(axis=-1, keepdims=True)).astype(float)
            self._plot(attn, info.title, path)
            paths.append(path)
        return paths

    def heads_to_infos(self, attn: np.ndarray, symbols: Sequence[str],
                       prefix: str = "head") -> List[MatchingGraphInfo]:
        """attn (n_heads, n_symbols, codebook_size) -> per-head infos."""
        return [
            MatchingGraphInfo(
                title=f"{prefix}-{h}",
                y_labels=list(symbols),
                x_labels=[str(i) for i in range(attn.shape[-1])],
                attn=np.asarray(attn[h]),
            )
            for h in range(attn.shape[0])
        ]

    def phoneme_transfer_table(self, attn: np.ndarray,
                               symbols: Sequence[str], top_k: int = 3):
        """Per-phoneme top-k codebook entries (phoneme-transfer analysis)."""
        attn = np.asarray(attn)
        if attn.ndim == 3:          # average heads
            attn = attn.mean(axis=0)
        rows = []
        for i, sym in enumerate(symbols):
            top = np.argsort(attn[i])[::-1][:top_k]
            rows.append({"symbol": sym,
                         "top_entries": top.tolist(),
                         "weights": attn[i, top].round(4).tolist()})
        return rows

    def cross_lingual_similarity(
        self, table_a: np.ndarray, table_b: np.ndarray,
        symbols_a: Sequence[str], symbols_b: Sequence[str],
        step: int = 0, name: str = "xling",
    ) -> np.ndarray:
        """Cosine similarity between two generated embedding tables
        (cross-lingual phoneme similarity heatmap)."""
        a = table_a / (np.linalg.norm(table_a, axis=-1, keepdims=True) + 1e-8)
        b = table_b / (np.linalg.norm(table_b, axis=-1, keepdims=True) + 1e-8)
        sim = a @ b.T
        self._plot(sim, name, os.path.join(self.result_dir, f"{name}-{step}.png"))
        return sim
