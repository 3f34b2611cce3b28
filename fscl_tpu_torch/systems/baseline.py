"""BaselineSystem: multilingual FastSpeech2 serving
(port of `fscl_tpu/systems/baseline.py`, the inference half, `:119-176`).

A MultilingualEmbedding feeding the headless FastSpeech2. `synthesize` is
the no-target forward; `synthesize_bucketed` is the two-pass serving path:
(1) encoder + duration predictor give each sample's predicted frame count,
(2) the full forward runs at the smallest mel bucket that covers the batch.
Training (`train_step`, the loss, the optimizer) comes with a later slice.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from fscl_tpu_torch.core.config import ModelConfig
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.core.stats import DEFAULT_STATS, GlobalStats
from fscl_tpu_torch.frontend.define import n_symbols
from fscl_tpu_torch.models.fastspeech2 import FastSpeech2, FastSpeech2Output
from fscl_tpu_torch.nn.embeddings import MultilingualEmbedding

MEL_BUCKETS = (128, 256, 512, 1000)


class BaselineSystem(nn.Module):
    """Parameters live under `embedding_model.` and `model.`; the model's
    keys are the reference torch FastSpeech2 keys. The system is built on
    `device` (default `cuda`) in eval mode, with dropout off."""

    def __init__(
        self,
        model_cfg: Optional[ModelConfig] = None,
        id2symbols: Optional[Tuple[Tuple[str, int], ...]] = None,
        stats: GlobalStats = DEFAULT_STATS,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.model_cfg = model_cfg if model_cfg is not None else ModelConfig()
        if id2symbols is None:
            id2symbols = (("en", n_symbols("en")),)
        self.embedding_model = MultilingualEmbedding(
            id2symbols, self.model_cfg.transformer.encoder_hidden)
        self.model = FastSpeech2(self.model_cfg, stats)
        self.to(self.device)
        self.eval()

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    @torch.inference_mode()
    def synthesize(self, texts, src_lens, max_mel_len: int, speaker_args,
                   lang_ids, symbol_id: Optional[str] = None,
                   p_control: float = 1.0, e_control: float = 1.0,
                   d_control: float = 1.0) -> FastSpeech2Output:
        """No-target forward: durations, pitch and energy are predicted."""
        emb = self.embedding_model(self._tensor(texts), symbol_id)
        return self.model(
            emb, self._tensor(src_lens), max_mel_len,
            speaker_args=self._tensor(speaker_args), lang_args=self._tensor(lang_ids),
            p_control=p_control, e_control=e_control, d_control=d_control)

    @torch.inference_mode()
    def pick_mel_bucket(self, texts, src_lens, speaker_args, lang_ids,
                        symbol_id: Optional[str] = None,
                        mel_buckets=MEL_BUCKETS, d_control: float = 1.0) -> int:
        """Pass 1: the smallest bucket covering every predicted length (the
        largest bucket when none does)."""
        emb = self.embedding_model(self._tensor(texts), symbol_id)
        mel_len = self.model.predict_mel_len(
            emb, self._tensor(src_lens), self._tensor(speaker_args),
            self._tensor(lang_ids), d_control=d_control)
        max_len = int(mel_len.max())
        return next((b for b in mel_buckets if max_len <= b), mel_buckets[-1])

    def synthesize_bucketed(self, texts, src_lens, speaker_args, lang_ids,
                            symbol_id: Optional[str] = None,
                            mel_buckets=MEL_BUCKETS, **controls) -> FastSpeech2Output:
        """Two-pass serving synthesis at the smallest adequate mel bucket.
        Pass 1 predicts lengths with the same `d_control` as pass 2."""
        T = self.pick_mel_bucket(texts, src_lens, speaker_args, lang_ids,
                                 symbol_id, mel_buckets,
                                 controls.get("d_control", 1.0))
        return self.synthesize(texts, src_lens, T, speaker_args, lang_ids,
                               symbol_id=symbol_id, **controls)
