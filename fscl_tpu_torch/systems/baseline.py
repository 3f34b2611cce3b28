"""BaselineSystem: supervised multilingual FastSpeech2
(port of `fscl_tpu/systems/baseline.py`).

A MultilingualEmbedding feeding the headless FastSpeech2, trained with the
full FastSpeech2 loss (`forward`, `loss_and_metrics`, `trainable_mask`,
`:42-116`; `train_step` and `eval_step` from `systems/base.py`).
`synthesize` is the no-target forward; `synthesize_bucketed` is the two-pass
serving path (`:119-176`): (1) encoder + duration predictor give each
sample's predicted frame count, (2) the full forward runs at the smallest
mel bucket that covers the batch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from fscl_tpu_torch.core.config import ModelConfig, OptimConfig
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.core.stats import DEFAULT_STATS, GlobalStats
from fscl_tpu_torch.data.batch import Batch
from fscl_tpu_torch.frontend.define import n_symbols
from fscl_tpu_torch.models.fastspeech2 import FastSpeech2, FastSpeech2Output
from fscl_tpu_torch.nn.embeddings import MultilingualEmbedding
from fscl_tpu_torch.nn.losses import fastspeech2_loss
from fscl_tpu_torch.systems.base import System

MEL_BUCKETS = (128, 256, 512, 1000)


@SYSTEMS.register("baseline", "baseline-tune")
class BaselineSystem(System):
    """Parameters live under `embedding_model.` and `model.`; the model's
    keys are the reference torch FastSpeech2 keys. The system is built on
    `device` (default `cuda`) in eval mode, with dropout off; `train_step`
    switches to train mode for the step."""

    def __init__(
        self,
        model_cfg: Optional[ModelConfig] = None,
        id2symbols: Optional[Tuple[Tuple[str, int], ...]] = None,
        stats: GlobalStats = DEFAULT_STATS,
        device: Optional[Union[str, torch.device]] = None,
        optim_cfg: Optional[OptimConfig] = None,
    ):
        super().__init__(optim_cfg)
        self.device = resolve_device(device)
        self.model_cfg = model_cfg if model_cfg is not None else ModelConfig()
        if id2symbols is None:
            id2symbols = (("en", n_symbols("en")),)
        self.embedding_model = MultilingualEmbedding(
            id2symbols, self.model_cfg.transformer.encoder_hidden)
        self.model = FastSpeech2(self.model_cfg, stats)
        self.to(self.device)
        self.eval()

    def _tensor(self, x):
        """x on the system's device; a `DvecRefs` (the d-vector speakers'
        speaker_args) field by field."""
        if isinstance(x, tuple):
            return type(x)(*(self._tensor(f) for f in x))
        return torch.as_tensor(x, device=self.device)

    # -- training ------------------------------------------------------------
    def trainable_mask(self) -> Dict[str, bool]:
        """emb_type "dvec" keeps the pretrained GE2E speaker encoder frozen
        ("encoder"/"scratch_encoder" fine-tune it), as reference
        speaker_encoder.py:115-136 detaches the d-vector path: the
        parameters under `model.speaker_emb.ge2e` stay out of the optimizer
        and its clip."""
        freeze_ge2e = self.model_cfg.speaker.emb_type == "dvec"
        return {name: p.requires_grad and not (freeze_ge2e and "ge2e" in name.split("."))
                for name, p in self.named_parameters()}

    def forward(self, batch: Batch, symbol_id: Optional[str] = None) -> FastSpeech2Output:
        """Teacher-forced forward on a batch of tensors on the system's
        device (`data.batch.to_device`), at the batch's mel length T, in the
        module's mode."""
        emb = self.embedding_model(batch.texts, symbol_id)
        return self.model(
            emb, batch.src_lens, batch.mels.shape[1],
            speaker_args=batch.speaker_args, mel_lens=batch.mel_lens,
            p_targets=batch.pitches, e_targets=batch.energies,
            d_targets=batch.durations, lang_args=batch.lang_ids)

    def loss_and_metrics(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        out = self(batch)
        var = self.model_cfg.variance
        losses = fastspeech2_loss(
            out.mel, out.postnet_mel, out.pitch_prediction,
            out.energy_prediction, out.log_duration_prediction,
            batch.mels, batch.pitches, batch.energies, batch.durations,
            out.src_valid, out.mel_valid, var.pitch_feature, var.energy_feature)
        return losses.total, {k: v.detach() for k, v in losses.as_dict().items()}

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
                        mel_buckets=MEL_BUCKETS) -> int:
        """Pass 1: the smallest bucket covering every length predicted at
        d_control 1 (the largest bucket when none does)."""
        emb = self.embedding_model(self._tensor(texts), symbol_id)
        mel_len = self.model.predict_mel_len(
            emb, self._tensor(src_lens), self._tensor(speaker_args),
            self._tensor(lang_ids))
        max_len = int(mel_len.max())
        return next((b for b in mel_buckets if max_len <= b), mel_buckets[-1])

    def synthesize_bucketed(self, texts, src_lens, speaker_args, lang_ids,
                            symbol_id: Optional[str] = None,
                            mel_buckets=MEL_BUCKETS, **controls) -> FastSpeech2Output:
        """Two-pass serving synthesis at the smallest adequate mel bucket.
        As in fscl_tpu, pass 1 predicts lengths at d_control 1 whatever the
        controls of pass 2, so a d_control above 1 can pick a bucket that
        pass 2 then clips mel_len to."""
        T = self.pick_mel_bucket(texts, src_lens, speaker_args, lang_ids,
                                 symbol_id, mel_buckets)
        return self.synthesize(texts, src_lens, T, speaker_args, lang_ids,
                               symbol_id=symbol_id, **controls)
