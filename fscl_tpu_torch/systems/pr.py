"""Phoneme-recognition (PR) systems (port of `fscl_tpu/systems/pr.py`;
lightning/systems/phoneme_recognition/, §2.6).

- `SSLLinearSystem` ("pr-ssl-linear", `:88`): frozen upstream ->
  `LinearDownstream` -> per-language linear head; framewise cross-entropy
  ignoring PAD.
- `SSLBaselineSystem` ("pr-ssl-baseline", `:127`): frozen upstream ->
  `Downstream1` -> `MultilingualPRHead`.
- `SSLClusterSystem` ("pr-ssl-cluster", `:173`): the cosine (or L2) cluster
  head.
- `TransHeadPRSystem` ("pr-trans-head", "pr-fscl", `:207`): the
  classification head generated per episode from the support set's raw SSL
  phoneme queries through a soft codebook; query frames through a BiLSTM.
- `SSLProtoNetSystem` ("pr-ssl-protonet", `:296`): per-episode prototypes
  from the support set (frame-level class means of `Downstream1` features),
  query frames classified by -L2^2 distance.

Systems are `nn.Module`s built on `device` (default `cuda`) in eval mode,
as the port's other systems (`systems/base.py`). The upstream is
`FrozenUpstream`'s: outside the trainable parameters, in eval mode and under
`no_grad`, stored in `model_cfg.upstream.compute_dtype`, drawn on the device
from `upstream_seed` unless one is given. `PRBatch.n_symbols` and
`symbol_id` are Python fields (flax static fields in fscl_tpu): they pick the
head and size the prototypes, and never reach the card. The PR heads hold a
head per language of `id2symbols` (`nn/downstreams.py`).

The protonet's logits are computed as -(|x|^2 - 2 x.c + |c|^2), one product,
where fscl_tpu sums (x - c)^2 over a broadcast (B, T, S, d) array (0.4 GB at
B = 8, T = 500, S = 100, d = 256 in f32, kept for the backward): the same
numbers up to f32 rounding of the expansion, about 1e-7 of |x|^2 (the tests
hold logits, loss and gradients to fscl_tpu at 1e-5 / 1e-4 relative).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from fscl_tpu_torch.core.config import ModelConfig, OptimConfig
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.models.hubert import SSLUpstream
from fscl_tpu_torch.nn.downstreams import (
    BiLSTMDownstream, Downstream1, LinearDownstream, MultilingualClusterHead,
    MultilingualPRHead, WeightedSumLayer,
)
from fscl_tpu_torch.nn.losses import framewise_accuracy, framewise_ce_loss
from fscl_tpu_torch.nn.phoneme_embedding import SoftAttCodebook
from fscl_tpu_torch.ops.length_regulator import gather_frame_labels
from fscl_tpu_torch.ops.segment_ops import frame_phoneme_query_extract
from fscl_tpu_torch.systems.base import System
from fscl_tpu_torch.systems.fscl import FrozenUpstream


class PRBatch(NamedTuple):
    wavs: np.ndarray          # (B, T_wav) 16 kHz
    wav_lens: np.ndarray      # (B,)
    avg_frames: np.ndarray    # (B, L) SSL frames per phoneme
    phonemes: np.ndarray      # (B, L) phoneme ids (= labels)
    lang_ids: np.ndarray      # (B,)
    n_symbols: int = 0
    symbol_id: str = "en"


class PREpisode(NamedTuple):
    sup: PRBatch
    qry: PRBatch


class _SSLPRBase(FrozenUpstream, System):
    """Device, frozen upstream and the framewise loss of the PR systems.
    Subclasses build their modules in `build`."""

    def __init__(self, model_cfg: ModelConfig, id2symbols: Tuple[Tuple[str, int], ...],
                 device: Optional[Union[str, torch.device]] = None,
                 optim_cfg: Optional[OptimConfig] = None,
                 upstream: Optional[SSLUpstream] = None, upstream_seed: int = 0):
        super().__init__(optim_cfg)
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.id2symbols = tuple(id2symbols)
        self.build()
        self.to(self.device)
        self.attach_upstream(upstream, upstream_seed)
        self.eval()

    def build(self) -> None:
        raise NotImplementedError

    def downstream_1(self) -> Downstream1:
        up, tr = self.model_cfg.upstream, self.model_cfg.transformer
        return Downstream1(n_in_layers=up.n_layers, d_in=up.dim, d_model=tr.encoder_hidden,
                           n_head=tr.encoder_head, specific_layer=up.layer_idx)

    def frame_labels(self, batch: PRBatch, n_frames: int) -> torch.Tensor:
        return gather_frame_labels(batch.phonemes, batch.avg_frames, n_frames)

    def framewise(self, logits, batch: PRBatch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        labels = self.frame_labels(batch, logits.shape[1])
        loss = framewise_ce_loss(logits, labels)
        return loss, {"Total Loss": loss.detach(),
                      "Acc": framewise_accuracy(logits.detach(), labels)}


@SYSTEMS.register("pr-ssl-linear", "pr-ssl-linear-tune")
class SSLLinearSystem(_SSLPRBase):
    """Parameters under `upstream.` (frozen), `downstream.` and `head.`."""

    def build(self) -> None:
        up, d = self.model_cfg.upstream, self.model_cfg.transformer.encoder_hidden
        self.downstream = LinearDownstream(up.n_layers, up.dim, d, specific_layer=up.layer_idx)
        self.head = MultilingualPRHead(self.id2symbols, d)

    def logits(self, batch: PRBatch) -> torch.Tensor:
        hidden, _ = self.extract_ssl(batch.wavs, batch.wav_lens)
        return self.head(self.downstream(hidden), batch.symbol_id)

    def loss_and_metrics(self, batch: PRBatch):
        return self.framewise(self.logits(batch), batch)


@SYSTEMS.register("pr-ssl-baseline", "pr-ssl-baseline-tune")
class SSLBaselineSystem(_SSLPRBase):
    """Downstream1 (dropout in train mode) and a linear head per language."""

    def build(self) -> None:
        self.downstream = self.downstream_1()
        self.head = MultilingualPRHead(self.id2symbols, self.model_cfg.transformer.encoder_hidden)

    def logits(self, batch: PRBatch) -> torch.Tensor:
        hidden, frame_valid = self.extract_ssl(batch.wavs, batch.wav_lens)
        return self.head(self.downstream(hidden, frame_valid), batch.symbol_id)

    def loss_and_metrics(self, batch: PRBatch):
        return self.framewise(self.logits(batch), batch)


@SYSTEMS.register("pr-ssl-cluster", "pr-ssl-cluster-tune")
class SSLClusterSystem(SSLBaselineSystem):
    """SSLBaselineSystem with cluster-centre heads (`cluster_mode` "cos" or
    "l2")."""

    def __init__(self, *args, cluster_mode: str = "cos", **kwargs):
        self.cluster_mode = cluster_mode
        super().__init__(*args, **kwargs)

    def build(self) -> None:
        self.downstream = self.downstream_1()
        self.head = MultilingualClusterHead(
            self.id2symbols, self.model_cfg.transformer.encoder_hidden, mode=self.cluster_mode)


class TransHeadGenerator(nn.Module):
    """Head-weight generator (TransHead.py:26-31): a learned weighted sum
    over the layer axis of the phoneme queries (1, n_symbols, n_layers,
    upstream_dim), then single-head soft codebook attention giving one
    classifier row per symbol: (table (n_symbols, dim), weights or None)."""

    def __init__(self, n_in_layers: int, codebook_size: int, dim: int, upstream_dim: int,
                 specific_layer: Optional[int] = None):
        super().__init__()
        self.weighted_sum = WeightedSumLayer(n_in_layers, specific_layer)
        self.codebook = SoftAttCodebook(codebook_size, dim, upstream_dim)

    def forward(self, queries, need_weights: bool = False):
        return self.codebook(self.weighted_sum(queries, axis=2)[0], need_weights)


@SYSTEMS.register("pr-trans-head", "pr-trans-head-tune", "pr-fscl", "pr-fscl-tune")
class TransHeadPRSystem(_SSLPRBase):
    """TransHead (TransHead.py:23-165): the support set's raw SSL phoneme
    queries (single-stage frame means) through the generator give the head's
    weight matrix; query frames through the BiLSTM downstream are classified
    by x @ W^T + bias. Parameters under `upstream.` (frozen), `downstream.`,
    `head_generator.` and `trans_head_bias`."""

    def build(self) -> None:
        up, d = self.model_cfg.upstream, self.model_cfg.transformer.encoder_hidden
        self.downstream = BiLSTMDownstream(up.n_layers, up.dim, d, specific_layer=up.layer_idx)
        self.head_generator = TransHeadGenerator(up.n_layers, self.model_cfg.codebook.size, d,
                                                 up.dim, specific_layer=up.layer_idx)
        self.trans_head_bias = nn.Parameter(torch.zeros(1))

    def support_frame_queries(self, sup: PRBatch) -> torch.Tensor:
        """(1, n_symbols, n_layers, dim) frame means of the raw SSL features
        (no downstream); separate so that an evaluation can stream many
        support batches before generating the head."""
        hidden, _ = self.extract_ssl(sup.wavs, sup.wav_lens)
        return frame_phoneme_query_extract(hidden, sup.avg_frames, sup.phonemes,
                                           int(sup.n_symbols))

    def head_from_queries(self, queries, need_weights: bool = False):
        return self.head_generator(queries, need_weights)

    def build_head_weights(self, sup: PRBatch, need_weights: bool = False):
        return self.head_from_queries(self.support_frame_queries(sup), need_weights)

    def head_logits(self, head_weights: torch.Tensor, qry: PRBatch) -> torch.Tensor:
        """(B, T, n_symbols) logits of the query frames against a head."""
        hidden, frame_valid = self.extract_ssl(qry.wavs, qry.wav_lens)
        x = self.downstream(hidden, frame_valid)
        return torch.matmul(x, head_weights.T) + self.trans_head_bias[0]

    def logits(self, episode: PREpisode) -> torch.Tensor:
        head_weights, _ = self.build_head_weights(episode.sup)
        return self.head_logits(head_weights, episode.qry)

    def loss_and_metrics(self, episode: PREpisode):
        return self.framewise(self.logits(episode), episode.qry)


@SYSTEMS.register("pr-ssl-protonet")
class SSLProtoNetSystem(_SSLPRBase):
    """Episodic: prototypes from the support set, -L2^2 classification of the
    query frames (SSLProtoNet.py:63-121). Parameters under `upstream.`
    (frozen) and `downstream.` (Downstream1, dropout in train mode)."""

    def build(self) -> None:
        self.downstream = self.downstream_1()

    def features(self, batch: PRBatch) -> torch.Tensor:
        hidden, frame_valid = self.extract_ssl(batch.wavs, batch.wav_lens)
        return self.downstream(hidden, frame_valid)

    def build_prototypes(self, sup: PRBatch) -> torch.Tensor:
        """(n_symbols, d): each symbol's mean Downstream1 frame."""
        protos = frame_phoneme_query_extract(self.features(sup)[:, :, None, :], sup.avg_frames,
                                             sup.phonemes, int(sup.n_symbols))
        return protos[0, :, 0]

    def classify(self, protos: torch.Tensor, qry: PRBatch) -> torch.Tensor:
        """(B, T, n_symbols) -|x - c|^2 logits."""
        x = self.features(qry)
        return (2.0 * torch.matmul(x, protos.T) - (x * x).sum(-1, keepdim=True)
                - (protos * protos).sum(-1))

    def loss_and_metrics(self, episode: PREpisode):
        logits = self.classify(self.build_prototypes(episode.sup), episode.qry)
        return self.framewise(logits, episode.qry)
