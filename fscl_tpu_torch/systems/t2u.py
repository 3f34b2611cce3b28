"""Text-to-unit (T2U) systems (port of `fscl_tpu/systems/t2u.py`).

- `TacoT2USystem` ("tacot2u", `:63`): a MultilingualEmbedding feeding
  TacoT2U, framewise cross-entropy and accuracy over the unit targets;
  `forward(..., tf_ratio)` runs scheduled sampling below 1.
- `TransEmbT2USystem` ("fscl-t2u", `:121`): FSCL applied to T2U. Per
  episode, the frozen HuBERT upstream (PR 6's) encodes the support wavs,
  `Downstream1` turns the 25 hidden states into frame features, two-stage
  phoneme query extraction averages them into an (n_symbols, d) table, and
  the query texts looked up in it go through TacoT2U at the
  teacher-forcing ratio `schedule_f(step)` (`:37`; constant 1, the
  reference's linear decay kept as `linear_decay_schedule`, `:44`).
  `TransEmbCT2USystem` (`:245`) takes `Downstream2`'s codeformer features;
  `TransEmbC2T2USystem` (`:268`) a codebook attention over the table.
- `GradientReversal` (`:297`), `UnitDiscriminator` (`:317`) and `DA`
  (`:340`): the domain-adversarial discriminator of the DA tune systems.

Systems are `nn.Module`s built on `device` in eval mode, as the port's
other systems (`systems/base.py`). Dropout masks come from `self.generator`,
a `torch.Generator` on the device seeded from `seed`. fscl_tpu runs the
FSCL-T2U systems' `Downstream1` deterministic whatever the mode
(`frame_features` passes deterministic=True): the port keeps the embedding
generator in eval mode in train mode too.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fscl_tpu_torch.core.config import ModelConfig, OptimConfig
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.data.batch import SupInfo
from fscl_tpu_torch.models.hubert import SSLUpstream
from fscl_tpu_torch.models.tacotron2_t2u import T2UConfig, TacoT2U, T2UMasks
from fscl_tpu_torch.nn.downstreams import Downstream1, Downstream2
from fscl_tpu_torch.nn.embeddings import MultilingualEmbedding, SoftMultiAttCodebook
from fscl_tpu_torch.nn.losses import framewise_accuracy, framewise_ce_loss
from fscl_tpu_torch.ops.masking import length_mask
from fscl_tpu_torch.ops.segment_ops import phoneme_query_extract
from fscl_tpu_torch.systems.base import System
from fscl_tpu_torch.systems.fscl import FrozenUpstream


def schedule_f(step) -> float:
    """The FSCL-T2U teacher-forcing schedule (TransEmb.py:213-217): constant
    1.0; the reference's commented linear decay is `linear_decay_schedule`."""
    return 1.0


def linear_decay_schedule(step, floor: float = 0.5, span: float = 20000.0) -> float:
    """1 - step / span, never below `floor`."""
    return max(floor, 1.0 - step / span)


class T2UBatch(NamedTuple):
    speaker_args: np.ndarray   # (B,)
    texts: np.ndarray          # (B, L) phoneme ids
    src_lens: np.ndarray       # (B,)
    units: np.ndarray          # (B, T_u) unit ids, <eos>=8 appended
    unit_lens: np.ndarray      # (B,)
    lang_ids: np.ndarray       # (B,)


class T2UEpisode(NamedTuple):
    sup: SupInfo
    qry: T2UBatch


def _metrics(loss, logits, units) -> Dict[str, torch.Tensor]:
    return {"Total Loss": loss.detach(),
            "Acc": framewise_accuracy(logits.detach(), units)}


class T2UBase(System):
    """Device, generator and the TacoT2U trunk shared by the T2U systems."""

    def __init__(self, t2u_cfg: T2UConfig, device, optim_cfg, seed: int):
        super().__init__(optim_cfg)
        self.device = resolve_device(device)
        self.t2u_cfg = t2u_cfg
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = TacoT2U(t2u_cfg)

    def decode(self, emb_texts, src_lens, units, masks: Optional[T2UMasks] = None,
               tf_ratio: float = 1.0):
        """Teacher-forced TacoT2U forward in the module's mode, scheduled
        sampling below `tf_ratio` 1; returns (logits, alignments)."""
        return self.model(emb_texts, src_lens, units.long(), masks=masks,
                          generator=self.generator, teacher_forcing_ratio=tf_ratio)


@SYSTEMS.register("tacot2u")
class TacoT2USystem(T2UBase):
    """Supervised text -> unit (TacoT2U.py). Parameters under
    `embedding_model.` and `model.`."""

    def __init__(self, model_cfg: ModelConfig, id2symbols: Tuple[Tuple[str, int], ...],
                 t2u_cfg: T2UConfig, device: Optional[Union[str, torch.device]] = None,
                 optim_cfg: Optional[OptimConfig] = None, seed: int = 0):
        super().__init__(t2u_cfg, device, optim_cfg, seed)
        self.model_cfg = model_cfg
        self.embedding_model = MultilingualEmbedding(id2symbols, t2u_cfg.symbols_embedding_dim)
        self.to(self.device)
        self.eval()

    def forward(self, batch: T2UBatch, masks: Optional[T2UMasks] = None,
                tf_ratio: float = 1.0):
        """(logits, alignments) of a batch on the device, at teacher-forcing
        ratio `tf_ratio` (fscl_tpu's `TacoT2USystem.forward`, `:88`)."""
        return self.decode(self.embedding_model(batch.texts), batch.src_lens, batch.units,
                           masks, tf_ratio)

    def loss_and_metrics(self, batch: T2UBatch, masks: Optional[T2UMasks] = None):
        logits, _ = self(batch, masks)
        loss = framewise_ce_loss(logits, batch.units)
        return loss, _metrics(loss, logits, batch.units)

    @torch.inference_mode()
    def infer(self, texts, src_lens, symbol_id: Optional[str] = None,
              max_steps: Optional[int] = None, masks: Optional[T2UMasks] = None):
        """Autoregressive units: (logits, unit ids, lengths, alignments)."""
        emb = self.embedding_model(torch.as_tensor(texts, device=self.device), symbol_id)
        return self.model.infer(emb, torch.as_tensor(src_lens, device=self.device),
                                max_steps, masks, self.generator)


@SYSTEMS.register("fscl-t2u", "fscl-t2u-orig")
class TransEmbT2USystem(FrozenUpstream, T2UBase):
    """FSCL T2U meta-system (t2u/TransEmb.py:22-217). Parameters under
    `upstream.` (frozen, HF HubertModel keys), `embedding_generator.` and
    `model.`. `Downstream1` is built at d_model = symbols_embedding_dim with
    its own defaults (2 heads, d_ff (1024, 1024), dropout 0.1): fscl_tpu
    ignores the model YAML's `downstream.transformer` block (ROADMAP Queue 3)."""

    def __init__(self, model_cfg: ModelConfig, n_symbols: int, t2u_cfg: T2UConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 optim_cfg: Optional[OptimConfig] = None,
                 upstream: Optional[SSLUpstream] = None, upstream_seed: int = 0,
                 seed: int = 0):
        super().__init__(t2u_cfg, device, optim_cfg, seed)
        self.model_cfg = model_cfg
        self.n_symbols = n_symbols
        self.embedding_generator = self.make_generator()
        self.to(self.device)
        self.attach_upstream(upstream, upstream_seed)
        self.eval()

    def make_generator(self) -> nn.Module:
        up = self.model_cfg.upstream
        return Downstream1(n_in_layers=up.n_layers, d_in=up.dim,
                           d_model=self.t2u_cfg.symbols_embedding_dim,
                           specific_layer=up.layer_idx)

    def train(self, mode: bool = True):
        super().train(mode)
        self.embedding_generator.eval()
        return self

    def frame_features(self, ssl_hidden, frame_valid):
        """Frame features the phoneme queries are averaged from: Downstream1."""
        return self.embedding_generator(ssl_hidden, frame_valid)

    def post_table(self, table_pre):
        """The transform after phoneme-query extraction: none here."""
        return table_pre

    def build_embedding_table(self, ssl_hidden, sup: SupInfo):
        """(n_symbols, d) table of `sup.n_symbols` rows (t2u/TransEmb.py:54-73)."""
        Tp = ssl_hidden.shape[1]
        frame_lens = sup.avg_frames.sum(dim=-1)
        frame_valid = length_mask(frame_lens.clamp(max=Tp), Tp)
        x = self.frame_features(ssl_hidden, frame_valid)
        table_pre = phoneme_query_extract(x[:, :, None, :], sup.avg_frames, sup.phonemes,
                                          int(sup.n_symbols))[0, :, 0]
        return self.post_table(table_pre)

    def forward(self, episode: T2UEpisode, masks: Optional[T2UMasks] = None, step: int = 0):
        """(logits, alignments) of the query batch, decoded at the
        teacher-forcing ratio `schedule_f(step)` (fscl_tpu's `common_step`,
        whose loss reads it at step 0)."""
        sup, qry = episode
        ssl_hidden, _ = self.extract_ssl(sup.wavs, sup.wav_lens)
        table = self.build_embedding_table(ssl_hidden, sup)
        emb = F.embedding(qry.texts, table).masked_fill((qry.texts == 0)[..., None], 0.0)
        return self.decode(emb, qry.src_lens, qry.units, masks, schedule_f(step))

    def loss_and_metrics(self, episode: T2UEpisode, masks: Optional[T2UMasks] = None):
        logits, _ = self(episode, masks)
        loss = framewise_ce_loss(logits, episode.qry.units)
        return loss, _metrics(loss, logits, episode.qry.units)


@SYSTEMS.register("fscl-t2u-c", "fscl-t2u-codebook")
class TransEmbCT2USystem(TransEmbT2USystem):
    """TransEmbC (t2u/TransEmbC.py:25-90): the frame features are
    Downstream2's (a codeformer last layer)."""

    def make_generator(self) -> nn.Module:
        up = self.model_cfg.upstream
        return Downstream2(n_in_layers=up.n_layers, d_in=up.dim,
                           codebook_size=self.model_cfg.codebook.size,
                           d_model=self.t2u_cfg.symbols_embedding_dim,
                           specific_layer=up.layer_idx)

    def frame_features(self, ssl_hidden, frame_valid):
        return self.embedding_generator(ssl_hidden, frame_valid)[0]


@SYSTEMS.register("fscl-t2u-c2", "fscl-t2u-codebook2")
class TransEmbC2T2USystem(TransEmbT2USystem):
    """TransEmbC2 (t2u/TransEmbC2.py:25-80): Downstream1 features, then a
    codebook attention over the extracted phoneme queries."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cb = self.model_cfg.codebook
        self.codebook_attention = SoftMultiAttCodebook(
            cb.size, self.t2u_cfg.symbols_embedding_dim, cb.num_heads).to(self.device)

    def post_table(self, table_pre):
        return self.codebook_attention(table_pre[None])[0][0]


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(x, scale):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.scale = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


class GradientReversal(nn.Module):
    """Identity forward, gradient times -scale backward (t2u/modules.py:10-20)."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return _Reverse.apply(x, self.scale)


class UnitDiscriminator(nn.Module):
    """Conv stack over (soft) one-hot unit distributions (B, T, n_units) ->
    one logit per sequence, the mean over valid frames (t2u/modules.py:
    22-39). Convs pad as flax's SAME: (k - 1) // 2 before, the rest after;
    GELU is the tanh approximation (flax's `nn.gelu`)."""

    def __init__(self, n_units: int, hidden: int = 256, n_layers: int = 3, kernel: int = 6):
        super().__init__()
        dims = [n_units] + [hidden] * (n_layers - 1)
        self.pad = ((kernel - 1) // 2, kernel - 1 - (kernel - 1) // 2)
        self.convs = nn.ModuleList(nn.Conv1d(dims[i], dims[i + 1], kernel)
                                   for i in range(n_layers - 1))
        self.conv_out = nn.Conv1d(hidden, 1, kernel)

    def forward(self, unit_probs, valid=None):
        x = unit_probs.transpose(1, 2)
        for conv in self.convs:
            x = F.gelu(conv(F.pad(x, self.pad)), approximate="tanh")
        x = self.conv_out(F.pad(x, self.pad))[:, 0]
        if valid is None:
            return x.mean(dim=-1)
        return torch.where(valid, x, 0.0).sum(dim=-1) / valid.sum(dim=-1).clamp(min=1)


class DA(nn.Module):
    """Domain-adversarial module: gradient reversal + discriminator."""

    def __init__(self, n_units: int, scale: float = 1.0):
        super().__init__()
        self.grl = GradientReversal(scale)
        self.discriminator = UnitDiscriminator(n_units)

    def forward(self, unit_probs, valid=None):
        return self.discriminator(self.grl(unit_probs), valid)
