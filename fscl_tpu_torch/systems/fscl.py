"""FSCL meta-system ("fscl-orig", TransEmb): a per-episode phoneme table made
from the support set's SSL features (port of `fscl_tpu/systems/fscl.py`,
`Episode` `:39-46`, `TransEmbSystem` `:50-199`, `transplant_embedding`
`:202-217`).

One episode:

    frozen SSL upstream over the support wavs (no gradient)
    -> phoneme_query_extract (segment ops): frames averaged per phoneme,
       then per symbol
    -> SoftMultiAttCodebook2 -> (n_symbols, d) table, PAD row 0, NaNs zeroed
    -> the query texts looked up in it -> FastSpeech2 (speaker embedding
       averaged over the batch) -> fastspeech2_loss.

The upstream is frozen as the JAX package's `TrainState.frozen` is: its
parameters do not require grad, `trainable_mask` leaves them out (so they
are outside `Adam` and its global-norm clip), it stays in eval mode when
`train_step` puts the system in train mode, and it runs under `no_grad`.
Everything else trains, the GE2E speaker encoder included: the JAX system
keeps the base class's mask, which trains every parameter (unlike
`BaselineSystem`, which freezes GE2E under "dvec").
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from fscl_tpu_torch.core.config import ModelConfig, OptimConfig
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.core.registry import SYSTEMS
from fscl_tpu_torch.core.stats import DEFAULT_STATS, GlobalStats
from fscl_tpu_torch.data.batch import Batch, SupInfo
from fscl_tpu_torch.models.fastspeech2 import FastSpeech2, FastSpeech2Output
from fscl_tpu_torch.models.hubert import (
    SSLUpstream, frozen_upstream_features, init_random_, load_torch_checkpoint, make_upstream)
from fscl_tpu_torch.nn.embeddings import SoftMultiAttCodebook2
from fscl_tpu_torch.nn.losses import fastspeech2_loss
from fscl_tpu_torch.ops.masking import length_mask
from fscl_tpu_torch.ops.segment_ops import phoneme_query_extract
from fscl_tpu_torch.systems.base import System

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Episode(NamedTuple):
    """One meta-episode: the support set's raw speech and the query TTS
    batch. `sup_batch`, the support set's own TTS batch, is for the MAML
    inner loop."""
    sup: SupInfo
    qry: Batch
    sup_batch: Optional[Batch] = None


class FrozenUpstream:
    """The frozen SSL upstream of an FSCL system (`System` subclasses with
    `device` and `model_cfg`): its parameters do not require grad and stay
    out of `trainable_mask`, it stays in eval mode in train mode and runs
    under `no_grad`, stored in `model_cfg.upstream.compute_dtype`. Every
    system with one (FSCL, MAML, ADA, ContiAE, T2U, PR, and the tune flows
    through them) runs it through `extract_ssl`, which dispatches through
    the optional `upstream_forward` hook, as fscl_tpu's four systems do
    (`parallel.pipeline.attach_parallel_upstream` sets it)."""

    # (upstream, wavs, wav_valid) -> (hidden, frame_valid); None: one process
    upstream_forward = None

    def attach_upstream(self, upstream: Optional[SSLUpstream], seed: int) -> None:
        """`upstream` moved to the device, or, when None, one made without
        storage and drawn on the device from `seed`."""
        if upstream is None:
            up = self.model_cfg.upstream
            with torch.device("meta"):
                upstream = make_upstream(up.name, up)
            self.upstream = upstream.to_empty(device=self.device)
            self.init_upstream(seed)
        else:
            self.upstream = upstream.to(self.device)
            self._store_upstream()

    def _store_upstream(self) -> None:
        """Frozen, and cast once to the compute dtype (`storage_cast`)."""
        self.upstream.requires_grad_(False)
        self.upstream.to(_DTYPES[self.model_cfg.upstream.compute_dtype])

    def init_upstream(self, seed: int) -> None:
        """New random upstream weights from `seed`, drawn on the device."""
        self.upstream.float()
        init_random_(self.upstream, torch.Generator(device=self.device).manual_seed(seed))
        self._store_upstream()

    def load_upstream(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Install upstream weights, cast to the compute dtype: a released
        checkpoint in any layout `models.hubert.load_torch_checkpoint` reads
        (HF, fairseq, s3prl), or HF keys from JAX params
        (`convert.hubert_state_dict`, per-layer or scan layout)."""
        self.upstream.float()
        self.upstream.load_state_dict(load_torch_checkpoint(state_dict, self.upstream),
                                      strict=True)
        self._store_upstream()

    def train(self, mode: bool = True):
        super().train(mode)
        self.upstream.eval()
        return self

    def trainable_mask(self) -> Dict[str, bool]:
        """Everything but the upstream, as the JAX system's default mask over
        its params (the upstream lives outside them, in `frozen`)."""
        return {name: p.requires_grad and not name.startswith("upstream.")
                for name, p in self.named_parameters()}

    def extract_ssl(self, wavs: torch.Tensor, wav_lens: torch.Tensor):
        """The frozen upstream's hidden states (S, T', n_layers, dim) in f32,
        and the valid frames (S, T'); through `upstream_forward` when set."""
        fwd = self.upstream_forward or frozen_upstream_features
        return fwd(self.upstream, wavs, length_mask(wav_lens, wavs.shape[-1]))


@SYSTEMS.register("fscl", "fscl-orig")
class TransEmbSystem(FrozenUpstream, System):
    """Parameters live under `upstream.` (frozen; HF HubertModel keys),
    `codebook.` and `model.` (the reference torch FastSpeech2 keys). Built on
    `device` (default `cuda`) in eval mode. The upstream is made on the
    device with random weights drawn from `upstream_seed`
    (`models.hubert.init_random_`) and stored in
    `model_cfg.upstream.compute_dtype`; `init_upstream` draws new ones and
    `load_upstream` installs given ones (`FrozenUpstream`); GE2E trains (but
    its constant `bias_ih`, see `GE2EEncoder`)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        n_symbols: int,
        stats: GlobalStats = DEFAULT_STATS,
        device: Optional[Union[str, torch.device]] = None,
        optim_cfg: Optional[OptimConfig] = None,
        upstream: Optional[SSLUpstream] = None,
        upstream_seed: int = 0,
    ):
        super().__init__(optim_cfg)
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.n_symbols = n_symbols
        up = model_cfg.upstream
        self.codebook = SoftMultiAttCodebook2(
            codebook_size=model_cfg.codebook.size,
            dim=model_cfg.transformer.encoder_hidden,
            num_heads=model_cfg.codebook.num_heads,
            upstream_dim=up.dim, n_layers=up.n_layers, layer_idx=up.layer_idx,
            use_layer_weights=up.name != "mel")
        self.model = FastSpeech2(model_cfg, stats)
        self.to(self.device)
        self.attach_upstream(upstream, upstream_seed)
        self.eval()

    # -- episode embedding table ----------------------------------------------
    def build_embedding_table(self, ssl_hidden: torch.Tensor, sup: SupInfo,
                              need_weights: bool = False):
        """(n_symbols, d) phoneme table: per-symbol query means through the
        codebook, the PAD row set to 0, then NaNs zeroed."""
        table_pre = phoneme_query_extract(ssl_hidden, sup.avg_frames, sup.phonemes,
                                          self.n_symbols)
        table, attn = self.codebook(table_pre, need_weights)
        table = table[0]
        table = torch.nan_to_num(torch.cat((table.new_zeros(1, table.shape[1]), table[1:])))
        return (table, attn) if need_weights else table

    # -- episode forward --------------------------------------------------------
    def forward(self, episode: Episode) -> FastSpeech2Output:
        """Teacher-forced forward of the query batch through the episode's
        table, on tensors on the system's device (`data.batch.to_device`)."""
        ssl_hidden, _ = self.extract_ssl(episode.sup.wavs, episode.sup.wav_lens)
        table = self.build_embedding_table(ssl_hidden, episode.sup)
        return self.forward_query(table, episode.qry)

    def forward_query(self, table: torch.Tensor, qry: Batch,
                      model_state: Optional[Dict[str, torch.Tensor]] = None) -> FastSpeech2Output:
        """The query batch's texts looked up in `table` (zero at PAD), through
        FastSpeech2 with the speaker embedding averaged over the batch; with
        `model_state` (names of `self.model`'s parameters and buffers to
        tensors), through `functional_call` with those in place of the
        module's own."""
        emb = nn.functional.embedding(qry.texts, table)
        emb = emb.masked_fill((qry.texts == 0)[..., None], 0.0)
        args = (emb, qry.src_lens, qry.mels.shape[1])
        kwargs = dict(speaker_args=qry.speaker_args, mel_lens=qry.mel_lens,
                      p_targets=qry.pitches, e_targets=qry.energies,
                      d_targets=qry.durations, lang_args=qry.lang_ids, average_spk_emb=True)
        if model_state is None:
            return self.model(*args, **kwargs)
        return torch.func.functional_call(self.model, model_state, args, kwargs)

    def query_loss(self, out: FastSpeech2Output, qry: Batch):
        """`fastspeech2_loss` of the query batch's forward."""
        var = self.model_cfg.variance
        return fastspeech2_loss(
            out.mel, out.postnet_mel, out.pitch_prediction,
            out.energy_prediction, out.log_duration_prediction,
            qry.mels, qry.pitches, qry.energies, qry.durations,
            out.src_valid, out.mel_valid, var.pitch_feature, var.energy_feature)

    def loss_and_metrics(self, episode: Episode) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        losses = self.query_loss(self(episode), episode.qry)
        return losses.total, {k: v.detach() for k, v in losses.as_dict().items()}


@torch.no_grad()
def transplant_embedding(baseline, table: torch.Tensor, symbol_id: str) -> None:
    """The embedding transplant of the tune flow: copy a generated table
    into a BaselineSystem's `table-<symbol_id>`, in place (the JAX package
    returns a new param tree)."""
    tables = baseline.embedding_model.tables
    key = f"table-{symbol_id}"
    if key not in tables:
        raise KeyError(f"no table for symbol_id {symbol_id}")
    if tables[key].shape != table.shape:
        raise ValueError(f"table shape {tuple(table.shape)} != {tuple(tables[key].shape)}")
    tables[key].copy_(table)
