"""Text -> mel and text -> wav serving (port of
`fscl_tpu/cli/synth_cmd.py:_run_batch`).

Text lines go through `text_to_sequence`, are grouped into batches of up to
8 and padded to the smallest L bucket (16 ... 256), and each batch runs the
two-pass `BaselineSystem.synthesize_bucketed`. `serve_wav` then vocodes each
batch's whole mel bucket on the same device and cuts every line's wav to
its mel length. Weights come in as port `state_dict`s (see `convert.py`);
an official vocoder checkpoint is folded by
`audio_out.vocoder.load_state_dict`. Checkpoints of the system come with a
later slice.

    from fscl_tpu_torch.serve import serve, serve_wav
    mels = serve(["Hello world."], state_dict)   # [(postnet_mel (n, 80), n)]
    wavs = serve_wav(["Hello world."], state_dict, vocoder_state_dict)
    # [(wav (max(n, 1) * 256,), n)]

The T2U family's chain, text -> units -> mel (-> wav through
`vocode_batches`): `serve_t2u_batches` runs each batch through a TacoT2U
system's batched `infer` and then a u2s BaselineSystem's two-pass synthesis
with the unit ids as its text, as fscl_tpu chains them (`cli/rehearse_cmd.py:
run_t2u`): all `max_decoder_ratio * L` unit positions, each sample's length
its steps before <eos> (at least 1).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fscl_tpu_torch.audio_out.vocoder import Vocoder
from fscl_tpu_torch.core.config import ModelConfig
from fscl_tpu_torch.frontend import text_to_sequence
from fscl_tpu_torch.frontend.define import LANG_NAME2ID, n_symbols
from fscl_tpu_torch.systems.baseline import BaselineSystem

L_BUCKETS = (16, 32, 64, 128, 256)
BATCH_SIZE = 8
CLEANERS = ("english_cleaners",)


class ServedBatch(NamedTuple):
    lines: List[int]              # indices of the batch's lines in the input
    postnet_mel: torch.Tensor     # (B, T_bucket, n_mels)
    mel_len: torch.Tensor         # (B,)


def pack_batch(seqs: Sequence[Sequence[int]],
               l_buckets: Sequence[int] = L_BUCKETS) -> Tuple[np.ndarray, np.ndarray]:
    """Pad id sequences to the smallest L bucket covering the longest one;
    sequences longer than the largest bucket are cut to it."""
    L = next((b for b in l_buckets if max(map(len, seqs)) <= b), l_buckets[-1])
    texts = np.zeros((len(seqs), L), np.int64)
    for i, s in enumerate(seqs):
        texts[i, :min(len(s), L)] = s[:L]
    src_lens = np.asarray([min(len(s), L) for s in seqs], np.int64)
    return texts, src_lens


def serve_batches(
    system: BaselineSystem,
    lines: Sequence[str],
    symbol_id: str = "en",
    cleaners: Sequence[str] = CLEANERS,
    speaker: int = 0,
    lang_id: Optional[int] = None,
    batch_size: int = BATCH_SIZE,
    l_buckets: Sequence[int] = L_BUCKETS,
    **controls,
) -> Iterator[ServedBatch]:
    """Synthesize `lines` batch by batch; yields each batch's mels on the
    system's device."""
    if lang_id is None:
        lang_id = LANG_NAME2ID[symbol_id]
    seqs = [text_to_sequence(line, list(cleaners), symbol_id) for line in lines]
    for start in range(0, len(seqs), batch_size):
        group = seqs[start:start + batch_size]
        texts, src_lens = pack_batch(group, l_buckets)
        B = len(group)
        out = system.synthesize_bucketed(
            texts, src_lens, np.full((B,), speaker, np.int64),
            np.full((B,), lang_id, np.int64), symbol_id=symbol_id, **controls)
        yield ServedBatch(list(range(start, start + B)), out.postnet_mel, out.mel_len)


def serve(
    lines: Sequence[str],
    state_dict: Dict[str, torch.Tensor],
    model_cfg: Optional[ModelConfig] = None,
    symbol_id: str = "en",
    device: Optional[Union[str, torch.device]] = None,
    **kwargs,
) -> List[Tuple[torch.Tensor, int]]:
    """Build a BaselineSystem with `state_dict` on `device` (default cuda)
    and synthesize every line; returns (postnet_mel[:max(n, 1)] on the CPU,
    n) per line, in input order."""
    system = BaselineSystem(model_cfg, ((symbol_id, n_symbols(symbol_id)),),
                            device=device)
    system.load_state_dict(state_dict, strict=True)
    results: List[Tuple[torch.Tensor, int]] = []
    for batch in serve_batches(system, lines, symbol_id=symbol_id, **kwargs):
        mels, lens = batch.postnet_mel.cpu(), batch.mel_len.cpu()
        for i in range(len(batch.lines)):
            n = int(lens[i])
            results.append((mels[i, :max(n, 1)], n))
    return results


class ChainedBatch(NamedTuple):
    lines: List[int]              # indices of the batch's lines in the input
    units: torch.Tensor           # (B, S) unit ids, 0 from <eos> on
    n_units: torch.Tensor         # (B,) units before <eos>
    postnet_mel: torch.Tensor     # (B, T_bucket, n_mels)
    mel_len: torch.Tensor         # (B,)


def serve_t2u_batches(t2u, u2s: BaselineSystem, lines: Sequence[str], unit_symbol_id: str,
                      symbol_id: str = "en", max_steps: Optional[int] = None
                      ) -> Iterator[ChainedBatch]:
    """Text -> units -> mel, batch by batch (`serve_batches`' batches and
    buckets, speaker 0): `t2u` (a TacoT2USystem) decodes each batch's units
    (`max_steps`, default 10 L), `u2s` synthesizes from them (its
    `unit_symbol_id` table); yields each batch on the systems' device."""
    lang_id = LANG_NAME2ID[symbol_id]
    seqs = [text_to_sequence(line, list(CLEANERS), symbol_id) for line in lines]
    for start in range(0, len(seqs), BATCH_SIZE):
        group = seqs[start:start + BATCH_SIZE]
        texts, src_lens = pack_batch(group)
        B = len(group)
        _, units, n_units, _ = t2u.infer(texts, src_lens, symbol_id, max_steps)
        out = u2s.synthesize_bucketed(
            units, n_units.clamp(min=1), np.zeros((B,), np.int64),
            np.full((B,), lang_id, np.int64), symbol_id=unit_symbol_id)
        yield ChainedBatch(list(range(start, start + B)), units, n_units, out.postnet_mel,
                           out.mel_len)


def vocode_batches(vocoder: Vocoder, batches: Iterator[ServedBatch]
                   ) -> Iterator[Tuple[ServedBatch, torch.Tensor]]:
    """Vocode each served batch's whole mel bucket on the vocoder's device;
    yields (batch, wav (B, T_bucket * hop))."""
    for batch in batches:
        yield batch, vocoder.infer_batch(batch.postnet_mel)


def serve_wav_on(system: BaselineSystem, vocoder: Vocoder, lines: Sequence[str],
                 **kwargs) -> List[Tuple[np.ndarray, int]]:
    """`serve_wav` with a system and a vocoder already built: returns
    (wav[:max(n, 1) * hop] as float32 numpy on the CPU, n) per line, in
    input order."""
    hop = vocoder.model.hop
    results: List[Tuple[np.ndarray, int]] = []
    for batch, wav in vocode_batches(vocoder, serve_batches(system, lines, **kwargs)):
        wavs, lens = wav.cpu().numpy(), batch.mel_len.cpu()
        for i in range(len(batch.lines)):
            n = int(lens[i])
            results.append((wavs[i, :max(n, 1) * hop], n))
    return results


def serve_wav(
    lines: Sequence[str],
    state_dict: Dict[str, torch.Tensor],
    vocoder_state_dict: Dict[str, torch.Tensor],
    model_cfg: Optional[ModelConfig] = None,
    symbol_id: str = "en",
    device: Optional[Union[str, torch.device]] = None,
    **kwargs,
) -> List[Tuple[np.ndarray, int]]:
    """Text -> wav: build a BaselineSystem with `state_dict` and the vocoder
    the config names (`model_cfg.vocoder.model`, HiFi-GAN V1 by default)
    with `vocoder_state_dict`, both on `device` (default cuda); returns
    (wav[:max(n, 1) * hop] as float32 numpy on the CPU, n) per line, in
    input order."""
    model_cfg = model_cfg if model_cfg is not None else ModelConfig()
    system = BaselineSystem(model_cfg, ((symbol_id, n_symbols(symbol_id)),), device=device)
    system.load_state_dict(state_dict, strict=True)
    vocoder = Vocoder.from_state_dict(vocoder_state_dict, kind=model_cfg.vocoder.model,
                                      device=system.device)
    return serve_wav_on(system, vocoder, lines, symbol_id=symbol_id, **kwargs)
