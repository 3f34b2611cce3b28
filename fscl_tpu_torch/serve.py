"""Text -> mel serving (port of `fscl_tpu/cli/synth_cmd.py:_run_batch`).

Text lines go through `text_to_sequence`, are grouped into batches of up to
8 and padded to the smallest L bucket (16 ... 256), and each batch runs the
two-pass `BaselineSystem.synthesize_bucketed`. Weights come in as a port
`state_dict` (see `convert.py`); checkpoints and the vocoder come with later
slices.

    from fscl_tpu_torch.serve import serve
    mels = serve(["Hello world."], state_dict)   # [(postnet_mel (n, 80), n)]
"""
from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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
