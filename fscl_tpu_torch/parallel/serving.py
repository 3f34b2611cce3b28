"""Data-parallel serving: batch-sharded synthesis over the mesh's data axis
(port of `fscl_tpu/parallel/serving.py`).

Each data rank synthesizes its rows of the request batch with its replica of
the system; the mels and lengths are gathered to every rank. Mel only, as in
fscl_tpu: the vocoder is not part of it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from fscl_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, all_gather, shard_batch


def make_parallel_synth(system, mesh: Mesh, max_mel_len: int,
                        symbol_id: Optional[str] = None) -> Callable:
    """synth(texts, src_lens, speaker_args, lang_ids) -> (postnet_mel,
    mel_len) of the whole request batch, on every rank. The batch size must
    divide by the mesh's data axis; pad the request batch to a multiple
    (serving collate already buckets)."""
    group = mesh.group(DATA_AXIS)

    @torch.inference_mode()
    def synth(texts, src_lens, speaker_args, lang_ids):
        texts, src_lens, speaker_args, lang_ids = shard_batch(
            (texts, src_lens, speaker_args, lang_ids), mesh)
        out = system.synthesize(texts, src_lens, max_mel_len, speaker_args, lang_ids,
                                symbol_id=symbol_id)
        return all_gather(out.postnet_mel, group, 0), all_gather(out.mel_len, group, 0)

    return synth
