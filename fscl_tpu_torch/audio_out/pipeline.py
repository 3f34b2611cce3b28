"""Text -> mel -> wav in one call (port of `fscl_tpu/audio_out/pipeline.py`).

The system synthesizes at one static mel bucket and the generator vocodes
the whole bucket, so the wav is (B, max_mel_len * hop): samples past
mel_len * hop are vocoded padding, to be cut per line before writing.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from fscl_tpu_torch.audio_out.vocoder import vocoder_apply
from fscl_tpu_torch.core.device import resolve_device


def make_text2wav(system, generator: nn.Module, max_mel_len: int,
                  symbol_id: Optional[str] = None,
                  device: Optional[Union[str, torch.device]] = None, **controls):
    """Returns (texts, src_lens, speaker_args, lang_ids) ->
    (wav (B, max_mel_len * hop), mel_len (B,)) on `device` (default cuda),
    where the port BaselineSystem `system` must already live; the generator
    is moved there."""
    device = resolve_device(device)
    if system.device != device:
        raise ValueError(f"the system lives on {system.device}, not on {device}")
    vocode = vocoder_apply(generator.to(device).eval())

    def text2wav(texts, src_lens, speaker_args, lang_ids):
        out = system.synthesize(texts, src_lens, max_mel_len, speaker_args, lang_ids,
                                symbol_id=symbol_id, **controls)
        return vocode(out.postnet_mel), out.mel_len

    return text2wav
