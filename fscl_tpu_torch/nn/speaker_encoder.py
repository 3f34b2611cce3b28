"""Speaker and language encoders (port of `fscl_tpu/nn/speaker_encoder.py`,
the `table` and `shared` paths and LanguageEncoder, `:54-74` and `:114-122`).

The GE2E d-vector paths ("encoder", "dvec", "scratch_encoder") come with a
later slice. The table is named `model`, as the reference's
`speaker_emb.model.weight` that `benchmarks/convert_reference.py` reads.
"""
from __future__ import annotations

import torch
from torch import nn


class SpeakerEncoder(nn.Module):
    def __init__(self, emb_type: str = "table", n_speakers: int = 1, d_model: int = 256):
        super().__init__()
        if emb_type not in ("table", "shared"):
            raise NotImplementedError(
                f"speaker emb_type {emb_type!r}: only 'table' and 'shared' are ported")
        self.emb_type = emb_type
        self.model = nn.Embedding(n_speakers if emb_type == "table" else 1, d_model)

    def forward(self, speaker_args: torch.Tensor) -> torch.Tensor:
        """speaker_args: (B,) int speaker ids -> (B, d_model)."""
        if self.emb_type == "shared":
            speaker_args = torch.zeros_like(speaker_args)
        return self.model(speaker_args)


class LanguageEncoder(nn.Module):
    """Language-id table; fixed at 100 languages like the reference
    (fastspeech2m.py:44-45)."""

    def __init__(self, n_languages: int = 100, d_model: int = 256):
        super().__init__()
        self.model = nn.Embedding(n_languages, d_model)

    def forward(self, lang_args: torch.Tensor) -> torch.Tensor:
        return self.model(lang_args)
