"""Speaker and language encoders (port of `fscl_tpu/nn/speaker_encoder.py`,
`:21-74` and `:114-122`).

- "table": per-speaker embedding table; "shared": one embedding for all.
  The table is named `model`, as the reference's `speaker_emb.model.weight`
  that `benchmarks/convert_reference.py` reads.
- "encoder", "dvec", "scratch_encoder": the GE2E d-vector encoder
  (`GE2EEncoder`, resemblyzer's VoiceEncoder) over speaker-reference mel
  slices, under the name `ge2e`. The three differ only in which systems
  train it (`BaselineSystem.trainable_mask` freezes it under "dvec").
- LanguageEncoder: language-id table, fixed at 100 languages.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch import nn

DVEC_TYPES = ("encoder", "dvec", "scratch_encoder")


def _unit(e: torch.Tensor) -> torch.Tensor:
    """e / (||e|| + 1e-5) over the last dim, as the JAX package (and
    resemblyzer) normalise; not `F.normalize`'s max(||e||, eps)."""
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-5)


def lstm_unrolled(lstm: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """`lstm(x)[0]` for a batch-first LSTM without dropout from a zero state,
    with the gate arithmetic written out step by step on the module's
    current weights (those `functional_call` puts in): each layer's input
    products for all steps at once, then per step the hidden product and
    the gates in torch's (i, f, g, o) order. x (N, T, C) -> (N, T, H)."""
    H = lstm.hidden_size
    out = x
    for layer in range(lstm.num_layers):
        w_ih, w_hh, b_ih, b_hh = (getattr(lstm, f"{name}_l{layer}") for name in
                                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
        xw = nn.functional.linear(out, w_ih, b_ih + b_hh)
        h = c = x.new_zeros(x.shape[0], H)
        hs = []
        for t in range(x.shape[1]):
            gates = xw[:, t] + h @ w_hh.T
            sig = torch.sigmoid(gates)
            c = torch.addcmul(sig[:, H:2 * H] * c, sig[:, :H], torch.tanh(gates[:, 2 * H:3 * H]))
            h = sig[:, 3 * H:] * torch.tanh(c)
            hs.append(h)
        out = torch.stack(hs, dim=1)
    return out


class GE2EEncoder(nn.Module):
    """3-layer LSTM(40 -> 256) -> Linear -> ReLU -> unit norm per slice; the
    slices' masked mean, normalised again, is the d-vector. Parameter names
    are resemblyzer's (`lstm.weight_ih_l{i}`, `lstm.bias_hh_l{i}`,
    `linear.*`), which `fscl_tpu/nn/speaker_encoder.py:
    convert_resemblyzer_checkpoint` reads. Where the JAX package vmaps the
    encoder over the batch, one batched LSTM runs over all B * N slices.

    flax's cell has one bias per gate, which the converter makes torch's
    bias_ih + bias_hh. `bias_ih` does not require grad, so only `bias_hh`
    trains: a step then moves the sum as far as the JAX step moves its bias,
    and the global norm of the clip counts that gradient once, not twice.

    Under a `torch.func` transform (the tune flow's task-parallel
    adaptation vmaps `grad` over the trunk) the LSTM runs as `lstm_unrolled`:
    on the card `nn.LSTM` reads its weights' storage, which the transforms'
    wrapped tensors do not have. So it does inside `unrolled_lstms`, which
    the meta-learning systems enter where a gradient keeps its graph for a
    second derivative: cuDNN's RNN has no double backward."""

    def __init__(self, mel_n_channels: int = 40, hidden_size: int = 256,
                 num_layers: int = 3, out_dim: int = 256):
        super().__init__()
        self.lstm = nn.LSTM(mel_n_channels, hidden_size, num_layers, batch_first=True)
        for i in range(num_layers):
            getattr(self.lstm, f"bias_ih_l{i}").requires_grad_(False)
        self.linear = nn.Linear(hidden_size, out_dim)
        self.unrolled = False

    def forward(self, mel_slices: torch.Tensor, mask=None) -> torch.Tensor:
        """mel_slices (B, N, T, 40); mask (B, N), 1 for real slices (padded
        slices run through the LSTM and are left out of the mean), or None.
        Returns (B, out_dim)."""
        B, N = mel_slices.shape[:2]
        x = mel_slices.reshape(B * N, *mel_slices.shape[2:])
        if self.unrolled or torch._C._functorch.is_functorch_wrapped_tensor(
                self.lstm.weight_hh_l0):
            out = lstm_unrolled(self.lstm, x)
        else:
            out, _ = self.lstm(x)
        e = _unit(torch.relu(self.linear(out[:, -1]))).reshape(B, N, -1)
        if mask is None:
            d = e.mean(dim=1)
        else:
            w = mask.to(e.dtype)[..., None]
            d = (e * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
        return _unit(d)


@contextlib.contextmanager
def unrolled_lstms(module: nn.Module) -> Iterator[None]:
    """Within, every `GE2EEncoder` under `module` runs `lstm_unrolled`."""
    encoders = [m for m in module.modules() if isinstance(m, GE2EEncoder)]
    for m in encoders:
        m.unrolled = True
    try:
        yield
    finally:
        for m in encoders:
            m.unrolled = False


class SpeakerEncoder(nn.Module):
    def __init__(self, emb_type: str = "table", n_speakers: int = 1, d_model: int = 256):
        super().__init__()
        self.emb_type = emb_type
        if emb_type in DVEC_TYPES:
            self.ge2e = GE2EEncoder(out_dim=d_model)
        elif emb_type in ("table", "shared"):
            self.model = nn.Embedding(n_speakers if emb_type == "table" else 1, d_model)
        else:
            raise ValueError(f"Unknown speaker emb_type: {emb_type}")

    def forward(self, speaker_args) -> torch.Tensor:
        """speaker_args: (B,) int speaker ids for table/shared; for the
        d-vector types a `DvecRefs` (slices (B, N, T, 40), mask (B, N)) or
        bare slices (B, N, T, 40). Returns (B, d_model)."""
        if self.emb_type in DVEC_TYPES:
            if isinstance(speaker_args, (tuple, list)) and len(speaker_args) == 2:
                return self.ge2e(*speaker_args)
            return self.ge2e(speaker_args)
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
