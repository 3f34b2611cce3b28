"""Streaming serving: chunked vocoding with receptive-field halos (port of
`fscl_tpu/audio_out/streaming.py`).

HiFiGAN has a finite receptive field: a wav sample depends on at most about
15 mel frames either side. So the vocoder can run on fixed-size mel windows
clamped inside the utterance and emit exactly chunk * hop samples per
window: every tap a chunk sample needs is inside its window, and edge
windows share the true array edge, so each layer's SAME zero padding
matches the full computation. The chunks, concatenated, equal the vocode
of the whole mel right-padded to a chunk multiple.
"""
from __future__ import annotations

import math
import warnings
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fscl_tpu_torch.audio_out.vocoder import vocoder_apply
from fscl_tpu_torch.core.device import resolve_device

# mel-frame halo for generators whose receptive field cannot be derived from
# their config (see generator_halo); HiFiGAN V1's analytic bound is 15.
DEFAULT_HALO = 16


def _has_halo_fields(gen) -> bool:
    return bool(getattr(gen, "upsample_rates", None)
                and getattr(gen, "upsample_kernel_sizes", None)
                and getattr(gen, "resblock_kernel_sizes", None)
                and getattr(gen, "resblock_dilations", None))


def generator_hop(gen) -> Optional[int]:
    """Samples emitted per mel frame (prod(upsample_rates)); None when the
    module does not declare rates."""
    rates = getattr(gen, "upsample_rates", None)
    if rates:
        return int(np.prod(rates))
    return None


def generator_halo(gen) -> int:
    """Mel-frame halo covering the generator's receptive field (+1 frame over
    the analytic bound): conv_pre (k-1)/2, per stage the transposed conv's
    reach (k+r-2)/(2r) at the incoming rate plus the MRF reach at the
    outgoing rate, conv_post (k-1)/2 at the sample rate. DEFAULT_HALO for
    modules without the HiFiGAN fields (MelGAN)."""
    if not _has_halo_fields(gen):
        return DEFAULT_HALO
    rf = 3.0                                      # conv_pre, k=7
    cum = 1.0
    for r, k in zip(gen.upsample_rates, gen.upsample_kernel_sizes):
        rf += ((k + r - 2) / (2 * r)) / cum
        cum *= r
        mrf = max(sum((rk - 1) // 2 * (d + 1) for d in rd)
                  for rk, rd in zip(gen.resblock_kernel_sizes, gen.resblock_dilations))
        rf += mrf / cum
    rf += 3.0 / cum                               # conv_post, k=7
    return int(math.ceil(rf)) + 1


def chunked_vocode(
    gen: nn.Module,
    mel,                                    # (B, T_mel, n_mels)
    chunk: int = 64,
    halo: Optional[int] = None,
    hop: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (start_sample, wav_chunk (B, chunk * hop)) left to right, with
    the generator moved to `device` (default cuda).

    halo and hop default to generator_halo / generator_hop. Windows are
    clamped inside the (right-padded) mel, so edge chunks see the same
    per-layer zero padding as the full computation; interior chunks sit at
    least `halo` frames from any window edge. Slice the concatenation to
    T_mel * hop (or mel_len * hop per line) downstream."""
    if halo is None:
        halo = generator_halo(gen)
        if not _has_halo_fields(gen):
            warnings.warn(
                f"chunked_vocode: {type(gen).__name__} does not declare HiFiGAN config "
                f"fields; falling back to halo={DEFAULT_HALO} mel frames, which is NOT "
                "guaranteed to cover this generator's receptive field. Pass an explicit "
                "halo and pin chunked==full equality for this module.", stacklevel=2)
    if hop is None:
        hop = generator_hop(gen)
    vocode = vocoder_apply(gen.to(resolve_device(device)).eval())
    p = next(gen.parameters())
    mel = torch.as_tensor(mel).to(p.device, p.dtype)
    B, T, _ = mel.shape
    n_chunks = -(-T // chunk)
    Tp = n_chunks * chunk
    if Tp > T:
        mel = F.pad(mel, (0, 0, 0, Tp - T))
    window = min(chunk + 2 * halo, Tp)
    pending = []
    for c in range(n_chunks):
        # launch every window before reading any back
        start_w = min(max(c * chunk - halo, 0), Tp - window)
        off = c * chunk - start_w
        wav = vocode(mel[:, start_w:start_w + window])       # (B, window * hop)
        if hop is None:
            hop = wav.shape[1] // window    # derive from the first window
        if wav.shape[1] != window * hop:
            raise ValueError(
                f"vocoder emits {wav.shape[1]} samples for a {window}-frame "
                f"window; expected window*hop = {window * hop}")
        pending.append((c * chunk * hop, wav[:, off * hop:(off + chunk) * hop]))
    for start, wav in pending:
        yield start, wav.cpu().numpy()


def make_streaming_text2wav(
    system,
    generator: nn.Module,
    max_mel_len: int,
    chunk: int = 64,
    halo: Optional[int] = None,
    symbol_id: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    **controls,
):
    """Returns stream(texts, src_lens, speaker_args, lang_ids) -> iterator of
    (start_sample, wav_chunk, mel_len). The system (already on `device`,
    default cuda) synthesizes once at the static bucket; audio then streams
    chunk by chunk through fixed-size windows of the generator."""
    device = resolve_device(device)
    if system.device != device:
        raise ValueError(f"the system lives on {system.device}, not on {device}")

    def stream(texts, src_lens, speaker_args, lang_ids):
        out = system.synthesize(texts, src_lens, max_mel_len, speaker_args, lang_ids,
                                symbol_id=symbol_id, **controls)
        mel_len = out.mel_len.cpu().numpy()      # one device->host read
        for start, wav in chunked_vocode(generator, out.postnet_mel, chunk=chunk,
                                         halo=halo, device=device):
            yield start, wav, mel_len

    return stream
