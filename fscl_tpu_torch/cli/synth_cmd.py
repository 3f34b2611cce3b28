"""`fscl_tpu_torch synth` — text -> mel -> wav (port of
`fscl_tpu/cli/synth_cmd.py`; BaselineSystem.inference + vocoder path,
language/FastSpeech2.py:112-141 / utils/log.py:15-53).

The checkpoint is restored as fscl_tpu restores it (warm start: parameters
only). `--text` synthesizes one utterance at T = min(max_seq_len,
max(64, 12 L)); `--text_file` serves the lines in batches through
`serve.py:serve_batches` (two-pass bucketed synthesis). With
`--vocoder_ckpt` (HiFi-GAN or MelGAN, by the model config's
`vocoder.model`) the wavs come from the generator on the same device; as
in fscl_tpu, each line's mel is cut to its length and vocoded alone, so
that its last frames see the edge and not the batch's padding (for
HiFi-GAN, 4 MRF stage launches per line). Without a vocoder, Griffin-Lim on
the host, line by line. `--stream` vocodes chunk by chunk
(`audio_out/streaming.py`). A d-vector model (`speaker_emb: dvec` or an
encoder) takes the speaker from `--ref_wav`: the wav at 16 kHz, its
40-mel slices on the device (`dsp/preprocess.py:dvec_mel_slices`), the
first `n_ref_slices` of them with a mask.
"""
from __future__ import annotations

import os
import time

import numpy as np

from fscl_tpu_torch.audio_out.vocoder import Vocoder, griffin_lim
from fscl_tpu_torch.core.checkpoint import CheckpointManager
from fscl_tpu_torch.core.config import ModelConfig, model_config_from_yaml, read_data_config
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.data.batch import DvecRefs
from fscl_tpu_torch.dsp.audio_io import load_wav, save_wav
from fscl_tpu_torch.dsp.preprocess import DVEC_SR, dvec_mel_slices
from fscl_tpu_torch.frontend import LANG_ID2SYMBOLS, text_to_sequence
from fscl_tpu_torch.serve import serve_batches
from fscl_tpu_torch.systems.baseline import BaselineSystem


def run(args):
    """Returns the postnet mel of each utterance, (max(mel_len, 1), n_mels)
    numpy, in input order."""
    device = resolve_device(args.device)
    dc = read_data_config(args.data_config)
    model_cfg = (model_config_from_yaml(args.model_config)
                 if args.model_config else ModelConfig())
    if not (args.text or args.text_file):
        raise ValueError("pass --text or --text_file")
    if model_cfg.speaker.uses_dvec:
        if not args.ref_wav:
            raise ValueError("this model uses a d-vector speaker encoder: pass --ref_wav "
                             "<audio of the target speaker>")
        if args.text_file:
            raise ValueError("--text_file serves table speakers; synthesize a d-vector "
                             "model's lines with --text and --ref_wav")
    id2symbols = ((dc.symbol_id, len(LANG_ID2SYMBOLS[dc.symbol_id])),)
    system = BaselineSystem(model_cfg, id2symbols, device=device)
    CheckpointManager(args.ckpt_dir).restore_into(system)
    voc = None
    if args.vocoder_ckpt:
        # vocoder.model from the model YAML picks the architecture
        # ("HifiGAN" | "MelGAN"; reference utils/tool.py get_vocoder)
        voc = Vocoder.from_checkpoint(args.vocoder_ckpt, kind=model_cfg.vocoder.model,
                                      device=device)
    if args.text_file:
        return _run_batch(args, dc, model_cfg, system, voc)

    sr = model_cfg.audio.sampling_rate
    seq = text_to_sequence(args.text, dc.text_cleaners, dc.symbol_id)
    L = len(seq)
    T = min(model_cfg.max_seq_len, max(64, L * 12))
    speaker_args = (ref_wav_speaker(args.ref_wav, model_cfg.speaker.n_ref_slices, device)
                    if model_cfg.speaker.uses_dvec else np.asarray([args.speaker]))
    out = system.synthesize(np.asarray(seq, np.int64)[None], np.asarray([L]), T,
                            speaker_args, np.asarray([dc.lang_id]), symbol_id=dc.symbol_id)
    n = int(out.mel_len[0])

    if args.stream:
        if voc is None or voc.kind.lower() == "melgan":
            raise ValueError("--stream needs --vocoder_ckpt of a HiFiGAN vocoder (the halo "
                             "derivation reads HiFiGAN config fields)")
        from fscl_tpu_torch.audio_out.streaming import chunked_vocode
        hop = voc.model.hop
        chunk = max(1, args.chunk)
        # vocode only the chunks covering the predicted mel_len, not the
        # whole static T bucket
        n_cover = min(T, -(-max(n, 1) // chunk) * chunk)
        t0 = time.time()
        pieces = []
        for _, chunk_wav in chunked_vocode(voc.model, out.postnet_mel[:, :n_cover],
                                           chunk=chunk, device=device):
            if not pieces:
                print(f"[synth] first {chunk_wav.shape[1] / sr:.2f} s of audio ready in "
                      f"{(time.time() - t0) * 1e3:.1f} ms")
            pieces.append(chunk_wav[0])
        save_wav(args.output, np.concatenate(pieces)[: max(n, 1) * hop], sr)
        print(f"[synth] {n} mel frames ({len(pieces)} chunks) -> {args.output}")
        return [out.postnet_mel[0, :max(n, 1)].float().cpu().numpy()]

    # at least one frame, as _run_batch cuts (fscl_tpu vocodes mel[:n] here
    # and its Griffin-Lim raises on an empty mel)
    mel = out.postnet_mel[0, :max(n, 1)].float().cpu().numpy()
    wav = voc.infer(mel) if voc is not None else griffin_lim(mel)
    save_wav(args.output, wav, sr)
    print(f"[synth] {n} mel frames -> {args.output}")
    return [mel]


def _run_batch(args, dc, model_cfg, system, voc):
    """--text_file serving path: one line per utterance, in batches of
    --batch_size over the two-pass bucketed synthesis. `--output` is a
    directory; utterances land as 0000.wav, 0001.wav, ..."""
    with open(args.text_file, encoding="utf-8") as f:
        lines = [line.strip() for line in f if line.strip()]
    if not lines:
        raise ValueError(f"no non-empty lines in {args.text_file}")
    os.makedirs(args.output, exist_ok=True)
    sr = model_cfg.audio.sampling_rate
    mels = []
    for batch in serve_batches(system, lines, symbol_id=dc.symbol_id,
                               cleaners=dc.text_cleaners, speaker=args.speaker,
                               lang_id=dc.lang_id, batch_size=max(1, args.batch_size)):
        lens = batch.mel_len.cpu().numpy()
        batch_mels = batch.postnet_mel.float().cpu().numpy()
        for i, line in enumerate(batch.lines):
            mel = batch_mels[i, :max(int(lens[i]), 1)]
            # each line vocoded alone, cut to its length, as fscl_tpu does
            wav = voc.infer(mel) if voc is not None else griffin_lim(mel)
            save_wav(os.path.join(args.output, f"{line:04d}.wav"), wav, sr)
            mels.append(mel)
    print(f"[synth] {len(mels)} utterances -> {args.output}/")
    return mels


def ref_wav_speaker(path: str, n_slices: int, device) -> DvecRefs:
    """The d-vector speaker of one reference wav: its first `n_slices` 40-mel
    slices (the STFT on `device`) and their mask, as a batch of 1."""
    slices = dvec_mel_slices(load_wav(path, DVEC_SR), device)
    out = np.zeros((1, n_slices) + slices.shape[1:], np.float32)
    mask = np.zeros((1, n_slices), np.float32)
    k = min(len(slices), n_slices)
    out[0, :k] = slices[:k]
    mask[0, :k] = 1.0
    return DvecRefs(out, mask)
