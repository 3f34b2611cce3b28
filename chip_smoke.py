#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`fscl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile] [--out DIR]

Run from the root of a checkout. Phases, each of which ends the run with a
non-zero exit code when it fails:

1. Device: require CUDA, print the card's name and power limit; the first
   call into the port (`core/device.py:resolve_device`) turns TF32 off for
   cuDNN convolutions and cuBLAS products, and the script checks that it did
   (it sets neither flag itself; phases 12 and 13 check them again after
   their CLI runs, so they measure what a user gets).
2. Build: compile every kernel under `fscl_tpu_torch/csrc/` with nvcc, one
   nvcc per source (per build part), all at once; ptxas's registers and
   spills are printed, and the attention kernel must spill nothing in any
   of its narrow route's 6 instances (f32 with and without row stats, bf16,
   at head dims 64 and 128) or its wide route's 6, nor the attention
   backward kernel in any of its 8 (dQ and dK/dV for f32 / bf16 at head
   dims 64 / 128) or its two score-orientation probes (f32, bf16), nor the
   MRF stage kernel in any of its 9 instances (f32 / bf16 by NP output
   channels a pass, M rows a tile and weight stages).
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main path's shapes, in float32 and bfloat16; then the
   kernel, the plain version and (where one exists) the library call are
   timed. The attention kernel at every L and T bucket the FFT blocks are
   served at, a few edge lengths and HuBERT-large's head layout (at
   L = 1000 and at phase 10's (32, 16, 199, 64) and card-vs-CPU shapes), at
   phase 11's shapes (tasks folded into the batch included), at the head
   dims 40 and 48 it pads, on its wide route at head dims 192, 200, 256,
   320, 512 and 1024 at L = 64, 512 and 1000 and at Lq = 100 against
   Lk = 200, at the 384- and 512-wide base.yaml's shapes of phase 8's wide
   checks, at Lq = Lk = 16385 and 20000 (head dims 64 and 128), at
   B * H = 70000, at 18000 keys whose V has a common part (V = 1 + 0.1
   N(0, 1), head dims 64, 128 and 192), and at phase 14's shapes, at each
   key split of the route (`attention.key_splits`: the narrow route's 1
   and 2, the wide route's 1, 2 and 4),
   held to f32 2e-5 / bf16 1e-2
   and the all-invalid sample to the mean of V (timed in phase 9); phases
   4-14 fail if a main path launches it at a shape not held here. The MRF stage
   kernel at the four HiFiGAN V1 stages, at B = 2 with a ragged T and at
   B = 8 in every mel bucket, then timed at B = 8, T_mel = 1000 beside its
   route's bound (split TF32 or bf16 tensor cores), the f32 FMA bound and
   the floor of its chain's traffic (the passes over a (B, C, T) f32 tensor
   that its launches make, by route: fused pairs or two launches a pair),
   its plain version, its conv_post + tanh kernel alone, the stage's convs
   alone in cuDNN (no single library call computes a stage), its launches,
   and one conv pair at each kernel size (time per tap and per pair); then one
   batch of 65540 samples, past the kernel's 65535-sample grid, which the
   wrapper splits into two launches; then one sample of C * T = 1.5 x 2^31
   elements (C = 64, 12 GiB of f32 a tensor) in one launch, held on its
   first, middle and last 4096 samples against the plain version run on
   each window with 64 samples of halo (the stage's receptive field is 60).
4. Text -> mel: `serve_batches` through `BaselineSystem.synthesize_bucketed`
   at the full width of `config/model/base.yaml`, with random weights made
   from --seed; checks shapes, finiteness and that every batch launched the
   attention kernel once per FFT block.
5. Card vs CPU, text -> mel: one full-width batch run on the card and on
   the CPU (where the plain versions run) with the same weights.
6. Main path, text -> wav: `serve_wav` (warm-up), then the same 32 lines
   through its serving loop `serve_wav_on` with the full-width system and a
   full-width HiFiGAN V1 with random weights from --seed, timed and counted;
   checks the wavs and that the run launched the attention kernel 14 times
   and the MRF stage kernel 4 times per batch; then once more batch by batch
   through `serve_batches` and `vocode_batches` for the per-batch mel and
   vocoder times and launches.
7. Card vs CPU, vocoder: one mel vocoded on the card and on the CPU with the
   same weights; then `chunked_vocode` on the card against the full vocode.
8. Training: first the score-orientation probe (the shared wgmma score
   routine of the forward and the backward kernels, both ways round, in f32
   and bf16: no bit of S^T may differ from S), the backward kernel held to
   `attention_bwd` at BACKWARD_SHAPES in f32 and bf16 (tests/test_torch_cuda.py's,
   ragged 64-row blocks and 32-row tiles, one row, B * H past one wave at
   L = 2000; the one-valid-key sample's dk exactly 0, which holds the
   forward kernel's own score bits), and with 2, 3 and 8 valid keys
   at L = 2000 its dk and dv against float64 (GRAD_ATOL of each gradient's
   max). Then `attend` under autograd (the kernel forward through a
   `torch.autograd.Function`, the backward kernel of csrc/attention_bwd.cu
   at head dims up to 128, two launches a call) against autograd through the
   plain version at B = 16 and 4, L = 128 and 512 (dq, dk, dv within
   GRAD_ATOL; the all-invalid sample's dk exactly 0, its dv within the bar);
   then `Trainer.fit` on `BaselineSystem` at base.yaml width, B = 16,
   L = 128, T = 512, f32, with batches from `collate_batch`: 30 steps counted
   (every loss finite, the last five below the first five, 10 attention and
   20 backward kernel launches per step at shapes held to the plain
   versions), 20 timed, one pass split into forward, backward and optimizer,
   peak memory, a traced step with --profile; 5 steps at B = 4 without
   dropout on the card and on the CPU; the Function's forward + backward
   timed beside SDPA's, and the backward kernel alone (by events and in a
   CUDA graph) beside the plain recompute backward, its bound and the
   library's backward alone (SDPA's efficient-attention backward). Every
   path's backward kernel launches are counted (`attention_shapes`), each
   (B, H, Lq, Lk, Dh, dtype) they launched at is held to `attention_bwd`
   right after the run (f32 GRAD_ATOL, bf16 BF16_GRAD_REL; one sample with
   one valid key, one with none), and the script
   fails if the train, FSCL and tune paths launched none. Then head dims
   above 128 end to end on the kernel's wide route: base.yaml at encoder
   and decoder width 384 with 2 heads (Dh 192), then at 512 with 1 head
   (Dh 512), each 3 train steps at B = 4 card vs CPU (the bars above) and
   the last 8 of phase 4's lines served card vs CPU (phase 5's bars). Then
   one long upstream forward: the base HuBERT over a 360 s wav (about 18000
   frames, past the 16384 keys of an earlier design) in f32 through the
   kernel, against the same forward with the plain version as its
   attention, each hidden state within 1e-5 of its layer's max.
10. FSCL meta-episode: `TransEmbSystem` at config/model/fscl-fastspeech2.yaml
   width (base trunk, `speaker_emb: dvec`, a 128 x 4 codebook) with a
   HuBERT-large of random weights drawn on the card from --seed, at the
   episode shape of benchmarks/bench_fscl_fullsize.py: 32 support wavs of
   4 s (int16 PCM, 64 phonemes each, 100 symbols), an 8-line query batch at
   L = 128, T = 512 with DvecRefs of 10 slices (two samples padded). First
   card vs CPU on a small episode (table and eval loss) and the bf16
   upstream's table against the f32 one's; then, with the upstream stored in
   f32 and again in bf16: 10 episodes through `Trainer.fit` counted (every
   loss finite, the last five below the first five, 34 attention launches
   per episode at shapes held in phase 3), 10 timed (episodes/s), one split
   by synchronizes into upstream forward, table, trunk forward + backward and
   optimizer (the upstream's share), the upstream's checksum unchanged and
   the codebook changed, peak memory, the positional conv alone, and with
   --profile a traced episode.
11. Few-shot tune: the reference table of a 32-shot split (phase 10's wavs
   and lines) through HuBERT-large stored in f32 and in bf16, streamed in
   SupInfo batches of 4 (timed, 24 attention launches per batch, bf16 table
   within 0.1 of f32's, upstream unchanged); `tune_init` into a
   `TransEmbTuneSystem` at fscl-fastspeech2.yaml width; the resident split
   adapted at B = 4, lr 1e-3 with SGD and with the tune Adam (10 steps
   counted, 25 timed: steps/s; losses finite and falling, every GE2E
   tensor moved); with --profile a traced adaptation step; 2 Adam steps
   card vs CPU (losses and parameters 1e-4 relative); `adapt_many_on_chip`
   at benchmarks/bench_adapt_many.py's configuration with N = 1 and 8 tasks
   of 5 steps (aggregate steps/s, one attention launch per layer for all tasks) and
   with d-vector speakers at N = 2, each task held to its run alone
   (1e-4); `synthesize_bucketed` with the adapted parameters on 8 lines.
12. The command line on a preprocessed corpus, through
   `fscl_tpu_torch.cli.main` in this process: two corpora (`en`, `zh`; 2
   speakers, 64 + 16 utterances of 2-7.9 s, 30-100 phonemes each) written
   from --seed with the port's FeatureStore into a temporary directory;
   `train --system baseline` (config/model/base.yaml with a 2-row speaker
   table, config/train/baseline.yaml + an overlay: lr 2e-3, warmup 10, log
   every 5, save every 10) for 20 steps, then `--resume` to 30 (the restored
   step, parameters and Adam moments equal to the file; every loss finite,
   the last five below the first five; the loss table and metrics written;
   steps/s from the store beside phase 8's, the host's batch-making time per
   step, checkpoint save / restore ms and bytes); `synth --text_file` of the
   32 lines in batches of 8 with a HiFi-GAN V1 checkpoint in the official
   layout (14 attention launches per batch; each line vocoded alone, 4 stage
   launches per line, its stage shapes held to the plain version; wavs
   finite and bounded, audio-s/s) and `synth --text` of one line on the card and with
   `--device cpu` (mels within phase 5's 1e-3); `train --system fscl` with
   config/model/fscl-fastspeech2.yaml (HuBERT-large drawn from the seed,
   d-vectors), config/algorithm/language/fscl.yaml (32 + 8) and
   config/train/fscl.yaml + an overlay, 6 episodes (no `upstream.` tensor
   in the checkpoint, the codebook moved, episodes/s beside phase 10's);
   `tune --scan_adapt` (Adam, lr 1e-3, 20 steps) to a 32-utterance split
   (adaptation.csv finite and falling, adaptation steps/s); `synth --text
   --vocoder_ckpt` with `vocoder.model: MelGAN` and a melgan-neurips
   checkpoint written from --seed (no MRF stage launch; the wav against the
   same mel vocoded on the CPU at phase 7's bars; `--stream` refused). Every attention
   launch is held in phase 3; each stage shape phase 3 did not hold is held
   to the plain version right after the run that launched it.
13. A raw corpus on the card: 32 utterances of 1.5-10 s in the LJSpeech
   layout with TextGrids, written from --seed (about 3 minutes of audio,
   tests/torch_corpus.py:write_raw_corpus). `python -m fscl_tpu_torch.cli
   preprocess ... --parse_raw --preprocess --create_dataset --pitch_method
   world_device --n_workers 4` in a fresh subprocess (wall time per stage,
   utterances/s, audio-s/s, every utterance ok); stage 2 in process on 32 of
   its utterances with each of `world` (host C++), `world_device` and
   `yin_device` (host prepare / device / host finish ms, one contour-fix
   launch per DIO batch, audio-s/s; the CLI's run counted too) and each
   bucket's batch of 16 timed alone; the contour-fix kernel bit for bit
   against its plain version at B = 16 in every wav bucket on DIO's
   candidates from the corpus, timed beside its bound of bytes; card vs CPU
   on one batch per bucket, and 8 of the store's utterances preprocessed
   again on the CPU (log-mel 1e-4, energy 1e-5 relative, F0 voicing 99 %
   and relative median 1e-5 / max 1e-3 but on 0.1 % of frames, each within
   one integer lag and explained by the refinement's detail; DIO with TF32
   on recorded beside it as a control; durations, phonemes and splits
   exactly); with --profile a traced DIO
   chunk. Then `train` base.yaml 10 steps at B = 16 from the new store (the
   loss falls) and `synth --text --ref_wav <a corpus wav> --vocoder_ckpt
   <HiFi-GAN V1>` with a base.yaml `speaker_emb: dvec` copy trained 5 steps
   (a finite wav; the mel card vs CPU within 1e-3).
14. The T2U family at full width, on a corpus of 64 + 8 utterances of
   1.5-10 s written from --seed: `make-units --source hubert_large_ll60k
   --n_units 512` through the CLI (HuBERT-large drawn on the card; 24
   attention launches per batch of 8; utterances/s, upstream and k-means
   ms); `make-units --source mel` (the CLI's default: no model) and
   `--source hubert` (the base upstream, 12 launches per batch) at 64
   units, every utterance with units, and the base upstream's 13 hidden
   states card vs CPU on 2 wavs (1e-5 of each layer's max); a seeded
   HuBERT-large written in five released layouts (HF with
   `weight_g` / `weight_v`, `masked_spec_embed` and `encoder.layer_norm`; HF
   with `parametrizations`; fairseq keys in `{"model", "cfg"}`; s3prl's
   `{"model_weight"}`; the `w2v_model.` prefix) and loaded back through
   `load_torch_checkpoint` on the card (each layer's hidden states on 8 wavs
   of 4 s within 1e-5 of its max, 24 attention launches per forward); the
   same `make-units` from make-units' own seeded weights in a fairseq
   container file through `--upstream_ckpt` (every utterance gets units;
   the unit strings equal to the seeded run's counted); `train --system
   tacot2u` through the CLI, 10 steps at B = 16 with
   T2UConfig's full width (encoder 512, RNNs 1024; a falling loss; steps/s;
   decoder ms and launches per step; card vs CPU teacher-forced logits
   within 1e-3; with --profile a traced train step); the trained T2U at
   teacher-forcing ratios 0, 0.5 and 1 (B = 4, 64 steps) card vs CPU on
   the same masks and teacher choices within 1e-3, ratio 1 bit-equal to
   the forward without it, one train step at 0.5 with a finite loss;
   `train --system fscl-t2u-da-tune` through the CLI (T2UDADataModule, 5
   steps at B = 16, every loss finite); a base.yaml u2s over
   the unit symbols trained 10 steps from T2U2SDataModule, saved, and read
   back through its model card; `train --system fscl-t2u` through the CLI
   (config/model/fscl-t2u.yaml: HuBERT-large + Downstream1 at 256; the
   generic path's episodes of 4 + 2), then 10 episodes of 32 + 8 on the
   same system (26 attention launches each, a falling loss, episodes/s);
   fscl-t2u-c (Downstream2) and fscl-t2u-c2 (a codebook attention over the
   table) on the same upstream, 2 episodes of 32 + 8 each; a small episode
   card vs CPU through each of the three (table and loss 1e-4); the upstream
   stored in bf16: the episode's table and the 32-shot tune reference table
   within 0.1 of the f32 upstream's, then 2 episodes; `t2u_tune_init` of a
   32-shot split into an E2ETuneSystem from the trained T2U, 10 steps at
   B = 4 on one batch through the frozen u2s (10 attention launches per
   step, a falling loss, the u2s unchanged), then on one seed 6 steps on
   the stream at config/train/tune-t2s-1500.yaml's optimizer beside 6 at
   lr 0 on the same batches and masks (the difference of their losses
   read; steps/s; the held val loss read after each); one step's loss
   1e-4 and gradient norm 1e-3 card vs CPU (the T2U side on its first 64
   unit steps); DAE2ETuneSystem from the trained
   T2U, 3 steps at B = 4 (every loss finite, 10 attention launches a step),
   one step card vs CPU as the E2E one, and the discriminator's gradient
   through GradientReversal against -scale times it without; chained serving of the 32
   lines of phase 4 in batches of 8, text -> units -> mel -> wav
   (`serve_t2u_batches`, `vocode_batches`: up to 2560 unit positions a
   batch, 14 attention and 4 stage launches per batch, units/s,
   audio-s/s). Every attention shape is held in phase 3.
15. The phoneme-recognition family at full width: a meta corpus as phase
   14's (64 + 8 utterances of 1.5-10 s) and a target corpus of 40, written
   from --seed. `pack --fscl` and `pack` of the meta corpus, each through
   `python -m fscl_tpu_torch.cli` in a subprocess (seconds, bytes), `clean`
   once; host ms per episode of 32 + 8 from the `.fscl.shard`
   (`collate_pr_episode`, C++ and numpy readers) beside the same episodes
   through PRDataset and the Python collate, and per supervised batch of 16
   from the `.shard`, NativeCollate and the Python path; base.yaml trained
   at B = 16 from the shard beside the store (steps/s); `train --system
   pr-ssl-protonet` through the CLI (config/model/fscl-fastspeech2.yaml:
   HuBERT-large drawn on the card, Downstream1 at 256 with 2 heads; the
   generic path's episodes of 4 + 2 from the shard; no upstream tensor in
   the checkpoint); SSLProtoNetSystem and TransHeadPRSystem 3 episodes of
   32 + 8 each through `Trainer.fit` (episodes/s, upstream / downstream /
   optimizer ms of one episode, a falling loss on one episode repeated);
   pr-ssl-linear, -baseline and -cluster 5 steps each at B = 8 through
   PRDataModule (steps/s; losses recorded); `TaskGenerator` over the target
   corpus, `run_protonet_eval` and `run_trans_head_eval`, then `python -m
   fscl_tpu_torch.cli evaluate` (PER, FER; query utterances/s split into
   the card and the host's DPDP); card vs CPU on the same weights (logits
   atol 1e-3, loss 1e-4 and one step's gradient norm 1e-3 relative, one
   task's eval frame logits atol 1e-3). Every attention shape is held in
   phase 3.
16. `rehearse` and the meta-learning variants. `python -m fscl_tpu_torch.cli
   rehearse --preset full`, each flow in a fresh interpreter (its `main`
   wrapped to report the attention shapes it launched) on synthetic
   corpora in one temporary cache: fscl at its defaults (40 episodes of
   4 + 2) with --adapt_steps 100 (its three gates enforced), t2u with 5
   episodes, 5 u2s and 5 tune steps and pr with 5 episodes (gates
   advisory, as fscl_tpu makes them below 100); each exits 0, and its
   phase seconds, per-phase kernel launches, rehearsal.json metrics and
   gates are printed. Then in process at fscl-fastspeech2.yaml width with
   HuBERT-large (f32) drawn on the card from --seed and shared: `meta`
   (32 + 8, one second-order inner step), `imaml` (20 + 5, 20 inner
   steps, K = 5), `fscl_ada1`, `fscl_ada2`, `fscl_ssl_ada1` (phase 10's
   32 + 8 episodes, the SSL one with the query speech), `conti_ae` (B = 8)
   and `semi_fscl` (a hand-built `SemiEpisode`), each 5 steps (meta 3, imaml 2)
   on one episode repeated at lr 5e-4 (all but the last through
   `Trainer.fit`, the last split into upstream, inner loop, CG + HVPs and
   the rest): every loss finite
   and the last below the first, steps/s, peak memory, attention
   launches; with --profile a traced `meta` step (busy share, kernel
   launches). Card vs
   CPU at a reduced size (the trunk at full width, a 3-layer custom
   upstream of dim 256, dropout off): one `meta` episode, one `imaml`
   episode (1 inner step, K = 2), one `fscl_ada1` step: losses 1e-4,
   gradient norms 1e-3 relative; the MAML and iMAML steps leave the
   PostNet's running statistics unchanged on both devices. Every attention
   shape phase 3 did not hold is held to the plain version right after the
   run that launched it.
17. Precision, remat and observability. The attention kernel in bf16 under
   `AttentionFunction` at the training shapes (B = 16, H = 2, L = 128 and
   512, Dh = 128): forward at every key split against the plain version
   (bf16 bars), gradients (the backward kernel, two launches) against autograd
   of the plain version within 1e-2 of each one's largest entry. Then four runs of 20 steps through
   `Trainer.fit` at base.yaml width on phase 8's batch shape (B = 16,
   L = 128, T = 512; every dropout off, Adam at lr 1e-4, eps 1e-3): f32,
   bf16 (`compute_dtype: bfloat16`), f32 + remat and bf16 + remat; each
   prints steps/s, peak GiB and the card's name and power limit; every loss
   finite and falling, 10 attention launches per step (20 under remat: the
   recompute); remat against no remat: the first step's loss within 1e-5
   and its gradient norm within 1e-4 relative; bf16 against f32:
   tests/test_precision_parity.py's bars (first loss 2 %, last 8 %, any
   step 15 %). `synthesize` of phase 4's 32 lines in bf16 against f32 (half
   the lines or more with equal rounded durations; on those, the mels' mean
   |d| over all their frames within 5e-2). `Trainer.fit` with a `SynthSaver` (HiFi-GAN V1:
   8 stage launches) for one validation, its mels against a CPU copy
   (1e-3); phase 10's FSCL system with an `FSCLSaver` for one validation,
   its codebook attention and layer weights against a CPU copy (1e-5);
   whether matplotlib is present decides up front whether the savers write
   PNGs. `train --use_tracker` through the CLI, then `--resume --exp_key`
   (metrics.jsonl at steps 1-5, `resumed` 1). The mel Tacotron2 at
   Tacotron2Config's defaults: a teacher-forced forward at B = 4 card vs CPU
   (1e-4 of each output's max), then `infer`: ms and kernel launches per
   decoder step. Every attention shape is held to the plain version.
18. The parallel layer (`fscl_tpu_torch/parallel/`). 18a: the attention
   kernel at Lq != Lk (the sequence-parallel upstream's local frames against
   all gathered ones) held to its plain version at every key split in f32
   and bf16 at PAR_CROSS's shapes, then timed beside its plain version, SDPA
   and its bound at (32, 16, 100 | 200, 64) and, as a control, at
   Lq = Lk = 199. 18b: one spawn of 2 ranks sharing the card over gloo,
   every check against the same computation in one process on the card:
   the data-parallel and the tensor-parallel train step at phase 8's shape
   (3 steps, dropout off: first loss 1e-5, its gradient norm 1e-4, each
   first gradient against float64 on the host within 1e-4 of its own max
   plus twice the one process's distance, later losses 1e-3 at Adam eps 1e-3,
   BatchNorm statistics 1e-5; the data-parallel steps again at phase 8's
   eps 1e-9 beside the one process on reversed rows, the parameters one
   step left apart named, no bar), the pipelined and the
   sequence-parallel HuBERT-large over 4 wavs of 4 s (hidden states 1e-4 of
   each layer's max), phase 10's episode through `attach_parallel_upstream`
   "pp" and "sp" (table and loss 1e-4), `adapt_many_sharded` at phase 11's
   shape (4 tasks, 1e-4), phase 4's 32 lines through `make_parallel_synth`
   (mels 1e-3, equal lengths); which collectives gloo takes on CUDA tensors;
   every attention shape the ranks launched held afterwards; each parallel
   call's attention launches (the count set to 0 just before it, read just
   after; the one-process runs outside) and wall seconds. 18c: `train
   --system fscl --n_devices 2 --upstream_parallel sp` (4 ranks) on phase
   12's corpus, then `--resume`; then one NCCL all_reduce and broadcast at
   world size 1. Seconds are labelled: 2 ranks sharing one H100 over gloo,
   correctness, not scaling.
9. Attention timing (run last, after phase 18): the kernel at each key
   split, its plain version and SDPA (with SDPA's own error against the
   plain version), each in a CUDA graph, at the encoder's and decoder's
   lengths and HuBERT-large's head layout (L = 1000 and phase 10's
   (32, 16, 199, 64)), on the wide route at (8, 2, 1000, Dh) for Dh 192,
   256 and 512 (bound: the minimal work, not the route's recompute), in
   float32 at every shape phases 14-16 launched and
   in bf16 at phase 17's training shapes,
   beside its route's bound (split TF32 or bf16 tensor cores) and the f32
   FMA bound of the earlier design. The kernel also through its
   public wrapper with CUDA events over back-to-back calls (how the main
   path calls it, and how earlier versions of this script timed it), and
   the wrapper's host time per call.

The line before the last holds the four kernels' numbers (the attention
forward, its backward, the MRF stage, the contour fix); the last line is
`{"ok": true, "device": {...}}`. It imports nothing of JAX or `fscl_tpu`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): float32 on the
# CUDA cores, bf16 and TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_TF32_FLOPS = 495e12     # TF32 on the tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12

F32_ATOL = 2e-5            # the bar tests/test_ops.py holds the TPU kernel to
BF16_TOL = 1e-2            # one bf16 rounding of the output
# Card vs CPU: the same float32 math summed in another order (cuBLAS, cuDNN
# and the kernel's online softmax against the CPU's kernels) through ten
# FFT blocks and the PostNet; 1e-3 is about 1e-4 of the mels' range.
CARD_VS_CPU_ATOL = 1e-3
# MRF stage kernel vs plain, float32: the bars tests/test_hifigan_fused.py
# holds the TPU stage kernel to. bf16 compute: both versions round the same
# operands, but an f32 sum in another order can round an intermediate to the
# neighbouring bf16 value; relative to max |plain| (tests/test_torch_hifigan.py).
STAGE_F32_MEAN, STAGE_F32_MAX = 1e-5, 5e-3
STAGE_BF16_MEAN, STAGE_BF16_MAX = 1e-4, 1e-2
# Whole generator, card vs CPU: the f32 generator bars of
# tests/test_hifigan_fused.py (a leaky-ReLU input near 0 can flip sign under
# another summation order). Chunked vs full vocode on the card: relative
# max |d| (different window lengths sum in different orders).
GEN_MEAN, GEN_MAX = 1e-4, 2e-2
CHUNKED_REL = 1e-2
# Training (phase 8): the repo's full-size training batch
# (benchmarks/bench_train_precision.py:21, config/train/baseline.yaml
# batch_size 16); steps counted with a loss read per step, then steps timed.
TRAIN_B, TRAIN_L, TRAIN_T = 16, 128, 512
TRAIN_STEPS, TIMED_STEPS = 30, 20
# The attention Function's gradients against autograd through the plain
# version: both recompute the weights in f32 from the same q, k, v and take
# the same products (TF32 off), in another order; 1e-5 at unit-scale inputs.
GRAD_ATOL = 1e-5
# Card vs CPU training, B = 4, no dropout: the first step's loss differs only
# by the forward's summation order (the kernel's split TF32 included); later
# steps add the divergence of Adam at eps 1e-9, whose rounding differences
# training amplifies (tests/test_torch_train.py).
CHECK_B, CARD_STEPS = 4, 5
TRAIN_FIRST_RTOL, TRAIN_LATER_RTOL = 1e-5, 1e-3
# Head dims above 128 end to end (after phase 8): base.yaml with both stacks
# 384 wide at 2 heads (Dh 192, ESPnet's FastSpeech2 width; the wrapper pads
# it to the kernel's 256 instance), DH192_STEPS train steps at B = CHECK_B
# card vs CPU at phase 8's loss bars, then phase 5's card-vs-CPU serving of
# the last 8 lines at its mel bar.
DH192_WIDTH, DH192_HEADS, DH192_STEPS = 384, 2, 3
# The same at head dim 512: base.yaml with both stacks 512 wide at 1 head (the
# example of a head dim above 256; the wrapper launches the wide route at
# 512 itself), DH192_STEPS train steps and the 8 served lines, card vs CPU at
# the same bars.
DH512_WIDTH, DH512_HEADS = 512, 1
# Head dims the wide route is held at in phase 3 (192 and 256 the widths
# above; 200 padded to 256; 320 and 512 ending in a half slice of 64 and in
# whole slices; 1024 the widest), at L = 64, 512 and 1000, and at Lq = 100
# against Lk = 200; and the lengths past the earlier 16384-key limit, the
# B * H past the earlier 65535-block one.
WIDE_DIMS = (192, 200, 256, 320, 512, 1024)
LONG_KEYS = (16385, 20000)
MANY_BH = (35000, 2, 16, 64)
# Long keys with V = 1 + 0.1 N(0, 1), a common part as real features have
# (phase 3 after the shapes above): both routes at BIASED_L keys.
BIASED_L, BIASED_DIMS = 18000, (64, 128, 192)
# One long upstream forward: the base HuBERT (`make-units --source hubert`'s
# upstream) drawn on the card from the seed, over one wav of LONG_WAV_S
# seconds (about 18000 frames at 50 a second) in f32 through the kernel,
# against the same forward with its attention the plain version on the card
# (head by head, to bound its score matrices): each hidden state within
# T2U_LAYOUT_REL of its layer's max, phase 14's bar for the base upstream.
LONG_WAV_S = 360
# FSCL meta-episode (phase 10): the episode shape of
# benchmarks/bench_fscl_fullsize.py:45-48 (32-shot support of 4 s wavs, 64
# phonemes each, 100 symbols; an 8-line query batch at L = 128, T = 512) and
# the d-vector references of config/model/fscl-fastspeech2.yaml (10 slices of
# 160 x 40); episodes counted, then timed.
FSCL_S, FSCL_WAV, FSCL_PHONES, FSCL_NSYM = 32, 64000, 64, 100
FSCL_B, FSCL_L, FSCL_T, DVEC_N = 8, 128, 512, 10
FSCL_EPISODES, FSCL_TIMED = 10, 10
# Card vs CPU, one small episode at full width in eval mode (S, samples, B,
# L, T): the upstream's 24 layers in f32 (TF32 off; the kernel's split TF32,
# about 1e-6 relative per call) summed in another order; the table is an
# average of those features through the codebook, the loss a mean of the
# trunk's errors. bf16 upstream vs f32: 8-bit mantissas through 24 layers,
# about sqrt(24 * 5) roundings of 2^-8, then the codebook's softmax.
FSCL_CHECK = (4, 32000, 4, 64, 256)
FSCL_TABLE_REL, FSCL_LOSS_RTOL = 1e-4, 1e-4
FSCL_BF16_TABLE_REL = 0.1
# Few-shot tune (phase 11): the 32-shot split of config/algorithm/language/
# fscl.yaml:24 (its test shots), made as phase 10's support set and query
# lines: 32 int16 wavs of 4 s streamed through the upstream in SupInfo
# batches of 4, as cli/tune_cmd.py:55-57 groups them, and the 32 lines as a
# resident support Batch at L = 128, T = 512 with DvecRefs of 10 slices;
# adapted at batch_size 4 (config/train/tune-1500.yaml:4) and the task lr
# 1e-3 (fscl.yaml:28), steps counted, then timed.
TUNE_K, TUNE_SUP_BATCH, TUNE_B, TUNE_LR, TUNE_SYMBOL = 32, 4, 4, 1e-3, "xx"
TUNE_COUNTED, TUNE_TIMED = 10, 25
# Task-parallel adaptation at benchmarks/bench_adapt_many.py:24-63's
# configuration (base width, table speakers, n_speakers 8, B = 4, L = 64,
# T = 256, lr 1e-4), N = 1 and 8 tasks of 5 steps (20 until the T2U
# configurations came to phase 14, 10 until PR 17's attention checks); and
# GE2E d-vectors at
# fscl-fastspeech2.yaml width under vmap, N = 2 tasks of 3 steps. Each task
# against the same task adapted alone on the card: vmap batches the products
# (and GE2E's written-out gates replace cuDNN's LSTM), so the sums run in
# another order; losses 1e-4 relative (the bar of phase 10's loss).
MANY_B, MANY_L, MANY_T, MANY_LR, MANY_STEPS, MANY_TASKS = 4, 64, 256, 1e-4, 5, (1, 8)
MANY_DVEC_TASKS, MANY_DVEC_STEPS = 2, 3
TUNE_RTOL = 1e-4
# Card vs CPU adaptation: 2 Adam steps (3 until the T2U configurations came
# to phase 14) of the d-vector trunk at B = 4, L = 64,
# T = 256 (lr 1e-4, where an entry whose gradient sits at rounding level
# moves by at most about lr per step in either direction): per-step losses
# and the adapted parameters (relative L2 over all of them) within 1e-4.
TUNE_CHECK_STEPS = 2
# The command line on a corpus (phase 12): two languages the frontend has
# tables for, each 2 speakers with 64 train and 16 val utterances of 2-7.9 s
# (mel T 172-680 at hop 256 / 22.05 kHz: the 256, 512 and 768 buckets; 16 kHz
# wavs in the 4 s and 8 s buckets) and 30-100 phonemes; the baseline trained
# 10 steps then resumed to 15 (20 and 30 before phase 18), 6 FSCL episodes, 50
# adaptation steps on a 32-utterance split. Depth (these step counts) is what to cut first. The
# corpora come from tests/torch_corpus.py:write_corpus, the CPU tests' writer,
# whose docstring names the features the datasets read.
CLI_LANGS = (("en", 0), ("zh", 1))
CLI_SPEAKERS = ("spkA", "spkB")
CLI_TRAIN, CLI_VAL, CLI_TUNE_K = 64, 16, 32
CLI_FRAMES, CLI_PHONES = (172, 680), (30, 100)
CLI_STEPS, CLI_RESUME_STEPS, CLI_FSCL_EPISODES, CLI_ADAPT_STEPS = 10, 15, 6, 20
# Precision, remat and observability (phase 17): phase 8's batch shape at
# base.yaml width with every dropout off (the PostNet's too), so that the
# f32, bf16 and remat runs draw no masks and compute the same function; Adam
# at lr 1e-4, eps 1e-3 after a 10-step warmup, the rate at which
# tests/test_torch_precision.py holds bf16 trajectories (at lr 2e-3 one
# implementation's own bf16 and f32 runs end 48 % apart on the CPU).
PREC_STEPS, PREC_LR, PREC_EPS = 20, 1e-4, 1e-3
PREC_RUNS = (("float32", False), ("bfloat16", False), ("float32", True), ("bfloat16", True))
# Remat recomputes the same ops on the same inputs: the first step's loss and
# the norm of all its gradients, against the run without remat.
REMAT_LOSS_RTOL, REMAT_GNORM_RTOL = 1e-5, 1e-4
# bf16 against f32, step by step: tests/test_precision_parity.py's bars
# (first loss, last loss, any step).
BF16_FIRST, BF16_LAST, BF16_ANY = 0.02, 0.08, 0.15
# The bf16 Function's gradients against autograd of the plain version,
# relative to each gradient's largest |entry| (measured on the CPU 5.4e-3).
BF16_GRAD_REL = 1e-2
# bf16 serving against f32 on the lines whose rounded durations agree: the
# mean |d| over all their valid frames, pooled (on the CPU at full width
# 1.94e-2 for phase 4's 32 lines; a short line's own mean reached 4.4e-2,
# and 6.3e-2 on the card, where a few bin swaps cover much of the line).
SERVE_BF16_MEAN = 5e-2
# The savers card vs CPU: mels as phase 5; the codebook's softmax weights
# (values near 1/128) and the layer weights absolute.
SAVER_MEL_ATOL, SAVER_ATTN_ATOL = 1e-3, 1e-5
# The mel Tacotron2 at Tacotron2Config's defaults: a teacher-forced forward of
# B = 4 lines of L = 48 embedded symbols over 240 mel frames (80 decoder
# steps), card vs CPU relative to each output's largest |value|; then infer.
TACO_B, TACO_L, TACO_T, TACO_INFER_STEPS, TACO_REL = 4, 48, 240, 50, 1e-4
# HiFiGAN V1 stages: (channels, upsampling so far, conv_post fused)
V1_STAGES = ((256, 8, False), (128, 64, False), (64, 128, False), (32, 256, True))
# One MRF stage sample past 2^31 elements (phase 3): V1's third stage width
# over 3 x 2^24 samples (C * T = 1.5 x 2^31, 12 GiB of f32 a tensor), held on
# windows of MRF_WINDOW samples with MRF_HALO of real input on each side
# (the stage's receptive field is 60).
MRF_BIG_C, MRF_BIG_T, MRF_WINDOW, MRF_HALO = 64, 3 * 2 ** 24 + 100, 4096, 64

# Serving input: four batches of eight English lines, from a few symbols to
# about 200, so that several L and T buckets are hit.
SHORT = [
    "Hello there.", "Good morning!", "Thank you kindly.", "See you soon.",
    "It is raining.", "Where is the station?", "Yes, of course.", "Turn left here.",
]
SENTENCES = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "She sells sea shells by the sea shore every summer afternoon.",
    "Printing, in the only sense with which we are at present concerned, differs from most arts.",
    "A journey of a thousand miles begins with a single step.",
    "The committee will meet again on the 3rd of May to review the budget.",
    "Dr. Smith said the results were better than anyone had expected.",
    "Please call Stella and ask her to bring these things with her from the store.",
    "Six spoons of fresh snow peas, five thick slabs of blue cheese, and maybe a snack.",
]
LINES = (
    SHORT
    + SENTENCES
    + [SENTENCES[i] + " " + SENTENCES[(i + 3) % 8] for i in range(8)]
    + [" ".join(SENTENCES[(i + j) % 8] for j in range(3)) for i in range(8)]
)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:6.1f}s] {msg}", flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int, stream, replays: int = 3) -> float:
    """Mean device time of fn() over `iters` calls captured in one CUDA graph
    on `stream` and replayed: the launches run back to back, so a call
    shorter than the host's per-call cost is not timed as that cost. One
    stream serves every capture, so that cuBLAS keeps one workspace."""
    import torch
    fn()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures the card")
    if not (REPO / "fscl_tpu_torch").is_dir() or not (REPO / "config" / "model").is_dir():
        fail(f"run chip_smoke.py from the root of a checkout ({REPO} has no fscl_tpu_torch/)")
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    # the first call into the port: a CUDA device comes with TF32 off for
    # cuDNN and cuBLAS (core/device.py); this script sets neither flag
    from fscl_tpu_torch.core.device import resolve_device
    resolve_device("cuda")
    check_f32_precision("the port's device")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; TF32 off (the port's "
        "setting)")
    return card


def phase_build():
    from fscl_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    built = cuda_lib.build_all()
    seconds = time.perf_counter() - t0
    for name, b in built.items():
        ptxas = [l.strip() for l in b.log.splitlines()
                 if "registers" in l or "spill" in l or "Compiling entry" in l]
        log(f"built {name} in {b.seconds:.1f} s -> {b.path.name}")
        for line in ptxas:
            log(f"  ptxas: {line}")
    log(f"build phase: {seconds:.1f} s")
    spills = kernel_spills(built["attention"].log, "attention_wide_kernel")
    log(f"attention wide route: {len(spills)} instances, spill bytes (stores, loads) "
        + ", ".join(f"{v}" for v in spills.values()))
    if len(spills) != 6 or any(v != (0, 0) for v in spills.values()):
        fail(f"the attention kernel's wide route spills or is missing: {spills}")
    # the narrow route: f32 with and without row stats, bf16, at head dims
    # 64 and 128
    spills = kernel_spills(built["attention"].log, "attention_fwd_kernel")
    log(f"attention narrow route: {len(spills)} instances, spill bytes (stores, loads) "
        + ", ".join(f"{v}" for v in spills.values()))
    if len(spills) != 6 or any(v != (0, 0) for v in spills.values()):
        fail(f"the attention kernel's narrow route spills or is missing: {spills}")
    # the backward kernel: a dQ and a dK/dV kernel for each of f32 / bf16 x
    # head dims 64 / 128, and the score-orientation probe of phase 8 (f32,
    # bf16)
    spills = kernel_spills(built["attention_bwd"].log, "attention_bwd_")
    kernels = [name for name in spills if "_q_kernel" in name or "_kv_kernel" in name]
    probes = [name for name in spills if "score_probe" in name]
    log(f"attention backward: {len(kernels)} instances and {len(probes)} probes, spill bytes "
        "(stores, loads) " + ", ".join(f"{v}" for v in spills.values()))
    if len(kernels) != 8 or len(probes) != 2 or len(spills) != 10 \
            or any(v != (0, 0) for v in spills.values()):
        fail(f"the attention backward kernel spills or is missing instances: {spills}")
    # the MRF stage: f32 / bf16 by NP channels a pass and M rows a tile
    spills = mrf_spills()
    log(f"mrf_stage: {len(spills)} instances, spill bytes (stores, loads) "
        + ", ".join(f"{k} {v}" for k, v in spills.items()))
    if len(spills) != 9 or any(v != (0, 0) for v in spills.values()):
        fail(f"the MRF stage kernel spills or is missing instances: {spills}")
    return built


def mrf_spills() -> dict:
    """ptxas's spill bytes of each MRF stage kernel instance (from the
    library's build log), by the name `f32|bf16 NP=.. M=.. [NW=..]` of its
    template arguments (NW where the instance names its weight stages)."""
    import re
    from fscl_tpu_torch.ops import cuda_lib
    out = {}
    for name, v in kernel_spills(cuda_lib.build("mrf_stage").log, "pair_kernel").items():
        found = re.search(r"pair_kernelILb([01])ELi(\d+)ELi(\d+)ELi(\d+)E", name)
        key = (f"{'bf16' if found.group(1) == '1' else 'f32'} NP={found.group(2)} "
               f"M={found.group(3)}" + (f" NW={found.group(4)}" if found.group(4) != "0" else "")
               ) if found else name
        out[key] = v
    return out


def kernel_spills(log_text: str, kernel: str) -> dict:
    """ptxas's spill stores and loads (bytes) of each instance of a kernel
    whose mangled name contains `kernel`, from `nvcc -Xptxas -v`'s log: a
    "Function properties for <name>" line, then its "spill" line."""
    import re
    spills, name = {}, None
    for line in log_text.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found and name and kernel in name:
            spills[name] = (int(found.group(1)), int(found.group(2)))
            name = None
    return spills


def attention_inputs(gen, B, H, L, Dh, dtype):
    import torch
    q, k, v = (torch.randn(B, H, L, Dh, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    lens = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
    lens[0] = L                 # one full row
    lens[-1] = 0                # one sample with no valid key: the mean of V
    valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    return q, k, v, valid


def attention_bound(B, H, L, Dh, dtype_name, itemsize):
    """Least time for one attention call by the route the kernel takes for
    the type (f32: split TF32, three TF32 products per f32 product; bf16:
    the tensor cores), against the bytes moved once; and the f32 FMA bound
    of the earlier design, for comparison."""
    flops = 4 * B * H * L * L * Dh
    nbytes = 4 * B * H * L * Dh * itemsize + B * L
    if dtype_name == "float32":
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    else:
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_fma = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_fma


def check_attention(attn, q, k, v, valid, key_split, label):
    """The kernel at one key split against the plain version; fails on a
    miss. Returns the max |kernel - plain|."""
    import torch
    want = attn.attention_reference(q, k, v, valid)
    got = (attn.attend(q, k, v, valid) if key_split is None
           else attn._launch(q, k, v, valid, None, key_split))
    torch.cuda.synchronize()
    if got.dtype != q.dtype or got.shape != q.shape:
        fail(f"attention {label}: got {got.dtype} {tuple(got.shape)}")
    if not torch.isfinite(got.float()).all():
        fail(f"attention {label}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    if q.dtype == torch.float32:
        ok = err <= F32_ATOL
    else:
        ok = torch.allclose(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    # the sample with no valid key gets uniform weights: the mean of V
    mean_v = v[-1].float().mean(dim=1, keepdim=True).expand(q.shape[1:])
    mean_err = float((got[-1].float() - mean_v).abs().max())
    ok = ok and mean_err <= (F32_ATOL if q.dtype == torch.float32 else BF16_TOL)
    if not ok:
        fail(f"attention kernel disagrees with its plain version ({label}: max err {err:.3g}, "
             f"all-invalid sample vs mean of V {mean_err:.3g})")
    return err


def phase_attention(seed: int):
    """The kernel against its plain version at every key split: at B = 8 and
    the FFT blocks' heads, at each L bucket (encoder) and T bucket (decoder)
    of the served path and at L = 1 and 77; at L = 2048 with Dh = 64; at
    HuBERT-large's head layout. Returns the max errors and the
    (B, H, L, Dh, dtype) shapes checked."""
    import torch
    from fscl_tpu_torch.core.config import model_config_from_yaml
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.serve import BATCH_SIZE, L_BUCKETS
    from fscl_tpu_torch.systems.baseline import MEL_BUCKETS

    t = model_config_from_yaml(str(REPO / "config" / "model" / "base.yaml")).transformer
    if t.encoder_head != t.decoder_head or t.encoder_hidden != t.decoder_hidden:
        fail("the check below assumes one head layout for the encoder and the decoder")
    H, Dh = t.encoder_head, t.encoder_hidden // t.encoder_head
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = sorted({1, 77, *L_BUCKETS, *MEL_BUCKETS})
    shapes = [(BATCH_SIZE, H, L, Dh) for L in lengths]
    # HuBERT-large (16 heads of 64) at phase 10's support set and at its
    # card-vs-CPU episode, whose query batch runs the trunk at B = 4
    from fscl_tpu_torch.models.hubert import ssl_num_frames
    S, n_samples, B_check, L_check, T_check = FSCL_CHECK
    shapes += [(8, 2, 2048, 64), (8, 16, 1000, 64), (FSCL_S, 16, ssl_num_frames(FSCL_WAV), 64),
               (S, 16, ssl_num_frames(n_samples), 64), (B_check, H, L_check, Dh),
               (B_check, H, T_check, Dh)]
    # phase 11: HuBERT-large over a SupInfo batch of the split, the trunk
    # adapting at B = 4 on the resident split (L = 128, T = 512) and at
    # bench_adapt_many's (L = 64, T = 256; N = 8 tasks folded into B = 32);
    # and head dims the kernel pads (the `mel` upstream's 40, a 96-dim
    # custom upstream's 48)
    shapes += [(TUNE_SUP_BATCH, 16, ssl_num_frames(FSCL_WAV), 64), (TUNE_B, H, FSCL_L, Dh),
               (TUNE_B, H, FSCL_T, Dh), (MANY_B, H, MANY_L, Dh), (MANY_B, H, MANY_T, Dh),
               (max(MANY_TASKS) * MANY_B, H, MANY_L, Dh),
               (max(MANY_TASKS) * MANY_B, H, MANY_T, Dh),
               (MANY_DVEC_TASKS * MANY_B, H, MANY_L, Dh), (MANY_DVEC_TASKS * MANY_B, H, MANY_T, Dh),
               (8, 2, 199, 40), (8, 2, 199, 48)]
    # phase 12: the trunk at every text and mel bucket of the data layer in
    # training (B = 16) and in FSCL queries and tune batches (B = 8);
    # HuBERT-large over the 4 s and 8 s wav buckets (T' = 199 and 399) for a
    # 32-wav support set and the tune table's batches of 4; and the
    # unbucketed (L, T) of `synth --text`'s line at B = 1
    from fscl_tpu_torch.data.batch import MEL_BUCKETS as DATA_MEL_BUCKETS, TEXT_BUCKETS
    from fscl_tpu_torch.data.episodic import WAV_BUCKETS
    _, line_L, line_T = cli_synth_line()
    shapes += [(B, H, L, Dh) for B in (16, 8) for L in (*TEXT_BUCKETS, *DATA_MEL_BUCKETS)]
    shapes += [(S, 16, ssl_num_frames(w), 64) for S in (FSCL_S, TUNE_SUP_BATCH)
               for w in WAV_BUCKETS[:2]]
    shapes += [(1, H, line_L, Dh), (1, H, line_T, Dh)]
    # phase 14: the T2U family (t2u_attention_shapes); phase 15: the PR family
    shapes += t2u_attention_shapes(H, Dh)
    shapes += pr_attention_shapes()
    # the wide route (head dims above 128); the 384-wide (2 heads of 192) and
    # 512-wide (1 head of 512) base.yaml of phase 8's `attention_wide_e2e`,
    # served at B = 8 in every L and T bucket and trained at B = CHECK_B;
    # keys past 16384 on the narrow route; B * H past 65535
    shapes += [(8, 2, L, d) for d in WIDE_DIMS for L in (64, 512, 1000)]
    for width, heads in ((DH192_WIDTH, DH192_HEADS), (DH512_WIDTH, DH512_HEADS)):
        shapes += [(BATCH_SIZE, heads, L, width // heads) for L in lengths]
        shapes += [(CHECK_B, heads, L, width // heads) for L in (TRAIN_L, TRAIN_T)]
    shapes += [(1, 2, L, d) for d in attn.HEAD_DIMS for L in LONG_KEYS]
    shapes += [MANY_BH]
    shapes = list(dict.fromkeys(shapes))
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    checked = set()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, H, L, Dh in shapes:
            q, k, v, valid = attention_inputs(gen, B, H, L, Dh, dtype)
            auto = attn.choose_key_split((B, H, L, Dh), dtype, n_sm, False)
            errs = {s: check_attention(attn, q, k, v, valid, None if s == auto else s,
                                       f"{dname} B={B} H={H} L={L} Dh={Dh} key_split={s}")
                    for s in attn.key_splits(Dh)}
            max_err[dname] = max(max_err[dname], *errs.values())
            checked.add((B, H, L, Dh, dname))
            log(f"attention {dname:8s} B={B} H={H:2d} L={L:4d} Dh={Dh:3d}: max |kernel - plain| "
                + ", ".join(f"{e:.3g}" + ("*" if s == auto else "") for s, e in errs.items())
                + f" at key_split {', '.join(map(str, errs))} (* the wrapper's choice) ok")
            del q, k, v, valid
    # the wide route at Lq != Lk, every head dim above, every key split
    cross = hold_cross_shapes([(8, 2, 100, 200, d) for d in WIDE_DIMS], set(), "wide route")
    for dname in max_err:
        max_err[dname] = max(max_err[dname], cross[dname])
    log(f"attention wide route at Lq=100, Lk=200, Dh {', '.join(map(str, WIDE_DIMS))}: max "
        f"|kernel - plain| f32 {cross['float32']:.3g} (bar {F32_ATOL}), bf16 "
        f"{cross['bfloat16']:.3g} at key_split 1, 2, 4 ok")
    # long keys whose V has a common part (as a trunk's or an upstream's
    # features do): o grows with the keys, and the tensor cores' truncating
    # adds into it would show here where zero-mean V hides them
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for Dh in BIASED_DIMS:
            q, k, v, valid = attention_inputs(gen, 2, 2, BIASED_L, Dh, dtype)
            v = (1.0 + 0.1 * v.float()).to(dtype)
            errs = [check_attention(attn, q, k, v, valid, s, f"{dname} biased V L={BIASED_L} "
                                    f"Dh={Dh} key_split={s}") for s in attn.key_splits(Dh)]
            max_err[dname] = max(max_err[dname], *errs)
            log(f"attention {dname:8s} B=2 H=2 L={BIASED_L} Dh={Dh} V = 1 + 0.1 N(0, 1): max "
                f"|kernel - plain| " + ", ".join(f"{e:.3g}" for e in errs)
                + f" at key_split {', '.join(map(str, attn.key_splits(Dh)))} ok")
            del q, k, v, valid
    torch.cuda.empty_cache()
    return max_err, checked


LAUNCHED = {}     # what -> the (B, H, L, Dh, dtype) `attention_shapes` recorded
BWD_BY_PATH = {}  # what -> the backward kernel's launches inside `attention_shapes`
BWD_CHECKED = set()   # (B, H, Lq, Lk, Dh, dtype) the backward kernel was held at
BWD_MAX_ERR = {"float32": 0.0, "bfloat16": 0.0}   # f32 absolute, bf16 relative to max


@contextlib.contextmanager
def attention_shapes(attn, checked, what: str, launches: bool = True):
    """Record the (B, H, L, Dh, dtype) of every `attention_cuda` call made
    inside (through `attend`, which looks the wrapper up at call time), in
    LAUNCHED too; on leaving, fail if one of them was not held to the plain
    version, or if none was made where `launches` expects some. The backward
    kernel's calls (`attention_bwd_cuda`, from `AttentionGradFunction`) are
    recorded too: their count inside goes into BWD_BY_PATH[what], and each
    (B, H, Lq, Lk, Dh, dtype) not held before is held to `attention_bwd`
    on leaving, right after the run that launched it."""
    launch, launch_bwd = attn.attention_cuda, attn.attention_bwd_cuda
    seen, seen_bwd = set(), set()
    bwd_before = attn.BWD_LAUNCHES

    def recording(q, *args):
        seen.add((*q.shape, str(q.dtype).split(".")[-1]))
        return launch(q, *args)

    def recording_bwd(q, k, *args):
        seen_bwd.add((*q.shape[:3], k.shape[2], q.shape[3], str(q.dtype).split(".")[-1]))
        return launch_bwd(q, k, *args)

    attn.attention_cuda = recording
    attn.attention_bwd_cuda = recording_bwd
    try:
        yield seen
    finally:
        attn.attention_cuda, attn.attention_bwd_cuda = launch, launch_bwd
        LAUNCHED.setdefault(what, set()).update(seen)
        BWD_BY_PATH[what] = BWD_BY_PATH.get(what, 0) + attn.BWD_LAUNCHES - bwd_before
    if not seen and launches:
        fail(f"{what}: no attention launch recorded")
    if seen - checked:
        fail(f"{what}: attention launched at {sorted(seen - checked)}, shapes phases 3 and 8 "
             f"did not hold to the plain version")
    log(f"{what}: attention launched at {sorted(seen)}, all held to the plain version")
    if seen_bwd:
        hold_backward_shapes(seen_bwd, what)


def backward_inputs(gen, B, H, Lq, Lk, Dh, dtype):
    """q, g (B, H, Lq, Dh), k, v (B, H, Lk, Dh) from `gen`; keys all valid,
    one, none, ragged, cycled over the batch. With one valid key every
    query's weight sits on it and dv there sums g over the query rows (tens
    at L = 512), held to the same bar: the kernel's weight there is exactly
    1 and it sums dv in cuBLAS's order."""
    import torch
    q, g = (torch.randn(B, H, Lq, Dh, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(B, H, Lk, Dh, generator=gen, device="cuda").to(dtype) for _ in range(2))
    pattern = torch.tensor([Lk, 1, 0, max(2, Lk - Lk // 3)], device="cuda")
    lens = pattern[torch.arange(B, device="cuda") % 4]
    valid = torch.arange(Lk, device="cuda")[None, :] < lens[:, None]
    return q, k, v, valid, g


def check_backward(attn, q, k, v, valid, g, label) -> float:
    """The backward kernel (from the forward kernel's row stats) against
    `attention_bwd`: f32 within GRAD_ATOL, bf16 within BF16_GRAD_REL of each
    gradient's max; the sample with no valid key (the third) gets dk 0 and
    the plain dv. The sample with one valid key (the second) gets dk exactly
    0: its weight there is exactly 1 only if the kernel recomputes the
    forward kernel's scores bit for bit, so this holds csrc/attention.cu
    itself, whose f32 scores with stats are the backward's by construction. Fails
    on a miss; returns the largest error."""
    import torch
    stats = torch.empty(*q.shape[:3], 2, device=q.device)
    attn.attention_cuda(q, k, v, valid, None, stats)
    got = attn.attention_bwd_cuda(q, k, v, valid, None, g, stats)
    want = attn.attention_bwd(q, k, v, valid, None, g)
    torch.cuda.synchronize()
    f32 = q.dtype == torch.float32
    errs = {}
    for name, a, b in zip("qkv", got, want):
        if a.dtype != q.dtype or a.shape != b.shape or not torch.isfinite(a.float()).all():
            fail(f"attention backward {label}: d{name} {a.dtype} {tuple(a.shape)} or non-finite")
        err = float((a.float() - b.float()).abs().max())
        errs[name] = err if f32 else err / max(float(b.float().abs().max()), 1e-30)
    bar = GRAD_ATOL if f32 else BF16_GRAD_REL
    dead = q.shape[0] >= 3 and not bool(valid[2].any())
    dead_dk = float(got[1][2].float().abs().max()) if dead else 0.0
    dead_dv = float((got[2][2].float() - want[2][2].float()).abs().max()) if dead else 0.0
    dv_bar = bar if f32 else BF16_GRAD_REL * float(want[2].float().abs().max())
    one = q.shape[0] >= 2 and int(valid[1].sum()) == 1
    one_dk = float(got[1][1].float().abs().max()) if one else 0.0
    if max(errs.values()) > bar or dead_dk != 0.0 or dead_dv > dv_bar or one_dk != 0.0:
        fail(f"attention backward kernel disagrees with its plain version ({label}: {errs}, "
             f"the all-invalid sample's dk {dead_dk:.3g}, dv {dead_dv:.3g}, the one-valid-key "
             f"sample's dk {one_dk:.3g})")
    dname = str(q.dtype).split(".")[-1]
    BWD_MAX_ERR[dname] = max(BWD_MAX_ERR[dname], *errs.values())
    return max(errs.values())


def hold_backward_shapes(shapes, what: str) -> int:
    """Hold the backward kernel to `attention_bwd` at each (B, H, Lq, Lk,
    Dh, dtype) of `shapes` not held before; these comparison launches are
    not counted (each wrapper's count is put back). Returns how many."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    new = sorted(set(shapes) - BWD_CHECKED)
    counts = attn.LAUNCHES, attn.BWD_LAUNCHES
    gen = torch.Generator(device="cuda").manual_seed(len(BWD_CHECKED))
    worst = 0.0
    for B, H, Lq, Lk, Dh, dname in new:
        dtype = getattr(torch, dname)
        worst = max(worst, check_backward(attn, *backward_inputs(gen, B, H, Lq, Lk, Dh, dtype),
                                          f"{what}: {dname} B={B} H={H} Lq={Lq} Lk={Lk} Dh={Dh}"))
        BWD_CHECKED.add((B, H, Lq, Lk, Dh, dname))
    attn.LAUNCHES, attn.BWD_LAUNCHES = counts
    if new:
        log(f"{what}: held the attention backward kernel to its plain version at {len(new)} "
            f"new shapes {new} (largest error {worst:.3g}; f32 absolute, bar {GRAD_ATOL}, bf16 "
            f"relative to each gradient's max, bar {BF16_GRAD_REL})")
    return len(new)


def export_trace(prof, path: Path) -> None:
    """The profiler's Chrome trace at `path` + ".gz" (a traced step's trace
    is tens of MB as text)."""
    import gzip
    import shutil
    prof.export_chrome_trace(str(path))
    with open(path, "rb") as src, gzip.open(f"{path}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    path.unlink()


def host_us_per_call(fn, calls: int = 100) -> float:
    """Host time per call of fn(), issued back to back without waiting for
    the card (100 launches stay inside the launch queue)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / calls


def phase_attention_timing(seed: int, extra_f32=(), extra_bf16=()):
    """The attention kernel at each key split, the plain version and SDPA,
    timed at the encoder's and decoder's lengths of the served layout, at
    HuBERT-large's head layout (16 heads of 64) and at phase 11's and 14's
    shapes; and in float32 at the shapes of `extra_f32` (every shape phases
    14-16 launched), in bf16 at those of `extra_bf16` (phase 17's training),
    these at the wrapper's key split alone and without the events and host
    readings below (PR 17's cut).
    Runs after the main path: the captures' cuBLAS workspace stays allocated
    and would count in its peak memory. The kernel is also timed through
    `attention_cuda` with CUDA events over 50 back-to-back calls, as earlier
    versions of this script timed the earlier design: a call shorter than the
    wrapper's host time reads as that time there."""
    import torch
    import torch.nn.functional as F
    from fscl_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.Stream()
    from fscl_tpu_torch.models.hubert import ssl_num_frames
    timed = [(8, 2, L, 128) for L in (64, 128, 256, 512, 1000)] + [
        (8, 16, 1000, 64), (FSCL_S, 16, ssl_num_frames(FSCL_WAV), 64),
        # phase 11: a SupInfo batch through HuBERT-large, 8 tasks folded
        # into one launch, and a head dim the wrapper pads (40 -> 64)
        (TUNE_SUP_BATCH, 16, ssl_num_frames(FSCL_WAV), 64),
        (max(MANY_TASKS) * MANY_B, 2, MANY_T, 128), (8, 2, ssl_num_frames(FSCL_WAV), 40),
        # phase 14: Downstream1 over a 32-shot support set in the 8 s wav
        # bucket, HuBERT-large in make-units' batches of 8 at 10 s, the
        # u2s encoder over the 1280 unit positions of a served L = 128 batch
        (FSCL_T2U_SHOTS, 2, ssl_num_frames(8 * 16000), 128), (8, 16, ssl_num_frames(160000), 64),
        (8, 2, 1280, 128),
        # the wide route at 192, 256 and 512
        (8, 2, 1000, 256), (8, 2, 1000, 192), (8, 2, 1000, 512)]
    timings = []
    extra = {torch.float32: sorted(set(extra_f32) - set(timed)),
             torch.bfloat16: sorted(set(extra_bf16) - set(timed))}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, H, L, Dh in timed + extra[dtype]:
            # the shapes of later phases at the wrapper's key split alone
            full = (B, H, L, Dh) in timed
            q, k, v, valid = attention_inputs(gen, B, H, L, Dh, dtype)
            mask4 = valid[:, None, None, :]
            iters = 100 if L <= 256 else 20
            key_split = attn.choose_key_split((B, H, L, Dh), dtype, n_sm, False)
            split_ms = {s: graph_time_ms(lambda: attn._launch(q, k, v, valid, None, s),
                                         iters, stream)
                        for s in (attn.key_splits(Dh) if full else (key_split,))}
            kernel_ms = split_ms[key_split]
            events_ms = cuda_time_ms(lambda: attn.attention_cuda(q, k, v, valid), 50) if full \
                else None
            host_us = host_us_per_call(lambda: attn.attention_cuda(q, k, v, valid)) if full \
                else None
            plain_ms = graph_time_ms(lambda: attn.attention_reference(q, k, v, valid), 10, stream)
            library_ms = graph_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4), iters, stream)
            # SDPA's own agreement with the plain version, on the samples
            # with a valid key (a boolean mask with none gives NaN there)
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=mask4)
            lib_err = float((lib[:-1].float() - attn.attention_reference(q, k, v, valid)[:-1]
                             .float()).abs().max())
            bound_ms, bound_by, fma_ms = attention_bound(B, H, L, Dh, dname, q.element_size())
            # the narrow route's work items (64- or 128-row query tiles)
            items = (attn.narrow_items(B * H, L, key_split)
                     if attn.padded_head_dim(Dh) <= attn.HEAD_DIMS[-1] else None)
            row = {"B": B, "H": H, "L": L, "Dh": Dh, "dtype": dname,
                   "key_split": key_split, "work_items": items,
                   "ms": kernel_ms, "ms_by_key_split": split_ms,
                   "events_ms": events_ms, "host_us": host_us, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_max_abs_err": lib_err,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_route": "split TF32" if dname == "float32" else "bf16 tensor cores",
                   "fma_bound_ms": fma_ms, "bound_share": bound_ms / kernel_ms}
            timings.append(row)
            log(f"attention {dname:8s} B={B} H={H:2d} L={L:4d} Dh={Dh}: kernel {kernel_ms:.4f} ms "
                f"(key_split {row['key_split']}"
                + (f", {items} work items" if items is not None else "")
                + (("; " + "/".join(map(str, split_ms)) + ": "
                    + "/".join(f"{split_ms[s]:.4f}" for s in split_ms)
                    + f"; events {events_ms:.4f} ms, host {host_us:.1f} us per call") if full
                   else "") + ")"
                f", plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms (max |SDPA - plain| "
                f"{lib_err:.3g}), bound {bound_ms:.4f} ms ({bound_by}, {row['bound_route']}), "
                f"{100 * bound_ms / kernel_ms:.1f}% of bound; f32 FMA bound {fma_ms:.4f} ms")
    return timings


def build_vocoder(seed: int, device: str):
    """Full-width HiFiGAN V1 with torch's init from `seed`."""
    import torch
    from fscl_tpu_torch.models.hifigan import HiFiGANGenerator

    torch.manual_seed(seed)
    return HiFiGANGenerator().to(device).eval()


def stage_bound(B, T, C, post, dtype_name, taps, n_convs):
    """Least time for one MRF stage by the route the kernel takes for the
    type: the convs' 2*B*T*taps*C^2 operations (`_stage_call`'s count) over
    the split-TF32 rate (three TF32 products per f32 product) in f32 or the
    bf16 tensor-core rate, plus conv_post's 2*B*T*7*C over the f32 FMA rate;
    against the input read once, the output and the weights over the HBM
    rate. Also the bound on the f32 FMA units, for comparison."""
    conv_flops = 2 * B * T * taps * C * C
    post_flops = 2 * B * T * 7 * C if post else 0
    nbytes = 4 * (B * T * C + (B * T if post else B * T * C) + taps * C * C + n_convs * C
                  + (7 * C + 1 if post else 0))
    if dtype_name == "float32":
        t_ops = 3 * conv_flops / PEAK_TF32_FLOPS * 1e3
    else:
        t_ops = conv_flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_ops += post_flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_fma = (conv_flops + post_flops) / PEAK_FLOPS["float32"] * 1e3
    route = "split TF32" if dtype_name == "float32" else "bf16 tensor cores"
    return (max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"),
            conv_flops + post_flops, route, t_fma)


def chain_floor(B, T, C, n_res, n_pairs, conv_launches):
    """The stage's chain of launches as passes over a (B, C, T) f32 tensor
    in device memory, from the conv launches the library queued for one
    stage: a fused pair (one launch) reads its input and its residual and
    writes its output (3); a pair in two launches also writes and reads h
    (5); the last pairs of resblocks 2.. read the running mean (n_res - 1).
    Returns the passes and their time at the HBM rate."""
    passes = 3 * n_pairs + 2 * (conv_launches - n_pairs) + (n_res - 1)
    return passes, passes * 4 * B * C * T / PEAK_BYTES_PER_S * 1e3


def cudnn_convs(x, rbs, dtype):
    """A callable running the stage's convs alone (for V1, 18) as F.conv1d on
    x, in `dtype` tensors: cuDNN's time for the same products, a yardstick
    for the kernel's convs (no leaky, residual or mean)."""
    import torch.nn.functional as F
    xs = x.to(dtype)
    convs = [(c.weight.detach().to(dtype), c.bias.detach().to(dtype), dil, c.weight.shape[-1])
             for rb in rbs for d, c1, c2 in zip(rb.dilations, rb.convs1, rb.convs2)
             for c, dil in ((c1, d), (c2, 1))]

    def run():
        for w, b, d, k in convs:
            F.conv1d(xs, w, b, padding=(k - 1) // 2 * d, dilation=d)
    return run, len(convs)


def check_stage(mrf, x, rbs, conv_post, dtype, label):
    """The wrapper against the plain version on x; fails on a miss. Returns
    the max |kernel - plain|."""
    import torch
    dname = str(dtype).split(".")[-1]
    # the plain version first: the kernel's output buffer is then fresh
    # memory and cannot hold the plain result by accident
    want = mrf.mrf_stage_reference(x, rbs, conv_post, dtype)
    got = mrf.mrf_stage(x, rbs, conv_post, dtype)
    torch.cuda.synchronize()
    B, C, T = x.shape
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"stage {label} C={C} T={T} {dname}: shape {tuple(got.shape)} or non-finite output")
    err = (got - want).abs()
    mean, mx = float(err.mean()), float(err.max())
    scale = float(want.abs().max())
    if dtype == torch.float32:
        ok = mean < STAGE_F32_MEAN and mx < STAGE_F32_MAX
    else:
        ok = mean < STAGE_BF16_MEAN * scale and mx < STAGE_BF16_MAX * scale
    log(f"mrf_stage {dname:8s} {label} B={B} C={C:3d} T={T:6d} post={conv_post is not None}: "
        f"mean |kernel - plain| {mean:.3g}, max {mx:.3g} (max |plain| {scale:.3g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"MRF stage kernel disagrees with its plain version ({dname}, B={B}, C={C}, T={T})")
    return mx


def phase_mrf_stage(seed: int):
    """The stage kernel against its plain version at B = 2 with a ragged T,
    and at B = 8 in every mel bucket (the main path's shapes); timed at
    T_mel = 1000. Returns the max errors, the timings and the (B, C, T)
    shapes checked in float32."""
    import torch
    from fscl_tpu_torch.models.hifigan import ResBlock1
    from fscl_tpu_torch.ops import mrf_stage as mrf
    from fscl_tpu_torch.systems.baseline import MEL_BUCKETS

    gen = build_vocoder(seed, "cuda")
    n = len(gen.resblock_kernel_sizes)
    taps = sum(2 * k * len(d) for k, d in zip(gen.resblock_kernel_sizes, gen.resblock_dilations))
    n_convs = sum(2 * len(d) for d in gen.resblock_dilations)
    gen_x = torch.Generator(device="cuda").manual_seed(seed)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    checked = set()
    timings = []
    stage_args = []
    for i, (C, up, post) in enumerate(V1_STAGES):
        stage_args.append((gen.resblocks[i * n:(i + 1) * n], gen.conv_post if post else None))
    # made outside inference mode: the weight packing reads version counters
    pairs = {C: {k: ResBlock1(C, k, (1,)).to("cuda") for k in (3, 7, 11)} for C, _, _ in V1_STAGES}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for (C, up, post), (rbs, conv_post) in zip(V1_STAGES, stage_args):
                # T = 37 * up is a multiple of no tile's output rows (M - (k - 1))
                for B, T_mel in [(2, 37)] + [(8, t) for t in MEL_BUCKETS]:
                    x = torch.randn(B, C, T_mel * up, generator=gen_x, device="cuda")
                    err = check_stage(mrf, x, rbs, conv_post, dtype, f"T_mel={T_mel:4d}")
                    max_err[dname] = max(max_err[dname], err)
                    if dtype == torch.float32:
                        checked.add((B, C, T_mel * up))
                # timed on the last, largest input (B = 8, T_mel = 1000)
                B, T = x.shape[0], x.shape[2]
                kernel_ms = cuda_time_ms(lambda: mrf.mrf_stage_cuda(x, rbs, conv_post, dtype), 3, 1)
                # the kernels one stage queues, as the library counts them
                counts = mrf.CONV_LAUNCHES, mrf.POST_LAUNCHES
                mrf.mrf_stage_cuda(x, rbs, conv_post, dtype)
                conv_launches = mrf.CONV_LAUNCHES - counts[0]
                launches = conv_launches + mrf.POST_LAUNCHES - counts[1]
                plain_ms = cuda_time_ms(lambda: mrf.mrf_stage_reference(x, rbs, conv_post, dtype),
                                        3, 1)
                post_ms = (cuda_time_ms(lambda: mrf._launch_post(x, conv_post, dtype), 10, 2)
                           if post else None)
                convs, n_convs_run = cudnn_convs(x, rbs, dtype)
                cudnn_ms = cuda_time_ms(convs, 3, 1)
                # one resblock of one dilation-1 pair at each kernel size: a
                # straight line through the three splits a conv's time into
                # a part per tap and a fixed part (a pair is one launch where
                # it is fused)
                pair_ms = {k: cuda_time_ms(lambda: mrf.mrf_stage_cuda(x, [rb], None, dtype), 3, 1)
                           for k, rb in pairs[C].items()}
                tap_ms = (pair_ms[11] - pair_ms[3]) / (2 * 8)
                fixed_ms = pair_ms[3] / 2 - 3 * tap_ms
                bound_ms, bound_by, flops, route, fma_ms = stage_bound(B, T, C, post, dname, taps,
                                                                       n_convs)
                passes, chain_ms = chain_floor(B, T, C, n, n_convs // 2, conv_launches)
                row = {"B": B, "T_mel": T // up, "T": T, "C": C, "post": post, "dtype": dname,
                       "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
                       "post_ms": post_ms, "cudnn_convs_ms": cudnn_ms, "cudnn_convs": n_convs_run,
                       "conv_pair_ms": pair_ms, "conv_ms_per_tap": tap_ms,
                       "conv_ms_fixed": fixed_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "bound_route": route,
                       "fma_bound_ms": fma_ms, "bound_share": bound_ms / kernel_ms,
                       "chain_passes": passes, "chain_floor_ms": chain_ms,
                       "route": mrf.route_on_card(C, dtype == torch.bfloat16)._asdict(),
                       "launches_per_stage": launches,
                       "tflops": flops / kernel_ms / 1e9}
                timings.append(row)
                # a launch a pair where the route fuses it, which it must at
                # every V1 width in bf16 and up to C = 128 in f32
                want = n_convs // 2 * (1 if row["route"]["fused"] else 2)
                if (conv_launches != want or launches != conv_launches + int(post)
                        or (not row["route"]["fused"] and (C <= 128 or dname == "bfloat16"))):
                    fail(f"MRF stage {dname} C={C}: {conv_launches} conv launches and "
                         f"{launches - conv_launches} conv_post, route {row['route']}")
                log(f"mrf_stage {dname:8s} B={B} C={C:3d} T={T:6d}: kernel {kernel_ms:.3f} ms "
                    f"({row['tflops']:.1f} TFLOP/s"
                    + (f"; conv_post + tanh alone {post_ms:.3f} ms" if post else "")
                    + f"), plain {plain_ms:.3f} ms, its {n_convs_run} convs alone in cuDNN "
                    f"{cudnn_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, {route}), "
                    f"{100 * row['bound_share']:.1f}% of bound; f32 FMA bound {fma_ms:.3f} ms; "
                    f"chain {passes} passes, floor {chain_ms:.3f} ms; {launches} launches "
                    f"({'fused pairs' if row['route']['fused'] else 'two a pair'}, NP "
                    f"{row['route']['np']}, M {row['route']['m']}); a conv pair at k = 3/7/11 "
                    + "/".join(f"{pair_ms[k]:.3f}" for k in (3, 7, 11))
                    + f" ms: {tap_ms:.4f} ms per tap + {fixed_ms:.4f} ms fixed a conv")
                del convs
                del x
        # past the kernel's 65535-sample grid: the wrapper splits the batch
        # (`batch_splits`), here into two launches of the last V1 stage
        rbs, conv_post = stage_args[-1]
        C = V1_STAGES[-1][0]
        B = mrf.MAX_BATCH + 5
        x = torch.randn(B, C, 8, generator=gen_x, device="cuda")
        before = mrf.LAUNCHES
        err = check_stage(mrf, x, rbs, conv_post, torch.float32, "split launch")
        splits = mrf.batch_splits(*x.shape)
        if mrf.LAUNCHES - before != len(splits) or len(splits) != 2:
            fail(f"MRF stage at B = {B}: {mrf.LAUNCHES - before} launches, splits {splits}")
        log(f"mrf_stage float32 at B = {B} (past the grid's {mrf.MAX_BATCH}): {len(splits)} "
            f"launches {splits}, held to the plain version")
        max_err["float32"] = max(max_err["float32"], err)
        del x
    big = mrf_stage_past_2_31(mrf, gen_x)
    max_err["float32"] = max(max_err["float32"], big["max_abs_err"])
    torch.cuda.empty_cache()
    return max_err, timings, checked, big


def mrf_stage_past_2_31(mrf, gen_x) -> dict:
    """One sample of C * T > 2^31 elements in f32, in one launch: HiFi-GAN
    V1's third stage (C = 64, kernels 3 / 7 / 11 at dilations 1 / 3 / 5) over
    T = MRF_BIG_T samples, 12 GiB a tensor (x, the stage's two work buffers
    and its output: 48 GiB of the card's 80 GB). The plain version cannot run
    whole at that size, so each checked window's plain version runs on the
    window plus MRF_HALO samples of real input on each side that exist (the
    stage's receptive field is 60: sum over resblocks and dilations of
    (k - 1) / 2 (d + 1)), and the kernel's output on the window is held to
    it at the stage's f32 bars. Windows: the first, one in the middle and the
    last (rows of channels 43 and up lie past element 2^31 everywhere)."""
    import torch
    from fscl_tpu_torch.models.hifigan import ResBlock1
    C, T = MRF_BIG_C, MRF_BIG_T
    torch.manual_seed(0)
    # made outside inference mode: the weight packing reads version counters
    rbs = [ResBlock1(C, k, (1, 3, 5)).to("cuda") for k in (3, 7, 11)]
    if mrf.batch_splits(1, C, T) != [(0, 1)]:
        fail(f"MRF stage past 2^31: batch_splits(1, {C}, {T}) = {mrf.batch_splits(1, C, T)}")
    with torch.inference_mode():
        x = torch.randn(1, C, T, generator=gen_x, device="cuda")
        before = mrf.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mrf.mrf_stage(x, rbs, None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = mrf.LAUNCHES - before
        if launches != 1 or out.shape != x.shape:
            fail(f"MRF stage past 2^31: {launches} launches, output {tuple(out.shape)}")
        worst_mean = worst_max = 0.0
        for a in (0, T // 2 - MRF_WINDOW // 2, T - MRF_WINDOW):
            b = a + MRF_WINDOW
            lo, hi = max(0, a - MRF_HALO), min(T, b + MRF_HALO)
            want = mrf.mrf_stage_reference(x[:, :, lo:hi], rbs)[:, :, a - lo:b - lo]
            got = out[:, :, a:b]
            if not torch.isfinite(got).all():
                fail(f"MRF stage past 2^31: non-finite output in [{a}, {b})")
            err = (got - want).abs()
            worst_mean, worst_max = max(worst_mean, float(err.mean())), max(worst_max,
                                                                            float(err.max()))
        if worst_mean >= STAGE_F32_MEAN or worst_max >= STAGE_F32_MAX:
            fail(f"MRF stage past 2^31 disagrees with its plain version on a window: mean "
                 f"{worst_mean:.3g} (bar {STAGE_F32_MEAN}), max {worst_max:.3g} (bar "
                 f"{STAGE_F32_MAX})")
        del x, out
    log(f"mrf_stage float32 B=1 C={C} T={T} ({C * T} elements, {C * T / 2**31:.2f} x 2^31; "
        f"{4 * C * T / 2**30:.1f} GiB a tensor): 1 launch in {seconds:.3f} s, windows of "
        f"{MRF_WINDOW} (first, middle, last) with {MRF_HALO}-sample halos against the plain "
        f"version: mean |d| {worst_mean:.3g}, max {worst_max:.3g} ok")
    return {"C": C, "T": T, "elements": C * T, "launches": launches, "seconds": seconds,
            "mean_abs_err": worst_mean, "max_abs_err": worst_max}


def build_system(seed: int, device: str):
    import torch
    from fscl_tpu_torch.core.config import model_config_from_yaml
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.systems.baseline import BaselineSystem

    cfg = model_config_from_yaml(str(REPO / "config" / "model" / "base.yaml"))
    torch.manual_seed(seed)
    system = BaselineSystem(cfg, (("en", n_symbols("en")),), device=device)
    # An untrained duration head predicts ~0 frames per phoneme; pin its bias
    # to +log(5) as bench.py does, and scale its random weights by 0.1, so
    # that every phoneme gets about 4 frames and the longest lines fill the
    # T = 1000 bucket (torch's default init alone gives ~1.6 frames).
    with torch.no_grad():
        head = system.model.variance_adaptor.duration_predictor.linear_layer
        head.weight.mul_(0.1)
        head.bias.add_(math.log(5.0))
    return cfg, system


def run_lines(system, lines):
    """Serve `lines`; returns per-batch records (synchronised, timed)."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.serve import serve_batches

    records = []
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    launches_prev = attn.LAUNCHES
    for batch in serve_batches(system, lines):
        torch.cuda.synchronize()
        t_now = time.perf_counter()
        records.append({"batch": batch, "seconds": t_now - t_prev,
                        "launches": attn.LAUNCHES - launches_prev})
        launches_prev = attn.LAUNCHES
        t_prev = t_now
    return records


def phase_main_path(seed: int, card: str, attn_checked, profile: bool, out_dir):
    import torch
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.serve import L_BUCKETS, pack_batch
    from fscl_tpu_torch.frontend import text_to_sequence
    from fscl_tpu_torch.systems.baseline import MEL_BUCKETS

    cfg, system = build_system(seed, "cuda")
    t = cfg.transformer
    per_batch = 2 * t.encoder_layer + t.decoder_layer   # pass 1 + pass 2
    n_mels = cfg.audio.n_mels

    run_lines(system, LINES)            # warm-up: cuDNN plans, allocator
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "text -> mel"):
        records = run_lines(system, LINES)
    launches = attn.LAUNCHES

    seqs = [text_to_sequence(l, ["english_cleaners"], "en") for l in LINES]
    frames = bucket_frames = 0
    total_s = 0.0
    for i, r in enumerate(records):
        b = r["batch"]
        mel, mel_len = b.postnet_mel, b.mel_len
        B, T = mel.shape[0], mel.shape[1]
        L = pack_batch([seqs[j] for j in b.lines], L_BUCKETS)[0].shape[1]
        if T not in MEL_BUCKETS or tuple(mel.shape) != (B, T, n_mels):
            fail(f"batch {i}: postnet_mel shape {tuple(mel.shape)}")
        if not torch.isfinite(mel).all():
            fail(f"batch {i}: non-finite mel")
        if int(mel_len.max()) > T or int(mel_len.min()) < 0:
            fail(f"batch {i}: mel_len {mel_len.tolist()} outside [0, {T}]")
        if r["launches"] != per_batch:
            fail(f"batch {i}: {r['launches']} attention launches, expected {per_batch}")
        frames += int(mel_len.sum())
        bucket_frames += B * T
        total_s += r["seconds"]
        log(f"batch {i}: B={B} L={L} T={T} mel_len {mel_len.tolist()} "
            f"{1e3 * r['seconds']:.2f} ms, {r['launches']} attention launches")
    if len(records) < 3:
        fail(f"served {len(records)} batches, expected at least 3")
    if launches != per_batch * len(records):
        fail(f"{launches} attention launches on the main path, expected {per_batch * len(records)}")
    t_hit = sorted({int(r["batch"].postnet_mel.shape[1]) for r in records})
    summary = {
        "batches": len(records), "lines": len(LINES), "mel_buckets_hit": t_hit,
        "mel_frames": frames, "bucket_frames": bucket_frames, "seconds": total_s,
        "mel_frames_per_s": frames / total_s,
        "bucket_frames_per_s": bucket_frames / total_s,
        "batch_ms": [1e3 * r["seconds"] for r in records],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "attention_launches": launches,
    }
    log(f"main path: {len(records)} batches, T buckets {t_hit}, {frames} mel frames in "
        f"{total_s:.4f} s = {summary['mel_frames_per_s']:.1f} mel-frames/s "
        f"({summary['bucket_frames_per_s']:.1f} bucket frames/s), "
        f"peak {summary['peak_mem_gib']:.2f} GiB, on {card}")
    if profile:
        summary["profile"] = profile_batch(system, LINES[-8:], out_dir)
    return system, summary


def profile_batch(system, lines, out_dir):
    """Device time by kernel over one served batch (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_lines(system, lines)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_lines(system, lines)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(({"name": e.key[:90], "calls": e.count,
                    "ms": e.self_device_time_total / 1e3} for e in events),
                  key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    log(f"profile: wall {1e3 * wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / (1e3 * wall):.1f}%)")
    for r in rows[:15]:
        log(f"  {r['ms']:9.3f} ms {r['calls']:5d}x  {r['name']}")
    if out_dir is not None:
        export_trace(prof, out_dir / "chip_smoke_trace.json")
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy, "top": rows[:25]}


def run_wav_lines(system, vocoder, lines):
    """Serve `lines` as text -> wav batch by batch; per-batch records with
    the mel and the vocoder time split by a synchronize, and each kernel's
    launches."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops import mrf_stage as mrf
    from fscl_tpu_torch.serve import serve_batches, vocode_batches

    marks = []

    def timed_mels():
        batches = serve_batches(system, lines)
        while True:
            torch.cuda.synchronize()
            t0, a0 = time.perf_counter(), attn.LAUNCHES
            batch = next(batches, None)
            if batch is None:
                return
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            marks.append((t1 - t0, attn.LAUNCHES - a0, t1))
            yield batch

    records = []
    s0 = mrf.LAUNCHES
    for batch, wav in vocode_batches(vocoder, timed_mels()):
        torch.cuda.synchronize()
        mel_s, attn_n, t1 = marks[-1]
        records.append({"batch": batch, "wav": wav, "mel_s": mel_s,
                        "voc_s": time.perf_counter() - t1,
                        "attention": attn_n, "stage": mrf.LAUNCHES - s0})
        s0 = mrf.LAUNCHES
    return records


def phase_text_to_wav(system, seed: int, card: str, attn_checked, stage_checked,
                      profile: bool, out_dir):
    import torch
    from fscl_tpu_torch.audio_out.vocoder import Vocoder
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops import mrf_stage as mrf
    from fscl_tpu_torch.serve import BATCH_SIZE, serve_wav, serve_wav_on

    cfg = system.model_cfg
    t = cfg.transformer
    attn_per_batch = 2 * t.encoder_layer + t.decoder_layer
    vocoder = Vocoder(build_vocoder(seed, "cuda"), device="cuda")
    hop, sr = vocoder.model.hop, cfg.audio.sampling_rate
    stages = len(vocoder.model.ups)
    n_batches = math.ceil(len(LINES) / BATCH_SIZE)

    def check_wavs(wavs, what):
        if len(wavs) != len(LINES):
            fail(f"{what} returned {len(wavs)} wavs for {len(LINES)} lines")
        for i, (wav, n) in enumerate(wavs):
            if wav.shape != (max(n, 1) * hop,) or not np_finite_bounded(wav):
                fail(f"{what} line {i}: wav {wav.shape} for mel_len {n}, or not finite in [-1, 1]")

    # warm-up through the user's entry point, from state_dicts
    t0 = time.perf_counter()
    wavs = serve_wav(LINES, system.state_dict(), vocoder.model.state_dict(), model_cfg=cfg)
    log(f"text -> wav warm-up via serve_wav: {len(wavs)} wavs in {time.perf_counter() - t0:.2f} s")
    check_wavs(wavs, "serve_wav")

    # The main path: serve_wav's own serving loop on the built system and
    # vocoder, up to the wavs cut per line on the host.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0
    mrf.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "text -> wav"):
        t0 = time.perf_counter()
        wavs = serve_wav_on(system, vocoder, LINES)
        wall = time.perf_counter() - t0
    launches = {"attention_fwd": attn.LAUNCHES, "mrf_stage": mrf.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_wavs(wavs, "serve_wav_on")
    if launches != {"attention_fwd": attn_per_batch * n_batches, "mrf_stage": stages * n_batches}:
        fail(f"main path launches {launches}, expected {attn_per_batch} and {stages} "
             f"per batch over {n_batches} batches")
    samples = sum(n for _, n in wavs) * hop

    # The same lines batch by batch, with a synchronize between the mel and
    # the vocoder: the per-batch split and the per-batch launches.
    records = run_wav_lines(system, vocoder, LINES)
    for i, r in enumerate(records):
        b, wav = r["batch"], r["wav"]
        B, T = b.postnet_mel.shape[0], b.postnet_mel.shape[1]
        if tuple(wav.shape) != (B, T * hop):
            fail(f"wav batch {i}: shape {tuple(wav.shape)}, expected {(B, T * hop)}")
        if not torch.isfinite(wav).all() or float(wav.abs().max()) > 1.0:
            fail(f"wav batch {i}: non-finite or |wav| > 1")
        if r["attention"] != attn_per_batch or r["stage"] != stages:
            fail(f"wav batch {i}: {r['attention']} attention and {r['stage']} stage launches, "
                 f"expected {attn_per_batch} and {stages}")
        unchecked = [(B, C, T * up) for C, up, _ in V1_STAGES
                     if (B, C, T * up) not in stage_checked]
        if unchecked:
            fail(f"wav batch {i}: stage shapes {unchecked} were not held to the plain version")
        log(f"wav batch {i}: B={B} T={T} mel {1e3 * r['mel_s']:.2f} ms + vocoder "
            f"{1e3 * r['voc_s']:.2f} ms = {1e3 * (r['mel_s'] + r['voc_s']):.2f} ms, "
            f"{r['attention']} attention + {r['stage']} stage launches")
    if len(records) != n_batches:
        fail(f"served {len(records)} wav batches, expected {n_batches}")
    summary = {
        "batches": len(records), "lines": len(LINES),
        "mel_buckets_hit": sorted({int(r["batch"].postnet_mel.shape[1]) for r in records}),
        "audio_samples": samples, "audio_seconds": samples / sr, "seconds": wall,
        "audio_s_per_s": samples / sr / wall,
        "batch_ms": [1e3 * (r["mel_s"] + r["voc_s"]) for r in records],
        "mel_ms": [1e3 * r["mel_s"] for r in records],
        "vocoder_ms": [1e3 * r["voc_s"] for r in records],
        "peak_mem_gib": peak,
        "launches": launches,
    }
    log(f"text -> wav via serve_wav_on: {len(records)} batches, {summary['audio_seconds']:.2f} s "
        f"of audio in {wall:.4f} s = {summary['audio_s_per_s']:.1f} audio-s/s, per-batch "
        f"{', '.join(f'{ms:.1f}' for ms in summary['batch_ms'])} ms, "
        f"peak {peak:.2f} GiB, on {card}")
    if profile:
        summary["profile"] = profile_wav_batch(system, vocoder, LINES[-8:], out_dir)
    return vocoder, records, summary


def np_finite_bounded(wav) -> bool:
    import numpy as np
    return bool(np.isfinite(wav).all() and np.abs(wav).max() <= 1.0)


def profile_wav_batch(system, vocoder, lines, out_dir):
    """Device time by kernel over one text -> wav batch (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_wav_lines(system, vocoder, lines)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_wav_lines(system, vocoder, lines)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(({"name": e.key[:90], "calls": e.count,
                    "ms": e.self_device_time_total / 1e3} for e in events),
                  key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    log(f"profile text -> wav: wall {1e3 * wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / (1e3 * wall):.1f}%)")
    for r in rows[:15]:
        log(f"  {r['ms']:9.3f} ms {r['calls']:5d}x  {r['name']}")
    if out_dir is not None:
        export_trace(prof, out_dir / "chip_smoke_wav_trace.json")
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy, "top": rows[:25]}


def phase_vocoder_card_vs_cpu(vocoder, records):
    """The card's generator against the same weights on the CPU, on the
    first 32 frames of two served mels; then chunked vs full on the card."""
    import numpy as np
    import torch
    from fscl_tpu_torch.audio_out.streaming import chunked_vocode
    from fscl_tpu_torch.audio_out.vocoder import Vocoder, build_generator

    mel = records[0]["batch"].postnet_mel[:2, :32].float()
    cpu = build_generator("HifiGAN")
    cpu.load_state_dict(vocoder.model.state_dict())
    cpu = Vocoder(cpu, device="cpu")
    t0 = time.perf_counter()
    card_wav = vocoder.infer_batch(mel).cpu()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_wav = cpu.infer_batch(mel.cpu())
    t2 = time.perf_counter()
    err = (card_wav - cpu_wav).abs()
    mean, mx = float(err.mean()), float(err.max())
    log(f"vocoder card vs CPU: mel {tuple(mel.shape)}, card {1e3 * (t1 - t0):.1f} ms, CPU "
        f"{1e3 * (t2 - t1):.1f} ms; mean |d| {mean:.3g} (bar {GEN_MEAN}), max {mx:.3g} (bar {GEN_MAX})")
    if card_wav.shape != cpu_wav.shape or not (mean < GEN_MEAN and mx < GEN_MAX):
        fail(f"vocoder card vs CPU: shapes {tuple(card_wav.shape)} / {tuple(cpu_wav.shape)}, "
             f"mean {mean:.3g}, max {mx:.3g}")

    long_mel = records[0]["batch"].postnet_mel[:1].float()          # one T = 128 mel
    full = vocoder.infer_batch(long_mel).cpu().numpy()
    parts = list(chunked_vocode(vocoder.model, long_mel, chunk=16, device="cuda"))
    chunked = np.concatenate([w for _, w in parts], axis=1)
    rel = float(np.abs(chunked - full).max() / np.abs(full).max())
    log(f"chunked vs full vocode on the card: T={long_mel.shape[1]}, {len(parts)} chunks of 16, "
        f"relative max |d| {rel:.3g} (bar {CHUNKED_REL})")
    if chunked.shape != full.shape or not rel < CHUNKED_REL:
        fail(f"chunked vocode differs from the full vocode: relative {rel:.3g}")
    return {"card_vs_cpu": {"mel_shape": list(mel.shape), "mean_abs_err": mean, "max_abs_err": mx},
            "chunked_vs_full_rel": rel}


def phase_card_vs_cpu(system, lines, attn_checked, what: str = "card vs CPU"):
    import torch
    from fscl_tpu_torch.frontend import text_to_sequence
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.serve import pack_batch
    from fscl_tpu_torch.systems.baseline import BaselineSystem

    seqs = [text_to_sequence(l, ["english_cleaners"], "en") for l in lines]
    texts, src_lens = pack_batch(seqs)
    B = len(seqs)
    spk = torch.zeros(B, dtype=torch.long)
    lang = torch.zeros(B, dtype=torch.long)
    cpu = BaselineSystem(system.model_cfg, (("en", n_symbols("en")),), device="cpu")
    cpu.load_state_dict(system.state_dict(), strict=True)
    outs = {}
    for name, s in (("cuda", system), ("cpu", cpu)):
        shapes = (attention_shapes(attn, attn_checked, what) if name == "cuda"
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with shapes:
            o = s.synthesize_bucketed(texts, src_lens, spk, lang, symbol_id="en")
        outs[name] = {k: getattr(o, k).cpu() for k in ("duration_rounded", "mel_len", "postnet_mel")}
        log(f"{what}: {name} run {time.perf_counter() - t0:.2f} s, "
            f"T={o.postnet_mel.shape[1]}")
    a, b = outs["cuda"], outs["cpu"]
    for key in ("duration_rounded", "mel_len"):
        if not torch.equal(a[key], b[key]):
            fail(f"{what}: {key} differs")
    if a["postnet_mel"].shape != b["postnet_mel"].shape:
        fail(f"{what}: shapes {tuple(a['postnet_mel'].shape)} vs {tuple(b['postnet_mel'].shape)}")
    err = float((a["postnet_mel"] - b["postnet_mel"]).abs().max())
    scale = float(b["postnet_mel"].abs().max())
    log(f"{what}: durations and mel_len equal; max |postnet_mel| diff {err:.3g} "
        f"(atol {CARD_VS_CPU_ATOL}, mel range {scale:.3g})")
    if not err <= CARD_VS_CPU_ATOL:
        fail(f"{what}: postnet_mel differs by {err:.3g} > {CARD_VS_CPU_ATOL}")
    return {"T": int(a["postnet_mel"].shape[1]), "max_abs_err": err, "mel_abs_max": scale}


def train_batches(seed: int, B: int, n_symbols: int, variance):
    """An endless stream of numpy `Batch`es from `collate_batch` at B lines:
    40-128 phonemes of 1-4 frames each, the first line 128 phonemes of 4
    frames, so every batch lands in the L = 128, T = 512 bucket. Targets are
    learnable: mel frames, pitch and energy from a fixed random table per
    phoneme plus noise, all from `seed`."""
    import numpy as np
    from fscl_tpu_torch.data.batch import collate_batch

    rng = np.random.default_rng(seed)
    table = np.random.default_rng(seed + 1).normal(size=(n_symbols, 82)).astype(np.float32)
    levels = {"pitch": variance.pitch_feature, "energy": variance.energy_feature}
    n_batch = 0
    while True:
        samples = []
        for i in range(B):
            n = TRAIN_L if i == 0 else int(rng.integers(40, TRAIN_L + 1))
            dur = np.full(n, 4) if i == 0 else rng.integers(1, 5, n)
            ph = rng.integers(1, n_symbols, n)
            frames = np.repeat(ph, dur)
            sample = dict(id=f"{n_batch}-{i}", text="", phonemes=ph, duration=dur,
                          mel=table[frames, :80] + 0.1 * rng.normal(size=(len(frames), 80)),
                          speaker=0, lang_id=int(rng.integers(0, 4)))
            for col, key in ((80, "pitch"), (81, "energy")):
                target = table[ph, col] + 0.1 * rng.normal(size=n)
                sample[key] = np.repeat(target, dur) if levels[key] == "frame_level" else target
            samples.append(sample)
        n_batch += 1
        yield collate_batch(samples, pitch_feature=levels["pitch"],
                            energy_feature=levels["energy"])[1]


def train_attention_bound(B, H, L, Dh):
    """Least time for the Function's forward + backward in f32: the forward's
    4 B H L^2 Dh and the backward's five products (10 B H L^2 Dh), all by
    split TF32 (three TF32 products per f32 product, the f32 route of the
    forward kernel), against q, k, v, the upstream gradient and the mask read
    once and the output and three gradients written once; and the same
    products on the f32 FMA units, for comparison."""
    flops = (4 + 10) * B * H * L * L * Dh
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = (8 * B * H * L * Dh * 4 + B * L) / PEAK_BYTES_PER_S * 1e3
    t_fma = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_fma


# (B, H, Lq, Lk, Dh) the backward kernel is held at in phase 8 besides the
# main paths' shapes, in f32 and bf16: tests/test_torch_cuda.py's
# BWD_SHAPES, then Lq and Lk that cut its 64-row blocks and 32-row tiles
# raggedly, one query row against one key (f32 only: there every gradient
# but dv is 0, so the bf16 bar, relative to the plain gradient's max, is 0,
# and dq = ((P * dP) K - D (P K)) / temp is a difference of two rounded
# products; tests/test_torch_cuda.py holds the bf16 case: dk exactly 0, dv
# the plain version's, dq within GRAD_ATOL), and B * H past one wave of
# blocks at L = 2000
BACKWARD_SHAPES = [(16, 2, 128, 128, 128), (16, 2, 512, 512, 128), (8, 2, 128, 128, 128),
                   (8, 2, 512, 512, 128), (4, 2, 128, 128, 128), (4, 2, 512, 512, 128),
                   (32, 2, 64, 64, 128), (32, 2, 256, 256, 128), (4, 2, 100, 200, 64),
                   (4, 2, 77, 77, 40), (4, 16, 199, 199, 64), (8, 2, 1000, 1000, 128),
                   (4, 2, 65, 130, 64), (2, 2, 1, 1, 128), (4, 2, 2000, 2000, 128)]
FEW_KEYS = (2, 3, 8)      # valid keys of each sample at L = 2000, held against float64


def score_bits_probe():
    """The forward kernel's f32 scores with row stats, and launch 1 of the
    backward kernel, take S = Q K^T by csrc/hopper_attention.cuh's `scores`
    with Q as A; launch 2 takes S^T with K as A (the first two split passes
    swapped). `fscl_attention_bwd_score_probe` runs the routine both ways
    round on 64 x 64 scores over head dim 128, from the row planes
    split_rows makes of each 32-row half as TMA stores it, on normal and on
    wide-range (e^N(0, 2)-scaled) inputs in f32 and bf16; S^T transposed
    must be S's bits. That the forward's scores are launch 1's is by
    construction (the same routine on the same planes); `check_backward`'s
    one-valid-key dk, exactly 0 only at a weight of exactly 1, holds the
    kernels end to end."""
    import ctypes
    import torch
    from fscl_tpu_torch.ops import cuda_lib
    fn = cuda_lib.build("attention_bwd").lib.fscl_attention_bwd_score_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for code, dtype in enumerate((torch.float32, torch.bfloat16)):
        for trial in range(4):
            q, k = (torch.randn(64, 128, generator=gen, device="cuda") for _ in range(2))
            if trial >= 2:
                q, k = (x * torch.exp(2 * torch.randn(64, 128, generator=gen, device="cuda"))
                        for x in (q, k))
            q, k = q.to(dtype), k.to(dtype)
            s_wg, st_wg = (torch.full((64, 64), float("nan"), device="cuda") for _ in range(2))
            err = fn(q.data_ptr(), k.data_ptr(), s_wg.data_ptr(), st_wg.data_ptr(), code,
                     torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err != 0:
                fail(f"score-bits probe: launch failed, cudaError {err}")
            exact = q.double() @ k.double().T
            rows.append({
                "dtype": str(dtype).split(".")[-1], "wide_range": trial >= 2,
                "transposed_bits_differ": int((st_wg.T.contiguous().view(torch.int32)
                                               != s_wg.view(torch.int32)).sum()),
                "rel_err_vs_f64": float((s_wg.double() - exact).abs().max()
                                        / exact.abs().max())})
    log("score-orientation probe (64 x 64 scores, head dim 128): the shared `scores` with Q as "
        "A vs with K as A (m64n32k8 split TF32 in f32, m64n32k16 in bf16), bits that differ: "
        + ", ".join(f"{r['dtype']} {r['transposed_bits_differ']}"
                    f"{' wide-range' if r['wide_range'] else ''}" for r in rows)
        + f"; the sums {max(r['rel_err_vs_f64'] for r in rows):.3g} of their max from float64")
    if any(r["transposed_bits_differ"] for r in rows):
        fail("score-bits probe: S^T with K as A differs from S with Q as A")
    return rows


def backward_few_keys(seed: int):
    """With FEW_KEYS valid keys per sample at L = 2000 every query row's
    weight sits on a few keys, whose dv and dk sum tens over the rows: the
    kernel's dk and dv against float64 on the host (the card test's
    reference, tests/attention_grads_f64.py) within GRAD_ATOL of each
    gradient's largest |entry|; the plain version's distance beside them.
    These launches are not counted as a path's."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    sys.path.insert(0, str(REPO / "tests"))
    from attention_grads_f64 import distance_from_float64
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    B, H, L, Dh = 2, 2, 2000, 128
    counts = attn.LAUNCHES, attn.BWD_LAUNCHES
    rows = []
    for n in FEW_KEYS:
        q, k, v, g = (torch.randn(B, H, L, Dh, generator=gen, device="cuda") for _ in range(4))
        valid = torch.zeros(B, L, dtype=torch.bool, device="cuda")
        valid[0, :n] = True
        valid[1, torch.randperm(L, generator=gen, device="cuda")[:n]] = True
        stats = torch.empty(B, H, L, 2, device="cuda")
        attn.attention_cuda(q, k, v, valid, None, stats)
        got = attn.attention_bwd_cuda(q, k, v, valid, None, g, stats)
        plain = attn.attention_bwd(q, k, v, valid, None, g)
        rows.append({"valid_keys": n, **distance_from_float64(q, k, v, valid, g, got, plain)})
    attn.LAUNCHES, attn.BWD_LAUNCHES = counts
    log("attention backward with a few valid keys (B=2 H=2 L=2000 Dh=128 f32), kernel (plain) "
        "distance from float64 over each gradient's max: " + "; ".join(
            f"{r['valid_keys']} keys dk {r['dk']:.3g} ({r['plain_dk']:.3g}) dv {r['dv']:.3g} "
            f"({r['plain_dv']:.3g}), max |dv| {r['max_abs_dv']:.3g}" for r in rows)
        + f" (bar {GRAD_ATOL})")
    if any(r["dk"] > GRAD_ATOL or r["dv"] > GRAD_ATOL for r in rows):
        fail(f"attention backward kernel off float64 with a few valid keys: {rows}")
    return rows


def phase_train_kernel_grads(seed: int, attn_checked):
    """`attend` under autograd on the card (the Function: the kernel forward,
    the backward kernel at head dims up to 128, the recompute backward above)
    against autograd through the plain version, at the training phase's
    shapes: H = 2, Dh = 128, f32, B = 16 (and B = 4 of the card-vs-CPU
    check) at L = 128 and T = 512, and the wide checks' (B = 4, 2 heads of
    192 and 1 head of 512, the kernel's wide route), ragged keys and one
    sample with none (its dk exactly 0, its dv within the bar). The forward
    is first held at every key split as phase 3 holds the served shapes; the
    shapes join the sets the recorders accept."""
    import torch
    from fscl_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(B, 2, L, 128) for B in (TRAIN_B, CHECK_B) for L in (TRAIN_L, TRAIN_T)]
    shapes += [(CHECK_B, heads, L, width // heads) for L in (TRAIN_L, TRAIN_T)
               for width, heads in ((DH192_WIDTH, DH192_HEADS), (DH512_WIDTH, DH512_HEADS))]
    worst = {"fwd": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for B, H, L, Dh in shapes:
        q, k, v, valid = attention_inputs(gen, B, H, L, Dh, torch.float32)
        auto = attn.choose_key_split((B, H, L, Dh), torch.float32, n_sm, False)
        for s in attn.key_splits(Dh):
            check_attention(attn, q, k, v, valid, None if s == auto else s,
                            f"train float32 B={B} L={L} key_split={s}")
        attn_checked.add((B, H, L, Dh, "float32"))
        g = torch.randn(q.shape, generator=gen, device="cuda")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        bwd_before = attn.BWD_LAUNCHES
        out = attn.attend(*leaves, valid)
        if out.grad_fn is None:
            fail("attend on CUDA under autograd returned an output without grad_fn")
        got = torch.autograd.grad(out, leaves, g)
        kernel_bwd = attn.BWD_LAUNCHES - bwd_before
        if kernel_bwd != (2 if Dh <= attn.HEAD_DIMS[-1] else 0):
            fail(f"attention Function B={B} L={L} Dh={Dh}: {kernel_bwd} backward kernel "
                 f"launches (two at head dims up to {attn.HEAD_DIMS[-1]}, none above)")
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = attn.attention_reference(*ref_leaves, valid)
        want = torch.autograd.grad(ref, ref_leaves, g)
        torch.cuda.synchronize()
        errs = {"fwd": float((out - ref).detach().abs().max())}
        errs.update({f"d{n}": float((a - b).abs().max()) for n, a, b in zip("qkv", got, want)})
        if not all(torch.isfinite(t).all() for t in got):
            fail(f"attention gradients B={B} L={L}: non-finite")
        # no gradient reaches a key of the sample that has none valid; its
        # keys' values get the uniform weights' gradient
        dead = float(got[1][-1].abs().max())
        dead_dv = float((got[2][-1] - want[2][-1]).abs().max())
        log(f"attention Function B={B} H={H} L={L} Dh={Dh} f32 "
            f"({'backward kernel' if kernel_bwd else 'recompute backward'}): max |d| fwd "
            f"{errs['fwd']:.3g} (bar {F32_ATOL}), dq {errs['dq']:.3g}, dk {errs['dk']:.3g}, dv "
            f"{errs['dv']:.3g} (bar {GRAD_ATOL}); the all-invalid sample's dk {dead:.3g}, dv "
            f"{dead_dv:.3g}")
        if errs["fwd"] > F32_ATOL or max(errs[n] for n in ("dq", "dk", "dv")) > GRAD_ATOL \
                or dead != 0.0 or dead_dv > GRAD_ATOL:
            fail(f"attention Function disagrees with autograd of the plain version at B={B} "
                 f"L={L}: {errs}, the all-invalid sample's dk {dead:.3g}, dv {dead_dv:.3g}")
        if kernel_bwd:
            BWD_CHECKED.add((B, H, L, L, Dh, "float32"))
            BWD_MAX_ERR["float32"] = max(BWD_MAX_ERR["float32"],
                                         *(errs[n] for n in ("dq", "dk", "dv")))
        worst = {n: max(worst[n], errs[n]) for n in worst}
    return worst


def backward_bound(B, H, Lq, Lk, Dh, dtype_name, itemsize):
    """Least time for one backward call (its two launches): its five products
    (10 B H Lq Lk Dh operations; f32 by split TF32, three TF32 products per
    f32 product, bf16 on the tensor cores) against q, g and the row stats
    read and dq written (3 Lq rows), k and v read and dk, dv written (4 Lk
    rows), and the key mask."""
    flops = 10 * B * H * Lq * Lk * Dh
    t_ops = (3 * flops / PEAK_TF32_FLOPS if dtype_name == "float32"
             else flops / PEAK_FLOPS["bfloat16"]) * 1e3
    nbytes = (3 * B * H * Lq * Dh + 4 * B * H * Lk * Dh) * itemsize + 8 * B * H * Lq + B * Lk
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_backward(q, k, v, valid, g, kernel_grads, iters: int, stream):
    """The library's attention backward alone, the yardstick of the backward
    kernel (never called by the port): torch's
    `_scaled_dot_product_efficient_attention_backward` on the output and
    log-sum-exp of its forward (`compute_log_sumexp`), the key mask as an
    additive bias (0 at valid keys, -1e9 at invalid ones) expanded to (B, H,
    L, L). Its times by events and in a CUDA graph, and its gradients' largest
    distance from the kernel's; or its error's text if torch refuses it."""
    import torch
    B, H, L, _ = q.shape
    bias = torch.zeros(B, 1, 1, L, device=q.device).masked_fill(
        ~valid[:, None, None, :], -1e9).expand(B, H, L, L)
    try:
        out, lse, philox_seed, philox_offset = \
            torch.ops.aten._scaled_dot_product_efficient_attention(q, k, v, bias, True)

        def backward():
            return torch.ops.aten._scaled_dot_product_efficient_attention_backward(
                g, q, k, v, bias, out, lse, philox_seed, philox_offset, 0.0,
                [True, True, True, False])

        grads = backward()
        torch.cuda.synchronize()
        diff = {f"d{n}": float((a - b).abs().max())
                for n, a, b in zip("qkv", grads, kernel_grads)}
        return {"ms": cuda_time_ms(backward, iters),
                "graph_ms": graph_time_ms(backward, iters, stream),
                "max_abs_diff_from_kernel": diff, "error": None}
    except RuntimeError as err:
        return {"ms": None, "graph_ms": None, "max_abs_diff_from_kernel": None,
                "error": str(err)[:500]}


def time_train_attention():
    """The Function's forward + backward, the backward kernel alone (CUDA
    events over back-to-back calls, as the Function calls it, and in a CUDA
    graph: its device time), the plain recompute backward (what the
    Function ran before the backward kernel), autograd through the plain
    version and SDPA's forward + backward (the yardstick), and the library's
    backward alone (SDPA's efficient-attention backward from its forward's
    output and log-sum-exp, the key mask as an additive -1e9 bias; events and
    graph, its gradients held beside the kernel's), at B = 16, H = 2, Dh =
    128, f32, L = 128 and 512; every sample has a valid key (SDPA gives NaN
    for a row with none)."""
    import torch
    import torch.nn.functional as F
    from fscl_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(5)
    stream = torch.cuda.Stream()
    rows = []
    for L in (TRAIN_L, TRAIN_T):
        B, H, Dh = TRAIN_B, 2, 128
        q, k, v, valid = attention_inputs(gen, B, H, L, Dh, torch.float32)
        valid[-1, 0] = True
        g = torch.randn(q.shape, generator=gen, device="cuda")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        mask4 = valid[:, None, None, :]
        stats = torch.empty(B, H, L, 2, device="cuda")
        attn.attention_cuda(q, k, v, valid, None, stats)
        # the forward's row max against the plain scores' (log2 units): what
        # its 16-column sums leave of the tensor cores' truncation
        scores = torch.matmul(q, k.transpose(-1, -2)) * (1.4426950408889634 / Dh ** 0.5)
        m_err = float((stats[..., 0] - scores.masked_fill(
            ~valid[:, None, None, :], -1e9 * 1.4426950408889634).amax(-1)).abs().max())
        del scores

        def fwd_bwd(f):
            return lambda: torch.autograd.grad(f(*leaves), leaves, g)

        def kernel_bwd():
            return attn.attention_bwd_cuda(q, k, v, valid, None, g, stats)

        iters = 50 if L <= 128 else 20
        counts = attn.LAUNCHES, attn.BWD_LAUNCHES
        kernel_ms = cuda_time_ms(fwd_bwd(lambda a, b, c: attn.attend(a, b, c, valid)), iters)
        fwd_ms = cuda_time_ms(lambda: attn.attention_cuda(q, k, v, valid), iters)
        # with the row stats the backward reads: scores summed as it recomputes them
        fwd_stats_ms = cuda_time_ms(lambda: attn.attention_cuda(q, k, v, valid, None, stats), iters)
        bwd_kernel_ms = cuda_time_ms(kernel_bwd, iters)
        bwd_kernel_graph_ms = graph_time_ms(kernel_bwd, iters, stream)
        bwd_ms = cuda_time_ms(lambda: attn.attention_bwd(q, k, v, valid, None, g), iters)
        lib = library_backward(q, k, v, valid, g, kernel_bwd(), iters, stream)
        plain_ms = cuda_time_ms(
            fwd_bwd(lambda a, b, c: attn.attention_reference(a, b, c, valid)), iters)
        library_ms = cuda_time_ms(fwd_bwd(
            lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=mask4)), iters)
        attn.LAUNCHES, attn.BWD_LAUNCHES = counts      # timing launches are not the path's
        bound_ms, bound_by, fma_ms = train_attention_bound(B, H, L, Dh)
        bwd_bound_ms, bwd_bound_by = backward_bound(B, H, L, L, Dh, "float32", 4)
        row = {"B": B, "H": H, "L": L, "Dh": Dh, "dtype": "float32", "ms": kernel_ms,
               "fwd_ms": fwd_ms, "fwd_stats_ms": fwd_stats_ms, "bwd_kernel_ms": bwd_kernel_ms,
               "bwd_kernel_graph_ms": bwd_kernel_graph_ms, "bwd_ms": bwd_ms,
               "bwd_bound_ms": bwd_bound_ms, "bwd_bound_by": bwd_bound_by,
               "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "fma_bound_ms": fma_ms,
               "beats_sdpa": kernel_ms <= library_ms, "fwd_row_max_err_log2": m_err,
               "bwd_library": lib}
        rows.append(row)
        log(f"attention fwd + bwd B={B} H={H} L={L} Dh={Dh} f32: Function {kernel_ms:.4f} ms "
            f"(kernel forward {fwd_ms:.4f}, {fwd_stats_ms:.4f} with the row stats; backward "
            f"kernel {bwd_kernel_ms:.4f} ms by events, "
            f"{bwd_kernel_graph_ms:.4f} ms in a graph, bound {bwd_bound_ms:.4f} ms "
            f"({bwd_bound_by}); plain recompute backward {bwd_ms:.4f} ms; the library's "
            f"backward alone {lib['graph_ms']} ms in a graph, {lib['ms']} by events, "
            f"{lib['max_abs_diff_from_kernel'] or lib['error']} from the kernel's), plain autograd "
            f"{plain_ms:.4f} ms, SDPA fwd + bwd {library_ms:.4f} ms "
            f"({'at or above' if kernel_ms <= library_ms else 'below'} the Function), bound "
            f"{bound_ms:.4f} ms ({bound_by}; f32 FMA bound {fma_ms:.4f} ms); the forward's row "
            f"max {m_err:.3g} (log2 units) from the plain scores'")
    return rows


def train_model_config(dropout: bool, name: str = "base.yaml"):
    """config/model/<name>, with every dropout rate 0 unless `dropout`."""
    from dataclasses import replace
    from fscl_tpu_torch.core.config import model_config_from_yaml

    cfg = model_config_from_yaml(str(REPO / "config" / "model" / name))
    if dropout:
        return cfg
    return replace(cfg, transformer=replace(cfg.transformer, encoder_dropout=0.0,
                                            decoder_dropout=0.0),
                   variance_predictor=replace(cfg.variance_predictor, dropout=0.0))


def build_train_system(cfg, seed: int, device: str):
    import torch
    from fscl_tpu_torch.core.config import OptimConfig
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.systems.baseline import BaselineSystem

    # lr 2e-3 after a 10-step warmup: the default warmup of 4000 steps would
    # leave the rate near 0 for a run this short
    optim = OptimConfig(batch_size=TRAIN_B, lr=2e-3, warmup_step=10, anneal_steps=())
    torch.manual_seed(seed)
    return BaselineSystem(cfg, (("en", n_symbols("en")),), device=device, optim_cfg=optim)


class LossRecorder:
    """Trainer callbacks: every logged step's metrics."""

    def __init__(self):
        self.logs = []

    def on_log(self, step, metrics, steps_per_sec):
        self.logs.append((step, metrics, steps_per_sec))

    def on_validation(self, step, metrics):
        pass

    def on_save(self, step, state):
        pass


def busy_union_ms(prof) -> float:
    """Time the device ran at least one kernel or copy in a trace: the union
    of their intervals (a sum of their times counts overlapping ones twice:
    a traced FSCL episode's kernel times summed to 110 % of its wall)."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_steps(fn, steps_per_call: int, out_dir, name: str):
    """Device time by kernel over two calls of fn (after one untraced),
    reported per step: fn runs `steps_per_call` steps (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    n = 2 * steps_per_call
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(({"name": e.key[:90], "calls": e.count / n,
                    "ms": e.self_device_time_total / (1e3 * n)} for e in events),
                  key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    union = busy_union_ms(prof) / n
    # the host's side of one step: the kernels it launched, its copies, and
    # the times a copy made it wait for the device (cudaStreamSynchronize);
    # the window's own closing synchronizes are cudaDeviceSynchronize, counted
    # apart. Per step over two or more steps, so a single wait reads 0.5 or less.
    host = {e.key: e.count / n for e in prof.key_averages()
            if e.key.startswith(("cudaLaunchKernel", "cudaStreamSynchronize",
                                 "cudaDeviceSynchronize", "cudaMemcpyAsync"))}
    launches = sum(k_n for k, k_n in host.items() if k.startswith("cudaLaunchKernel"))
    syncs = host.get("cudaStreamSynchronize", 0)
    log(f"profile {name} step: wall {1e3 * wall:.2f} ms, kernel time {busy:.2f} ms, device "
        f"busy {union:.2f} ms ({100 * union / (1e3 * wall):.1f}%); per step {launches:g} "
        f"kernel launches, "
        f"{syncs:g} host waits for the device, {host.get('cudaMemcpyAsync', 0):g} copies; "
        f"{n * host.get('cudaDeviceSynchronize', 0):g} device synchronizes at the window's end")
    for r in rows[:15]:
        log(f"  {r['ms']:9.3f} ms {r['calls']:7.1f}x  {r['name']}")
    if out_dir is not None:
        export_trace(prof, out_dir / f"chip_smoke_{name}_trace.json")
    return {"wall_ms": 1e3 * wall, "kernel_ms": busy, "device_busy_ms": union,
            "device_busy_share": union / (1e3 * wall), "host_calls_per_step": host,
            "top": rows[:25]}


def phase_train(seed: int, card: str, attn_checked, profile: bool, out_dir):
    """Main path, training: `Trainer.fit` on `BaselineSystem` at base.yaml
    width, B = 16, L = 128, T = 512, f32; the counted run (TRAIN_STEPS steps,
    a loss each), then a timed run, one pass split by synchronizes, and
    (with --profile) a traced step. Then card vs CPU at B = 4 without
    dropout, and the attention Function's timings."""
    import torch
    from fscl_tpu_torch.core.config import TrainConfig
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops import mrf_stage as mrf
    from fscl_tpu_torch.train.trainer import Trainer

    probe = score_bits_probe()
    hold_backward_shapes([(*shape, dtype) for shape in BACKWARD_SHAPES
                          for dtype in ("float32", "bfloat16")
                          if shape[2:4] != (1, 1) or dtype == "float32"], "backward shapes")
    few_keys = backward_few_keys(seed)
    grads = phase_train_kernel_grads(seed, attn_checked)
    cfg = train_model_config(dropout=True)
    t = cfg.transformer
    per_step = t.encoder_layer + t.decoder_layer
    system = build_train_system(cfg, seed, "cuda")
    n_params = sum(p.numel() for p in system.parameters())
    state = system.init_state()
    # made before the runs (set-up): the prefetch thread only copies them
    stream = train_batches(seed, TRAIN_B, n_symbols("en"), cfg.variance)
    counted = [next(stream) for _ in range(TRAIN_STEPS)]
    timed = [next(stream) for _ in range(TIMED_STEPS)]
    if any(b.texts.shape != (TRAIN_B, TRAIN_L) or b.mels.shape[1] != TRAIN_T
           for b in counted + timed):
        fail(f"train batch shapes differ from B = {TRAIN_B}, L = {TRAIN_L}, T = {TRAIN_T}")

    # the counted run: every step logged, so that each loss is read
    rec = LossRecorder()
    train_cfg = TrainConfig(optim=system.optim_cfg, total_step=TRAIN_STEPS, log_step=1,
                            val_step=10 ** 9, save_step=10 ** 9, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0
    attn.BWD_LAUNCHES = 0
    mrf.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "train"):
        t0 = time.perf_counter()
        state = Trainer(system, train_cfg, [rec]).fit(state, iter(counted))
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
        bwd_launches = attn.BWD_LAUNCHES
    launches, stage_launches = attn.LAUNCHES, mrf.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [mt["Total Loss"] for _, mt, _ in rec.logs]
    if state.step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        fail(f"train: {state.step} steps and {len(losses)} losses, expected {TRAIN_STEPS}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss in {losses}")
    head, tail = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not tail < head:
        fail(f"train: loss did not fall (first 5 mean {head:.4f}, last 5 mean {tail:.4f})")
    if launches != per_step * TRAIN_STEPS:
        fail(f"train: {launches} attention launches in {TRAIN_STEPS} steps, expected "
             f"{per_step} per step")
    if bwd_launches != 2 * per_step * TRAIN_STEPS:
        fail(f"train: {bwd_launches} attention backward kernel launches in {TRAIN_STEPS} "
             f"steps, expected {2 * per_step} per step (two a call)")
    log(f"train: {TRAIN_STEPS} steps through Trainer.fit at B={TRAIN_B} L={TRAIN_L} "
        f"T={TRAIN_T} ({n_params / 1e6:.2f} M parameters), loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (first 5 mean {head:.4f}, last 5 mean {tail:.4f}), {launches} "
        f"attention launches ({per_step} per step) and {bwd_launches} of its backward kernels, "
        f"{counted_s:.2f} s with a loss read per step, peak {peak:.2f} GiB")

    # the timed run: no read of the loss until its end
    timed_cfg = TrainConfig(optim=system.optim_cfg, total_step=TRAIN_STEPS + TIMED_STEPS,
                            log_step=TRAIN_STEPS + TIMED_STEPS, val_step=10 ** 9,
                            save_step=10 ** 9, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = Trainer(system, timed_cfg, [rec]).fit(state, iter(timed))
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    step_ms = 1e3 * timed_s / TIMED_STEPS
    log(f"train: {TIMED_STEPS} steps in {timed_s:.3f} s = {TIMED_STEPS / timed_s:.2f} "
        f"steps/s, {step_ms:.2f} ms per step, {TRAIN_B * TIMED_STEPS / timed_s:.1f} "
        f"utterances/s, loss {rec.logs[-1][1]['Total Loss']:.4f}, on {card}")

    # one pass split into forward, backward and optimizer by synchronizes
    batch = to_device(next(stream), "cuda")
    splits = []
    for _ in range(3):
        system.train()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = system.loss_and_metrics(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = torch.autograd.grad(loss, system.optimizer.params, allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        system.eval()
        system.optimizer.update(state.opt_state, g)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        splits.append((1e3 * (t1 - t0), 1e3 * (t2 - t1), 1e3 * (t3 - t2)))
        del g, loss
    fwd_ms, bwd_ms, opt_ms = sorted(splits)[1]
    log(f"train: one synchronised pass: forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms, "
        f"optimizer {opt_ms:.2f} ms (median of 3)")
    summary = {
        "B": TRAIN_B, "L": TRAIN_L, "T": TRAIN_T, "parameters": n_params,
        "steps": TRAIN_STEPS, "losses": losses, "attention_launches": launches,
        "attention_bwd_launches": bwd_launches, "mrf_stage_launches": stage_launches,
        "counted_seconds": counted_s, "peak_mem_gib": peak,
        "timed_steps": TIMED_STEPS, "timed_seconds": timed_s,
        "steps_per_s": TIMED_STEPS / timed_s, "ms_per_step": step_ms,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms, "optimizer_ms": opt_ms,
        "kernel_grads_max_abs_err": grads, "score_bits_probe": probe,
        "backward_few_valid_keys": few_keys,
    }
    if profile:
        summary["profile"] = profile_steps(lambda: system.train_step(state, batch), 1, out_dir,
                                           "train")
    del system, state, batch
    summary["card_vs_cpu"] = phase_train_card_vs_cpu(seed, attn_checked)
    summary["attention_fwd_bwd"] = time_train_attention()
    return summary


def phase_train_card_vs_cpu(seed: int, attn_checked, cfg=None, steps: int = CARD_STEPS,
                            what: str = "train card vs CPU"):
    """`steps` train steps at B = 4 without dropout from the same weights
    on the card and on the CPU (where the plain versions run): the per-step
    losses against TRAIN_FIRST_RTOL at the first step and TRAIN_LATER_RTOL
    after it. `cfg`: base.yaml without dropout unless given."""
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.ops import attention as attn

    cfg = cfg or train_model_config(dropout=False)
    card = build_train_system(cfg, seed, "cuda")
    cpu = build_train_system(cfg, seed, "cpu")
    cpu.load_state_dict(card.state_dict(), strict=True)
    stream = train_batches(seed + 7, CHECK_B, n_symbols("en"), cfg.variance)
    batches = [next(stream) for _ in range(steps)]
    losses = {}
    for name, system in (("cuda", card), ("cpu", cpu)):
        system.model.postnet.dropout.p = 0.0
        state = system.init_state()
        shapes = (attention_shapes(attn, attn_checked, what) if name == "cuda"
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with shapes:
            losses[name] = [float(system.train_step(state, to_device(b, name))[1]["Total Loss"])
                            for b in batches]
        log(f"{what}: {name} {steps} steps in {time.perf_counter() - t0:.2f} s")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    log(f"{what}: losses " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(losses["cuda"], losses["cpu"]))
        + " (card/CPU), relative |d| " + ", ".join(f"{r:.3g}" for r in rel)
        + f" (bars {TRAIN_FIRST_RTOL} at step 1, {TRAIN_LATER_RTOL} after)")
    if not (rel[0] <= TRAIN_FIRST_RTOL and max(rel[1:]) <= TRAIN_LATER_RTOL):
        fail(f"{what}: relative loss differences {rel}")
    return {"B": CHECK_B, "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
            "rel": rel}


def attention_wide_e2e(seed: int, attn_checked, width: int, heads: int):
    """Head dims above 128 end to end, on the kernel's wide route: base.yaml
    with encoder and decoder `width` wide at `heads` heads (Dh 192 at 384 /
    2, 512 at 512 / 1). DH192_STEPS train steps at B = CHECK_B card vs CPU
    (phase 8's loss bars), then the last 8 of phase 4's lines served card vs
    CPU on a system with the duration head pinned as phase 4's (phase 5's
    bars). Returns the card's attention launches."""
    import torch
    from dataclasses import replace
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.baseline import BaselineSystem

    t0 = time.perf_counter()
    dh = width // heads
    base = train_model_config(dropout=False)
    cfg = replace(base, transformer=replace(
        base.transformer, encoder_hidden=width, decoder_hidden=width,
        encoder_head=heads, decoder_head=heads))
    attn.LAUNCHES = 0
    train = phase_train_card_vs_cpu(seed + 1, attn_checked, cfg, DH192_STEPS,
                                    f"attention Dh {dh} train card vs CPU")
    train_launches = attn.LAUNCHES
    torch.manual_seed(seed + 2)
    system = BaselineSystem(cfg, (("en", n_symbols("en")),), device="cuda")
    with torch.no_grad():
        head = system.model.variance_adaptor.duration_predictor.linear_layer
        head.weight.mul_(0.1)
        head.bias.add_(math.log(5.0))
    attn.LAUNCHES = 0
    serve = phase_card_vs_cpu(system, LINES[-8:], attn_checked,
                              f"attention Dh {dh} serving card vs CPU")
    launches = train_launches + attn.LAUNCHES
    t = cfg.transformer
    want = (DH192_STEPS * (t.encoder_layer + t.decoder_layer)
            + 2 * t.encoder_layer + t.decoder_layer)
    if launches != want:
        fail(f"attention Dh {dh}: {launches} attention launches, expected {want}")
    seconds = time.perf_counter() - t0
    log(f"attention Dh {dh} end to end ({width} wide, {heads} heads): {launches} attention "
        f"launches at head dim {dh} (the wide route at {attn.padded_head_dim(dh)}); "
        f"{seconds:.2f} s")
    del system
    torch.cuda.empty_cache()
    return {"width": width, "heads": heads, "train": train, "serve": serve,
            "attention_launches": launches, "seconds": seconds}


def long_upstream_forward(seed: int):
    """The base HuBERT over one LONG_WAV_S-second wav, f32, on the card: the
    kernel (Lk past 16384) against the same forward with the plain version
    as its attention (`models.hubert.attend` swapped for a head-by-head
    plain call on the card for the control alone). Each of the 13 hidden
    states within T2U_LAYOUT_REL of its layer's max |h|."""
    import numpy as np
    import torch
    from fscl_tpu_torch.models import hubert
    from fscl_tpu_torch.models.hubert import (frozen_upstream_features, init_random_,
                                              make_upstream, ssl_num_frames)
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops.masking import length_mask

    t0 = time.perf_counter()
    gen = torch.Generator(device=CARD).manual_seed(seed + 170)
    with torch.device("meta"):
        shell = make_upstream("hubert")
    model = shell.to_empty(device=CARD).eval().requires_grad_(False)
    init_random_(model, gen)
    n = LONG_WAV_S * 16000
    wav = torch.from_numpy(
        (0.1 * np.random.default_rng(seed + 171).standard_normal((1, n))).astype(np.float32))
    wav = wav.to(CARD)
    valid = length_mask(torch.tensor([n], device=CARD), n)
    frames = ssl_num_frames(n)

    def plain_by_head(q, k, v, key_valid=None, temperature=None, return_weights=False):
        return torch.cat([attn.attention_reference(q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1],
                                                   key_valid, temperature)
                          for h in range(q.shape[1])], dim=1)

    attn.LAUNCHES = 0
    with torch.no_grad():
        t1 = time.perf_counter()
        got = frozen_upstream_features(model, wav, valid)[0]
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t1
        launches = attn.LAUNCHES
        kernel_attend = hubert.attend
        hubert.attend = plain_by_head
        try:
            t1 = time.perf_counter()
            want = frozen_upstream_features(model, wav, valid)[0]
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
        finally:
            hubert.attend = kernel_attend
    if attn.LAUNCHES != launches or launches != model.n_layers:
        fail(f"long upstream forward: {launches} kernel launches ({model.n_layers} layers), "
             f"{attn.LAUNCHES - launches} in the plain control")
    peak = want.abs().amax(dim=(0, 1, 3))
    errs = ((got - want).abs().amax(dim=(0, 1, 3)) / peak).cpu()
    ok = bool(torch.isfinite(got).all()) and got.shape[1] == frames \
        and got.shape[2] == model.n_layers + 1 and float(errs.max()) <= T2U_LAYOUT_REL
    seconds = time.perf_counter() - t0
    log(f"long upstream forward: base HuBERT over {LONG_WAV_S} s ({n} samples, {frames} frames, "
        f"Lq = Lk = {frames}), {launches} attention launches at (1, {model.n_heads}, {frames}, "
        f"{model.dim // model.n_heads}) f32: forward {kernel_s:.2f} s through the kernel, "
        f"{plain_s:.2f} s with the plain version; max |d| / layer max {float(errs.max()):.3g} "
        f"(bar {T2U_LAYOUT_REL}; by layer " + ", ".join(f"{e:.2g}" for e in errs.tolist())
        + f"); {seconds:.2f} s")
    if not ok:
        fail(f"long upstream forward: shape {tuple(got.shape)}, errors {errs.tolist()}")
    del model, got, want
    torch.cuda.empty_cache()
    return {"seconds_of_audio": LONG_WAV_S, "frames": frames, "attention_launches": launches,
            "kernel_s": kernel_s, "plain_s": plain_s, "max_rel_err": float(errs.max()),
            "by_layer": errs.tolist(), "seconds": seconds}


def fscl_model_config(compute_dtype: str):
    """config/model/fscl-fastspeech2.yaml (base trunk, `speaker_emb: dvec`,
    a 128 x 4 codebook over HuBERT-large's 25 hidden states), with the
    upstream stored and run in `compute_dtype`."""
    from dataclasses import replace

    cfg = train_model_config(True, "fscl-fastspeech2.yaml")
    return replace(cfg, upstream=replace(cfg.upstream, compute_dtype=compute_dtype))


def build_fscl_system(cfg, seed: int, device: str, upstream=None):
    """TransEmbSystem with the trunk and codebook from torch's init under
    `seed` and HuBERT-large drawn on the device from `seed` (or `upstream`,
    an unfilled module to load weights into)."""
    import torch
    from fscl_tpu_torch.core.config import OptimConfig
    from fscl_tpu_torch.systems.fscl import TransEmbSystem

    optim = OptimConfig(batch_size=FSCL_B, lr=2e-3, warmup_step=5, anneal_steps=())
    torch.manual_seed(seed)
    return TransEmbSystem(cfg, FSCL_NSYM, device=device, optim_cfg=optim,
                          upstream=upstream, upstream_seed=seed)


def fscl_episodes(seed: int, n: int, S: int, n_samples: int, B: int, L: int, T: int):
    """`n` numpy Episodes: S support wavs of n_samples 16-bit PCM samples
    (noise at 0.1 of full scale; every fourth cut to 3/4 of its length) with
    FSCL_PHONES phonemes of 1-3 SSL frames each; a query batch of B lines
    from `collate_batch` in the (L, T) bucket (the first line L phonemes of
    4 frames), learnable targets from a fixed random table per phoneme plus
    noise, and DvecRefs of DVEC_N slices of (160, 40), the last two samples
    padded (6 and 3 real slices)."""
    import numpy as np
    from fscl_tpu_torch.data.batch import SupInfo, collate_batch
    from fscl_tpu_torch.systems.fscl import Episode

    rng = np.random.default_rng(seed)
    table = np.random.default_rng(seed + 1).normal(size=(FSCL_NSYM, 82)).astype(np.float32)
    out = []
    for e in range(n):
        wavs = np.clip(0.1 * rng.normal(size=(S, n_samples)) * 32767, -32768, 32767)
        wav_lens = np.full(S, n_samples, np.int32)
        wav_lens[3::4] = 3 * n_samples // 4
        wavs[np.arange(n_samples)[None, :] >= wav_lens[:, None]] = 0
        sup = SupInfo(wavs.astype(np.int16), wav_lens,
                      rng.integers(1, 4, (S, FSCL_PHONES)).astype(np.int32),
                      rng.integers(1, FSCL_NSYM, (S, FSCL_PHONES)).astype(np.int32), FSCL_NSYM)
        samples = []
        for i in range(B):
            n_ph = L if i == 0 else int(rng.integers(L // 3, L + 1))
            dur = np.full(n_ph, 4) if i == 0 else rng.integers(1, 5, n_ph)
            ph = rng.integers(1, FSCL_NSYM, n_ph)
            frames = np.repeat(ph, dur)
            n_slices = {B - 2: 6, B - 1: 3}.get(i, DVEC_N)
            samples.append(dict(
                id=f"{e}-{i}", text="", phonemes=ph, duration=dur,
                mel=table[frames, :80] + 0.1 * rng.normal(size=(len(frames), 80)),
                pitch=table[ph, 80] + 0.1 * rng.normal(size=n_ph),
                energy=table[ph, 81] + 0.1 * rng.normal(size=n_ph), lang_id=0,
                spk_ref_mel_slices=rng.normal(size=(n_slices, 160, 40)).astype(np.float32)))
        qry = collate_batch(samples, (L,), (T,), dvec_slices=DVEC_N,
                            pitch_feature="phoneme_level", energy_feature="phoneme_level")[1]
        out.append(Episode(sup=sup, qry=qry))
    return out


def fscl_table_and_loss(system, episode):
    """The episode's table and its eval-mode loss, without gradients."""
    import torch
    system.eval()
    with torch.no_grad():
        hidden, _ = system.extract_ssl(episode.sup.wavs, episode.sup.wav_lens)
        table = system.build_embedding_table(hidden, episode.sup)
        loss = system.query_loss(system.forward_query(table, episode.qry), episode.qry).total
    return table.float().cpu(), float(loss)


def checksum(module) -> float:
    import torch
    with torch.no_grad():
        return sum(float(p.double().sum()) + float(p.double().abs().sum())
                   for p in module.parameters())


def phase_fscl_card_vs_cpu(system, seed: int, attn_checked):
    """One small episode (FSCL_CHECK) through the card's system and the same
    weights on the CPU (where the plain versions run), in eval mode: the
    table and the loss against FSCL_TABLE_REL and FSCL_LOSS_RTOL."""
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.models.hubert import make_upstream
    from fscl_tpu_torch.ops import attention as attn

    S, n_samples, B, L, T = FSCL_CHECK
    ep = fscl_episodes(seed + 5, 1, S, n_samples, B, L, T)[0]
    up = system.model_cfg.upstream
    with torch.device("meta"):
        shell = make_upstream(up.name, up)
    cpu = build_fscl_system(system.model_cfg, seed, "cpu", upstream=shell.to_empty(device="cpu"))
    cpu.load_state_dict(system.state_dict(), strict=True)
    got = {}
    for name, s in (("cuda", system), ("cpu", cpu)):
        shapes = (attention_shapes(attn, attn_checked, "fscl card vs CPU") if name == "cuda"
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with shapes:
            got[name] = fscl_table_and_loss(s, to_device(ep, name))
        log(f"fscl card vs CPU: {name} episode in {time.perf_counter() - t0:.2f} s")
    (t_card, l_card), (t_cpu, l_cpu) = got["cuda"], got["cpu"]
    table_rel = float((t_card - t_cpu).abs().max() / t_cpu.abs().max())
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"fscl card vs CPU (S={S} wavs of {n_samples} samples, B={B} L={L} T={T}, eval mode): "
        f"table relative max |d| {table_rel:.3g} (bar {FSCL_TABLE_REL}), loss {l_card:.6f} / "
        f"{l_cpu:.6f}, relative {loss_rel:.3g} (bar {FSCL_LOSS_RTOL})")
    if not (table_rel <= FSCL_TABLE_REL and loss_rel <= FSCL_LOSS_RTOL):
        fail(f"fscl card vs CPU: table {table_rel:.3g}, loss {loss_rel:.3g}")
    del cpu
    return {"S": S, "samples": n_samples, "B": B, "L": L, "T": T, "table_rel": table_rel,
            "loss_cuda": l_card, "loss_cpu": l_cpu, "loss_rel": loss_rel}


def fscl_split(system, state, ep):
    """One synchronised episode: upstream forward, table (segment ops +
    codebook), trunk forward + backward, optimizer; ms, median of 3."""
    import torch
    splits = []
    for _ in range(3):
        system.train()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden, _ = system.extract_ssl(ep.sup.wavs, ep.sup.wav_lens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        table = system.build_embedding_table(hidden, ep.sup)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss = system.query_loss(system.forward_query(table, ep.qry), ep.qry).total
        g = torch.autograd.grad(loss, system.optimizer.params, allow_unused=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        system.eval()
        system.optimizer.update(state.opt_state, g)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        splits.append(tuple(1e3 * d for d in (t1 - t0, t2 - t1, t3 - t2, t4 - t3)))
        del g, loss, table, hidden
    return sorted(splits, key=sum)[1]


def run_fscl(system, dtype_name: str, episodes, timed, extra, card: str, attn_checked,
             profile: bool, out_dir):
    """The main path for one upstream dtype: FSCL_EPISODES episodes through
    `Trainer.fit` counted (a loss each, 34 attention launches each at shapes
    held in phase 3), FSCL_TIMED more timed, one split by synchronizes, the
    upstream's checksum before and after, the codebook changed, peak memory,
    and with --profile a traced episode."""
    import torch
    from fscl_tpu_torch.core.config import TrainConfig
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.train.trainer import Trainer

    t = system.model_cfg.transformer
    per_episode = system.upstream.n_layers + t.encoder_layer + t.decoder_layer
    up_sum = checksum(system.upstream)
    codebook = {k: v.clone() for k, v in system.codebook.state_dict().items()}
    state = system.init_state()
    rec = LossRecorder()
    cfg = TrainConfig(optim=system.optim_cfg, total_step=FSCL_EPISODES, log_step=1,
                      val_step=10 ** 9, save_step=10 ** 9, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, f"fscl episode {dtype_name}"):
        t0 = time.perf_counter()
        state = Trainer(system, cfg, [rec]).fit(state, iter(episodes))
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
    launches = attn.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["Total Loss"] for _, m, _ in rec.logs]
    if state.step != FSCL_EPISODES or len(losses) != FSCL_EPISODES:
        fail(f"fscl {dtype_name}: {state.step} episodes and {len(losses)} losses")
    if not all(math.isfinite(x) for x in losses):
        fail(f"fscl {dtype_name}: non-finite loss in {losses}")
    head, tail = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not tail < head:
        fail(f"fscl {dtype_name}: loss did not fall (first 5 mean {head:.4f}, last 5 {tail:.4f})")
    if launches != per_episode * FSCL_EPISODES:
        fail(f"fscl {dtype_name}: {launches} attention launches in {FSCL_EPISODES} episodes, "
             f"expected {per_episode} per episode")
    log(f"fscl {dtype_name}: {FSCL_EPISODES} episodes through Trainer.fit, loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f} (first 5 mean {head:.4f}, last 5 mean {tail:.4f}), {launches} "
        f"attention launches ({per_episode} per episode), {counted_s:.2f} s with a loss read "
        f"per episode, peak {peak:.2f} GiB")

    timed_cfg = TrainConfig(optim=system.optim_cfg, total_step=FSCL_EPISODES + FSCL_TIMED,
                            log_step=FSCL_EPISODES + FSCL_TIMED, val_step=10 ** 9,
                            save_step=10 ** 9, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = Trainer(system, timed_cfg, [rec]).fit(state, iter(timed))
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    ms = 1e3 * timed_s / FSCL_TIMED
    ep = to_device(extra, "cuda")
    up_ms, table_ms, trunk_ms, opt_ms = fscl_split(system, state, ep)
    split_total = up_ms + table_ms + trunk_ms + opt_ms
    log(f"fscl {dtype_name}: {FSCL_TIMED} episodes in {timed_s:.3f} s = "
        f"{FSCL_TIMED / timed_s:.3f} episodes/s, {ms:.2f} ms per episode, on {card}; one "
        f"synchronised episode: upstream forward {up_ms:.2f} ms, table {table_ms:.2f}, trunk "
        f"forward + backward {trunk_ms:.2f}, optimizer {opt_ms:.2f}: upstream share "
        f"{100 * up_ms / split_total:.1f}%")
    up_after = checksum(system.upstream)
    changed = any(not torch.equal(v, system.codebook.state_dict()[k]) for k, v in codebook.items())
    log(f"fscl {dtype_name}: upstream checksum {up_sum!r} before, {up_after!r} after; codebook "
        f"{'changed' if changed else 'UNCHANGED'}")
    if up_after != up_sum or not changed:
        fail(f"fscl {dtype_name}: the upstream changed or the codebook did not")
    summary = {
        "upstream_dtype": dtype_name, "episodes": FSCL_EPISODES, "losses": losses,
        "attention_launches": launches, "attention_per_episode": per_episode,
        "counted_seconds": counted_s, "peak_mem_gib": peak,
        "timed_episodes": FSCL_TIMED, "timed_seconds": timed_s,
        "episodes_per_s": FSCL_TIMED / timed_s, "ms_per_episode": ms,
        "upstream_ms": up_ms, "table_ms": table_ms, "trunk_fwd_bwd_ms": trunk_ms,
        "optimizer_ms": opt_ms, "upstream_share": up_ms / split_total,
        "upstream_checksum": up_sum,
    }
    if profile:
        summary["profile"] = profile_steps(lambda: system.train_step(state, ep), 1, out_dir,
                                           f"fscl_{dtype_name}")
    return summary


def time_pos_conv(system):
    """The positional conv alone (k = 128, 16 groups, 1024 channels, cuDNN)
    at the episode's (S, T', 1024), in the upstream's storage dtype."""
    import torch
    from fscl_tpu_torch.models.hubert import ssl_num_frames
    conv = system.upstream.encoder.pos_conv_embed
    w = next(conv.parameters())
    x = torch.randn(FSCL_S, ssl_num_frames(FSCL_WAV), system.upstream.dim, device=w.device,
                    dtype=w.dtype)
    with torch.no_grad():
        return cuda_time_ms(lambda: conv(x), 10)


def phase_fscl(seed: int, card: str, attn_checked, profile: bool, out_dir):
    """Main path, the FSCL meta-episode: `TransEmbSystem` at
    fscl-fastspeech2.yaml width with a random HuBERT-large from `seed`, at
    the episode shape of benchmarks/bench_fscl_fullsize.py (32 support wavs
    of 4 s, 64 phonemes each, 100 symbols; an 8-line query batch at L = 128,
    T = 512), trained through `Trainer.fit` once with the f32 upstream and
    once with it stored in bf16. Before training: card vs CPU on a small
    episode, and the bf16 upstream's table against the f32 one's."""
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.ops import attention as attn

    # made before the runs (set-up): the prefetch thread only copies them
    episodes = fscl_episodes(seed, FSCL_EPISODES + FSCL_TIMED + 1, FSCL_S, FSCL_WAV,
                             FSCL_B, FSCL_L, FSCL_T)
    counted, timed = episodes[:FSCL_EPISODES], episodes[FSCL_EPISODES:-1]
    extra = episodes[-1]

    summary = {"S": FSCL_S, "wav_samples": FSCL_WAV, "phones": FSCL_PHONES,
               "n_symbols": FSCL_NSYM, "B": FSCL_B, "L": FSCL_L, "T": FSCL_T,
               "dvec_slices": DVEC_N}
    first = to_device(counted[0], "cuda")
    tables, trunk_sums = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        system = build_fscl_system(fscl_model_config(dtype_name), seed, "cuda")
        torch.cuda.synchronize()
        n_up = sum(p.numel() for p in system.upstream.parameters())
        mask = system.trainable_mask()
        n_train = sum(p.numel() for n, p in system.named_parameters() if mask[n])
        log(f"fscl {dtype_name}: built in {time.perf_counter() - t0:.2f} s: upstream "
            f"{n_up / 1e6:.1f} M parameters ({dtype_name}), {n_train / 1e6:.2f} M trainable")
        if dtype_name == "float32":
            summary["card_vs_cpu"] = phase_fscl_card_vs_cpu(system, seed, attn_checked)
        # the same seed gives both builds the same weights (the bf16 one cast)
        trunk_sums[dtype_name] = checksum(system.model) + checksum(system.codebook)
        with attention_shapes(attn, attn_checked, f"fscl table {dtype_name}"):
            tables[dtype_name] = fscl_table_and_loss(system, first)[0]
        summary[f"pos_conv_ms_{dtype_name}"] = time_pos_conv(system)
        summary[dtype_name] = run_fscl(system, dtype_name, counted, timed, extra, card,
                                       attn_checked, profile, out_dir)
        log(f"fscl {dtype_name}: positional conv alone {summary[f'pos_conv_ms_{dtype_name}']:.3f}"
            f" ms per episode (upstream forward {summary[dtype_name]['upstream_ms']:.2f} ms)")
        del system
        torch.cuda.empty_cache()
    if trunk_sums["bfloat16"] != trunk_sums["float32"]:
        fail(f"fscl: the two builds from one seed differ ({trunk_sums})")
    rel = float((tables["bfloat16"] - tables["float32"]).abs().max()
                / tables["float32"].abs().max())
    log(f"fscl: bf16 upstream's table vs the f32 upstream's, relative max |d| {rel:.3g} "
        f"(bar {FSCL_BF16_TABLE_REL})")
    if not rel <= FSCL_BF16_TABLE_REL:
        fail(f"fscl: the bf16 upstream's table is {rel:.3g} from the f32 one's")
    summary["bf16_vs_f32_table_rel"] = rel
    return summary


def tune_split(seed: int):
    """The few-shot split: phase 10's support set and query lines at
    TUNE_K each; the wavs in SupInfo batches of TUNE_SUP_BATCH, the lines one
    K-row support Batch."""
    from fscl_tpu_torch.data.batch import SupInfo

    ep = fscl_episodes(seed, 1, TUNE_K, FSCL_WAV, TUNE_K, FSCL_L, FSCL_T)[0]
    sups = [SupInfo(*(x[i:i + TUNE_SUP_BATCH] for x in ep.sup[:4]), FSCL_NSYM)
            for i in range(0, TUNE_K, TUNE_SUP_BATCH)]
    return sups, ep.qry


def many_tasks(seed: int, n_tasks: int, n_steps: int, dvec: bool):
    """benchmarks/bench_adapt_many.py's tasks: per step a numpy Batch of
    MANY_B lines at L = MANY_L, T = MANY_T (random texts of 100 symbols,
    random targets, one duration pattern), with DvecRefs of DVEC_N slices
    when `dvec`."""
    import numpy as np
    from fscl_tpu_torch.data.batch import Batch, DvecRefs

    B, L, T = MANY_B, MANY_L, MANY_T
    dur = np.random.default_rng(seed).integers(1, 5, (B, L)).astype(np.int32)

    def mk(s):
        r = np.random.default_rng(s)
        spk = (DvecRefs(r.normal(size=(B, DVEC_N, 160, 40)).astype(np.float32),
                        np.ones((B, DVEC_N), np.float32)) if dvec else np.zeros(B, np.int32))
        return Batch(spk, r.integers(1, 100, (B, L)).astype(np.int32), np.full(B, L, np.int32),
                     r.normal(size=(B, T, 80)).astype(np.float32),
                     np.minimum(dur.sum(1), T).astype(np.int32),
                     r.normal(size=(B, L)).astype(np.float32),
                     r.normal(size=(B, L)).astype(np.float32), dur, np.zeros(B, np.int32))

    return [[mk(seed + 1000 * t + i) for i in range(n_steps)] for t in range(n_tasks)]


def params_rel(a, b) -> float:
    """||a - b|| / ||b|| over every tensor of two parameter dicts, in f64."""
    num = sum(float((a[k].double() - b[k].double().to(a[k].device)).square().sum()) for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return math.sqrt(num / den)


def build_tune_system(seed: int, device: str):
    """TransEmbTuneSystem at fscl-fastspeech2.yaml width (its trunk: base
    width, GE2E d-vectors) with one table of FSCL_NSYM symbols, torch's init
    from `seed` and the duration head pinned as in `build_system`."""
    import torch
    from fscl_tpu_torch.systems.tune import TransEmbTuneSystem

    torch.manual_seed(seed)
    system = TransEmbTuneSystem(fscl_model_config("float32"), ((TUNE_SYMBOL, FSCL_NSYM),),
                                device=device)
    with torch.no_grad():
        head = system.model.variance_adaptor.duration_predictor.linear_layer
        head.weight.mul_(0.1)
        head.bias.add_(math.log(5.0))
    return system


def phase_tune_tables(seed: int, sups, attn_checked):
    """The reference table over the split through HuBERT-large stored in f32
    and in bf16 (one warm-up batch, then the whole split timed and its
    attention launches counted); returns the f32 FSCL system and a
    summary."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.tune import build_reference_table

    summary, tables, keep = {}, {}, None
    for dtype_name in ("float32", "bfloat16"):
        fscl = build_fscl_system(fscl_model_config(dtype_name), seed, "cuda")
        up_sum = checksum(fscl.upstream)
        build_reference_table(fscl, sups[:1])
        torch.cuda.synchronize()
        attn.LAUNCHES = 0
        with attention_shapes(attn, attn_checked, f"tune reference table {dtype_name}"):
            t0 = time.perf_counter()
            table = build_reference_table(fscl, sups)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        launches = attn.LAUNCHES
        if launches != fscl.upstream.n_layers * len(sups):
            fail(f"tune table {dtype_name}: {launches} attention launches for {len(sups)} "
                 f"batches of {fscl.upstream.n_layers} layers")
        if table.shape != (FSCL_NSYM, fscl.model_cfg.transformer.encoder_hidden) \
                or not torch.isfinite(table).all() or float(table[0].abs().max()) != 0.0:
            fail(f"tune table {dtype_name}: shape {tuple(table.shape)}, finite "
                 f"{bool(torch.isfinite(table).all())}, PAD row {float(table[0].abs().max())}")
        if checksum(fscl.upstream) != up_sum:
            fail(f"tune table {dtype_name}: the upstream changed")
        tables[dtype_name] = table.float().cpu()
        summary[dtype_name] = {"ms": ms, "attention_launches": launches,
                               "upstream_checksum": up_sum}
        log(f"tune reference table {dtype_name}: {TUNE_K} wavs of {FSCL_WAV} samples in "
            f"{len(sups)} SupInfo batches of {TUNE_SUP_BATCH}: {ms:.2f} ms, {launches} attention "
            f"launches ({fscl.upstream.n_layers} per batch), upstream unchanged")
        if dtype_name == "float32":
            keep = fscl
        else:
            del fscl
            torch.cuda.empty_cache()
    rel = float((tables["bfloat16"] - tables["float32"]).abs().max()
                / tables["float32"].abs().max())
    log(f"tune reference table: bf16 upstream's vs f32's, relative max |d| {rel:.3g} "
        f"(bar {FSCL_BF16_TABLE_REL})")
    if not rel <= FSCL_BF16_TABLE_REL:
        fail(f"tune: the bf16 upstream's table is {rel:.3g} from the f32 one's")
    summary["bf16_vs_f32_rel"] = rel
    return keep, summary


def phase_tune_adapt(system, p0, support, optimizer: str, card: str, attn_checked):
    """`adapt_on_chip_resident` over the resident split: TUNE_COUNTED steps
    counted (attention launches, shapes, losses read at the end), then
    TUNE_TIMED steps from the same parameters timed (no read until the
    end); the losses fall and stay finite, every parameter moved the GE2E
    encoder's included."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.tune import adapt_on_chip_resident

    t = system.model_cfg.transformer
    per_step = t.encoder_layer + t.decoder_layer
    kw = dict(batch_size=TUNE_B, lr=TUNE_LR, symbol_id=TUNE_SYMBOL, optimizer=optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, f"tune adapt {optimizer}"):
        t0 = time.perf_counter()
        _, losses = adapt_on_chip_resident(system, p0, support, TUNE_COUNTED, seed=1, **kw)
        counted = losses.cpu().tolist()
        counted_s = time.perf_counter() - t0
    launches = attn.LAUNCHES
    if launches != per_step * TUNE_COUNTED:
        fail(f"tune adapt {optimizer}: {launches} attention launches in {TUNE_COUNTED} steps")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adapted, losses = adapt_on_chip_resident(system, p0, support, TUNE_TIMED, seed=2, **kw)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = losses.cpu().tolist()
    if not all(math.isfinite(x) for x in counted + timed):
        fail(f"tune adapt {optimizer}: non-finite loss in {counted} / {timed}")
    head, tail = sum(timed[:5]) / 5, sum(timed[-5:]) / 5
    if not tail < head:
        fail(f"tune adapt {optimizer}: loss did not fall (first 5 mean {head:.4f}, last 5 "
             f"{tail:.4f})")
    moved = [k for k in p0 if not torch.equal(adapted[k], p0[k])]
    ge2e = [k for k in p0 if ".ge2e." in k]
    if not ge2e or any(k not in moved for k in ge2e) or len(moved) < 0.5 * len(p0):
        fail(f"tune adapt {optimizer}: {len(moved)} of {len(p0)} tensors moved, GE2E's "
             f"{sum(k in moved for k in ge2e)} of {len(ge2e)}")
    log(f"tune adapt {optimizer}: adapt_on_chip_resident at B={TUNE_B} from {TUNE_K} rows, lr "
        f"{TUNE_LR}: {TUNE_COUNTED} steps counted ({launches} attention launches, "
        f"{counted_s:.2f} s, loss {counted[0]:.4f} -> {counted[-1]:.4f}); {TUNE_TIMED} steps "
        f"in {timed_s:.3f} s = {TUNE_TIMED / timed_s:.2f} steps/s, "
        f"{1e3 * timed_s / TUNE_TIMED:.2f} ms per step (first 5 mean {head:.4f}, last 5 {tail:.4f}); {len(moved)} of {len(p0)} "
        f"tensors moved, all {len(ge2e)} of GE2E; peak {peak:.2f} GiB, on {card}")
    return adapted, {"counted_losses": counted, "attention_launches": launches,
                     "counted_seconds": counted_s, "timed_losses": timed,
                     "timed_seconds": timed_s, "steps_per_s": TUNE_TIMED / timed_s,
                     "ms_per_step": 1e3 * timed_s / TUNE_TIMED, "peak_mem_gib": peak,
                     "tensors_moved": len(moved), "tensors": len(p0)}


def phase_tune_card_vs_cpu(system, seed: int, attn_checked):
    """TUNE_CHECK_STEPS Adam steps of `adapt_on_chip` from the tune system's
    weights on the card and on the CPU (where the plain versions run)."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.tune import adaptable_params, adapt_on_chip

    cpu = build_tune_system(seed, "cpu")
    cpu.load_state_dict(system.state_dict(), strict=True)
    batches = many_tasks(seed + 21, 1, TUNE_CHECK_STEPS, dvec=True)[0]
    got = {}
    for name, s in (("cuda", system), ("cpu", cpu)):
        shapes = (attention_shapes(attn, attn_checked, "tune card vs CPU") if name == "cuda"
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with shapes:
            p, losses = adapt_on_chip(s, adaptable_params(s), batches, lr=MANY_LR,
                                      symbol_id=TUNE_SYMBOL, optimizer="adam")
            got[name] = (p, losses.cpu().tolist())
        log(f"tune card vs CPU: {name} {TUNE_CHECK_STEPS} Adam steps in "
            f"{time.perf_counter() - t0:.2f} s")
    (p_card, l_card), (p_cpu, l_cpu) = got["cuda"], got["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu)]
    prel = params_rel(p_card, p_cpu)
    pmax = max(float((p_card[k].cpu() - v).abs().max()) for k, v in p_cpu.items())
    log("tune card vs CPU: losses " + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(l_card, l_cpu))
        + f" (card/CPU), relative {max(rel):.3g}; parameters relative L2 {prel:.3g}, max |d| "
        f"{pmax:.3g} (bars {TUNE_RTOL})")
    if not (max(rel) <= TUNE_RTOL and prel <= TUNE_RTOL):
        fail(f"tune card vs CPU: losses {rel}, parameters {prel:.3g}")
    del cpu
    return {"losses_cuda": l_card, "losses_cpu": l_cpu, "loss_rel": rel, "params_rel": prel,
            "params_max_abs": pmax}


def run_many(system, params, tasks, symbol_id, lr, what, attn_checked, optimizer="sgd"):
    """`adapt_many_on_chip` over `tasks`, then each task alone through
    `adapt_on_chip`, both timed; each task's losses and parameters against
    its run alone (TUNE_RTOL)."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.tune import adapt_many_on_chip, adapt_on_chip

    n, steps = len(tasks), len(tasks[0])
    t = system.model_cfg.transformer
    torch.cuda.synchronize()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, f"{what} N={n}"):
        t0 = time.perf_counter()
        many, losses = adapt_many_on_chip(system, params, tasks, lr=lr, symbol_id=symbol_id,
                                          optimizer=optimizer)
        torch.cuda.synchronize()
        many_s = time.perf_counter() - t0
    launches = attn.LAUNCHES
    if launches != (t.encoder_layer + t.decoder_layer) * steps:
        fail(f"{what} N={n}: {launches} attention launches in {steps} steps (the vmap rule "
             f"folds the tasks into one launch per layer)")
    losses = losses.cpu()
    if losses.shape != (n, steps) or not torch.isfinite(losses).all():
        fail(f"{what} N={n}: losses {tuple(losses.shape)}, finite "
             f"{bool(torch.isfinite(losses).all())}")
    seq_s, worst, worst_p = 0.0, 0.0, 0.0
    for i, task in enumerate(tasks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one, one_losses = adapt_on_chip(system, params, task, lr=lr, symbol_id=symbol_id,
                                        optimizer=optimizer)
        torch.cuda.synchronize()
        seq_s += time.perf_counter() - t0
        rel = ((losses[i] - one_losses.cpu()).abs() / one_losses.cpu().abs()).max().item()
        worst = max(worst, rel)
        worst_p = max(worst_p, params_rel({k: v[i] for k, v in many.items()}, one))
    log(f"{what} N={n}: {steps} steps in {many_s:.3f} s = {n * steps / many_s:.2f} aggregate "
        f"steps/s ({launches} attention launches); each task alone {seq_s:.3f} s = "
        f"{n * steps / seq_s:.2f} steps/s; task by task vs alone: losses relative {worst:.3g}, "
        f"parameters relative L2 {worst_p:.3g} (bar {TUNE_RTOL})")
    if not (worst <= TUNE_RTOL and worst_p <= TUNE_RTOL):
        fail(f"{what} N={n}: tasks differ from their runs alone (losses {worst:.3g}, "
             f"parameters {worst_p:.3g})")
    return {"n_tasks": n, "steps": steps, "seconds": many_s,
            "aggregate_steps_per_s": n * steps / many_s, "sequential_seconds": seq_s,
            "sequential_steps_per_s": n * steps / seq_s, "attention_launches": launches,
            "loss_rel": worst, "params_rel": worst_p}


def phase_tune_many(seed: int, dvec_system, attn_checked):
    """Task-parallel adaptation at bench_adapt_many.py's configuration, at N
    = 1 and 8 (after one untimed N = 1 run), and the d-vector tune system
    at N = MANY_DVEC_TASKS."""
    import dataclasses
    import torch
    from fscl_tpu_torch.core.config import SpeakerConfig
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    from fscl_tpu_torch.systems.tune import adaptable_params, adapt_many_on_chip

    cfg = train_model_config(dropout=False)
    cfg = dataclasses.replace(cfg, speaker=SpeakerConfig(n_speakers=8))
    torch.manual_seed(seed)
    system = BaselineSystem(cfg, (("ko", 100),), device="cuda")
    params = adaptable_params(system)
    adapt_many_on_chip(system, params, many_tasks(seed, 1, 2, False), lr=MANY_LR,
                       symbol_id="ko")
    summary = {"B": MANY_B, "L": MANY_L, "T": MANY_T, "lr": MANY_LR}
    for n in MANY_TASKS:
        summary[f"n{n}"] = run_many(system, params, many_tasks(seed + n, n, MANY_STEPS, False),
                                    "ko", MANY_LR, "tune adapt_many", attn_checked)
    del system, params
    torch.cuda.empty_cache()
    summary["dvec"] = run_many(
        dvec_system, adaptable_params(dvec_system),
        many_tasks(seed + 50, MANY_DVEC_TASKS, MANY_DVEC_STEPS, True), TUNE_SYMBOL, MANY_LR,
        "tune adapt_many dvec", attn_checked, optimizer="adam")
    return summary


def phase_tune(seed: int, card: str, attn_checked, profile: bool, out_dir):
    """Main path, few-shot tune: the reference table over a 32-shot split
    through HuBERT-large (f32 and bf16 storage), `tune_init` into a
    TransEmbTuneSystem at fscl-fastspeech2.yaml width, adaptation with SGD
    and the tune Adam on the resident split, synthesis with the adapted
    parameters, card vs CPU, and task-parallel adaptation."""
    import torch
    from fscl_tpu_torch.data.batch import DvecRefs, to_device
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops import mrf_stage as mrf
    from fscl_tpu_torch.systems.baseline import MEL_BUCKETS
    from fscl_tpu_torch.systems.tune import (adaptable_params, adapt_on_chip_resident,
                                             load_adapted, tune_init)

    sups, support = tune_split(seed + 11)
    summary = {"K": TUNE_K, "sup_batch": TUNE_SUP_BATCH, "B": TUNE_B, "lr": TUNE_LR,
               "L": FSCL_L, "T": FSCL_T, "dvec_slices": DVEC_N}
    mrf.LAUNCHES = 0
    fscl, summary["reference_table"] = phase_tune_tables(seed, sups, attn_checked)
    up_sum = checksum(fscl.upstream)
    system = build_tune_system(seed, "cuda")
    with attention_shapes(attn, attn_checked, "tune_init"):
        table = tune_init(fscl, system, sups, TUNE_SYMBOL)
    if not torch.equal(system.embedding_model.tables[f"table-{TUNE_SYMBOL}"].detach(), table):
        fail("tune_init: the table was not transplanted")
    if checksum(fscl.upstream) != up_sum:
        fail("tune_init: the upstream changed")
    del fscl
    torch.cuda.empty_cache()

    p0 = {k: v.clone() for k, v in adaptable_params(system).items()}
    resident = to_device(support, "cuda")
    adapted = {}
    for optimizer in ("sgd", "adam"):
        adapted[optimizer], summary[optimizer] = phase_tune_adapt(
            system, p0, resident, optimizer, card, attn_checked)
    if profile:
        summary["profile"] = profile_steps(
            lambda: adapt_on_chip_resident(system, p0, resident, 2, batch_size=TUNE_B,
                                           lr=TUNE_LR, symbol_id=TUNE_SYMBOL, optimizer="adam"),
            2, out_dir, "tune_adapt_adam")
    summary["card_vs_cpu"] = phase_tune_card_vs_cpu(system, seed, attn_checked)
    summary["many"] = phase_tune_many(seed, system, attn_checked)

    # synthesis with the adapted parameters: 8 of the split's lines
    rows = slice(0, 8)
    spk = DvecRefs(*(x[rows] for x in support.speaker_args))
    summary["synthesis"] = {}
    for optimizer in ("sgd", "adam"):
        load_adapted(system, adapted[optimizer])
        attn.LAUNCHES = 0
        with attention_shapes(attn, attn_checked, f"tune synthesis {optimizer}"):
            out = system.synthesize_bucketed(support.texts[rows], support.src_lens[rows], spk,
                                             support.lang_ids[rows], symbol_id=TUNE_SYMBOL)
            torch.cuda.synchronize()
        T = out.postnet_mel.shape[1]
        mel_len = out.mel_len.cpu()
        if T not in MEL_BUCKETS or not torch.isfinite(out.postnet_mel).all() \
                or int(mel_len.max()) > T or int(mel_len.min()) < 1:
            fail(f"tune synthesis {optimizer}: T {T}, mel_len {mel_len.tolist()}, finite "
                 f"{bool(torch.isfinite(out.postnet_mel).all())}")
        summary["synthesis"][optimizer] = {"T": T, "mel_len": mel_len.tolist(),
                                           "attention_launches": attn.LAUNCHES}
        log(f"tune synthesis {optimizer}: 8 lines through the adapted system at T = {T}, "
            f"mel_len {mel_len.tolist()}, {attn.LAUNCHES} attention launches, finite")
    summary["mrf_stage_launches"] = mrf.LAUNCHES
    del system
    torch.cuda.empty_cache()
    return summary


# -- phase 12: the CLI workflow on a corpus ------------------------------------------

class CliProbe:
    """Records what the CLI does inside it, without changing it: every
    checkpoint save (ms with the device synchronised, bytes on disk) and
    restore (ms; after a full restore, the restored step and whether every
    parameter and Adam moment equals the file), every `Trainer.fit` (steps,
    seconds, and the seconds of the saves made inside it), every train
    step's loss (the device tensor, read after the run) and the system built
    by `System.init_state` (with its codebook at init, if any)."""

    def __init__(self):
        self.saves, self.restores, self.fits, self.losses, self.systems = [], [], [], [], []
        self._in_fit = False

    @contextlib.contextmanager
    def active(self):
        import torch
        from fscl_tpu_torch.core import checkpoint as ckpt
        from fscl_tpu_torch.systems.base import System
        from fscl_tpu_torch.train.trainer import Trainer

        def save(orig):
            def call(mgr, step, system, state):
                t0 = time.perf_counter()
                path = orig(mgr, step, system, state)
                self.saves.append({"step": step, "in_fit": self._in_fit,
                                   "ms": 1e3 * (time.perf_counter() - t0),
                                   "bytes": (Path(path) / ckpt.STATE_FILE).stat().st_size})
                return path
            return call

        def restore_into(orig):
            def call(mgr, system, state=None, step=None, remap=None, full=False):
                t0 = time.perf_counter()
                out = orig(mgr, system, state, step, remap, full)
                torch.cuda.synchronize()
                rec = {"full": full, "ms": 1e3 * (time.perf_counter() - t0)}
                if full:
                    raw = mgr.restore(step)
                    live = dict(system.named_parameters())
                    names = ckpt.optimizer_names(system)
                    rec.update(step=out.step, params_equal=all(
                        torch.equal(live[k].cpu(), v) for k, v in raw["params"].items()),
                        moments_equal=all(
                            torch.equal(t.cpu(), raw["opt_state"][m][n])
                            for m, ts in (("mu", out.opt_state.mu), ("nu", out.opt_state.nu))
                            for t, n in zip(ts, names)),
                        count=out.opt_state.count)
                self.restores.append(rec)
                return out
            return call

        def fit(orig):
            def call(trainer, state, *args, **kwargs):
                s0, n_saves = state.step, len(self.saves)
                self._in_fit = True
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    out = orig(trainer, state, *args, **kwargs)
                    torch.cuda.synchronize()
                finally:
                    self._in_fit = False
                seconds = time.perf_counter() - t0
                save_s = sum(s["ms"] for s in self.saves[n_saves:]) / 1e3
                self.fits.append({"steps": out.step - s0, "seconds": seconds,
                                  "save_seconds": save_s,
                                  "steps_per_s": (out.step - s0) / (seconds - save_s)})
                return out
            return call

        def train_step(orig):
            def call(system, state, batch):
                state, metrics = orig(system, state, batch)
                self.losses.append(metrics["Total Loss"])
                return state, metrics
            return call

        def init_state(orig):
            def call(system):
                codebook = getattr(system, "codebook", None)
                self.systems.append((system, None if codebook is None else
                                     {k: v.clone() for k, v in codebook.state_dict().items()}))
                return orig(system)
            return call

        Manager = ckpt.CheckpointManager
        with mock.patch.object(Manager, "save", save(Manager.save)), \
                mock.patch.object(Manager, "restore_into", restore_into(Manager.restore_into)), \
                mock.patch.object(Trainer, "fit", fit(Trainer.fit)), \
                mock.patch.object(System, "train_step", train_step(System.train_step)), \
                mock.patch.object(System, "init_state", init_state(System.init_state)):
            yield self

    def read_losses(self):
        losses = [float(x) for x in self.losses]
        self.losses = []
        return losses


def falling(losses) -> bool:
    return len(losses) >= 10 and sum(losses[-5:]) / 5 < sum(losses[:5]) / 5


def cli_train_overlay(root: Path, name: str, text: str) -> str:
    path = root / f"{name}.yaml"
    path.write_text(text)
    return str(path)


def cli_synth_line():
    """The line of the card-vs-CPU synthesis and its (L, T): `synth --text`
    runs at L = its length and T = min(1000, max(64, 12 L)), unbucketed, so
    phase 3 holds both shapes."""
    from fscl_tpu_torch.frontend import text_to_sequence
    line = SENTENCES[2]
    L = len(text_to_sequence(line, ["basic_cleaners"], "en"))
    return line, L, min(1000, max(64, 12 * L))


def phase_cli(seed: int, card: str, attn_checked, stage_checked, train, fscl):
    """Main path, the command line on a preprocessed corpus: two corpora
    written with the port's FeatureStore, then `fscl_tpu_torch.cli.main` as
    a user runs it: train the baseline (then resume it), synthesize from its
    checkpoint through both kernels, train FSCL meta-episodes with
    HuBERT-large, tune to a 32-utterance split with --scan_adapt. At full
    width; the step counts are the depth to cut first should the script
    outgrow its time."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="fscl_cli_"))
    try:
        sys.path.insert(0, str(REPO / "tests"))
        from torch_corpus import write_corpus

        t0 = time.perf_counter()
        en, zh = (write_corpus(str(root), f"{sid}-cli", sid, lang, seed + 40 + lang,
                               n_train=CLI_TRAIN, n_val=CLI_VAL, speakers=CLI_SPEAKERS,
                               frames=CLI_FRAMES, n_phones=CLI_PHONES,
                               n_slices=(DVEC_N, DVEC_N), tune=CLI_TUNE_K)
                  for sid, lang in CLI_LANGS)
        zh_tune = str(Path(zh).with_name("tune.yaml"))
        corpus_s = time.perf_counter() - t0
        corpus_bytes = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
        log(f"cli: wrote 2 corpora ({len(CLI_SPEAKERS)} speakers, {CLI_TRAIN} + {CLI_VAL} "
            f"utterances of {CLI_FRAMES[0]}-{CLI_FRAMES[1]} mel frames each) in "
            f"{corpus_s:.2f} s, {corpus_bytes / 2**20:.1f} MiB")
        summary = {"corpus_seconds": corpus_s, "corpus_bytes": corpus_bytes}
        summary["train"] = cli_baseline(root, en, card, attn_checked, train)
        summary["synth"] = cli_synth(root, en, seed, attn_checked, stage_checked,
                                     summary["train"].pop("ckpt"))
        summary["fscl"] = cli_fscl(root, en, zh, attn_checked, fscl)
        summary["tune"] = cli_tune(root, zh_tune, attn_checked, summary["fscl"].pop("ckpt"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return summary


def cli_baseline(root: Path, en: str, card: str, attn_checked, train):
    """`train --system baseline` on `en` for CLI_STEPS steps, then
    `--resume --total_step CLI_RESUME_STEPS`; steps/s beside phase 8's and
    the host's batch-making time per step (`train_cmd.baseline_batches`, the
    prefetch thread's work, timed alone), and the same steps on batches made
    beforehand with and without the CLI's callbacks."""
    import dataclasses

    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.cli import train_cmd
    from fscl_tpu_torch.core.checkpoint import CheckpointManager
    from fscl_tpu_torch.core.config import (TrainConfig, model_config_from_yaml,
                                            read_data_config, train_config_from_yaml)
    from fscl_tpu_torch.obs.loggers import (CheckpointCallback, LossTableLogger,
                                            TensorBoardLogger)
    from fscl_tpu_torch.data.datasets import FastSpeech2Dataset
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    from fscl_tpu_torch.train.trainer import Trainer
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.ops import attention as attn

    # base.yaml names no speaker table (one row) and the corpus has two
    # speakers: the port refuses that (fscl_tpu would train on NaN rows)
    model = root / "base-2spk.yaml"
    model.write_text((REPO / "config" / "model" / "base.yaml").read_text()
                     + f"\nspeaker:\n  n_speakers: {len(CLI_SPEAKERS)}\n")
    # warmup 10 and lr 2e-3 as phase 8 (the yaml's 4000-step warmup leaves
    # the rate near 0 for a run this short)
    overlay = cli_train_overlay(root, "baseline-overlay",
                                "optimizer:\n  lr: 0.002\n  warm_up_step: 10\n  anneal_steps: []\n"
                                "step:\n  log_step: 5\n  val_step: 10\n  save_step: 10\n")
    exp = root / "exp-baseline"
    args = ["train", "--system", "baseline", "--data_config", en, "--model_config", str(model),
            "--train_config", str(REPO / "config" / "train" / "baseline.yaml"),
            "--train_config", overlay, "--exp_dir", str(exp)]
    t = model_config_from_yaml(str(model)).transformer
    per_step = t.encoder_layer + t.decoder_layer
    out = {}
    probe = CliProbe()
    for run, extra in (("first", ["--total_step", str(CLI_STEPS)]),
                       ("resume", ["--resume", "--total_step", str(CLI_RESUME_STEPS)])):
        attn.LAUNCHES = 0
        with probe.active(), attention_shapes(attn, attn_checked, f"cli train {run}"):
            t0 = time.perf_counter()
            system, state = cli(args + extra)
            wall = time.perf_counter() - t0
        fit = probe.fits[-1]
        losses = probe.read_losses()
        if not all(math.isfinite(x) for x in losses):
            fail(f"cli train {run}: non-finite loss in {losses}")
        if attn.LAUNCHES != per_step * fit["steps"]:
            fail(f"cli train {run}: {attn.LAUNCHES} attention launches in {fit['steps']} steps")
        out[run] = {"steps": fit["steps"], "wall_s": wall, "fit_s": fit["seconds"],
                    "save_s_in_fit": fit["save_seconds"], "steps_per_s": fit["steps_per_s"],
                    "losses": losses, "attention_launches": attn.LAUNCHES}
        log(f"cli train {run}: {fit['steps']} steps in {fit['seconds']:.3f} s ({fit['save_seconds']:.3f} "
            f"s of it saving) = {fit['steps_per_s']:.2f} steps/s from the store (phase 8 on "
            f"prepared batches: {train['steps_per_s']:.2f}); the CLI call {wall:.2f} s; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; {attn.LAUNCHES} attention launches")
        del system, state
    resume = probe.restores[-1]
    if not (resume["full"] and resume["step"] == CLI_STEPS and resume["params_equal"]
            and resume["moments_equal"] and resume["count"] == CLI_STEPS):
        fail(f"cli resume: restored {resume}, expected step {CLI_STEPS} with the saved "
             "parameters and moments")
    losses = out["first"]["losses"] + out["resume"]["losses"]
    if not falling(losses):
        fail(f"cli train: loss did not fall: {losses}")
    log_txt, jsonl = exp / "log" / "log.txt", exp / "tb" / "metrics.jsonl"
    events = list((exp / "tb").glob("events.*"))
    if not log_txt.is_file() or not (jsonl.is_file() or events):
        fail(f"cli train: no loss table ({log_txt}) or metrics ({jsonl} or events)")
    n_logged = len(log_txt.read_text().splitlines())
    # the host's work per step: utterances read from the store and collated
    cfg = train_config_from_yaml([str(REPO / "config" / "train" / "baseline.yaml"), overlay])
    dc = read_data_config(en)
    mcfg = model_config_from_yaml(str(model))
    ds = FastSpeech2Dataset(dc.subset_path("train"), FeatureStore(dc.data_dir), dc, mcfg)
    stream = train_cmd.baseline_batches(ds, cfg, mcfg, None)
    next(stream)
    t0 = time.perf_counter()
    batches = [next(stream) for _ in range(CLI_STEPS)]
    batch_ms = 1e3 * (time.perf_counter() - t0) / CLI_STEPS
    shapes = [tuple(b.mels.shape[:2]) for b in batches]
    saves = list(probe.saves)
    # the same steps on those batches made beforehand, timed as the CLI's
    # run (saves inside the run taken out), four ways: bare, as phase 8
    # trains (one log at the end, no callbacks); "logs", the CLI's train
    # config and callbacks without its saves (a log every 5 steps reads the
    # metrics, which waits for the card, then the loss table and metrics
    # writer); "callbacks", with the saves too (every 10 steps); and
    # "reader", the callbacks while a thread makes batches from the store
    # at the prefetch thread's pace (at most `prefetch` ahead of the step)
    # and drops them: what the reading thread's Python takes from the step
    # (the GIL) rather than the step waiting for its batch. One system for
    # all, warmed up first, the four in turn twice, so that no variant pays
    # the first run's costs alone.
    torch.manual_seed(cfg.seed)
    system = BaselineSystem(mcfg, ((dc.symbol_id, n_symbols(dc.symbol_id)),), device="cuda",
                            optim_cfg=cfg.optim)
    bare = TrainConfig(optim=cfg.optim, total_step=CLI_STEPS, log_step=CLI_STEPS,
                       val_step=10**9, save_step=10**9, seed=cfg.seed)
    Trainer(system, bare).fit(system.init_state(), iter(batches))
    variants = {"bare": bare,
                "logs": dataclasses.replace(cfg, total_step=CLI_STEPS, save_step=10**9),
                "callbacks": dataclasses.replace(cfg, total_step=CLI_STEPS),
                "reader": dataclasses.replace(cfg, total_step=CLI_STEPS)}
    prepared = {label: [] for label in variants}
    reader_batches = []
    for rep in range(2):
        for label, run_cfg in variants.items():
            callbacks, tb = [], None
            if label != "bare":
                pexp = root / f"exp-{label}-{rep}"
                tb = TensorBoardLogger(str(pexp / "tb"))
                callbacks = [LossTableLogger(str(pexp / "log")), tb, CheckpointCallback(
                    CheckpointManager(str(pexp / "ckpt"), max_to_keep=5), system)]
            stop, made = threading.Event(), []

            def read():
                reader = train_cmd.baseline_batches(ds, cfg, mcfg, None)
                while not stop.is_set():
                    if len(made) < len(probe.losses) + run_cfg.prefetch:
                        made.append(next(reader).mels.shape[0])
                    else:
                        time.sleep(0.0005)

            thread = threading.Thread(target=read) if label == "reader" else None
            if thread is not None:
                thread.start()
            try:
                with probe.active():
                    Trainer(system, run_cfg, callbacks).fit(system.init_state(), iter(batches))
            finally:
                stop.set()
                if thread is not None:
                    thread.join()
                    reader_batches.append(len(made))
            if tb is not None:
                tb.close()
            prepared[label].append(probe.fits[-1]["steps_per_s"])
            probe.read_losses()
    del system
    out.update({
        "restored": resume, "saves": saves, "loss_table_lines": n_logged,
        "metrics": "metrics.jsonl" if jsonl.is_file() else "tensorboard events",
        "host_batch_ms": batch_ms, "batch_shapes": sorted(set(shapes)),
        "prepared_steps_per_s": prepared, "reader_batches": reader_batches,
        "ckpt_bytes": saves[-1]["bytes"], "save_ms": [s["ms"] for s in saves],
        "restore_ms": resume["ms"], "phase8_steps_per_s": train["steps_per_s"],
        "ckpt": str(exp / "ckpt")})
    save_ms = ", ".join(f"{s['ms']:.0f}" for s in saves)
    log(f"cli train: resume restored step {resume['step']} with parameters and moments equal "
        f"to the file; checkpoint {saves[-1]['bytes'] / 2**20:.1f} MiB, save {save_ms} ms, "
        f"restore {resume['ms']:.0f} ms; "
        f"host batch making {batch_ms:.2f} ms per step of B = 16 ({sorted(set(shapes))}); "
        f"the same {CLI_STEPS} steps on those batches made beforehand, steps/s in two rounds: "
        + ", ".join(f"{k} {' / '.join(f'{x:.2f}' for x in v)}" for k, v in prepared.items())
        + f" (the reader thread made {reader_batches} batches; the CLI's first run from the "
        f"store {out['first']['steps_per_s']:.2f}); "
        f"loss table {n_logged} lines, {out['metrics']}; on {card}")
    return out


def cli_synth(root: Path, en: str, seed: int, attn_checked, stage_checked, ckpt: str):
    """`synth --text_file` (CLI_LINES lines, batches of 8) with a HiFi-GAN V1
    checkpoint through both kernels, then one line on the card and on the
    CPU (mels held to phase 5's bar). The checkpoint is phase 12's baseline
    with its duration head pinned as phase 4 pins the random model's: 30
    training steps move the head's bias by a few hundredths, and lines would
    stay in the smallest bucket."""
    import numpy as np
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.cli import synth_cmd
    from fscl_tpu_torch.core.checkpoint import STATE_FILE, CheckpointManager
    from fscl_tpu_torch.core.config import model_config_from_yaml
    from fscl_tpu_torch.dsp.audio_io import load_wav
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops import mrf_stage as mrf

    raw = CheckpointManager(ckpt).restore()
    head = "model.variance_adaptor.duration_predictor.linear_layer."
    raw["params"][head + "weight"].mul_(0.1)
    raw["params"][head + "bias"].add_(math.log(5.0))
    pinned = root / "ckpt-synth" / f"step_{raw['step']:08d}"
    pinned.mkdir(parents=True)
    torch.save(raw, str(pinned / STATE_FILE))
    voc = root / "g_v1.pt"
    from torch_corpus import write_hifigan_checkpoint
    write_hifigan_checkpoint(str(voc), seed)
    lines = root / "lines.txt"
    lines.write_text("\n".join(LINES) + "\n")
    model = str(root / "base-2spk.yaml")
    common = ["synth", "--ckpt_dir", str(pinned.parent), "--data_config", en, "--model_config",
              model]
    attn.LAUNCHES, mrf.LAUNCHES = 0, 0
    stages = []

    def record_stage(orig):
        def call(x, *args):
            stages.append(tuple(x.shape))
            return orig(x, *args)
        return call

    serving = {}

    def time_serving(orig):
        def call(*args):
            t0 = time.perf_counter()
            out = orig(*args)
            serving["seconds"] = time.perf_counter() - t0
            return out
        return call

    with attention_shapes(attn, attn_checked, "cli synth"), \
            mock.patch.object(mrf, "mrf_stage_cuda", record_stage(mrf.mrf_stage_cuda)), \
            mock.patch.object(synth_cmd, "_run_batch", time_serving(synth_cmd._run_batch)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mels = cli(common + ["--text_file", str(lines), "--batch_size", "8", "--vocoder_ckpt",
                             str(voc), "--output", str(root / "wavs")])
        wall = time.perf_counter() - t0
    n_batches = math.ceil(len(LINES) / 8)
    t = model_config_from_yaml(model).transformer
    per_batch = 2 * t.encoder_layer + t.decoder_layer          # pass 1 + pass 2
    launches = {"attention_fwd": attn.LAUNCHES, "mrf_stage": mrf.LAUNCHES}
    # each line vocoded alone (fscl_tpu's _run_batch): 4 stage launches per line
    if launches != {"attention_fwd": per_batch * n_batches, "mrf_stage": 4 * len(LINES)}:
        fail(f"cli synth: launches {launches}, expected {per_batch} per batch of "
             f"{n_batches} and 4 per line of {len(LINES)}")
    hold_stage_shapes(stages, stage_checked, str(voc), "cli synth")
    samples = 0
    for i, mel in enumerate(mels):
        wav = load_wav(str(root / "wavs" / f"{i:04d}.wav"), 22050)
        if wav.shape != (mel.shape[0] * 256,) or not np_finite_bounded(wav) \
                or not np.isfinite(mel).all():
            fail(f"cli synth line {i}: wav {wav.shape} for {mel.shape[0]} frames, or not finite")
        samples += wav.shape[0]
    audio_s = samples / 22050
    log(f"cli synth: {len(mels)} lines in {n_batches} batches, {audio_s:.2f} s of audio in "
        f"{wall:.3f} s = {audio_s / wall:.1f} audio-s/s through the CLI (system and vocoder "
        f"built, checkpoints read, wavs written); of it the batches (mels, vocoder, Python "
        f"cuts, wav files) {serving['seconds']:.3f} s = {audio_s / serving['seconds']:.1f} "
        f"audio-s/s; mel_len {[m.shape[0] for m in mels]}; "
        f"{launches['attention_fwd']} attention + {launches['mrf_stage']} stage launches")

    line, L, T = cli_synth_line()
    got = {}
    for device in ("cuda", "cpu"):
        shapes = (attention_shapes(attn, attn_checked, "cli synth card vs CPU")
                  if device == "cuda" else contextlib.nullcontext())
        t0 = time.perf_counter()
        with shapes:
            (got[device],) = cli(common + ["--text", line, "--device", device, "--output",
                                           str(root / f"{device}.wav")])
        log(f"cli synth --text on {device}: {got[device].shape[0]} frames in "
            f"{time.perf_counter() - t0:.2f} s")
    if got["cuda"].shape != got["cpu"].shape:
        fail(f"cli synth card vs CPU: mel {got['cuda'].shape} vs {got['cpu'].shape}")
    err = float(np.abs(got["cuda"] - got["cpu"]).max())
    log(f"cli synth card vs CPU (L = {L}, T = {T}): max |postnet_mel| diff {err:.3g} "
        f"(atol {CARD_VS_CPU_ATOL})")
    if not err <= CARD_VS_CPU_ATOL:
        fail(f"cli synth card vs CPU: {err:.3g} > {CARD_VS_CPU_ATOL}")
    melgan = cli_synth_melgan(root, common, model, seed, attn_checked)
    return {"melgan": melgan,
            "lines": len(mels), "batches": n_batches, "audio_seconds": audio_s, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "batches_s": serving["seconds"],
            "batches_audio_s_per_s": audio_s / serving["seconds"], "mel_len": [int(m.shape[0]) for m in mels],
            "launches": launches, "card_vs_cpu": {"L": L, "T": T, "frames": got["cpu"].shape[0],
                                                  "max_abs_err": err}}


def cli_synth_melgan(root: Path, common, model: str, seed: int, attn_checked):
    """`synth --text --vocoder_ckpt` with the model YAML's `vocoder.model:
    MelGAN` and a melgan-neurips checkpoint in its weight-norm layout,
    written from the seed: no MRF stage launch; the card's wav against the
    same mel vocoded on the CPU (phase 7's bars); `--stream` refused, as
    fscl_tpu refuses it."""
    import numpy as np
    from fscl_tpu_torch.audio_out.vocoder import Vocoder
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops import mrf_stage as mrf
    from torch_corpus import write_melgan_checkpoint

    text = Path(model).read_text()
    if text.count('model: "HifiGAN"') != 1:
        fail(f"cli synth melgan: {model} names no single HifiGAN vocoder to replace")
    melgan_model = root / "base-2spk-melgan.yaml"
    melgan_model.write_text(text.replace('model: "HifiGAN"', 'model: "MelGAN"'))
    voc = root / "melgan.pt"
    write_melgan_checkpoint(str(voc), seed + 3)
    args = [a if a != model else str(melgan_model) for a in common]
    line, L, T = cli_synth_line()
    wavs = []

    def infer(orig):
        def call(self, mel):
            wav = orig(self, mel)
            wavs.append((self.kind, wav))
            return wav
        return call

    attn.LAUNCHES, mrf.LAUNCHES = 0, 0
    with attention_shapes(attn, attn_checked, "cli synth melgan"), \
            mock.patch.object(Vocoder, "infer", infer(Vocoder.infer)):
        t0 = time.perf_counter()
        (mel,) = cli(args + ["--text", line, "--vocoder_ckpt", str(voc), "--output",
                             str(root / "melgan.wav")])
        wall = time.perf_counter() - t0
    launches = {"attention_fwd": attn.LAUNCHES, "mrf_stage": mrf.LAUNCHES}
    kind, wav = wavs[-1]
    cpu_wav = Vocoder.from_checkpoint(str(voc), kind="MelGAN", device="cpu").infer(mel)
    err = np.abs(wav - cpu_wav) if wav.shape == cpu_wav.shape else np.full(1, np.inf)
    try:
        cli(args + ["--text", line, "--vocoder_ckpt", str(voc), "--stream", "--output",
                    str(root / "melgan-stream.wav")])
        refused = None
    except ValueError as e:
        refused = str(e)
    log(f"cli synth melgan ({kind}): {mel.shape[0]} frames -> {wav.shape[0]} samples in "
        f"{wall:.2f} s, {launches['attention_fwd']} attention + {launches['mrf_stage']} stage "
        f"launches; the card's wav vs the same mel vocoded on the CPU: mean |d| "
        f"{float(err.mean()):.3g} (bar {GEN_MEAN}), max {float(err.max()):.3g} (bar {GEN_MAX}); "
        f"--stream refused: {refused!r}")
    if kind != "MelGAN" or launches["mrf_stage"] != 0 or not launches["attention_fwd"] \
            or wav.shape != (mel.shape[0] * 256,) or not np_finite_bounded(wav):
        fail(f"cli synth melgan: vocoder {kind}, launches {launches}, wav {wav.shape} for "
             f"{mel.shape[0]} frames, or not finite")
    if not (float(err.mean()) < GEN_MEAN and float(err.max()) < GEN_MAX):
        fail(f"cli synth melgan card vs CPU: mean {float(err.mean()):.3g}, max "
             f"{float(err.max()):.3g}")
    if refused is None or "--stream" not in refused:
        fail(f"cli synth melgan: --stream with MelGAN was not refused ({refused!r})")
    return {"frames": int(mel.shape[0]), "wall_s": wall, "launches": launches,
            "wav_mean_abs_err": float(err.mean()), "wav_max_abs_err": float(err.max()),
            "stream_refused": refused}


def hold_stage_shapes(stages, stage_checked, voc, what: str) -> None:
    """The (B, C, T) stage shapes of a main path's run that phase 3 did not
    hold (a line vocoded alone runs at its own length): each held now, in
    float32, with the vocoder's own stage modules (`voc`: its checkpoint's
    path, or the generator) on random inputs, as phase 3 holds its shapes;
    added to `stage_checked`."""
    import torch
    from fscl_tpu_torch.audio_out.vocoder import Vocoder
    from fscl_tpu_torch.ops import mrf_stage as mrf

    new = sorted(set(stages) - stage_checked)
    if not new:
        return
    gen = (voc if isinstance(voc, torch.nn.Module)
           else Vocoder.from_checkpoint(voc, kind="HifiGAN", device=CARD).model)
    n = len(gen.resblock_kernel_sizes)
    by_c = {C: (gen.resblocks[i * n:(i + 1) * n], gen.conv_post if post else None)
            for i, (C, _, post) in enumerate(V1_STAGES)}
    g = torch.Generator(device=CARD).manual_seed(len(new))
    with torch.inference_mode():
        for B, C, T in new:
            rbs, post = by_c[C]
            check_stage(mrf, torch.randn(B, C, T, generator=g, device=CARD), rbs, post,
                        torch.float32, f"{what} T={T}")
            stage_checked.add((B, C, T))
    log(f"{what}: {len(new)} stage shapes not in phase 3 held to the plain version")


def cli_fscl(root: Path, en: str, zh: str, attn_checked, fscl):
    """`train --system fscl` on both corpora with config/model/fscl-fastspeech2.yaml
    (HuBERT-large drawn on the card from the train seed, d-vector
    speakers), config/algorithm/language/fscl.yaml (32 shots + 8 queries)
    and config/train/fscl.yaml + an overlay, CLI_FSCL_EPISODES episodes."""
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.ops import attention as attn

    overlay = cli_train_overlay(root, "fscl-overlay",
                                "optimizer:\n  lr: 0.002\n  warm_up_step: 5\n  anneal_steps: []\n"
                                f"step:\n  log_step: 1\n  save_step: {CLI_FSCL_EPISODES}\n")
    exp = root / "exp-fscl"
    probe = CliProbe()
    attn.LAUNCHES = 0
    with probe.active(), attention_shapes(attn, attn_checked, "cli fscl"):
        t0 = time.perf_counter()
        system, state = cli([
            "train", "--system", "fscl", "--data_config", en, "--data_config", zh,
            "--model_config", str(REPO / "config" / "model" / "fscl-fastspeech2.yaml"),
            "--algorithm_config", str(REPO / "config" / "algorithm" / "language" / "fscl.yaml"),
            "--train_config", str(REPO / "config" / "train" / "fscl.yaml"),
            "--train_config", overlay, "--exp_dir", str(exp),
            "--total_step", str(CLI_FSCL_EPISODES)])
        wall = time.perf_counter() - t0
    fit, losses = probe.fits[-1], probe.read_losses()
    per_episode = system.upstream.n_layers + system.model_cfg.transformer.encoder_layer + \
        system.model_cfg.transformer.decoder_layer
    if state.step != CLI_FSCL_EPISODES or not all(math.isfinite(x) for x in losses):
        fail(f"cli fscl: {state.step} episodes, losses {losses}")
    if attn.LAUNCHES != per_episode * CLI_FSCL_EPISODES:
        fail(f"cli fscl: {attn.LAUNCHES} attention launches, expected {per_episode} per episode")
    _, codebook0 = probe.systems[0]
    moved = any(not torch.equal(v, system.codebook.state_dict()[k]) for k, v in codebook0.items())
    saved = probe.saves[-1]
    from fscl_tpu_torch.core.checkpoint import CheckpointManager
    raw = CheckpointManager(str(exp / "ckpt")).restore()
    upstream_keys = [k for part in (raw["params"], raw["buffers"]) for k in part
                     if k.startswith("upstream.")]
    if upstream_keys or not moved:
        fail(f"cli fscl: upstream tensors in the checkpoint {upstream_keys[:3]}, or the codebook "
             "did not move")
    n_saved = sum(v.numel() for v in raw["params"].values())
    log(f"cli fscl: {CLI_FSCL_EPISODES} episodes in {fit['seconds']:.3f} s "
        f"({fit['save_seconds']:.3f} s saving) = {fit['steps_per_s']:.3f} episodes/s through the "
        f"CLI (phase 10, f32 upstream: {fscl['float32']['episodes_per_s']:.3f}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; codebook moved; checkpoint "
        f"{saved['bytes'] / 2**20:.1f} MiB ({n_saved / 1e6:.2f} M parameters, no upstream "
        f"tensor), save {saved['ms']:.0f} ms; the CLI call {wall:.2f} s")
    out = {"episodes": CLI_FSCL_EPISODES, "fit_s": fit["seconds"],
           "save_s_in_fit": fit["save_seconds"], "episodes_per_s": fit["steps_per_s"],
           "phase10_episodes_per_s": fscl["float32"]["episodes_per_s"], "losses": losses,
           "attention_launches": attn.LAUNCHES, "ckpt_bytes": saved["bytes"],
           "ckpt_parameters": n_saved, "save_ms": saved["ms"], "wall_s": wall,
           "ckpt": str(exp / "ckpt")}
    del system, state
    torch.cuda.empty_cache()
    return out


def cli_tune(root: Path, zh_tune: str, attn_checked, fscl_ckpt: str):
    """`tune --scan_adapt` (Adam, lr 1e-3, CLI_ADAPT_STEPS steps) to the
    32-utterance split from phase 12's FSCL checkpoint. The model config's
    d-vector speakers take the chunked path (`adapt_on_chip_chunked`,
    batches of 8 from the datamodule, one chunk)."""
    import numpy as np
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.cli import tune_cmd
    from fscl_tpu_torch.ops import attention as attn

    timed = {}

    def time_adapt(orig):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            timed["seconds"] = time.perf_counter() - t0
            return out
        return call

    exp = root / "exp-tune"
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "cli tune"), \
            mock.patch.object(tune_cmd, "adapt_on_chip_chunked",
                              time_adapt(tune_cmd.adapt_on_chip_chunked)):
        t0 = time.perf_counter()
        system, losses = cli([
            "tune", "--data_config", zh_tune, "--fscl_ckpt", fscl_ckpt,
            "--model_config", str(REPO / "config" / "model" / "fscl-fastspeech2.yaml"),
            "--exp_dir", str(exp), "--scan_adapt", "--scan_optimizer", "adam",
            "--scan_lr", "1e-3", "--adaptation_steps", str(CLI_ADAPT_STEPS)])
        wall = time.perf_counter() - t0
    curve = exp / "csv" / "zh" / "adaptation.csv"
    if not curve.is_file() or "seconds" not in timed:
        fail(f"cli tune: no {curve}, or the chunked adaptation did not run")
    rows = curve.read_text().splitlines()[1:]
    written = [float(r.split(",")[1]) for r in rows]
    if len(written) != CLI_ADAPT_STEPS or not np.array_equal(written, losses) \
            or not all(math.isfinite(x) for x in written) or not falling(written):
        fail(f"cli tune: adaptation.csv {written[:3]}... ({len(written)} rows) not finite and "
             "falling, or not the run's losses")
    steps_per_s = CLI_ADAPT_STEPS / timed["seconds"]
    log(f"cli tune: {CLI_ADAPT_STEPS} Adam steps in {timed['seconds']:.3f} s = "
        f"{steps_per_s:.2f} adaptation steps/s (chunked, d-vector speakers), loss "
        f"{written[0]:.4f} -> {written[-1]:.4f}; {attn.LAUNCHES} attention launches; the CLI call "
        f"{wall:.2f} s")
    del system
    torch.cuda.empty_cache()
    return {"steps": CLI_ADAPT_STEPS, "adapt_s": timed["seconds"], "steps_per_s": steps_per_s,
            "losses": written, "attention_launches": attn.LAUNCHES, "wall_s": wall}


# Phase 13: a raw corpus in the LJSpeech layout written from --seed: 32
# utterances of 1.5-10 s (LJSpeech: 1.1-10.1 s) at 22.05 kHz int16, about 3
# minutes of audio over the 2-10 s wav buckets (256 until PR 12, cut to make
# room for phase 16, then 128, cut for phase 18, then 64, cut for phase 14's
# T2U configurations; tests/torch_corpus.py:
# write_raw_corpus). `preprocess` runs once through the command line in a
# subprocess (world_device, 4 workers for --parse_raw), then the three pitch
# methods in process on RAW_INPROC of its utterances; the baseline trains
# RAW_TRAIN_STEPS steps from the store and a d-vector copy RAW_DVEC_STEPS
# steps before `synth --ref_wav`. RAW_UTTS is the depth to cut first.
RAW_UTTS, RAW_SECONDS, RAW_WORKERS = 32, (1.5, 10.0), 4
RAW_INPROC, RAW_CPU_UTTS, RAW_CHECK_B = 32, 8, 4
RAW_TRAIN_STEPS, RAW_DVEC_STEPS = 10, 5
# phase 13's device (a CPU rehearsal of the phase sets it to "cpu")
CARD = "cuda"
# The preprocessing bars, card against the CPU: tests/test_torch_preprocess.py's
# (log-mel atol 1e-4, energy rtol 1e-5 of each frame with 1e-4 absolute on
# near-zero frames; the d-vector mel at the log-mel bar); F0 voicing equal on
# 99 % of frames and, on frames voiced in both, a relative difference of
# median 1e-5 and max 1e-3. The one exception is DIO's refinement: a frame
# may pass 1e-3 by at most one integer lag (|sr / f_card - sr / f_cpu| <= 1
# sample), on at most 0.1 % of the voiced frames, and only where a run of
# `world_f0_batched` with `detail` on each device shows why: on one of the
# two the refinement fitted no parabola inside (-1, 1) lag (its peak at the
# tau range's edge, or flat: the integer lag or a clamped shift stands), or
# the two tau ranges start a lag apart (`tau_lo`). There a rounding-level
# change in the convolutions moves the refined lag by up to one lag (an H100
# against the CPU: one frame of 6529 5.5e-3 apart, 0.31 lag at tau ~ 56;
# PERF.md section 6). YIN and every other DIO frame keep max 1e-3.
PRE_MEL_ATOL, PRE_ENERGY_RTOL = 1e-4, 1e-5
PRE_VOICING, PRE_F0_MEDIAN, PRE_F0_MAX, PRE_F0_TAIL, PRE_F0_LAG = 0.99, 1e-5, 1e-3, 1e-3, 1.0
# the contour fix's operations per frame (two differences, two maxima, two
# products, six compares), for its bound beside its bytes
DIO_OPS_PER_FRAME = 12


def f0_agreement(got, want, valid=None, excused=None, sr: int = 22050):
    """Voicing agreement, and on frames voiced in both the median and max
    relative F0 difference, the share of frames beyond PRE_F0_MAX, the
    largest lag difference |sr / got - sr / want| among them and how many of
    them `excused` (a boolean mask like got; None excuses none) leaves
    unexplained."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    excused = np.zeros(got.shape, bool) if excused is None else np.asarray(excused)
    if valid is not None:
        got, want, excused = got[valid], want[valid], excused[valid]
    both = (got > 0) & (want > 0)
    rel = np.abs(got[both] - want[both]) / want[both]
    tail = rel > PRE_F0_MAX
    lag = np.abs(sr / got[both][tail] - sr / want[both][tail])
    return {"voicing_agreement": float(((got > 0) == (want > 0)).mean()),
            "f0_rel_median": float(np.median(rel)) if rel.size else 0.0,
            "f0_rel_max": float(rel.max()) if rel.size else 0.0,
            "frames_beyond": int(tail.sum()), "frames_voiced": int(both.sum()),
            "frames_unexcused": int((~excused[both][tail]).sum()),
            "frames_excusable": int(excused[both].sum()),
            "max_lag_beyond": float(lag.max()) if lag.size else 0.0}


def f0_passes(r) -> bool:
    return (r["voicing_agreement"] >= PRE_VOICING and r["f0_rel_median"] <= PRE_F0_MEDIAN
            and r["frames_beyond"] <= PRE_F0_TAIL * r["frames_voiced"]
            and r["frames_unexcused"] == 0 and r["max_lag_beyond"] <= PRE_F0_LAG)


def f0_held(got, want, what, valid=None, excused=None):
    r = f0_agreement(got, want, valid, excused)
    ok = f0_passes(r)
    log(f"{what}: voicing agreement {r['voicing_agreement']:.4f}, relative F0 diff median "
        f"{r['f0_rel_median']:.3g} max {r['f0_rel_max']:.3g}; {r['frames_beyond']} of "
        f"{r['frames_voiced']} frames beyond {PRE_F0_MAX} ({r['frames_unexcused']} unexplained; "
        f"{r['frames_excusable']} voiced frames excusable), within {r['max_lag_beyond']:.3g} "
        f"lags {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what}: F0 outside the bars (voicing {PRE_VOICING}, median {PRE_F0_MEDIAN}, "
             f"beyond {PRE_F0_MAX} on at most {PRE_F0_TAIL} of the frames, each explained by "
             f"the refinement's detail and by one lag at most)")
    return r


def dio_detail(wavs, lens, device):
    """`world_f0_batched` on (B, T) numpy wavs on `device`, with the
    refinement's detail: F0, and the frames where the card and the CPU may
    land up to a lag apart (no parabola fitted inside (-1, 1)), and tau_lo."""
    import torch
    from fscl_tpu_torch.dsp.world_device import world_f0_batched
    det = {}
    with torch.no_grad():
        f0 = world_f0_batched(torch.from_numpy(wavs).to(device),
                              torch.from_numpy(lens).to(device), 22050, 256, detail=det)
    return f0.cpu().numpy(), (~det["fitted"]).cpu().numpy(), det["tau_lo"].cpu().numpy()


def tf32_round(x):
    """A float32 tensor rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero, as `cvt.rna.tf32.f32`)."""
    import torch
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_conv_same(conv_same):
    """`conv_same` (`world_device._conv_same`) as a TF32 tensor-core filter
    computes it: signal and taps rounded to TF32, products summed in
    float32."""
    import torch

    def call(x, h):
        return conv_same(tf32_round(x), tf32_round(torch.from_numpy(h.copy())).numpy())
    return call


def dio_excused(card, cpu):
    """Frames a card-vs-CPU difference beyond 1e-3 may fall on (see the
    bars above), from two `dio_detail` results."""
    return card[1] | cpu[1] | (card[2] != cpu[2])


def check_f32_precision(what: str) -> None:
    """The port's entry points run float32 convolutions and products without
    TF32 (`core/device.py`); this script sets neither flag itself."""
    import torch
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if flags != (False, False):
        fail(f"{what}: TF32 flags (cudnn, matmul) are {flags}, not the port's (False, False)")


def bucket_batch(trims, bucket: int, B: int):
    """B rows of real audio at most `bucket` samples long, each longer than
    the bucket below it: corpus trims laid end to end (wrapping around), as
    (wavs, lengths) on the card."""
    import numpy as np
    import torch
    from fscl_tpu_torch.dsp.preprocess import WAV_BUCKETS
    below = max([0] + [b for b in WAV_BUCKETS if b < bucket])
    rows = np.zeros((B, bucket), np.float32)
    lens = np.zeros(B, np.int64)
    k = 0
    for r in range(B):
        target = below + 1 + (bucket - below - 1) * (r + 1) // (B + 1)
        n = 0
        while n < target:
            w = trims[k % len(trims)][: target - n]
            rows[r, n:n + len(w)] = w
            n += len(w)
            k += 1
        lens[r] = n
    return torch.from_numpy(rows).to(CARD), torch.from_numpy(lens).to(CARD)


def phase_preprocess(seed: int, card: str, attn_checked, stage_checked, profile: bool, out_dir):
    """Main path, preprocessing a raw corpus on the card, then training from
    the store it wrote and synthesizing with a reference wav."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="fscl_pre_"))
    try:
        sys.path.insert(0, str(REPO / "tests"))
        from torch_corpus import write_raw_corpus
        t0 = time.perf_counter()
        corpus, tg = write_raw_corpus(str(root / "raw" / "LJSpeech"), RAW_UTTS, seed + 90,
                                      RAW_SECONDS)
        write_s = time.perf_counter() - t0
        from scipy.io import wavfile
        durations = {p.stem: wavfile.read(str(p))[1].shape[0] / 22050
                     for p in sorted(Path(corpus, "wavs").glob("*.wav"))}
        audio_s = sum(durations.values())
        log(f"preprocess: wrote a raw corpus of {len(durations)} utterances, "
            f"{min(durations.values()):.2f}-{max(durations.values()):.2f} s, {audio_s / 60:.2f} "
            f"min of audio, in {write_s:.2f} s")
        out = {"utterances": len(durations), "audio_seconds": audio_s, "write_s": write_s}
        store = root / "store"
        steps = {}

        def step(name, fn, *args):
            t = time.perf_counter()
            res = fn(*args)
            steps[name] = time.perf_counter() - t
            return res

        out["cli"] = step("cli", preprocess_subprocess, corpus, tg, store, audio_s)
        out["methods"], items, counted = step("in_process", preprocess_in_process, root, store,
                                              tg, durations)
        out["kernel"] = step("kernel", check_dio_contour, items, store)
        out["card_vs_cpu"] = step("card_vs_cpu", preprocess_card_vs_cpu, root, store, items)
        if profile:
            out["profile"] = step("profile", profile_preprocess, root, store, items, out_dir)
        out["train"], out["synth"] = step("chain", preprocess_chain, root, store, corpus, seed,
                                          attn_checked, stage_checked)
        out["dio_contour_launches"] = counted
        out["step_s"] = steps
        out["phase_s"] = time.perf_counter() - t0
        log(f"phase 13 took {out['phase_s']:.1f} s: corpus {write_s:.1f} s, "
            + ", ".join(f"{k} {v:.1f} s" for k, v in steps.items()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def preprocess_subprocess(corpus: str, tg: str, store: Path, audio_s: float):
    """`python -m fscl_tpu_torch.cli preprocess` in a fresh interpreter, as a
    user runs it: its wall time, the stages it prints, utterances/s and
    audio-seconds/s, every utterance ok."""
    import re
    cmd = [sys.executable, "-m", "fscl_tpu_torch.cli", "preprocess", corpus, str(store),
           "--parser", "LJSpeech", "--parse_raw", "--preprocess", "--create_dataset",
           "--textgrid_dir", tg, "--pitch_method", "world_device",
           "--n_workers", str(RAW_WORKERS), "--device", CARD]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"preprocess CLI exited {proc.returncode}:\n{proc.stdout[-2000:]}"
             f"{proc.stderr[-3000:]}")
    text = proc.stdout
    parse = re.search(r"\[parse_raw\] (\d+) utterances in ([\d.]+) s", text)
    pre = re.search(r"\[preprocess\] (\d+)/(\d+) ok in ([\d.]+) s \(host prepare ([\d.]+) s, "
                    r"device ([\d.]+) s in (\d+) batches \((\d+) mel\), host finish ([\d.]+) s\), "
                    r"(\d+) contour-fix launches", text)
    if not parse or not pre or "[create_dataset]" not in text:
        fail(f"preprocess CLI: stages not reported:\n{text[-2000:]}")
    n_ok, n_all = int(pre.group(1)), int(pre.group(2))
    if not n_ok == n_all == int(parse.group(1)) == RAW_UTTS:
        fail(f"preprocess CLI: {n_ok}/{n_all} ok of {parse.group(1)} parsed, expected {RAW_UTTS}")
    mel_batches, launches = int(pre.group(7)), int(pre.group(9))
    # one per DIO batch on the card (none in a rehearsal on the CPU)
    if launches != (mel_batches if CARD != "cpu" else 0) or not mel_batches:
        fail(f"preprocess CLI: {launches} contour-fix launches for {mel_batches} mel batches "
             "(one per DIO batch expected)")
    res = {"wall_s": wall, "parse_raw_s": float(parse.group(2)),
           "stage2_s": float(pre.group(3)), "prepare_s": float(pre.group(4)),
           "device_s": float(pre.group(5)), "batches": int(pre.group(6)),
           "mel_batches": mel_batches, "dio_contour_launches": launches,
           "finish_s": float(pre.group(8)), "ok": n_ok,
           "utterances_per_s": RAW_UTTS / wall, "audio_s_per_s": audio_s / wall,
           "stage2_audio_s_per_s": audio_s / float(pre.group(3))}
    log(f"preprocess CLI (subprocess, world_device, {RAW_WORKERS} workers): {wall:.2f} s wall: "
        f"parse_raw {res['parse_raw_s']:.2f} s, stage 2 {res['stage2_s']:.2f} s (host prepare "
        f"{res['prepare_s']:.2f}, device {res['device_s']:.2f} in {res['batches']} batches, "
        f"{mel_batches} of them mel + DIO with {launches} contour-fix launches, host "
        f"finish {res['finish_s']:.2f}), create_dataset and the interpreter's start the rest; "
        f"{res['utterances_per_s']:.2f} utterances/s, {res['audio_s_per_s']:.1f} audio-s/s "
        f"({res['stage2_audio_s_per_s']:.1f} in stage 2); {n_ok}/{n_all} ok")
    return res


def store_items(store: Path, tg: str, n: int):
    from fscl_tpu_torch.data.feature_store import FeatureStore
    queries = FeatureStore(str(store)).load_metadata()[:n]
    return [(q, str(Path(tg, q["spk"], q["basename"] + ".TextGrid"))) for q in queries]


def linked_store(root: Path, store: Path, name: str):
    """A new store that shares `store`'s 22.05 and 16 kHz wavs (stage 1)."""
    from fscl_tpu_torch.data.feature_store import FeatureStore
    new = root / name
    new.mkdir()
    for feat in ("wav_22050", "wav_16000"):
        (new / feat).symlink_to(store / feat)
    return FeatureStore(str(new))


def preprocess_in_process(root: Path, store: Path, tg: str, durations):
    """Stage 2 on RAW_INPROC utterances of the store, once per pitch method,
    through `preprocess_utterances_batched` on the card: the host prepare /
    device / host finish split, the device passes counted, audio-s/s; then
    each bucket's batch of 16 timed alone (mel + energy, + F0 by each
    tracker, the d-vector STFT). Returns the rows, the items and the
    contour-fix launches of the world_device run."""
    import numpy as np
    import torch
    from fscl_tpu_torch.core.config import AudioConfig
    from fscl_tpu_torch.dsp import preprocess as pp
    from fscl_tpu_torch.ops import dio_contour as dc

    items = store_items(store, tg, RAW_INPROC)
    audio_s = sum(durations[q["basename"]] for q, _ in items)
    # warm-up (cuFFT plans, the C++ build, first launches), untimed
    pp.preprocess_utterances_batched(linked_store(root, store, "warm-up"), items[:16],
                                     pitch_method="world_device", device=CARD)
    rows = {}
    counted = None
    for method in ("world", "world_device", "yin_device"):
        st = linked_store(root, store, f"inproc-{method}")
        passes = []

        def count(orig):
            def call(wavs, lengths, audio, pitch_method=None):
                passes.append(tuple(wavs.shape))
                return orig(wavs, lengths, audio, pitch_method)
            return call

        timings = {}
        dc.LAUNCHES = 0
        with mock.patch.object(pp, "mel_energy_pitch", count(pp.mel_energy_pitch)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples, ok = pp.preprocess_utterances_batched(st, items, pitch_method=method,
                                                           device=CARD, timings=timings)
            wall = time.perf_counter() - t0
        launches = dc.LAUNCHES
        want = len(passes) if method == "world_device" else 0
        if len(ok) != len(items) or launches != want:
            fail(f"preprocess {method}: {len(ok)}/{len(items)} ok, {launches} contour-fix "
                 f"launches (expected {want}, one per mel batch)")
        if method == "world_device":
            counted = launches
        rows[method] = {"wall_s": wall, "prepare_ms": 1e3 * timings["prepare"],
                        "device_ms": 1e3 * timings["device"],
                        "finish_ms": 1e3 * timings["finish"], "batches": timings["batches"],
                        "mel_batches": passes, "audio_s_per_s": audio_s / wall,
                        "dio_contour_launches": launches}
        log(f"preprocess in process, {method}: {len(items)} utterances ({audio_s:.1f} s of "
            f"audio) in {wall:.3f} s = {audio_s / wall:.1f} audio-s/s: host prepare "
            f"{rows[method]['prepare_ms']:.1f} ms, device {rows[method]['device_ms']:.1f} ms "
            f"({timings['batches']} batches launched, then one synchronize), host finish "
            f"{rows[method]['finish_ms']:.1f} ms; mel batches {passes}; {launches} contour-fix "
            f"launches")
    check_f32_precision("preprocess in process")
    # each bucket's batch of 16 alone, on real trims
    from fscl_tpu_torch.data.feature_store import FeatureStore
    st = FeatureStore(str(root / "inproc-world_device"))
    trims22 = [st.wav_trim_22050.read_from_query(q) for q, _ in items]
    trims16 = [st.wav_trim_16000.read_from_query(q) for q, _ in items]
    audio = AudioConfig()
    used = sorted({b for b in pp.WAV_BUCKETS for t in trims22
                   if pp.bucket_len(len(t), pp.WAV_BUCKETS) == b})
    per_bucket = []
    for bucket in used:
        wavs, lens = bucket_batch(trims22, bucket, 16)
        w16, _ = bucket_batch(trims16, bucket * 16000 // 22050, 16)
        row = {"bucket_s": bucket / 22050, "B": 16}
        for name, method in (("mel_energy", None), ("mel_energy_world", "world_device"),
                             ("mel_energy_yin", "yin_device")):
            row[f"{name}_ms"] = cuda_time_ms(
                lambda: pp.mel_energy_pitch(wavs, lens, audio, method), 3, 1)
        row["dvec_ms"] = cuda_time_ms(lambda: pp.dvec_mel(w16), 5, 1)
        per_bucket.append(row)
        log(f"preprocess device pass, {row['bucket_s']:.0f} s bucket, B = 16: mel + energy "
            f"{row['mel_energy_ms']:.2f} ms, + DIO {row['mel_energy_world_ms']:.2f} ms, + YIN "
            f"{row['mel_energy_yin_ms']:.2f} ms, d-vector STFT {row['dvec_ms']:.2f} ms")
        del wavs, lens, w16
    rows["per_bucket"] = per_bucket
    torch.cuda.empty_cache()
    return rows, items, counted


def check_dio_contour(items, store: Path):
    """The contour-fix kernel bit for bit against its plain version at B = 16
    in every wav bucket, on the candidates DIO makes from the corpus's audio
    (laid end to end to fill the buckets the corpus does not reach); both
    timed in a CUDA graph (device time), the wrapper also back to back (its
    host cost per call), beside the bound: one read and one write of B * F
    floats, or the compares if those took longer."""
    import torch
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.dsp import preprocess as pp
    from fscl_tpu_torch.dsp.world_device import band_candidates
    from fscl_tpu_torch.ops import dio_contour as dc

    st = FeatureStore(str(store))
    trims = [st.wav_trim_22050.read_from_query(q) for q, _ in items]
    stream = torch.cuda.Stream()
    rows = []
    for bucket in pp.WAV_BUCKETS:
        wavs, _ = bucket_batch(trims, bucket, 16)
        with torch.no_grad():
            cand = band_candidates(wavs, 22050, 256, 71.0, 800.0).contiguous()
            want = dc.dio_contour_reference(cand)
            got = dc.dio_contour_cuda(cand)
        torch.cuda.synchronize()
        B, F = cand.shape
        if not torch.equal(got, want):
            fail(f"dio_contour at B={B} F={F}: {int((got != want).sum())} values differ from the "
                 "plain version")
        ms = graph_time_ms(lambda: dc.dio_contour_cuda(cand), 50, stream)
        plain_ms = graph_time_ms(lambda: dc.dio_contour_reference(cand), 20, stream)
        call_ms = cuda_time_ms(lambda: dc.dio_contour_cuda(cand), 50, 3)
        t_bytes = 2 * 4 * B * F / PEAK_BYTES_PER_S * 1e3
        t_ops = DIO_OPS_PER_FRAME * B * F / PEAK_FLOPS["float32"] * 1e3
        row = {"bucket_s": bucket / 22050, "B": B, "F": F, "ms": ms, "plain_ms": plain_ms,
               "call_ms": call_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": float((got - want).abs().max()),
               "changed": int((got != cand).sum()), "voiced": int((cand > 0).sum())}
        rows.append(row)
        log(f"dio_contour B={B} F={F:4d}: equal to the plain version bit for bit ({row['changed']} "
            f"of {row['voiced']} voiced candidates dropped); kernel {ms:.4f} ms ({call_ms:.4f} "
            f"per call back to back), plain {plain_ms:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']})")
    dc.LAUNCHES = 0          # comparison launches are not the main path's
    return rows


def store_close(a, b, q, what: str):
    """One utterance of two stores at the preprocessing bars; durations,
    phonemes and segments exactly."""
    import numpy as np
    for name in ("mfa_duration",):
        if not np.array_equal(getattr(a, name).read_from_query(q),
                              getattr(b, name).read_from_query(q)):
            fail(f"{what} {q['basename']}: {name} differs")
    for name in ("phoneme", "mfa_segment"):
        if getattr(a, name).read_from_query(q) != getattr(b, name).read_from_query(q):
            fail(f"{what} {q['basename']}: {name} differs")
    errs = {}
    for name, atol in (("mel", PRE_MEL_ATOL), ("spk_ref_mel_slices", PRE_MEL_ATOL)):
        x, y = getattr(a, name).read_from_query(q), getattr(b, name).read_from_query(q)
        errs[name] = float(np.abs(x - y).max())
        if x.shape != y.shape or not errs[name] <= atol:
            fail(f"{what} {q['basename']}: {name} {x.shape} vs {y.shape}, max diff "
                 f"{errs[name]:.3g} > {atol}")
    e1, e2 = a.energy.read_from_query(q), b.energy.read_from_query(q)
    errs["energy_rel"] = float((np.abs(e1 - e2) / np.maximum(np.abs(e2), 10.0)).max())
    if not errs["energy_rel"] <= PRE_ENERGY_RTOL:
        fail(f"{what} {q['basename']}: energy differs by {errs['energy_rel']:.3g} relative")
    return errs


def dio_card_and_cpu(trims, queries):
    """DIO with the refinement's detail on the card and on the CPU for each
    query's 22.05 kHz trim, batched by wav bucket: {basename: (F0 on the
    card, F0 on the CPU, excused)}, each of the utterance's frames."""
    import numpy as np
    from fscl_tpu_torch.dsp import preprocess as pp
    groups = {}
    for q in queries:
        groups.setdefault(pp.bucket_len(len(trims[q["basename"]]), pp.WAV_BUCKETS), []).append(q)
    out = {}
    for bucket, qs in groups.items():
        wavs = np.zeros((len(qs), bucket), np.float32)
        lens = np.zeros(len(qs), np.int64)
        for r, q in enumerate(qs):
            t = trims[q["basename"]]
            wavs[r, :len(t)], lens[r] = t, len(t)
        card, cpu = dio_detail(wavs, lens, CARD), dio_detail(wavs, lens, "cpu")
        excused = dio_excused(card, cpu)
        for r, q in enumerate(qs):
            nf = 1 + int(lens[r]) // 256
            out[q["basename"]] = (card[0][r, :nf], cpu[0][r, :nf], excused[r, :nf])
    return out


def preprocess_card_vs_cpu(root: Path, store: Path, items):
    """One batch per wav bucket of the corpus (B = RAW_CHECK_B) on the card
    and on the CPU: log-mel, energy, both trackers' F0 (DIO with the
    refinement's detail) and the d-vector mel. Two controls of the F0 bar,
    recorded, not held: DIO on the card with TF32 switched on, and with its
    filters in emulated TF32 (`tf32_conv_same`). Then RAW_CPU_UTTS of the store's utterances preprocessed again
    on the CPU (world_device) and held to the CLI's store."""
    import numpy as np
    import torch
    from fscl_tpu_torch.core.config import AudioConfig
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.dsp import preprocess as pp
    from fscl_tpu_torch.dsp import world_device as wd

    st = FeatureStore(str(store))
    trims = {}
    for q, _ in items:
        t = st.wav_trim_22050.read_from_query(q)
        trims.setdefault(pp.bucket_len(len(t), pp.WAV_BUCKETS), []).append(
            (t, st.wav_trim_16000.read_from_query(q)))
    audio = AudioConfig()
    res = {"buckets": []}
    pooled = {name: ([], [], []) for name in ("world", "yin", "tf32", "tf32_input")}
    for bucket in sorted(trims):
        pairs = trims[bucket][:RAW_CHECK_B]
        wavs = np.zeros((len(pairs), bucket), np.float32)
        w16 = np.zeros((len(pairs), bucket * 16000 // 22050), np.float32)
        lens = np.zeros(len(pairs), np.int64)
        for i, (a, b) in enumerate(pairs):
            wavs[i, :len(a)], w16[i, :len(b)], lens[i] = a, b, len(a)
        outs, dio = {}, {}
        for device in (CARD, "cpu"):
            w, l, v = (torch.from_numpy(x).to(device) for x in (wavs, lens, w16))
            with torch.no_grad():
                mel, energy, _ = pp.mel_energy_pitch(w, l, audio, None)
                f0y = pp.DEVICE_PITCH["yin_device"](w, l)
                outs[device] = [x.cpu().numpy() for x in (mel, energy, f0y, pp.dvec_mel(v))]
            dio[device] = dio_detail(wavs, lens, device)
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = dio_detail(wavs, lens, CARD)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        with mock.patch.object(wd, "_conv_same", tf32_conv_same(wd._conv_same)):
            tf32_input = dio_detail(wavs, lens, CARD)
        (mg, eg, yg, dg), (mc, ec, yc, dcpu) = outs[CARD], outs["cpu"]
        wg, wc = dio[CARD][0], dio["cpu"][0]
        valid = np.arange(wg.shape[1])[None, :] < (1 + lens // 256)[:, None]
        row = {"bucket_s": bucket / 22050, "B": len(pairs),
               "mel_max_abs": float(np.abs(mg - mc).max()),
               "energy_rel": float((np.abs(eg - ec) / np.maximum(np.abs(ec), 1e-4 / PRE_ENERGY_RTOL))
                                   .max()),
               "dvec_max_abs": float(np.abs(dg - dcpu).max()),
               "world": f0_agreement(wg, wc, valid, dio_excused(dio[CARD], dio["cpu"])),
               "yin": f0_agreement(yg, yc, valid),
               "world_tf32": f0_agreement(tf32[0], wc, valid, dio_excused(tf32, dio["cpu"]))}
        for name, got, want, excused in (
                ("world", wg, wc, dio_excused(dio[CARD], dio["cpu"])),
                ("yin", yg, yc, np.zeros(yg.shape, bool)),
                ("tf32", tf32[0], wc, dio_excused(tf32, dio["cpu"])),
                ("tf32_input", tf32_input[0], wc, dio_excused(tf32_input, dio["cpu"]))):
            for lst, x in zip(pooled[name], (got, want, excused)):
                lst.append(x[valid])
        if not (row["mel_max_abs"] <= PRE_MEL_ATOL and row["energy_rel"] <= PRE_ENERGY_RTOL
                and row["dvec_max_abs"] <= PRE_MEL_ATOL):
            fail(f"preprocess card vs CPU, {bucket / 22050:.0f} s bucket: {row}")
        log(f"preprocess card vs CPU, {bucket / 22050:.0f} s bucket, B = {len(pairs)}: log-mel "
            f"{row['mel_max_abs']:.3g}, energy {row['energy_rel']:.3g} relative, d-vector mel "
            f"{row['dvec_max_abs']:.3g} ok; F0 relative max DIO {row['world']['f0_rel_max']:.3g} "
            f"({row['world']['frames_beyond']} beyond 1e-3, {row['world']['frames_unexcused']} "
            f"unexplained), YIN {row['yin']['f0_rel_max']:.3g}; DIO with TF32 on "
            f"{row['world_tf32']['f0_rel_max']:.3g}, median "
            f"{row['world_tf32']['f0_rel_median']:.3g}")
        res["buckets"].append(row)
    for name, tracker in (("world", "DIO"), ("yin", "YIN")):
        got, want, excused = (np.concatenate(x) for x in pooled[name])
        res[name] = f0_held(got, want, f"card vs CPU {tracker}, every bucket", excused=excused)
    card_f0 = np.concatenate(pooled["world"][0])
    for name, what in (("tf32", "DIO on the card with TF32 on"),
                       ("tf32_input", "DIO on the card, its filters in emulated TF32")):
        got, want, excused = (np.concatenate(x) for x in pooled[name])
        r = f0_agreement(got, want, excused=excused)
        r = dict(r, passes=f0_passes(r), equal_to_tf32_off=bool(np.array_equal(got, card_f0)))
        res[f"world_{name}_control"] = r
        log(f"control, {what} vs the CPU, every bucket: voicing agreement "
            f"{r['voicing_agreement']:.4f}, relative F0 diff median {r['f0_rel_median']:.3g} "
            f"max {r['f0_rel_max']:.3g}; {r['frames_beyond']} of {r['frames_voiced']} frames "
            f"beyond {PRE_F0_MAX} ({r['frames_unexcused']} unexplained), within "
            f"{r['max_lag_beyond']:.3g} lags; F0 {'equal' if r['equal_to_tf32_off'] else 'not equal'}"
            f" to the card's with TF32 off: {'passes' if r['passes'] else 'fails'} the bar")
    # the CLI's store against the port on the CPU, utterance by utterance
    cpu = linked_store(root, store, "cpu-check")
    some = items[:RAW_CPU_UTTS]
    t0 = time.perf_counter()
    _, ok = pp.preprocess_utterances_batched(cpu, some, pitch_method="world_device", device="cpu")
    cpu_s = time.perf_counter() - t0
    if len(ok) != len(some):
        fail(f"preprocess on the CPU: {len(ok)}/{len(some)} ok")
    # the frames DIO's detail explains, from runs of the same utterances on
    # each device; whether those runs reproduce the two stores' F0 is counted
    detail = dio_card_and_cpu({q["basename"]: st.wav_trim_22050.read_from_query(q)
                               for q, _ in some}, [q for q, _ in some])
    errs, f0s, reproduced = [], ([], [], []), 0
    for q, _ in some:
        errs.append(store_close(st, cpu, q, "store vs CPU"))
        a, b = st.pitch.read_from_query(q), cpu.pitch.read_from_query(q)
        card_f0, cpu_f0, excused = detail[q["basename"]]
        reproduced += int(np.array_equal(a, card_f0[:len(a)])
                          and np.array_equal(b, cpu_f0[:len(b)]))
        for lst, x in zip(f0s, (a, b, excused[:len(a)])):
            lst.append(x)
    res["store_vs_cpu"] = {
        "utterances": len(some), "cpu_s": cpu_s,
        "mel_max_abs": max(e["mel"] for e in errs),
        "energy_rel": max(e["energy_rel"] for e in errs),
        "dvec_max_abs": max(e["spk_ref_mel_slices"] for e in errs),
        "f0_detail_reproduces": reproduced,
        "f0": f0_held(*(np.concatenate(x) for x in f0s[:2]), "store vs CPU F0",
                      excused=np.concatenate(f0s[2]))}
    log(f"store vs CPU F0: the detail runs reproduce both stores' F0 exactly for {reproduced} "
        f"of {len(some)} utterances")
    # the splits: monospeaker tail split of the ok utterances (template.py:103-115)
    from fscl_tpu_torch.data.feature_store import read_queries_from_txt
    queries = st.load_metadata()
    k = min(400, max(1, len(queries) // 10))
    splits = {n: [(q["spk"], q["basename"]) for q in
                  read_queries_from_txt(str(store / "splits" / f"{n}.txt"))]
              for n in ("train", "val", "test")}
    want = {"train": queries[:-2 * k], "val": queries[-2 * k:-k], "test": queries[-k:]}
    if any(splits[n] != [(q["spk"], q["basename"]) for q in want[n]] for n in want):
        fail("preprocess: the splits are not the monospeaker tail split")
    log(f"preprocess store vs the CPU ({len(some)} utterances, {cpu_s:.2f} s on the CPU): "
        f"log-mel {res['store_vs_cpu']['mel_max_abs']:.3g}, energy "
        f"{res['store_vs_cpu']['energy_rel']:.3g} relative, d-vector slices "
        f"{res['store_vs_cpu']['dvec_max_abs']:.3g}; durations, phonemes, segments and the "
        f"splits ({', '.join(f'{n} {len(v)}' for n, v in splits.items())}) equal")
    return res


def profile_preprocess(root: Path, store: Path, items, out_dir):
    """One traced world_device chunk (RAW_INPROC utterances, after one
    untraced): device busy share and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fscl_tpu_torch.dsp import preprocess as pp

    st = linked_store(root, store, "profiled")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp.preprocess_utterances_batched(st, items, pitch_method="world_device", device=CARD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_union_ms(prof)
    launches = sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunchKernel"))
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:80])
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    log(f"profile preprocess world_device chunk ({len(items)} utterances): wall "
        f"{1e3 * wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / (1e3 * wall):.1f}%), "
        f"{launches} kernel launches")
    for ms, n, name in kernels[:12]:
        log(f"  {ms:9.3f} ms {n:6d}x  {name}")
    if out_dir is not None:
        export_trace(prof, out_dir / "chip_smoke_preprocess_trace.json")
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "device_busy_share": busy / (1e3 * wall), "launches": launches,
            "top": [{"ms": ms, "calls": n, "name": k} for ms, n, k in kernels[:20]]}


def preprocess_chain(root: Path, store: Path, corpus: str, seed: int, attn_checked,
                     stage_checked):
    """`train` base.yaml RAW_TRAIN_STEPS steps at B = 16 from the new store
    (the loss falls), then a base.yaml copy with `speaker_emb: dvec` trained
    RAW_DVEC_STEPS steps, its duration head pinned as phase 12 pins it, and
    `synth --text --ref_wav <a store wav> --vocoder_ckpt <HiFi-GAN V1>`: a
    finite wav, the mel on the card against the CPU at phase 5's bar."""
    import numpy as np
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.core.checkpoint import STATE_FILE, CheckpointManager
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.dsp.audio_io import load_wav
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops import mrf_stage as mrf
    from torch_corpus import write_hifigan_checkpoint

    data = root / "lj.yaml"
    data.write_text(f"name: lj\nlang_id: 0\nsymbol_id: en\ndata_dir: {store}\n"
                    "text_cleaners: [basic_cleaners]\n"
                    f"subsets:\n  train: {store}/splits/train.txt\n"
                    f"  val: {store}/splits/val.txt\n")
    base = (REPO / "config" / "model" / "base.yaml").read_text()
    models = {"base": root / "base.yaml", "dvec": root / "base-dvec.yaml"}
    models["base"].write_text(base)
    models["dvec"].write_text(base + "\nspeaker_emb: dvec\n")
    out = {}
    probe = CliProbe()
    for name, steps in (("base", RAW_TRAIN_STEPS), ("dvec", RAW_DVEC_STEPS)):
        # warmup 10 and lr 2e-3 as phase 12; the d-vector model saves its
        # last step for `synth`
        overlay = cli_train_overlay(
            root, f"pre-overlay-{name}",
            "optimizer:\n  lr: 0.002\n  warm_up_step: 10\n  anneal_steps: []\n"
            f"step:\n  log_step: 5\n  val_step: 1000\n  save_step: {steps}\n")
        attn.LAUNCHES = 0
        with probe.active(), attention_shapes(attn, attn_checked, f"preprocess train {name}"):
            t0 = time.perf_counter()
            system, state = cli(["train", "--data_config", str(data), "--model_config",
                                 str(models[name]), "--train_config",
                                 str(REPO / "config" / "train" / "baseline.yaml"),
                                 "--train_config", overlay, "--exp_dir", str(root / f"exp-{name}"),
                                 "--total_step", str(steps)])
            wall = time.perf_counter() - t0
        check_f32_precision(f"preprocess train {name}")
        losses = probe.read_losses()
        fit = probe.fits[-1]
        if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
                or (name == "base" and not falling(losses)):
            fail(f"preprocess train {name}: losses {losses} not finite (and falling)")
        out[name] = {"steps": steps, "steps_per_s": fit["steps_per_s"], "wall_s": wall,
                     "losses": losses, "attention_launches": attn.LAUNCHES}
        log(f"preprocess train {name} from the new store: {steps} steps at "
            f"{fit['steps_per_s']:.2f} steps/s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"{attn.LAUNCHES} attention launches; the CLI call {wall:.2f} s")
        del system, state
    torch.cuda.empty_cache()

    raw = CheckpointManager(str(root / "exp-dvec" / "ckpt")).restore()
    head = "model.variance_adaptor.duration_predictor.linear_layer."
    raw["params"][head + "weight"].mul_(0.1)
    raw["params"][head + "bias"].add_(math.log(5.0))
    pinned = root / "ckpt-dvec" / f"step_{raw['step']:08d}"
    pinned.mkdir(parents=True)
    torch.save(raw, str(pinned / STATE_FILE))
    voc = root / "g_v1.pt"
    write_hifigan_checkpoint(str(voc), seed)
    q = FeatureStore(str(store)).load_metadata()[1]
    ref = str(Path(corpus, "wavs", q["basename"] + ".wav"))
    line, L, T = cli_synth_line()
    common = ["synth", "--ckpt_dir", str(pinned.parent), "--data_config", str(data),
              "--model_config", str(models["dvec"]), "--text", line, "--ref_wav", ref]
    stages = []

    def record_stage(orig):
        def call(x, *args):
            stages.append(tuple(x.shape))
            return orig(x, *args)
        return call

    attn.LAUNCHES = mrf.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "preprocess synth --ref_wav"), \
            mock.patch.object(mrf, "mrf_stage_cuda", record_stage(mrf.mrf_stage_cuda)):
        t0 = time.perf_counter()
        (mel,) = cli(common + ["--vocoder_ckpt", str(voc), "--output", str(root / "ref.wav")])
        wall = time.perf_counter() - t0
    launches = {"attention_fwd": attn.LAUNCHES, "mrf_stage": mrf.LAUNCHES}
    check_f32_precision("preprocess synth --ref_wav")
    wav = load_wav(str(root / "ref.wav"), 22050)
    if launches["mrf_stage"] != 4 or not launches["attention_fwd"] \
            or wav.shape != (mel.shape[0] * 256,) or not np_finite_bounded(wav):
        fail(f"preprocess synth --ref_wav: launches {launches}, wav {wav.shape} for "
             f"{mel.shape[0]} frames, or not finite")
    hold_stage_shapes(stages, stage_checked, str(voc), "preprocess synth --ref_wav")
    (cpu_mel,) = cli(common + ["--device", "cpu", "--output", str(root / "ref-cpu.wav")])
    err = float(np.abs(mel - cpu_mel).max()) if mel.shape == cpu_mel.shape else math.inf
    log(f"preprocess synth --ref_wav (d-vector of {q['basename']}): {mel.shape[0]} frames, "
        f"{launches['attention_fwd']} attention + {launches['mrf_stage']} stage launches, "
        f"{wall:.2f} s; card vs CPU mel max diff {err:.3g} (atol {CARD_VS_CPU_ATOL})")
    if not err <= CARD_VS_CPU_ATOL:
        fail(f"preprocess synth --ref_wav card vs CPU: {err:.3g} > {CARD_VS_CPU_ATOL}")
    return out, {"frames": int(mel.shape[0]), "wall_s": wall, "launches": launches,
                 "card_vs_cpu_max_abs": err}


# -- phase 14: the T2U family ---------------------------------------------------

# A corpus of 64 + 8 utterances of 1.5-10 s (130-860 mel frames at hop 256 /
# 22.05 kHz), 30-100 phonemes, with the frame-level pitch and energy that
# unit discovery averages (tests/torch_corpus.py:write_corpus); 512 units, the
# inventory of the reference's u2s card "512c" (config/model/fscl-t2u-e2e.yaml:
# 30). Depth, to cut first: the step and episode counts.
T2U_TRAIN, T2U_VAL, T2U_FRAMES, T2U_PHONES = 64, 8, (130, 860), (30, 100)
T2U_UNITS, T2U_UNIT_NAME = 512, "hubert-512c"
T2U_STEPS, U2S_STEPS = 10, 10          # B = 16 (config/train/baseline.yaml:3); 20 before phase 18
FSCL_T2U_CLI_EPISODES, FSCL_T2U_EPISODES = 3, 10
FSCL_T2U_SHOTS, FSCL_T2U_QUERIES = 32, 8    # config/algorithm/t2u/fscl.yaml
E2E_B, E2E_COUNTED = 4, 10                  # config/train/tune-t2s-1500.yaml:4
# The E2E tune on its stream at tune-t2s-1500.yaml's optimizer (Adam, betas
# 0.9 / 0.98, eps 1e-9, clip 1.0, the sqrt schedule to lr 1e-3), cut from
# the config's 1500 steps to E2E_STREAM and its 4000 warm-up steps with it
# (to 4000 * E2E_STREAM / 1500, so that the lr climbs over the run to the
# 3.75e-4 the config's 1500 steps reach), from the same start on one seed
# (the stream's draws and the dropout masks; two until PR 11, cut to keep
# the script near half its time limit once phase 15 came; 40 steps until
# PR 12, cut to 20 to make room for phase 16, and to 6 for the T2U
# configurations added beside it). Beside each run, a control at
# lr 0 on the same seed sees the same batches and masks, so the difference
# of their losses step by step is what the tune learned: B = 4 batches of
# 1.5-10 s utterances vary more from one to the next than 6 steps move the
# loss; it is read over the first and the last E2E_GAIN_STEPS. The held
# val batches' loss is read before and after each run, and
# after it with the T2U's BatchNorm statistics of the start. These are
# readings: at this schedule the tune beats its control over its first
# steps but not over its last 10 (at 40 steps, PR 10-11), as fscl_tpu's does
# (tests/test_torch_t2u.py holds the trajectory to it; PERF.md section 7),
# so the check that the chain learns is the one-batch fit at lr 2e-3.
E2E_STREAM, E2E_SEEDS, E2E_REF_STEPS, E2E_GAIN_STEPS = 6, 1, 1500, 3
# Card vs CPU: the teacher-forced logits of the T2U trained above through
# its 1024-wide recurrences (cuBLAS and the CPU's BLAS sum in another
# order, and the recurrence carries the differences step to step); the
# FSCL-T2U episode's table and eval loss through HuBERT-large's 24 f32
# layers and Downstream1 (phase 10's bars); one E2E step's loss and the
# global norm of its gradient (a sum over every T2U parameter of products
# through the u2s trunk's backward).
T2U_LOGIT_ATOL, T2U_TABLE_REL, T2U_LOSS_RTOL, T2U_GRAD_NORM_RTOL = 1e-3, 1e-4, 1e-4, 1e-3
# The E2E and DAE2E steps held card vs CPU run the T2U side on its first
# E2E_CHECK_T unit steps (the CPU steps the 1024-wide decoder one unit at a
# time, forward and backward: about 10 s a step over a whole batch); the
# u2s side keeps its length (the soft units are zero-padded to it).
E2E_CHECK_T = 64
# Serving: the 32 lines the text -> mel phases serve, in batches of 8; the
# two- and three-sentence lines take the L bucket 256, so the u2s runs over
# 10 L = 2560 unit positions.
T2U_LINES = LINES
# Released checkpoints: HuBERT-large drawn on the card from the seed (its
# biases and norm scales drawn too, and a final `encoder.layer_norm` as the
# released pre-LN files carry), written in each layout of T2U_LAYOUTS
# (tests/ssl_layouts.py) and read back by `models/hubert.py:
# load_torch_checkpoint` on the card; on phase 10's 8 wavs of 4 s (two cut
# to 3 s) every layer's hidden states within T2U_LAYOUT_REL of that layer's
# largest |value| in the original module's (the weight-norm fold rounds the
# positional conv's weights once). `make-units --upstream_ckpt` then reads
# make-units' own seeded weights from a fairseq container file.
T2U_LAYOUTS = ("hf_weight_g", "hf_parametrizations", "fairseq_container", "s3prl_container",
               "w2v_model_prefix")
T2U_LAYOUT_REL = 1e-5
T2U_CKPT_UNIT_NAME = "hubert-512c-ckpt"
# Scheduled sampling: the trained T2U at teacher-forcing ratios 0, 0.5 and 1
# on the first T2U_SCHEDULE_T unit steps of B = 4 lines, card vs CPU on the
# same drawn masks and teacher choices (T2U_LOGIT_ATOL). A sampled step reads
# the previous step's argmax, so the logits are held up to the first sampled
# step whose predecessor's argmax differs between card and CPU, which must
# be a near-tie (CPU top-2 margin below 2 * T2U_LOGIT_ATOL).
T2U_SCHEDULE_T, T2U_RATIOS = 64, (0.0, 0.5, 1.0)
# The FSCL-T2U configurations beside fscl-t2u, at fscl-t2u.yaml on the same
# corpus: the codebook variants (fscl-t2u-c: Downstream2's codeformer
# features; fscl-t2u-c2: Downstream1, then a codebook attention over the
# table), sharing the fscl-t2u system's HuBERT-large, T2U_VARIANT_EPISODES
# episodes of 32 + 8 each through Trainer.fit (every loss finite), each card
# vs CPU on the 4 + 2 episode beside fscl-t2u's (T2U_TABLE_REL,
# T2U_LOSS_RTOL); and the upstream stored in bf16 (`upstream.compute_dtype:
# bfloat16`) with the f32 system's weights: its table of the first 32 + 8
# episode and its 32-shot tune reference table each within
# FSCL_BF16_TABLE_REL of the f32 upstream's, then T2U_VARIANT_EPISODES
# episodes (3 until PR 17's attention checks).
T2U_VARIANTS = ("fscl-t2u-c", "fscl-t2u-c2")
T2U_VARIANT_EPISODES = 2
# The DA tunes: `train --system fscl-t2u-da-tune` through the CLI
# (T2UDADataModule; T2UConfig's defaults, B = 16) for T2U_DA_STEPS steps;
# DAE2ETuneSystem from the trained T2U through the frozen u2s at B = E2E_B,
# DAE2E_STEPS steps through Trainer.fit, one step card vs CPU (the E2E
# bars), and the discriminator's gradient into the unit probabilities
# through GradientReversal against -scale times the gradient without it
# (GRL_REL of its largest entry: the same backward in the same order).
T2U_DA_STEPS, DAE2E_STEPS = 5, 3
GRL_REL = 1e-6
# make-units from the CLI's default source (`mel`: k-means over the stored
# mel frames on the card, no model) and from the base upstream (`hubert`:
# 768 wide, 12 heads of 64, post-LN, group-norm extractor, drawn from the
# seed), each at the CLI's default 64 units; the base upstream's 13 hidden
# states card vs CPU on T2U_BASE_CHECK_WAVS wavs (4 s and 3 s), its biases
# and norm scales drawn too, within T2U_LAYOUT_REL of each layer's max.
T2U_MEL_UNIT_NAME, T2U_BASE_UNIT_NAME = "mel-64c", "hubert-base-64c"
T2U_BASE_CHECK_WAVS = 2


def t2u_attention_shapes(H: int, Dh: int):
    """The (B, H, L, Dh) the T2U family launches the attention kernel at:
    HuBERT-large (16 heads of 64) and the base upstream (12 heads of 64) in
    make-units' batches of 8 at every SSL wav bucket, the base upstream card
    vs CPU on 2 wavs of 4 s; HuBERT-large over the FSCL-T2U support sets
    (32 shots, the generic path's 4, the tune table's batches of 4) at every
    episode wav bucket; Downstream1 and Downstream2's encoder block (2 heads
    of 128) over the same support sets; the u2s trunk at B = 4 (E2E, DAE2E)
    at every text and mel bucket, and in chained serving at the 10 L unit
    positions of each served text bucket."""
    from fscl_tpu_torch.data.batch import MEL_BUCKETS as DATA_MEL_BUCKETS, TEXT_BUCKETS
    from fscl_tpu_torch.data.episodic import WAV_BUCKETS
    from fscl_tpu_torch.data.ssl_units import SSL_WAV_BUCKETS
    from fscl_tpu_torch.models.hubert import ssl_num_frames
    from fscl_tpu_torch.serve import L_BUCKETS
    shapes = [(8, heads, ssl_num_frames(w), 64) for heads in (16, 12) for w in SSL_WAV_BUCKETS]
    shapes.append((T2U_BASE_CHECK_WAVS, 12, ssl_num_frames(FSCL_WAV), 64))
    for S in (FSCL_T2U_SHOTS, 4):
        for w in WAV_BUCKETS:
            shapes += [(S, 16, ssl_num_frames(w), 64), (S, 2, ssl_num_frames(w), 128)]
    shapes += [(E2E_B, H, L, Dh) for L in (*TEXT_BUCKETS, *DATA_MEL_BUCKETS)]
    shapes += [(8, H, 10 * L, Dh) for L in L_BUCKETS]
    return shapes


def t2u_corpus(root: Path, seed: int):
    sys.path.insert(0, str(REPO / "tests"))
    from torch_corpus import write_corpus
    data = write_corpus(str(root), "en-t2u", "en", 0, seed + 60, n_train=T2U_TRAIN,
                        n_val=T2U_VAL, frames=T2U_FRAMES, n_phones=T2U_PHONES,
                        unit_name=T2U_UNIT_NAME)
    t2u = str(Path(data).with_name("t2u.yaml"))
    # the unit view for the u2s model card: the unit inventory as symbol set
    u2s = Path(data).with_name("u2s.yaml")
    u2s.write_text(Path(t2u).read_text().replace("symbol_id: en", f"symbol_id: {T2U_UNIT_NAME}"))
    return data, t2u, str(u2s)


def t2u_make_units(features: str, seed: int, attn_checked):
    """`make-units --source hubert_large_ll60k --n_units 512` through the CLI:
    HuBERT-large drawn on the card from the seed, its last layer over every
    utterance in wav buckets of 8, k-means on the card, DPDP on the host."""
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.data.ssl_units import make_upstream
    from fscl_tpu_torch.ops import attention as attn

    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "t2u make-units"):
        t0 = time.perf_counter()
        out = cli(["make-units", features, "--unit_name", T2U_UNIT_NAME, "--n_units",
                   str(T2U_UNITS), "--source", "hubert_large_ll60k", "--seed", str(seed)])
        wall = time.perf_counter() - t0
    store = FeatureStore(features)
    n = len(store.load_metadata())
    units = store.get_ssl_unit_store(T2U_UNIT_NAME)
    counts = [len(units.phoneme.read_from_query(q).split()) for q in store.load_metadata()]
    if out["utterances"] != n or units.load_attrs().get("n_units") != T2U_UNITS or min(counts) < 1:
        fail(f"t2u make-units: {out}, attrs {units.load_attrs()}, min units {min(counts)}")
    with torch.device("meta"):
        n_layers = make_upstream("hubert_large_ll60k").n_layers
    if attn.LAUNCHES == 0 or attn.LAUNCHES % n_layers:
        fail(f"t2u make-units: {attn.LAUNCHES} attention launches, not {n_layers} per batch")
    sec = out["seconds"]
    log(f"t2u make-units: {n} utterances in {wall:.2f} s = {n / wall:.2f} utterances/s "
        f"(upstream {1e3 * sec['upstream']:.0f} ms, k-means {1e3 * sec['kmeans']:.0f} ms, "
        f"logits + DPDP + store {1e3 * sec['units']:.0f} ms), {attn.LAUNCHES // n_layers} upstream "
        f"batches; units per utterance {min(counts)}-{max(counts)}")
    return {"utterances": n, "wall_s": wall, "utterances_per_s": n / wall,
            "upstream_ms": 1e3 * sec["upstream"], "kmeans_ms": 1e3 * sec["kmeans"],
            "units_ms": 1e3 * sec["units"], "units_per_utterance": [min(counts), max(counts)],
            "attention_launches": attn.LAUNCHES}


def t2u_make_units_sources(features: str, seed: int, attn_checked):
    """`make-units --source mel` (the CLI's default: k-means over the stored
    mel frames on the card, DPDP on the host, no model) and `--source
    hubert` (the base upstream drawn on the card from the seed: 12 attention
    launches per batch of 8) through the CLI at its default 64 units: every
    utterance gets units. Then the base upstream's 13 hidden states card vs
    CPU on T2U_BASE_CHECK_WAVS wavs."""
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.models.hubert import frozen_upstream_features, init_random_, make_upstream
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops.masking import length_mask

    store = FeatureStore(features)
    queries = store.load_metadata()
    with torch.device("meta"):
        n_layers = make_upstream("hubert").n_layers
    out = {}
    for source, name in (("mel", T2U_MEL_UNIT_NAME), ("hubert", T2U_BASE_UNIT_NAME)):
        what = f"t2u make-units --source {source}"
        attn.LAUNCHES = 0
        with attention_shapes(attn, attn_checked, what, launches=source != "mel"):
            t0 = time.perf_counter()
            res = cli(["make-units", features, "--unit_name", name, "--source", source,
                       "--seed", str(seed)])
            wall = time.perf_counter() - t0
        units = store.get_ssl_unit_store(name)
        counts = [len(units.phoneme.read_from_query(q).split()) for q in queries]
        launches_ok = (attn.LAUNCHES == 0 if source == "mel"
                       else attn.LAUNCHES > 0 and attn.LAUNCHES % n_layers == 0)
        if res["utterances"] != len(queries) or min(counts) < 1 or not launches_ok:
            fail(f"{what}: {res}, min units {min(counts)}, {attn.LAUNCHES} attention launches")
        sec = res["seconds"]
        log(f"{what}: {res['utterances']} utterances in {wall:.2f} s = "
            f"{res['utterances'] / wall:.2f} utterances/s (features {1e3 * sec['upstream']:.0f} "
            f"ms, k-means {1e3 * sec['kmeans']:.0f} ms, logits + DPDP + store "
            f"{1e3 * sec['units']:.0f} ms), {units.load_attrs().get('n_units')} units, "
            f"{min(counts)}-{max(counts)} per utterance; {attn.LAUNCHES} attention launches")
        out[source] = {"utterances": res["utterances"], "wall_s": wall,
                       "utterances_per_s": res["utterances"] / wall,
                       "units_per_utterance": [min(counts), max(counts)],
                       "attention_launches": attn.LAUNCHES}
    # the base upstream card vs CPU, biases and norm scales drawn too
    t0 = time.perf_counter()
    gen = torch.Generator(device=CARD).manual_seed(seed + 160)
    with torch.device("meta"):
        shell = make_upstream("hubert")
    card = shell.to_empty(device=CARD).eval().requires_grad_(False)
    init_random_(card, gen)
    with torch.no_grad():
        for p in card.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=CARD))
    with torch.device("meta"):
        shell = make_upstream("hubert")
    cpu = shell.to_empty(device="cpu").eval().requires_grad_(False)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    wavs, lens = query_speech(seed + 161, T2U_BASE_CHECK_WAVS + 2)
    wavs, lens = wavs[1:1 + T2U_BASE_CHECK_WAVS], lens[1:1 + T2U_BASE_CHECK_WAVS]
    hidden = {}
    for dev, module in (("card", card), ("cpu", cpu)):
        w = torch.from_numpy(wavs).to(CARD if dev == "card" else "cpu")
        valid = length_mask(torch.from_numpy(lens).to(w.device), w.shape[1])
        shapes = (attention_shapes(attn, attn_checked, "t2u base upstream card vs CPU")
                  if dev == "card" else contextlib.nullcontext())
        with shapes:
            hidden[dev] = frozen_upstream_features(module, w, valid)[0].cpu()
    peak = hidden["cpu"].abs().amax(dim=(0, 1, 3))
    errs = ((hidden["card"] - hidden["cpu"]).abs().amax(dim=(0, 1, 3)) / peak)
    seconds = time.perf_counter() - t0
    log(f"t2u base upstream card vs CPU ({T2U_BASE_CHECK_WAVS} wavs of {lens.tolist()} samples, "
        f"{hidden['cpu'].shape[2]} hidden states): max |d| / layer max {float(errs.max()):.3g} "
        f"(bar {T2U_LAYOUT_REL}; by layer " + ", ".join(f"{e:.2g}" for e in errs.tolist())
        + f"); {seconds:.2f} s")
    if hidden["cpu"].shape[2] != n_layers + 1 or not float(errs.max()) <= T2U_LAYOUT_REL:
        fail(f"t2u base upstream card vs CPU: {hidden['cpu'].shape[2]} hidden states, "
             f"{errs.tolist()}")
    del card, cpu
    torch.cuda.empty_cache()
    out["base_card_vs_cpu"] = {"max_rel_err": float(errs.max()),
                               "by_layer": errs.tolist(), "seconds": seconds}
    return out


def hubert_large_on_card():
    """HuBERT-large made without storage and placed on the card, frozen."""
    import torch
    from fscl_tpu_torch.models.hubert import make_upstream
    with torch.device("meta"):
        upstream = make_upstream("hubert_large_ll60k")
    return upstream.to_empty(device=CARD).eval().requires_grad_(False)


def t2u_upstream_layouts(seed: int, attn_checked):
    """HuBERT-large drawn on the card from the seed, written in each layout
    of T2U_LAYOUTS and loaded back through `load_torch_checkpoint` on the
    card: each layout's 25 hidden states against the original module's on 8
    wavs of 4 s, 24 attention launches per forward."""
    import torch
    from fscl_tpu_torch.models.hubert import (
        frozen_upstream_features, init_random_, load_torch_checkpoint)
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops.masking import length_mask
    sys.path.insert(0, str(REPO / "tests"))
    from ssl_layouts import layout

    t0 = time.perf_counter()
    gen = torch.Generator(device=CARD).manual_seed(seed + 150)
    original = hubert_large_on_card()
    init_random_(original, gen)
    with torch.no_grad():
        for p in original.parameters():
            if p.dim() == 1:        # biases and norm scales, 0 and 1 after init_random_
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=CARD))
    sd = dict(original.state_dict())
    for leaf, base in (("weight", 1.0), ("bias", 0.0)):
        sd[f"encoder.layer_norm.{leaf}"] = base + 0.1 * torch.randn(
            original.dim, generator=gen, device=CARD)
    wavs, lens = query_speech(seed + 151, 8)
    w = torch.from_numpy(wavs).to(CARD)
    valid = length_mask(torch.from_numpy(lens).to(CARD), w.shape[1])

    def hidden(module):
        attn.LAUNCHES = 0
        h, _ = frozen_upstream_features(module, w, valid)
        torch.cuda.synchronize()
        return h, attn.LAUNCHES

    loaded = hubert_large_on_card()
    errs, launches = {}, {}
    with attention_shapes(attn, attn_checked, "t2u upstream layouts"):
        want, launches["original"] = hidden(original)
        peak = want.abs().amax(dim=(0, 1, 3))
        for name in T2U_LAYOUTS:
            loaded.load_state_dict(load_torch_checkpoint(layout(name, sd), loaded), strict=True)
            got, launches[name] = hidden(loaded)
            errs[name] = float(((got - want).abs().amax(dim=(0, 1, 3)) / peak).max())
    seconds = time.perf_counter() - t0
    log(f"t2u upstream layouts (HuBERT-large, {len(sd)} keys, 8 wavs of 4 s): hidden states "
        f"max |d| / layer max " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (bar {T2U_LAYOUT_REL}); attention launches per forward {launches}; {seconds:.2f} s")
    if any(n != original.n_layers for n in launches.values()):
        fail(f"t2u upstream layouts: attention launches {launches}, not {original.n_layers} "
             f"per forward")
    if not all(e <= T2U_LAYOUT_REL for e in errs.values()):
        fail(f"t2u upstream layouts: {errs}")
    del original, loaded, sd, want
    torch.cuda.empty_cache()
    return {"max_rel_err": errs, "attention_launches": sum(launches.values()),
            "launches_per_forward": launches, "seconds": seconds}


def t2u_make_units_ckpt(root: Path, features: str, seed: int, attn_checked):
    """`make-units --upstream_ckpt`: make-units' own seeded HuBERT-large
    written as a fairseq container file, then read by the CLI; every
    utterance gets units, and the unit strings and frames' units equal to
    the seeded run's are counted (advisory: the file's weight-normed
    positional conv is folded back with one rounding, and k-means and the
    segmentation may then break ties otherwise)."""
    import numpy as np
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.models.hubert import init_random_
    from fscl_tpu_torch.ops import attention as attn
    sys.path.insert(0, str(REPO / "tests"))
    from ssl_layouts import layout

    t0 = time.perf_counter()
    upstream = hubert_large_on_card()
    init_random_(upstream, torch.Generator(device=CARD).manual_seed(seed))
    ckpt = root / "hubert_large_fairseq.pt"
    torch.save(layout("fairseq_container", {k: v.cpu() for k, v in upstream.state_dict().items()}),
               ckpt)
    n_layers = upstream.n_layers
    del upstream
    torch.cuda.empty_cache()
    t_write = time.perf_counter() - t0
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "t2u make-units --upstream_ckpt"):
        t1 = time.perf_counter()
        out = cli(["make-units", features, "--unit_name", T2U_CKPT_UNIT_NAME, "--n_units",
                   str(T2U_UNITS), "--source", "hubert_large_ll60k", "--seed", str(seed),
                   "--upstream_ckpt", str(ckpt)])
        wall = time.perf_counter() - t1
    store = FeatureStore(features)
    queries = store.load_metadata()
    mine, seeded = (store.get_ssl_unit_store(name) for name in (T2U_CKPT_UNIT_NAME, T2U_UNIT_NAME))
    strings = [(mine.phoneme.read_from_query(q), seeded.phoneme.read_from_query(q))
               for q in queries]
    counts = [len(a.split()) for a, _ in strings]
    same = sum(a == b for a, b in strings)

    def frame_units(unit_store, q):
        return np.repeat([int(u) for u in unit_store.phoneme.read_from_query(q).split()],
                         np.asarray(unit_store.duration.read_from_query(q)))
    pairs = [(frame_units(mine, q), frame_units(seeded, q)) for q in queries]
    frames_same = sum(int((a == b).sum()) for a, b in pairs if len(a) == len(b))
    frames = sum(len(b) for _, b in pairs)
    log(f"t2u make-units --upstream_ckpt (fairseq container, {ckpt.stat().st_size / 2**30:.2f} "
        f"GiB, written in {t_write:.2f} s): {out['utterances']} utterances in {wall:.2f} s, "
        f"{attn.LAUNCHES} attention launches; units per utterance {min(counts)}-{max(counts)}; "
        f"{same} of {len(queries)} unit strings and {frames_same} of {frames} frames' units "
        f"equal the seeded run's (advisory)")
    if out["utterances"] != len(queries) or min(counts) < 1 \
            or mine.load_attrs().get("n_units") != T2U_UNITS:
        fail(f"t2u make-units --upstream_ckpt: {out}, min units {min(counts)}")
    if attn.LAUNCHES == 0 or attn.LAUNCHES % n_layers:
        fail(f"t2u make-units --upstream_ckpt: {attn.LAUNCHES} attention launches, "
             f"not {n_layers} per batch")
    return {"utterances": out["utterances"], "wall_s": wall, "write_s": t_write,
            "ckpt_bytes": ckpt.stat().st_size, "attention_launches": attn.LAUNCHES,
            "equal_unit_strings": same, "equal_frame_units": [frames_same, frames],
            "seconds": time.perf_counter() - t0}


def t2u_scheduled_sampling(system, batch):
    """The trained T2U at teacher-forcing ratios 0, 0.5 and 1 (B = 4, the
    first T2U_SCHEDULE_T unit steps) on the card and on the CPU with the same
    masks and teacher choices; at ratio 1 the forward with the argument
    bit-equal to the one without, its generator left where the forward
    without it leaves it; one train step at 0.5 with a finite loss."""
    import torch
    from fscl_tpu_torch.models.tacotron2_t2u import draw_masks
    from fscl_tpu_torch.nn.losses import framewise_ce_loss
    from fscl_tpu_torch.systems.t2u import TacoT2USystem

    t0 = time.perf_counter()
    T = min(T2U_SCHEDULE_T, batch.units.shape[1])
    small = batch._replace(**{f: getattr(batch, f)[:4] for f in batch._fields
                              if getattr(batch, f) is not None})
    small = small._replace(units=small.units[:, :T], unit_lens=small.unit_lens.clamp(max=T))
    small_cpu = type(small)(*(None if x is None else x.cpu() for x in small))
    B, L = small.texts.shape
    cpu = TacoT2USystem(system.model_cfg, id2symbols_of(system), system.t2u_cfg, device="cpu")
    cpu.load_state_dict(system.state_dict(), strict=True)
    held = {}
    for ratio in T2U_RATIOS:
        masks = draw_masks(system.t2u_cfg, B, L, T, False, torch.Generator().manual_seed(8),
                           "cpu", ratio)
        on_card = type(masks)(*(None if m is None else m.to(CARD) for m in masks))
        with torch.no_grad():
            card, _ = system(small, on_card, tf_ratio=ratio)
            ref, _ = cpu(small_cpu, masks, tf_ratio=ratio)
        card = card.cpu()
        upto = T
        if masks.teacher is not None:
            differs = (card.argmax(-1) != ref.argmax(-1)).any(0)
            sampled = ~masks.teacher
            cut = [t for t in range(1, T) if sampled[t] and differs[t - 1]]
            if cut:
                upto = cut[0]
                top2 = ref[:, upto - 1].topk(2, dim=-1).values
                margin = float((top2[:, 0] - top2[:, 1]).min())
                if not margin < 2 * T2U_LOGIT_ATOL:
                    fail(f"t2u scheduled sampling at {ratio}: card and CPU argmax differ at "
                         f"step {upto - 1} with a top-2 margin of {margin:.3g}")
        err = float((card[:, :upto] - ref[:, :upto]).abs().max())
        n_sampled = 0 if masks.teacher is None else int((~masks.teacher).sum())
        held[ratio] = {"max_abs_err": err, "steps_held": upto, "sampled_steps": n_sampled}
        if not err <= T2U_LOGIT_ATOL:
            fail(f"t2u scheduled sampling at {ratio}: logits max |d| {err:.3g}")
    del cpu
    start = system.generator.get_state()
    with torch.no_grad():
        plain, _ = system(small)
        after_plain = system.generator.get_state()
        system.generator.set_state(start)
        one, _ = system(small, tf_ratio=1.0)
        after_one = system.generator.get_state()
    bit_equal = bool(torch.equal(plain, one)) and bool(torch.equal(after_plain, after_one))
    step_sys = TacoT2USystem(system.model_cfg, id2symbols_of(system), system.t2u_cfg,
                             device=CARD, optim_cfg=system.optim_cfg)
    step_sys.load_state_dict(system.state_dict(), strict=True)

    def loss_at_half(b):
        logits, _ = step_sys(b, None, tf_ratio=0.5)
        loss = framewise_ce_loss(logits, b.units)
        return loss, {"Total Loss": loss.detach()}

    step_sys.loss_and_metrics = loss_at_half
    state, metrics = step_sys.train_step(step_sys.init_state(), small)
    loss = float(metrics["Total Loss"])
    seconds = time.perf_counter() - t0
    log(f"t2u scheduled sampling (B={B}, T={T}): card vs CPU logits "
        + ", ".join(f"ratio {r}: max |d| {h['max_abs_err']:.3g} over {h['steps_held']} steps "
                    f"({h['sampled_steps']} sampled)" for r, h in held.items())
        + f" (bar {T2U_LOGIT_ATOL}); ratio 1 bit-equal to no argument, generator too: "
        f"{bit_equal}; one train step at 0.5: loss {loss:.4f}; {seconds:.2f} s")
    if not bit_equal:
        fail("t2u scheduled sampling: ratio 1 differs from the forward without the argument")
    if not math.isfinite(loss) or state.step != 1:
        fail(f"t2u scheduled sampling: train step at 0.5 gave loss {loss}")
    del step_sys
    return {"B": B, "T": T, "by_ratio": {str(r): h for r, h in held.items()},
            "ratio_1_bit_equal": bit_equal, "train_step_loss_at_half": loss, "seconds": seconds}


def decoder_step_cost(system, batch):
    """ms per teacher-forced decoder step (CUDA events over one no-grad
    forward, eval mode) and kernel launches per step (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    T = batch.units.shape[1]
    with torch.no_grad():
        system(batch)
        ms = cuda_time_ms(lambda: system(batch), iters=2, warmup=1)
        with tprofile(activities=[ProfilerActivity.CPU]) as prof:
            system(batch)
            torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunchKernel"))
    return {"T": T, "B": int(batch.units.shape[0]), "forward_ms": ms, "ms_per_step": ms / T,
            "launches_per_step": launches / T}


def t2u_train(root: Path, t2u: str, attn_checked, profile: bool, out_dir):
    """`train --system tacot2u` through the CLI, T2U_STEPS at B = 16
    (config/train/baseline.yaml + an overlay): T2UConfig's full width (the
    generic path passes no T2U config), a falling loss; the decoder's cost
    per step; with --profile a traced train step."""
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.data.datamodules import T2UDataModule
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems import factory

    overlay = cli_train_overlay(root, "t2u-overlay",
                                "optimizer:\n  lr: 0.002\n  warm_up_step: 5\n  anneal_steps: []\n"
                                f"step:\n  log_step: 1\n  save_step: {T2U_STEPS}\n")
    exp = root / "exp-tacot2u"
    probe = CliProbe()
    attn.LAUNCHES = 0
    with probe.active():
        t0 = time.perf_counter()
        system, state = cli(["train", "--system", "tacot2u", "--data_config", t2u,
                             "--train_config", str(REPO / "config" / "train" / "baseline.yaml"),
                             "--train_config", overlay, "--exp_dir", str(exp),
                             "--total_step", str(T2U_STEPS)])
        wall = time.perf_counter() - t0
    fit, losses = probe.fits[-1], probe.read_losses()
    c = system.t2u_cfg
    if c != factory.T2UConfig(n_units=c.n_units) or state.step != T2U_STEPS:
        fail(f"t2u train: config {c} is not T2UConfig's defaults, or {state.step} steps")
    if not all(math.isfinite(x) for x in losses) or not falling(losses):
        fail(f"t2u train: losses {losses}")
    dm = T2UDataModule([read_data_config(t2u)], system.model_cfg, t2u_train_config(16))
    dm.setup()
    batch = to_device(next(dm.train_batches()), CARD)
    cost = decoder_step_cost(system, batch)
    log(f"t2u train (tacot2u, encoder {c.encoder_embedding_dim}, RNNs {c.attention_rnn_dim}, "
        f"{c.n_units} unit symbols): {T2U_STEPS} "
        f"steps at B=16 in {fit['seconds']:.2f} s = {fit['steps_per_s']:.2f} steps/s; loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; {attn.LAUNCHES} attention launches; decoder "
        f"{cost['ms_per_step']:.3f} ms and {cost['launches_per_step']:.1f} launches per "
        f"teacher-forced step (B={cost['B']}, T={cost['T']}, no grad); the CLI call {wall:.1f} s")
    out = {"steps": T2U_STEPS, "steps_per_s": fit["steps_per_s"], "losses": losses,
           "decoder": cost, "wall_s": wall, "attention_launches": attn.LAUNCHES}
    if profile:
        # no trace file: 34k launches a step make one of hundreds of MB
        out["profile"] = profile_steps(lambda: system.train_step(state, batch), 1, None,
                                       "t2u_train")
    return system, batch, out


def t2u_train_config(batch_size: int, **step):
    """config/train/baseline.yaml with `batch_size`, lr 2e-3, warmup 5, no
    anneal, and `step` fields set."""
    import dataclasses
    from fscl_tpu_torch.core.config import train_config_from_yaml
    cfg = train_config_from_yaml(str(REPO / "config" / "train" / "baseline.yaml"))
    optim = dataclasses.replace(cfg.optim, batch_size=batch_size, lr=2e-3, warmup_step=5,
                                anneal_steps=())
    return dataclasses.replace(cfg, optim=optim, **step)


def id2symbols_of(system):
    return tuple((k[len("table-"):], v.shape[0]) for k, v in system.embedding_model.tables.items())


def t2u_card_vs_cpu_logits(system, batch):
    """The trained T2U's teacher-forced logits (eval mode, the same prenet
    masks) on the card and on the CPU."""
    import torch
    from fscl_tpu_torch.models.tacotron2_t2u import draw_masks
    from fscl_tpu_torch.systems.t2u import TacoT2USystem
    small = type(batch)(*(x[:4] for x in batch))
    small_cpu = type(small)(*(x.cpu() for x in small))
    B, L = small.texts.shape
    masks = draw_masks(system.t2u_cfg, B, L, small.units.shape[1], False,
                       torch.Generator().manual_seed(7), "cpu")
    cpu = TacoT2USystem(system.model_cfg, id2symbols_of(system), system.t2u_cfg, device="cpu")
    cpu.load_state_dict(system.state_dict(), strict=True)
    with torch.no_grad():
        card, _ = system(small, type(masks)(*(None if m is None else m.to(CARD) for m in masks)))
        ref, _ = cpu(small_cpu, masks)
    err = float((card.cpu() - ref).abs().max())
    log(f"t2u card vs CPU: teacher-forced logits (B={B}, T={small.units.shape[1]}) max |d| "
        f"{err:.3g} (bar {T2U_LOGIT_ATOL}), max |logit| {float(ref.abs().max()):.3g}")
    if not err <= T2U_LOGIT_ATOL:
        fail(f"t2u card vs CPU: logits max |d| {err:.3g}")
    del cpu
    return {"B": B, "T": int(small.units.shape[1]), "logits_max_abs_err": err}


def t2u_u2s(root: Path, t2u: str, u2s_cfg_path: str, attn_checked):
    """The u2s: a base.yaml BaselineSystem over the unit symbols trained
    U2S_STEPS steps at B = 16 on T2U2SDataModule's u2s side (as fscl_tpu's
    run_t2u does), saved, its model card written and read back."""
    import torch
    from fscl_tpu_torch.core.checkpoint import CheckpointManager
    from fscl_tpu_torch.core.config import model_config_from_yaml, read_data_config
    from fscl_tpu_torch.data.mix_datamodules import T2U2SDataModule
    from fscl_tpu_torch.frontend import n_symbols
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    from fscl_tpu_torch.systems.model_cards import (load_baseline_from_card, load_model_cards,
                                                    write_model_card)
    from fscl_tpu_torch.train.trainer import Trainer

    # base.yaml with a row per speaker of the corpus (it has one)
    base = root / "u2s-model.yaml"
    base.write_text((REPO / "config" / "model" / "base.yaml").read_text()
                    + "\nspeaker:\n  n_speakers: 2\n")
    base = str(base)
    model_cfg = model_config_from_yaml(base)
    train_cfg = t2u_train_config(16, log_step=1, save_step=10**9, val_step=10**9,
                                 synth_step=10**9)
    dm = T2U2SDataModule([read_data_config(t2u)], model_cfg, train_cfg)
    dm.setup()
    torch.manual_seed(11)
    u2s = BaselineSystem(model_cfg, ((T2U_UNIT_NAME, n_symbols(T2U_UNIT_NAME)),),
                         optim_cfg=train_cfg.optim)
    state = u2s.init_state()
    rec = LossRecorder()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "t2u u2s train"):
        t0 = time.perf_counter()
        Trainer(u2s, train_cfg, callbacks=[rec]).fit(
            state, (b.u2s for b in dm.train_batches()), max_steps=U2S_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    losses = [float(m["Total Loss"]) for _, m, _ in rec.logs]
    if not all(math.isfinite(x) for x in losses) or not falling(losses):
        fail(f"t2u u2s train: losses {losses}")
    ckpt = root / "exp-u2s" / "ckpt"
    CheckpointManager(str(ckpt)).save(state.step, u2s, state)
    cards = str(root / "model.json")
    write_model_card(cards, "u2s-512c", {"ckpt": str(ckpt), "config_paths": [u2s_cfg_path],
                                         "model_config": base})
    loaded = load_baseline_from_card(load_model_cards(cards)["u2s-512c"])
    same = all(torch.equal(a, b) for a, b in zip(u2s.state_dict().values(),
                                                 loaded.state_dict().values()))
    if not same:
        fail("t2u u2s: the model card's system differs from the trained one")
    log(f"t2u u2s (base.yaml over {n_symbols(T2U_UNIT_NAME)} unit symbols): {U2S_STEPS} steps "
        f"at B=16 in {wall:.2f} s, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
        f"{attn.LAUNCHES} attention launches; saved and reloaded through its model card")
    return loaded, {"steps": U2S_STEPS, "steps_per_s": U2S_STEPS / wall, "losses": losses,
                    "attention_launches": attn.LAUNCHES}


def t2u_fscl(root: Path, t2u: str, attn_checked):
    """`train --system fscl-t2u` through the CLI (config/model/fscl-t2u.yaml:
    HuBERT-large drawn on the card, Downstream1 at 256; the generic path's
    episodes of 4 + 2, ROADMAP Queue 3), then FSCL_T2U_EPISODES episodes of
    32 + 8 (config/algorithm/t2u/fscl.yaml) from T2UEpisodicDataModule on
    the same system, counted and timed (`t2u_fscl_card_vs_cpu` holds it card
    vs CPU beside the variants)."""
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.core.checkpoint import CheckpointManager
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.mix_datamodules import T2UEpisodicDataModule
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.train.trainer import Trainer

    overlay = cli_train_overlay(root, "fscl-t2u-overlay",
                                "optimizer:\n  lr: 0.002\n  warm_up_step: 5\n  anneal_steps: []\n"
                                f"step:\n  log_step: 1\n  save_step: {FSCL_T2U_CLI_EPISODES}\n")
    exp = root / "exp-fscl-t2u"
    probe = CliProbe()
    attn.LAUNCHES = 0
    with probe.active(), attention_shapes(attn, attn_checked, "t2u fscl-t2u cli"):
        system, state = cli([
            "train", "--system", "fscl-t2u", "--data_config", t2u,
            "--model_config", str(REPO / "config" / "model" / "fscl-t2u.yaml"),
            "--algorithm_config", str(REPO / "config" / "algorithm" / "t2u" / "fscl.yaml"),
            "--train_config", str(REPO / "config" / "train" / "fscl.yaml"),
            "--train_config", overlay, "--exp_dir", str(exp),
            "--total_step", str(FSCL_T2U_CLI_EPISODES)])
    cli_losses, cli_launches = probe.read_losses(), attn.LAUNCHES
    per_episode = system.upstream.n_layers + len(system.embedding_generator.layers)
    raw = CheckpointManager(str(exp / "ckpt")).restore()
    if any(k.startswith("upstream.") for k in raw["params"]) or \
            not all(math.isfinite(x) for x in cli_losses) or \
            cli_launches != per_episode * FSCL_T2U_CLI_EPISODES:
        fail(f"t2u fscl-t2u cli: losses {cli_losses}, {cli_launches} attention launches, "
             "or upstream tensors in the checkpoint")
    train_cfg = t2u_train_config(8, log_step=1, save_step=10**9, val_step=10**9,
                                 synth_step=10**9)
    dm = T2UEpisodicDataModule([read_data_config(t2u)], system.model_cfg, train_cfg,
                               shots=FSCL_T2U_SHOTS, queries=FSCL_T2U_QUERIES)
    dm.setup()
    rec = LossRecorder()
    gen0 = {k: v.clone() for k, v in system.embedding_generator.state_dict().items()}
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "t2u fscl-t2u episodes"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Trainer(system, train_cfg, callbacks=[rec]).fit(
            state, dm.train_batches(), max_steps=state.step + FSCL_T2U_EPISODES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    losses = [float(m["Total Loss"]) for _, m, _ in rec.logs]
    moved = any(not torch.equal(v, system.embedding_generator.state_dict()[k])
                for k, v in gen0.items())
    if not all(math.isfinite(x) for x in losses) or not falling(losses) or not moved or \
            attn.LAUNCHES != per_episode * FSCL_T2U_EPISODES:
        fail(f"t2u fscl-t2u episodes: losses {losses}, {attn.LAUNCHES} attention launches, "
             f"Downstream1 moved {moved}")
    log(f"t2u fscl-t2u: the CLI's {FSCL_T2U_CLI_EPISODES} episodes of 4 + 2 (loss "
        f"{cli_losses[0]:.3f} -> {cli_losses[-1]:.3f}, no upstream tensor in the checkpoint); "
        f"{FSCL_T2U_EPISODES} episodes of {FSCL_T2U_SHOTS} + {FSCL_T2U_QUERIES} in {wall:.2f} s "
        f"= {FSCL_T2U_EPISODES / wall:.3f} episodes/s, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
        f"{per_episode} attention launches per episode, Downstream1 moved")
    return system, {"cli_episodes": FSCL_T2U_CLI_EPISODES, "cli_losses": cli_losses,
                    "cli_attention_launches": cli_launches, "episodes": FSCL_T2U_EPISODES,
                    "episodes_per_s": FSCL_T2U_EPISODES / wall, "losses": losses,
                    "attention_launches": attn.LAUNCHES}


def t2u_episodes(t2u: str, model_cfg, shots: int, queries: int):
    """T2UEpisodicDataModule over the corpus at B = 8's train config."""
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.mix_datamodules import T2UEpisodicDataModule
    train_cfg = t2u_train_config(8, log_step=1, save_step=10**9, val_step=10**9,
                                 synth_step=10**9)
    dm = T2UEpisodicDataModule([read_data_config(t2u)], model_cfg, train_cfg, shots=shots,
                               queries=queries)
    dm.setup()
    return dm


def t2u_fscl_card_vs_cpu(systems, t2u: str, attn_checked):
    """One episode of 4 + 2 in eval mode through each FSCL-T2U system of
    `systems` (name -> system, all on one upstream) on the card and on the
    CPU (the same weights, the same prenet masks): the table and the loss.
    On the CPU the shared upstream's hidden states are computed once and
    given to every system."""
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.models.hubert import make_upstream
    from fscl_tpu_torch.models.tacotron2_t2u import draw_masks
    from fscl_tpu_torch.ops import attention as attn

    first = next(iter(systems.values()))
    ep = next(t2u_episodes(t2u, first.model_cfg, 4, 2).train_batches())
    up = first.model_cfg.upstream
    with torch.device("meta"):
        shell = make_upstream(up.name, up)
    cpu_upstream = shell.to_empty(device="cpu")
    cpu_upstream.load_state_dict({k: v.cpu() for k, v in first.upstream.state_dict().items()})
    B, L = ep.qry.texts.shape
    masks = draw_masks(first.t2u_cfg, B, L, ep.qry.units.shape[1], False,
                       torch.Generator().manual_seed(8), "cpu")
    hidden_cpu = None
    out = {}
    for name, system in systems.items():
        if system.upstream is not first.upstream:
            fail(f"t2u {name} card vs CPU: the systems held here share one upstream")
        t0 = time.perf_counter()
        cpu = type(system)(system.model_cfg, system.n_symbols, system.t2u_cfg, device="cpu",
                           upstream=cpu_upstream)
        missing, unexpected = cpu.load_state_dict(
            {k: v for k, v in system.state_dict().items() if not k.startswith("upstream.")},
            strict=False)
        if unexpected or any(not k.startswith("upstream.") for k in missing):
            fail(f"t2u {name} card vs CPU: copying the weights left {missing[:3]} / "
                 f"{unexpected[:3]}")
        got = {}
        for dev, s in (("card", system), ("cpu", cpu)):
            e = to_device(ep, CARD if dev == "card" else "cpu")
            m = type(masks)(*(None if x is None else x.to(e.qry.texts.device) for x in masks))
            shapes = (attention_shapes(attn, attn_checked, f"t2u {name} card vs CPU")
                      if dev == "card" else contextlib.nullcontext())
            with shapes, torch.no_grad():
                s.eval()
                if dev == "cpu" and hidden_cpu is None:
                    hidden_cpu = s.extract_ssl(e.sup.wavs, e.sup.wav_lens)
                cached = (mock.patch.object(s, "extract_ssl", lambda wavs, wav_lens: hidden_cpu)
                          if dev == "cpu" else contextlib.nullcontext())
                with cached:
                    hidden, _ = s.extract_ssl(e.sup.wavs, e.sup.wav_lens)
                    table = s.build_embedding_table(hidden, e.sup)
                    loss, _ = s.loss_and_metrics(e, masks=m)
            got[dev] = (table.cpu(), float(loss))
        (t_card, l_card), (t_cpu, l_cpu) = got["card"], got["cpu"]
        table_rel = float((t_card - t_cpu).abs().max() / t_cpu.abs().max())
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        log(f"t2u {name} card vs CPU (4 + 2, eval): table relative max |d| {table_rel:.3g} (bar "
            f"{T2U_TABLE_REL}), loss {l_card:.6f} / {l_cpu:.6f}, relative {loss_rel:.3g} (bar "
            f"{T2U_LOSS_RTOL}); {time.perf_counter() - t0:.2f} s")
        if not (table_rel <= T2U_TABLE_REL and loss_rel <= T2U_LOSS_RTOL):
            fail(f"t2u {name} card vs CPU: table {table_rel:.3g}, loss {loss_rel:.3g}")
        out[name] = {"table_rel": table_rel, "loss_cuda": l_card, "loss_cpu": l_cpu,
                     "loss_rel": loss_rel}
        del cpu
    return out


def t2u_fit_episodes(system, dm, n: int, what: str, attn_checked):
    """`n` episodes of `dm` through `Trainer.fit` from a fresh state: every
    loss finite, one attention launch per upstream layer and per downstream
    encoder block an episode. Returns (losses, launches, seconds)."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.train.trainer import Trainer

    per_episode = system.upstream.n_layers + len(system.embedding_generator.layers)
    rec = LossRecorder()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, what):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Trainer(system, dm.train_cfg, callbacks=[rec]).fit(system.init_state(),
                                                           dm.train_batches(), max_steps=n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    losses = [float(m["Total Loss"]) for _, m, _ in rec.logs]
    if len(losses) != n or not all(math.isfinite(x) for x in losses) \
            or attn.LAUNCHES != per_episode * n:
        fail(f"{what}: losses {losses}, {attn.LAUNCHES} attention launches (expected "
             f"{per_episode} per episode)")
    return losses, attn.LAUNCHES, wall


def t2u_fscl_variants(t2u: str, fscl, seed: int, attn_checked):
    """fscl-t2u-c and fscl-t2u-c2 (T2U_VARIANTS) at fscl-t2u.yaml, on the
    fscl-t2u system's upstream: T2U_VARIANT_EPISODES episodes of 32 + 8
    each. Returns the systems and their records."""
    import torch
    from fscl_tpu_torch.core.registry import SYSTEMS

    dm = t2u_episodes(t2u, fscl.model_cfg, FSCL_T2U_SHOTS, FSCL_T2U_QUERIES)
    systems, out = {}, {}
    for i, kind in enumerate(T2U_VARIANTS):
        torch.manual_seed(seed + 170 + i)
        system = SYSTEMS.get(kind)(fscl.model_cfg, fscl.n_symbols, fscl.t2u_cfg, device=CARD,
                                   optim_cfg=dm.train_cfg.optim, upstream=fscl.upstream)
        losses, launches, wall = t2u_fit_episodes(system, dm, T2U_VARIANT_EPISODES,
                                                  f"t2u {kind} episodes", attn_checked)
        log(f"t2u {kind} ({type(system).__name__}, {type(system.embedding_generator).__name__}): "
            f"{T2U_VARIANT_EPISODES} episodes of {FSCL_T2U_SHOTS} + {FSCL_T2U_QUERIES} in "
            f"{wall:.2f} s = {T2U_VARIANT_EPISODES / wall:.3f} episodes/s, loss "
            f"{' -> '.join(f'{x:.4f}' for x in losses)}, {launches} attention launches")
        systems[kind] = system
        out[kind] = {"episodes": T2U_VARIANT_EPISODES, "losses": losses,
                     "episodes_per_s": T2U_VARIANT_EPISODES / wall, "attention_launches": launches}
    return systems, out


def t2u_bf16_upstream(t2u: str, fscl, attn_checked):
    """The fscl-t2u system with its upstream stored in bf16 and the f32
    system's weights: the table of the first 32 + 8 episode and the 32-shot
    tune reference table (`t2u_build_reference_table`, SupInfo batches of
    4) against the f32 upstream's (FSCL_BF16_TABLE_REL), then
    T2U_VARIANT_EPISODES episodes of 32 + 8."""
    import torch
    from dataclasses import replace
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.data.datasets import FSCLDataset
    from fscl_tpu_torch.data.episodic import collate_sup_info
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.t2u import TransEmbT2USystem
    from fscl_tpu_torch.systems.t2u_tune import t2u_build_reference_table

    t0 = time.perf_counter()
    cfg = replace(fscl.model_cfg, upstream=replace(fscl.model_cfg.upstream,
                                                   compute_dtype="bfloat16"))
    dm = t2u_episodes(t2u, cfg, FSCL_T2U_SHOTS, FSCL_T2U_QUERIES)
    bf16 = TransEmbT2USystem(cfg, fscl.n_symbols, fscl.t2u_cfg, device=CARD,
                             optim_cfg=dm.train_cfg.optim)
    bf16.load_upstream(fscl.upstream.state_dict())
    missing, unexpected = bf16.load_state_dict(
        {k: v for k, v in fscl.state_dict().items() if not k.startswith("upstream.")},
        strict=False)
    if unexpected or any(not k.startswith("upstream.") for k in missing) \
            or next(bf16.upstream.parameters()).dtype != torch.bfloat16:
        fail(f"t2u bf16 upstream: the copy left {missing[:3]} / {unexpected[:3]}, or its "
             "upstream is not stored in bf16")
    ep = to_device(next(dm.train_batches()), CARD)
    tables, ref = {}, {}
    dc = read_data_config(t2u)
    ds = FSCLDataset(dc.subset_path("train"), FeatureStore(dc.data_dir), dc, cfg)
    shots = [ds[i] for i in range(FSCL_T2U_SHOTS)]
    sups = [collate_sup_info(shots[i:i + 4]) for i in range(0, FSCL_T2U_SHOTS, 4)]
    for name, s in (("float32", fscl), ("bfloat16", bf16)):
        s.eval()
        with attention_shapes(attn, attn_checked, f"t2u fscl-t2u table {name} upstream"), \
                torch.no_grad():
            hidden, _ = s.extract_ssl(ep.sup.wavs, ep.sup.wav_lens)
            tables[name] = s.build_embedding_table(hidden, ep.sup).float()
        attn.LAUNCHES = 0
        with attention_shapes(attn, attn_checked, f"t2u tune table {name} upstream"):
            ref[name] = t2u_build_reference_table(s, sups).float()
        ref_launches = attn.LAUNCHES
    rel = {k: float((d["bfloat16"] - d["float32"]).abs().max() / d["float32"].abs().max())
           for k, d in (("episode_table", tables), ("reference_table", ref))}
    per_batch = bf16.upstream.n_layers + len(bf16.embedding_generator.layers)
    log(f"t2u bf16 upstream: the {FSCL_T2U_SHOTS} + {FSCL_T2U_QUERIES} episode's table and the "
        f"{FSCL_T2U_SHOTS}-shot reference table ({len(sups)} SupInfo batches, {ref_launches} "
        f"attention launches) against the f32 upstream's, relative max |d| "
        f"{rel['episode_table']:.3g} / {rel['reference_table']:.3g} (bar {FSCL_BF16_TABLE_REL})")
    if not all(r <= FSCL_BF16_TABLE_REL for r in rel.values()) \
            or ref_launches != per_batch * len(sups):
        fail(f"t2u bf16 upstream: tables {rel}, {ref_launches} reference-table launches")
    losses, launches, wall = t2u_fit_episodes(bf16, dm, T2U_VARIANT_EPISODES,
                                              "t2u fscl-t2u bf16 upstream episodes", attn_checked)
    seconds = time.perf_counter() - t0
    log(f"t2u bf16 upstream: {T2U_VARIANT_EPISODES} episodes in {wall:.2f} s = "
        f"{T2U_VARIANT_EPISODES / wall:.3f} episodes/s, loss "
        f"{' -> '.join(f'{x:.4f}' for x in losses)}, {launches} attention launches; "
        f"{seconds:.2f} s")
    del bf16
    torch.cuda.empty_cache()
    return {"table_rel": rel, "reference_table_attention_launches": ref_launches,
            "losses": losses, "episodes_per_s": T2U_VARIANT_EPISODES / wall,
            "attention_launches": launches, "seconds": seconds}


def e2e_held_batches(dm, dc):
    """The val split's utterances as E2E batches of E2E_B (t2u and u2s views
    of the same utterances, as T2U2SDataModule pairs them)."""
    from fscl_tpu_torch.data.batch import collate_batch
    from fscl_tpu_torch.data.datamodules import collate_t2u
    from fscl_tpu_torch.data.datasets import UnitDataset
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.systems.t2u_tune import E2EBatch
    ds = UnitDataset(dc.subset_path("val"), FeatureStore(dc.data_dir), dc)
    samples = [ds[i] for i in range(len(ds))]
    return [E2EBatch(t2u=collate_t2u(samples[i:i + E2E_B]),
                     u2s=collate_batch([dm.u2s_sample(dc, x) for x in samples[i:i + E2E_B]],
                                       **dm._var_kw)[1])
            for i in range(0, len(samples) - E2E_B + 1, E2E_B)]


def e2e_held_loss(system, held, buffers=None) -> dict:
    """Mean total, T2U and U2S losses of the held batches in eval mode, each
    with the same prenet masks at every reading (the prenet drops out at
    inference too); with `buffers`, read with those BatchNorm statistics
    (the system's own are put back after)."""
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.models.tacotron2_t2u import draw_masks
    own = None
    if buffers is not None:
        own = {k: system.state_dict()[k].clone() for k in buffers}
        system.load_state_dict(buffers, strict=False)
    out = {"Total Loss": 0.0, "T2U Loss": 0.0, "U2S Loss": 0.0}
    system.eval()
    with torch.no_grad():
        for i, b in enumerate(held):
            B, L = b.t2u.texts.shape
            masks = draw_masks(system.t2u_cfg, B, L, b.t2u.units.shape[1], False,
                               torch.Generator().manual_seed(100 + i), "cpu")
            masks = type(masks)(*(None if m is None else m.to(system.device) for m in masks))
            _, metrics = system.loss_and_metrics(to_device(b, system.device), masks=masks)
            for k in out:
                out[k] += float(metrics[k]) / len(held)
    if own is not None:
        system.load_state_dict(own, strict=False)
    return out


def e2e_check_batch(batch):
    """An E2E or DAE2E batch with its T2U side cut to E2E_CHECK_T unit steps."""
    import numpy as np
    t2u = batch.t2u
    T = min(E2E_CHECK_T, t2u.units.shape[1])
    return batch._replace(t2u=t2u._replace(units=t2u.units[:, :T],
                                           unit_lens=np.minimum(t2u.unit_lens, T)))


def t2u_e2e(t2u: str, tacot2u, fscl, u2s, seed: int, attn_checked):
    """`t2u_tune_init` (the 32-shot split's table through the FSCL-T2U
    system) into an E2ETuneSystem that starts from the trained T2U, chained
    through the frozen u2s. Then, from that start: E2E_COUNTED steps at
    B = 4 on one batch at lr 2e-3 (its loss falls: the gradient's sign
    through the chain; launches counted, the u2s unchanged); for each of
    E2E_SEEDS seeds, E2E_STREAM steps on the stream at tune-t2s-1500.yaml's
    optimizer, its warm-up cut with the run, and the same steps at lr 0 on
    the same batches and masks, the difference of their losses and the held
    val loss read after each (the second seed's tune timed); one step's
    loss and gradient norm card vs CPU."""
    import dataclasses
    import torch
    from fscl_tpu_torch.core.config import read_data_config, train_config_from_yaml
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.data.datasets import FSCLDataset
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.data.episodic import collate_sup_info
    from fscl_tpu_torch.data.mix_datamodules import T2U2SDataModule
    from fscl_tpu_torch.models.tacotron2_t2u import draw_masks
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    from fscl_tpu_torch.systems.t2u_tune import E2ETuneSystem, t2u_tune_init
    from fscl_tpu_torch.train.trainer import Trainer

    dc = read_data_config(t2u)
    steps = dict(log_step=1, save_step=10**9, val_step=10**9, synth_step=10**9)
    fit_cfg = t2u_train_config(E2E_B, **steps)
    ref = train_config_from_yaml(str(REPO / "config" / "train" / "tune-t2s-1500.yaml"))
    if ref.total_step != E2E_REF_STEPS:
        fail(f"tune-t2s-1500.yaml runs {ref.total_step} steps, not {E2E_REF_STEPS}")
    warmup = round(ref.optim.warmup_step * E2E_STREAM / E2E_REF_STEPS)
    ref_cfg = dataclasses.replace(ref, optim=dataclasses.replace(ref.optim, warmup_step=warmup),
                                  **steps)

    def build(u2s_system, device):
        return E2ETuneSystem(u2s.model_cfg, id2symbols_of(tacot2u), tacot2u.t2u_cfg, u2s_system,
                             device=device, u2s_symbol_id=T2U_UNIT_NAME)

    e2e = build(u2s, CARD)
    missing, unexpected = e2e.load_state_dict(tacot2u.state_dict(), strict=False)
    if unexpected or any(not k.startswith("u2s_system.") for k in missing):
        fail(f"t2u e2e: loading the trained T2U left {missing[:3]} / {unexpected[:3]}")
    ds = FSCLDataset(dc.subset_path("train"), FeatureStore(dc.data_dir), dc, fscl.model_cfg)
    shots = [ds[i] for i in range(FSCL_T2U_SHOTS)]
    sups = [collate_sup_info(shots[i:i + 4]) for i in range(0, FSCL_T2U_SHOTS, 4)]
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "t2u tune_init"):
        t0 = time.perf_counter()
        table = t2u_tune_init(fscl, e2e, sups, dc.symbol_id)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    init_launches = attn.LAUNCHES
    if not torch.isfinite(table).all():
        fail("t2u tune_init: non-finite table")
    start = {k: v.clone() for k, v in e2e.state_dict().items()
             if not k.startswith("u2s_system.")}
    u2s0 = {k: v.clone() for k, v in e2e.u2s_system.state_dict().items()}
    per_step = u2s.model_cfg.transformer.encoder_layer + u2s.model_cfg.transformer.decoder_layer

    def fit(train_cfg, batches, n_steps, run_seed):
        e2e.load_state_dict(start, strict=False)
        e2e.optim_cfg = train_cfg.optim
        e2e.generator.manual_seed(run_seed)
        rec = LossRecorder()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Trainer(e2e, train_cfg, callbacks=[rec]).fit(e2e.init_state(), batches,
                                                     max_steps=n_steps)
        torch.cuda.synchronize()
        return [float(m["Total Loss"]) for _, m, _ in rec.logs], time.perf_counter() - t0

    # the gradient's sign through the chain: one batch, lr 2e-3
    dm = T2U2SDataModule([dc], u2s.model_cfg, fit_cfg)
    dm.setup()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "t2u e2e tune"):
        fit_losses, _ = fit(fit_cfg, itertools.repeat(next(dm.train_batches())), E2E_COUNTED,
                            seed)
        counted_launches = attn.LAUNCHES
        # the tune on its stream at the reference's optimizer, each run
        # beside its lr-0 control
        held = e2e_held_batches(dm, dc)
        bn0 = {k: v for k, v in start.items() if "running_" in k or "num_batches" in k}
        e2e.load_state_dict(start, strict=False)
        held0 = e2e_held_loss(e2e, held)
        control_cfg = dataclasses.replace(
            ref_cfg, optim=dataclasses.replace(ref_cfg.optim, lr=0.0))
        runs = []
        for run_seed in range(seed, seed + E2E_SEEDS):
            run = {"seed": run_seed}
            for name, cfg in (("tune", ref_cfg), ("control", control_cfg)):
                cfg = dataclasses.replace(cfg, seed=run_seed)
                stream = T2U2SDataModule([dc], u2s.model_cfg, cfg)
                stream.setup()
                losses, wall = fit(cfg, stream.train_batches(), E2E_STREAM, run_seed)
                run[name] = {"stream_losses": losses, "wall_s": wall,
                             "steps_per_s": E2E_STREAM / wall, "held": e2e_held_loss(e2e, held),
                             "held_start_bn": e2e_held_loss(e2e, held, bn0)}
            gain = [a - b for a, b in zip(run["tune"]["stream_losses"],
                                          run["control"]["stream_losses"])]
            n = E2E_GAIN_STEPS
            run["gain_first"], run["gain_last"] = sum(gain[:n]) / n, sum(gain[-n:]) / n
            runs.append(run)
    unchanged = all(torch.equal(v, e2e.u2s_system.state_dict()[k]) for k, v in u2s0.items())
    finite = all(math.isfinite(x) for r in runs for k in ("tune", "control")
                 for x in r[k]["stream_losses"])
    if not all(math.isfinite(x) for x in fit_losses) or not falling(fit_losses) or \
            not unchanged or counted_launches != per_step * E2E_COUNTED or not finite:
        fail(f"t2u e2e: one-batch losses {fit_losses}, u2s unchanged {unchanged}, "
             f"{counted_launches} attention launches (expected {per_step} per step: the u2s "
             f"trunk's forward); stream runs {runs}")
    # one step card vs CPU: the loss and the gradient's global norm
    batch = e2e_check_batch(next(stream.train_batches()))
    B, L = batch.t2u.texts.shape
    masks = draw_masks(e2e.t2u_cfg, B, L, batch.t2u.units.shape[1], True,
                       torch.Generator().manual_seed(9), "cpu")
    cpu = build(BaselineSystem(u2s.model_cfg, id2symbols_of(u2s), device="cpu"), "cpu")
    cpu.load_state_dict(e2e.state_dict(), strict=True)
    got = {}
    for name, s in (("card", e2e), ("cpu", cpu)):
        m = type(masks)(*(None if x is None else x.to(s.device) for x in masks))
        s.train()
        loss, _ = s.loss_and_metrics(to_device(batch, s.device), masks=m)
        params = [p for n, p in s.named_parameters() if s.trainable_mask()[n]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        s.eval()
        got[name] = (float(loss.detach()), float(torch.sqrt(sum((g.double() ** 2).sum()
                                                       for g in grads if g is not None))))
    (l_card, g_card), (l_cpu, g_cpu) = got["card"], got["cpu"]
    loss_rel, grad_rel = abs(l_card - l_cpu) / abs(l_cpu), abs(g_card - g_cpu) / g_cpu
    del cpu
    steps_per_s = runs[-1]["tune"]["steps_per_s"]
    log(f"t2u e2e: tune_init of a {FSCL_T2U_SHOTS}-shot split in {1e3 * init_s:.0f} ms "
        f"({init_launches} attention launches); {E2E_COUNTED} steps at B={E2E_B} on one batch "
        f"(lr 2e-3) through the frozen u2s, loss {fit_losses[0]:.3f} -> {fit_losses[-1]:.3f}, "
        f"u2s unchanged, {per_step} attention launches per step")
    fmt = "total {Total Loss:.5f} (T2U {T2U Loss:.5f}, U2S {U2S Loss:.7f})".format
    n = E2E_GAIN_STEPS
    log(f"t2u e2e held val loss ({len(held)} batches) at the start: {fmt(**held0)}")
    for r in runs:
        t, c = r["tune"], r["control"]
        log(f"t2u e2e (tune-t2s-1500.yaml's optimizer, warm-up {ref_cfg.optim.warmup_step}, "
            f"seed {r['seed']}): {E2E_STREAM} stream steps at B={E2E_B} in {t['wall_s']:.2f} s "
            f"= {t['steps_per_s']:.2f} steps/s; stream loss mean of the first / last {n} steps "
            f"{sum(t['stream_losses'][:n]) / n:.5f} / {sum(t['stream_losses'][-n:]) / n:.5f}, "
            f"the lr-0 control's {sum(c['stream_losses'][:n]) / n:.5f} / "
            f"{sum(c['stream_losses'][-n:]) / n:.5f}: tune - control over the first / last "
            f"{n} {r['gain_first']:+.5f} / {r['gain_last']:+.5f} (read, not held to a fall: "
            f"PERF.md section 7)")
        for name in ("tune", "control"):
            log(f"t2u e2e held val loss after the {name} run (seed {r['seed']}): "
                f"{fmt(**r[name]['held'])}; with the start's BatchNorm statistics "
                f"{fmt(**r[name]['held_start_bn'])}")
    log(f"t2u e2e card vs CPU: loss {l_card:.6f} / {l_cpu:.6f} ({loss_rel:.3g}, bar "
        f"{T2U_LOSS_RTOL}), gradient norm {g_card:.6g} / {g_cpu:.6g} ({grad_rel:.3g}, bar "
        f"{T2U_GRAD_NORM_RTOL})")
    if not (loss_rel <= T2U_LOSS_RTOL and grad_rel <= T2U_GRAD_NORM_RTOL):
        fail(f"t2u e2e card vs CPU: loss {loss_rel:.3g}, gradient norm {grad_rel:.3g}")
    return e2e, {"tune_init_ms": 1e3 * init_s, "tune_init_attention_launches": init_launches,
                 "steps": E2E_COUNTED, "losses": fit_losses, "steps_per_s": steps_per_s,
                 "held_start": held0, "stream_runs": runs, "attention_launches": counted_launches,
                 "card_vs_cpu": {"loss_cuda": l_card, "loss_cpu": l_cpu, "loss_rel": loss_rel,
                                 "grad_norm_cuda": g_card, "grad_norm_cpu": g_cpu,
                                 "grad_norm_rel": grad_rel}}


def t2u_da_tune_cli(root: Path, t2u: str, attn_checked):
    """`train --system fscl-t2u-da-tune` through the CLI (T2UDADataModule:
    a t2u stream and a real-unit stream for the discriminator; T2UConfig's
    defaults, B = 16) for T2U_DA_STEPS steps: every loss finite. TacoT2U
    runs no attention kernel: its launches are counted, not expected."""
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.ops import attention as attn

    overlay = cli_train_overlay(root, "da-tune-overlay",
                                "optimizer:\n  lr: 0.002\n  warm_up_step: 5\n  anneal_steps: []\n"
                                f"step:\n  log_step: 1\n  save_step: {T2U_DA_STEPS}\n")
    probe = CliProbe()
    attn.LAUNCHES = 0
    with probe.active(), attention_shapes(attn, attn_checked, "t2u fscl-t2u-da-tune cli",
                                          launches=False):
        t0 = time.perf_counter()
        system, state = cli(["train", "--system", "fscl-t2u-da-tune", "--data_config", t2u,
                             "--train_config", str(REPO / "config" / "train" / "baseline.yaml"),
                             "--train_config", overlay, "--exp_dir", str(root / "exp-da-tune"),
                             "--total_step", str(T2U_DA_STEPS)])
        wall = time.perf_counter() - t0
    losses = probe.read_losses()
    if type(system).__name__ != "DATuneSystem" or state.step != T2U_DA_STEPS \
            or len(losses) != T2U_DA_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"t2u fscl-t2u-da-tune cli: {type(system).__name__}, step {state.step}, "
             f"losses {losses}")
    fit = probe.fits[-1]
    log(f"t2u fscl-t2u-da-tune cli ({type(system).__name__}): {T2U_DA_STEPS} steps at B=16 in "
        f"{fit['seconds']:.2f} s = {fit['steps_per_s']:.2f} steps/s, loss "
        f"{' -> '.join(f'{x:.3f}' for x in losses)}; {attn.LAUNCHES} attention launches; the "
        f"CLI call {wall:.1f} s")
    del system
    return {"steps": T2U_DA_STEPS, "losses": losses, "steps_per_s": fit["steps_per_s"],
            "wall_s": wall, "attention_launches": attn.LAUNCHES}


def t2u_dae2e(t2u: str, tacot2u, u2s, seed: int, attn_checked):
    """DAE2ETuneSystem (the E2E chain plus a gradient-reversal unit
    discriminator) from the trained T2U through the frozen u2s:
    DAE2E_STEPS steps at B = E2E_B on T2U2SDADataModule's stream through
    `Trainer.fit` (every loss finite, the u2s trunk's attention launches per
    step); one step card vs CPU (loss T2U_LOSS_RTOL, gradient norm
    T2U_GRAD_NORM_RTOL); the gradient the discriminator sends into the unit
    probabilities through GradientReversal against -scale times its
    gradient without the reversal."""
    import torch
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.data.mix_datamodules import T2U2SDADataModule
    from fscl_tpu_torch.models.tacotron2_t2u import draw_masks
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    from fscl_tpu_torch.systems.t2u_tune import DAE2ETuneSystem
    from fscl_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    fit_cfg = t2u_train_config(E2E_B, log_step=1, save_step=10**9, val_step=10**9,
                               synth_step=10**9)

    def build(u2s_system, device):
        return DAE2ETuneSystem(u2s.model_cfg, id2symbols_of(tacot2u), tacot2u.t2u_cfg,
                               u2s_system, device=device, optim_cfg=fit_cfg.optim,
                               u2s_symbol_id=T2U_UNIT_NAME)

    torch.manual_seed(seed + 180)
    system = build(u2s, CARD)
    missing, unexpected = system.load_state_dict(tacot2u.state_dict(), strict=False)
    if unexpected or any(not k.startswith(("u2s_system.", "da.")) for k in missing):
        fail(f"t2u dae2e: loading the trained T2U left {missing[:3]} / {unexpected[:3]}")
    dm = T2U2SDADataModule([read_data_config(t2u)], u2s.model_cfg, fit_cfg)
    dm.setup()
    per_step = u2s.model_cfg.transformer.encoder_layer + u2s.model_cfg.transformer.decoder_layer
    rec = LossRecorder()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "t2u dae2e tune"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        Trainer(system, fit_cfg, callbacks=[rec]).fit(system.init_state(), dm.train_batches(),
                                                      max_steps=DAE2E_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    launches = attn.LAUNCHES
    losses = [float(m["Total Loss"]) for _, m, _ in rec.logs]
    da_losses = [float(m["DA Loss"]) for _, m, _ in rec.logs]
    if len(losses) != DAE2E_STEPS or not all(math.isfinite(x) for x in losses + da_losses) \
            or launches != per_step * DAE2E_STEPS:
        fail(f"t2u dae2e: losses {losses}, DA losses {da_losses}, {launches} attention launches "
             f"(expected {per_step} per step)")
    batch = e2e_check_batch(next(dm.train_batches()))
    B, L = batch.t2u.texts.shape
    masks = draw_masks(system.t2u_cfg, B, L, batch.t2u.units.shape[1], True,
                       torch.Generator().manual_seed(9), "cpu")
    cpu = build(BaselineSystem(u2s.model_cfg, id2symbols_of(u2s), device="cpu"), "cpu")
    cpu.load_state_dict(system.state_dict(), strict=True)
    got = {}
    for name, s in (("card", system), ("cpu", cpu)):
        m = type(masks)(*(None if x is None else x.to(s.device) for x in masks))
        s.train()
        loss, _ = s.loss_and_metrics(to_device(batch, s.device), masks=m)
        params = [p for n, p in s.named_parameters() if s.trainable_mask()[n]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        s.eval()
        got[name] = (float(loss.detach()), float(torch.sqrt(sum((g.double() ** 2).sum()
                                                       for g in grads if g is not None))))
    (l_card, g_card), (l_cpu, g_cpu) = got["card"], got["cpu"]
    loss_rel, grad_rel = abs(l_card - l_cpu) / abs(l_cpu), abs(g_card - g_cpu) / g_cpu
    del cpu
    # the discriminator's gradient into the soft units, with and without
    # the reversal
    b = to_device(batch, CARD)
    with torch.no_grad():
        logits, _ = system(b.t2u)
    probs = torch.softmax(logits, dim=-1).requires_grad_()
    valid = b.t2u.units != 0
    (g_rev,) = torch.autograd.grad(system.da(probs, valid).sum(), probs)
    (g_plain,) = torch.autograd.grad(system.da.discriminator(probs, valid).sum(), probs)
    scale = system.da.grl.scale
    peak = float(g_plain.abs().max())
    grl_rel = float((g_rev + scale * g_plain).abs().max()) / peak if peak > 0 else math.inf
    seconds = time.perf_counter() - t0
    log(f"t2u dae2e ({DAE2E_STEPS} steps at B={E2E_B} through the frozen u2s in {wall:.2f} s = "
        f"{DAE2E_STEPS / wall:.2f} steps/s): loss {' -> '.join(f'{x:.3f}' for x in losses)}, DA "
        f"loss {' -> '.join(f'{x:.4f}' for x in da_losses)}, {per_step} attention launches per "
        f"step; card vs CPU loss {l_card:.6f} / {l_cpu:.6f} ({loss_rel:.3g}, bar {T2U_LOSS_RTOL}), "
        f"gradient norm {g_card:.6g} / {g_cpu:.6g} ({grad_rel:.3g}, bar {T2U_GRAD_NORM_RTOL}); "
        f"gradient through the reversal + {scale} x the plain one: {grl_rel:.3g} of its max "
        f"{peak:.3g} (bar {GRL_REL}); {seconds:.2f} s")
    if not (loss_rel <= T2U_LOSS_RTOL and grad_rel <= T2U_GRAD_NORM_RTOL):
        fail(f"t2u dae2e card vs CPU: loss {loss_rel:.3g}, gradient norm {grad_rel:.3g}")
    if not grl_rel <= GRL_REL:
        fail(f"t2u dae2e: the gradient through GradientReversal is {grl_rel:.3g} from -{scale} "
             "times the gradient without it")
    del system
    return {"steps": DAE2E_STEPS, "losses": losses, "da_losses": da_losses,
            "steps_per_s": DAE2E_STEPS / wall, "attention_launches": launches,
            "card_vs_cpu": {"loss_cuda": l_card, "loss_cpu": l_cpu, "loss_rel": loss_rel,
                            "grad_norm_cuda": g_card, "grad_norm_cpu": g_cpu,
                            "grad_norm_rel": grad_rel},
            "gradient_reversal_rel": grl_rel, "seconds": seconds}


def t2u_chained(e2e, seed: int, sr: int, attn_checked, stage_checked):
    """Text -> units -> mel -> wav: `serve_t2u_batches` (the tuned T2U's
    `infer`, all 10 L steps, then the u2s' two-pass synthesis) and
    `vocode_batches` (HiFi-GAN V1 with random weights from the seed) over
    T2U_LINES in batches of 8; a warm-up run, then one timed and counted."""
    import torch
    from fscl_tpu_torch.audio_out.vocoder import Vocoder
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops import mrf_stage as mrf
    from fscl_tpu_torch.serve import serve_t2u_batches, vocode_batches

    vocoder = Vocoder(build_vocoder(seed, CARD), device=CARD)
    hop = vocoder.model.hop
    u2s = e2e.u2s_system

    def run(lines):
        return [(b, w) for b, w in vocode_batches(
            vocoder, serve_t2u_batches(e2e, u2s, lines, T2U_UNIT_NAME))]

    run(T2U_LINES[:8])
    attn.LAUNCHES = mrf.LAUNCHES = 0
    torch.cuda.synchronize()
    with attention_shapes(attn, attn_checked, "t2u chained serving"):
        t0 = time.perf_counter()
        out = run(T2U_LINES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t = u2s.model_cfg.transformer
    n_batches = math.ceil(len(T2U_LINES) / 8)
    per_batch = 2 * t.encoder_layer + t.decoder_layer
    launches = {"attention_fwd": attn.LAUNCHES, "mrf_stage": mrf.LAUNCHES}
    if launches != {"attention_fwd": per_batch * n_batches, "mrf_stage": 4 * n_batches}:
        fail(f"t2u chained: launches {launches}, expected {per_batch} and 4 per batch")
    samples = units = steps = 0
    for b, wav in out:
        B, T = b.postnet_mel.shape[:2]
        if tuple(wav.shape) != (B, T * hop) or not torch.isfinite(wav).all() \
                or float(wav.abs().max()) > 1.0:
            fail(f"t2u chained: wav {tuple(wav.shape)} for mel {tuple(b.postnet_mel.shape)}, or "
                 "not finite in [-1, 1]")
        unchecked = [(B, C, T * up) for C, up, _ in V1_STAGES
                     if (B, C, T * up) not in stage_checked]
        if unchecked:
            fail(f"t2u chained: stage shapes {unchecked} were not held to the plain version")
        n = b.n_units.cpu()
        if ((b.units.cpu() != 0).sum(dim=1) > n).any():
            fail("t2u chained: unit ids past a sample's <eos>")
        units += int(n.sum())
        steps += int(b.units.shape[1])
        samples += int(b.mel_len.clamp(min=1).sum()) * hop
    log(f"t2u chained: {len(T2U_LINES)} lines in {n_batches} batches, {steps // n_batches} "
        f"decoder steps per batch, {units} units ({units / wall:.1f} units/s), "
        f"{samples / sr:.2f} s of audio in {wall:.3f} s = {samples / sr / wall:.2f} audio-s/s; "
        f"{per_batch} attention + 4 stage launches per batch")
    return {"lines": len(T2U_LINES), "batches": n_batches, "decoder_steps_per_batch":
            steps / n_batches, "units": units, "units_per_s": units / wall,
            "audio_s": samples / sr, "audio_s_per_s": samples / sr / wall, "wall_s": wall,
            "launches": launches}


def phase_t2u(seed: int, card: str, attn_checked, stage_checked, profile: bool, out_dir):
    """Main path, the T2U family at full width on a corpus written from the
    seed: make-units (HuBERT-large, 512 units; the mel and base-upstream
    sources), train tacot2u and the DA tune, a u2s and its model card,
    FSCL-T2U episodes (the C and C2 variants, a bf16 upstream), the E2E and
    DAE2E tunes, chained serving."""
    import shutil
    import tempfile
    import torch

    root = Path(tempfile.mkdtemp(prefix="fscl_t2u_"))
    summary = {}
    try:
        t0 = time.perf_counter()
        data, t2u, u2s_cfg = t2u_corpus(root, seed)
        log(f"t2u: wrote a corpus of {T2U_TRAIN} + {T2U_VAL} utterances of "
            f"{T2U_FRAMES[0]}-{T2U_FRAMES[1]} mel frames in {time.perf_counter() - t0:.2f} s")
        features = str(Path(data).parent / "features")
        summary["make_units"] = t2u_make_units(features, seed, attn_checked)
        summary["make_units_sources"] = t2u_make_units_sources(features, seed, attn_checked)
        summary["upstream_layouts"] = t2u_upstream_layouts(seed, attn_checked)
        summary["make_units_ckpt"] = t2u_make_units_ckpt(root, features, seed, attn_checked)
        tacot2u, batch, summary["train"] = t2u_train(root, t2u, attn_checked, profile, out_dir)
        summary["train"]["card_vs_cpu"] = t2u_card_vs_cpu_logits(tacot2u, batch)
        summary["scheduled_sampling"] = t2u_scheduled_sampling(tacot2u, batch)
        u2s, summary["u2s"] = t2u_u2s(root, t2u, u2s_cfg, attn_checked)
        summary["da_tune_cli"] = t2u_da_tune_cli(root, t2u, attn_checked)
        fscl, summary["fscl"] = t2u_fscl(root, t2u, attn_checked)
        variants, summary["fscl_variants"] = t2u_fscl_variants(t2u, fscl, seed, attn_checked)
        checks = t2u_fscl_card_vs_cpu({"fscl-t2u": fscl, **variants}, t2u, attn_checked)
        summary["fscl"]["card_vs_cpu"] = checks.pop("fscl-t2u")
        for kind, check in checks.items():
            summary["fscl_variants"][kind]["card_vs_cpu"] = check
        del variants
        summary["bf16_upstream"] = t2u_bf16_upstream(t2u, fscl, attn_checked)
        e2e, summary["e2e"] = t2u_e2e(t2u, tacot2u, fscl, u2s, seed, attn_checked)
        del fscl
        torch.cuda.empty_cache()
        summary["dae2e"] = t2u_dae2e(t2u, tacot2u, u2s, seed, attn_checked)
        summary["chained"] = t2u_chained(e2e, seed, 22050, attn_checked, stage_checked)
        del tacot2u, e2e, u2s
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return summary


# -- phase 15: the phoneme-recognition (PR) family ----------------------------

# A meta corpus as phase 14's (64 + 8 utterances of 1.5-10 s, 30-100
# phonemes; 16 kHz wavs and MFA segments) and a target corpus of 40
# utterances of 30-60 phonemes for task generation, both written from the
# seed (tests/torch_corpus.py:write_corpus; the store also gets the 22.05 kHz
# trims and frame pitch that `clean` reads). The model is
# config/model/fscl-fastspeech2.yaml's: HuBERT-large in f32 drawn on the card,
# Downstream1 and the heads at 256 with 2 heads (Dh 128), a 128-row codebook.
# Depth, to cut first: the step, episode and task counts (the timed episodes
# cut from 10 to 5 for phase 14's T2U configurations).
PR_TRAIN, PR_VAL, PR_FRAMES, PR_PHONES = 64, 8, (130, 860), (30, 100)
PR_TARGET_UTTS, PR_TARGET_PHONES = 40, (30, 60)
PR_SHOTS, PR_QUERIES = 32, 8        # config/algorithm/phoneme_recognition/pr-fscl.yaml
# (PR 17 cut the CLI's episodes 20 -> 10, the timed episodes 5 -> 3, the
# supervised steps 10 -> 5, the host reads 10 -> 5 and the shard steps
# 20 -> 10 for its attention checks.)
PR_CLI_STEPS, PR_EPISODES, PR_FIT_STEPS = 10, 3, 10
PR_SUP_B, PR_SUP_STEPS = 8, 5       # the supervised systems through PRDataModule
PR_TASK_SHOTS, PR_TASK_QUERIES, PR_TASKS, PR_EVAL_BATCH = 8, 8, 2, 8
PR_READ_BATCHES, PR_SHARD_STEPS = 5, 10
# Card vs CPU on one small episode (the 4 + 2 shortest utterances, one wav
# bucket): the protonet's and TransHead's logits (phase 14's logits bar),
# the loss, one train step's gradient norm, one task's eval frame logits.
PR_LOGIT_ATOL, PR_LOSS_RTOL, PR_GRAD_NORM_RTOL = 1e-3, 1e-4, 1e-3
PR_ALGO = REPO / "config" / "algorithm" / "phoneme_recognition"


def pr_attention_shapes():
    """The (B, H, L, Dh) the PR family launches the attention kernel at:
    HuBERT-large (16 heads of 64) and Downstream1 (2 heads of 128) over the
    episodes' support and query sets (32 + 8 in process, the CLI's 4 + 2),
    the supervised batches and eval chunks of 8, and the card-vs-CPU
    episode's 4 + 2, at each episode wav bucket the corpora reach (4-12 s)."""
    from fscl_tpu_torch.data.episodic import WAV_BUCKETS
    from fscl_tpu_torch.models.hubert import ssl_num_frames
    shapes = []
    for B in sorted({PR_SHOTS, PR_QUERIES, PR_SUP_B, PR_EVAL_BATCH, 4, 2}):
        for w in WAV_BUCKETS[:3]:
            shapes += [(B, 16, ssl_num_frames(w), 64), (B, 2, ssl_num_frames(w), 128)]
    return shapes


def pr_corpora(root: Path, seed: int):
    """The meta and target corpora; returns their data config paths."""
    import numpy as np
    sys.path.insert(0, str(REPO / "tests"))
    from torch_corpus import write_corpus
    from fscl_tpu_torch.data.feature_store import FeatureStore
    meta = write_corpus(str(root), "en-pr", "en", 0, seed + 70, n_train=PR_TRAIN, n_val=PR_VAL,
                        frames=PR_FRAMES, n_phones=PR_PHONES, unit_name="pr-frames")
    target = write_corpus(str(root), "en-target", "en", 0, seed + 71, n_train=PR_TARGET_UTTS,
                          n_val=0, frames=PR_FRAMES, n_phones=PR_TARGET_PHONES)
    store = FeatureStore(str(Path(meta).parent / "features"))
    for q in store.load_metadata():
        n = store.wav_trim_16000.read_from_query(q).shape[0]
        store.wav_trim_22050.save(np.zeros(round(n * 22050 / 16000), np.float32), q)
        store.pitch.save(store.interpolate_pitch.read_from_query(q), q)
    return meta, target


def pr_subprocess(args, what: str):
    """`python -m fscl_tpu_torch.cli <args>` in a fresh process: (stdout, s)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fscl_tpu_torch.cli", *args], cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"pr {what}: exit {proc.returncode}\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return proc.stdout, wall


def pr_pack_and_clean(meta: str):
    """`pack --fscl` and `pack` of the meta corpus's train split, each in a
    subprocess (seconds, bytes); `clean` once, in process."""
    from fscl_tpu_torch.cli import main as cli
    split = Path(meta).parent / "splits" / "train.txt"
    out = {}
    for name, extra in (("fscl", ["--fscl"]), ("supervised", [])):
        _, wall = pr_subprocess(["pack", "--data_config", meta, *extra], f"pack {name}")
        path = Path(str(split) + (".fscl.shard" if extra else ".shard"))
        out[name] = {"seconds": wall, "bytes": path.stat().st_size}
    t0 = time.perf_counter()
    cleaned = cli(["clean", str(Path(meta).parent / "features")])
    out["clean"] = dict(cleaned, seconds=time.perf_counter() - t0)
    if cleaned["kept"] != PR_TRAIN + PR_VAL:
        fail(f"pr clean: kept {cleaned}")
    log(f"pr pack: --fscl {out['fscl']['bytes'] / 2**20:.1f} MiB in {out['fscl']['seconds']:.2f} "
        f"s, supervised {out['supervised']['bytes'] / 2**20:.1f} MiB in "
        f"{out['supervised']['seconds']:.2f} s (subprocesses, interpreter start included); "
        f"clean kept {cleaned['kept']}/{cleaned['total']} in {out['clean']['seconds']:.2f} s")
    return out


def pr_host_reads(meta: str):
    """Host ms per episode of 32 + 8 from the shard (C++ and numpy readers)
    beside the same episodes through PRDataset and the Python collate, and
    per supervised batch of 16 from the `.shard`, NativeCollate and the
    Python path; each reader the same draws, after one untimed call (the C++
    libraries are built with g++ at their first call)."""
    import numpy as np
    from fscl_tpu_torch.core.config import ModelConfig, read_data_config
    from fscl_tpu_torch.data.batch import collate_batch
    from fscl_tpu_torch.data.datamodules import collate_pr
    from fscl_tpu_torch.data.datasets import FastSpeech2Dataset, PRDataset
    from fscl_tpu_torch.data.episodic import split_sup_qry
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.data.native_loader import NativeCollate
    from fscl_tpu_torch.data.shards import PackedShard
    from fscl_tpu_torch.frontend import n_symbols
    from fscl_tpu_torch.systems.pr import PREpisode

    dc = read_data_config(meta)
    store, split = FeatureStore(dc.data_dir), dc.subset_path("train")
    rng = np.random.default_rng(0)
    draws = [rng.integers(0, PR_TRAIN, PR_SHOTS + PR_QUERIES) for _ in range(PR_READ_BATCHES)]
    ds = PRDataset(split, store, dc)
    n_sym = n_symbols(dc.symbol_id)

    def python_episode(idxs):
        samples = [ds[int(i)] for i in idxs]
        sup, qry = split_sup_qry(samples, PR_SHOTS, PR_QUERIES)
        return PREpisode(collate_pr([samples[i] for i in sup], dc.symbol_id, n_sym),
                         collate_pr([samples[i] for i in qry], dc.symbol_id, n_sym))

    def timed(fn, items):
        fn(items[0])            # builds the C++ reader at its first call
        t0 = time.perf_counter()
        outs = [fn(x) for x in items]
        return 1e3 * (time.perf_counter() - t0) / len(items), outs

    readers = {"shard_cpp": PackedShard(split + ".fscl.shard"),
               "shard_numpy": PackedShard(split + ".fscl.shard", native=False)}
    episodes = {name: timed(lambda i, s=sh: s.collate_pr_episode(
        i, PR_SHOTS, PR_QUERIES, dc.symbol_id, n_sym), draws) for name, sh in readers.items()}
    episodes["python"] = timed(python_episode, draws)
    ref = episodes["python"][1]
    for name, (_, outs) in episodes.items():
        for a, b in zip(outs, ref):
            for side in ("sup", "qry"):
                x, y = getattr(a, side), getattr(b, side)
                if not all(np.array_equal(u, v) for u, v in zip(x[:5], y[:5])):
                    fail(f"pr host reads: the {name} episode differs from the Python one")
    mc = ModelConfig()
    fs_ds = FastSpeech2Dataset(split, store, dc, mc)
    batches = [rng.integers(0, PR_TRAIN, 16) for _ in range(PR_READ_BATCHES)]
    native = NativeCollate(store, dc, mc)
    shard = PackedShard(split + ".shard")
    sup = {"shard_cpp": timed(lambda i: shard.collate(i)[1], batches),
           "native": timed(lambda i: native.collate([fs_ds.queries[int(j)] for j in i])[1],
                           batches),
           "python": timed(lambda i: collate_batch([fs_ds[int(j)] for j in i])[1], batches)}
    out = {"episode_ms": {k: v[0] for k, v in episodes.items()},
           "supervised_ms": {k: v[0] for k, v in sup.items()}}
    e, s = out["episode_ms"], out["supervised_ms"]
    log(f"pr host reads: an episode of {PR_SHOTS} + {PR_QUERIES} {e['shard_cpp']:.2f} ms from the "
        f"shard (C++), {e['shard_numpy']:.2f} (numpy), {e['python']:.2f} through PRDataset "
        f"({e['python'] / e['shard_cpp']:.1f}x); a supervised batch of 16 {s['shard_cpp']:.2f} ms "
        f"from the .shard, {s['native']:.2f} NativeCollate, {s['python']:.2f} Python "
        f"({s['python'] / s['shard_cpp']:.1f}x); the same episodes from each reader")
    return out


def pr_shard_steps(meta: str, seed: int):
    """config/model/base.yaml trained at B = 16 from FastSpeech2DataModule's
    shard path and from its Python path (native_io=False), PR_SHARD_STEPS
    each after a warm-up, on one system: steps/s beside each other."""
    import dataclasses
    import torch
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.datamodules import FastSpeech2DataModule
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    from fscl_tpu_torch.train.trainer import Trainer

    dc = read_data_config(meta)
    cfg = train_model_config(True)
    cfg = dataclasses.replace(cfg, speaker=dataclasses.replace(cfg.speaker, n_speakers=2))
    train_cfg = t2u_train_config(16, log_step=10**9, save_step=10**9, val_step=10**9,
                                 synth_step=10**9)
    torch.manual_seed(seed)
    system = BaselineSystem(cfg, (("en", 152),), device=CARD, optim_cfg=train_cfg.optim)
    state = system.init_state()
    out = {}
    for name, native_io in (("warm-up", True), ("shard", True), ("python", False),
                            ("shard_again", True)):
        dm = FastSpeech2DataModule([dc], cfg, train_cfg, native_io=native_io, re_id=False)
        dm.setup()
        if native_io and dm._shard is None:
            fail("pr shard steps: the datamodule did not take the shard")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = Trainer(system, train_cfg).fit(state, dm.train_batches(),
                                               max_steps=state.step + PR_SHARD_STEPS)
        torch.cuda.synchronize()
        out[name] = PR_SHARD_STEPS / (time.perf_counter() - t0)
    del out["warm-up"]
    log(f"pr train from the shard: {out['shard']:.2f} / {out['shard_again']:.2f} steps/s "
        f"(base.yaml, B=16) against {out['python']:.2f} from the store in Python")
    del system
    torch.cuda.empty_cache()
    return out


def pr_cli_train(root: Path, meta: str, attn_checked):
    """`train --system pr-ssl-protonet` through the CLI on the packed corpus:
    the generic path's episodes of 4 + 2 from the `.fscl.shard`, HuBERT-large
    drawn from the seed; finite losses; no upstream tensor in the
    checkpoint."""
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.core.checkpoint import CheckpointManager
    from fscl_tpu_torch.ops import attention as attn

    overlay = cli_train_overlay(root, "pr-overlay",
                                "optimizer:\n  lr: 0.002\n  warm_up_step: 5\n  anneal_steps: []\n"
                                f"step:\n  log_step: 1\n  save_step: {PR_CLI_STEPS}\n")
    exp = root / "exp-pr"
    probe = CliProbe()
    attn.LAUNCHES = 0
    with probe.active(), attention_shapes(attn, attn_checked, "pr cli train"):
        system, state = cli([
            "train", "--system", "pr-ssl-protonet", "--data_config", meta,
            "--model_config", str(REPO / "config" / "model" / "fscl-fastspeech2.yaml"),
            "--algorithm_config", str(PR_ALGO / "ssl-protonet.yaml"),
            "--train_config", overlay, "--exp_dir", str(exp), "--total_step", str(PR_CLI_STEPS)])
    losses, launches, fit = probe.read_losses(), attn.LAUNCHES, probe.fits[-1]
    per_episode = 2 * (system.upstream.n_layers + len(system.downstream.layers))
    raw = CheckpointManager(str(exp / "ckpt")).restore()
    if any(k.startswith("upstream.") for k in raw["params"]) or state.step != PR_CLI_STEPS or \
            not all(math.isfinite(x) for x in losses) or launches != per_episode * PR_CLI_STEPS:
        fail(f"pr cli train: losses {losses}, {launches} attention launches, step {state.step}, "
             "or upstream tensors in the checkpoint")
    log(f"pr cli train (pr-ssl-protonet, episodes of 4 + 2): {PR_CLI_STEPS} episodes in "
        f"{fit['seconds']:.2f} s = {fit['steps_per_s']:.2f} episodes/s (saves excluded); loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; {per_episode} attention launches per episode")
    return system, {"episodes": PR_CLI_STEPS, "episodes_per_s": fit["steps_per_s"],
                    "losses": losses, "attention_launches": launches,
                    "checkpoint_bytes": probe.saves[-1]["bytes"]}


def pr_split(system, state, ep):
    """One episode split by synchronizes: the frozen upstream over support
    and query, the rest of the forward and the backward, the optimizer."""
    import torch

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    t0 = now()
    with torch.no_grad():
        system.extract_ssl(ep.sup.wavs, ep.sup.wav_lens)
        system.extract_ssl(ep.qry.wavs, ep.qry.wav_lens)
    t1 = now()
    system.train()
    loss, _ = system.loss_and_metrics(ep)
    grads = torch.autograd.grad(loss, system.optimizer.params, allow_unused=True)
    system.eval()
    t2 = now()
    system.optimizer.update(state.opt_state, grads)
    t3 = now()
    return {"upstream_ms": 1e3 * (t1 - t0), "downstream_ms": 1e3 * (t2 - t1 - (t1 - t0)),
            "optimizer_ms": 1e3 * (t3 - t2), "episode_ms": 1e3 * (t3 - t0)}


def pr_episodic(kind: str, dc, upstream, seed: int, attn_checked):
    """PR_EPISODES episodes of 32 + 8 from PREpisodicDataModule (the shard)
    through Trainer.fit: every loss finite, episodes/s, one episode split;
    then PR_FIT_STEPS steps on one episode repeated: the loss falls."""
    import itertools
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.data.datamodules import PREpisodicDataModule
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.pr import SSLProtoNetSystem, TransHeadPRSystem
    from fscl_tpu_torch.train.trainer import Trainer

    cls = SSLProtoNetSystem if kind == "protonet" else TransHeadPRSystem
    cfg = train_model_config(True, "fscl-fastspeech2.yaml")
    train_cfg = t2u_train_config(PR_SHOTS, log_step=1, save_step=10**9, val_step=10**9,
                                 synth_step=10**9)
    torch.manual_seed(seed)
    system = cls(cfg, (("en", 152),), device=CARD, optim_cfg=train_cfg.optim,
                 upstream=upstream, upstream_seed=seed)
    dm = PREpisodicDataModule([dc], cfg, train_cfg, shots=PR_SHOTS, queries=PR_QUERIES)
    dm.setup()
    if dm.datasets[0][2] is None:
        fail("pr episodes: PREpisodicDataModule did not take the shard")
    start = {k: v.clone() for k, v in system.state_dict().items() if not k.startswith("upstream.")}
    rec = LossRecorder()
    n_attn = len(getattr(system.downstream, "layers", ()))
    per_episode = 2 * (system.upstream.n_layers + n_attn)
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, f"pr {kind} episodes"):
        state = system.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = Trainer(system, train_cfg, callbacks=[rec]).fit(state, dm.train_batches(),
                                                                max_steps=PR_EPISODES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = attn.LAUNCHES
        host_ep = next(dm.train_batches())
        split = pr_split(system, state, to_device(host_ep, CARD))
    losses = [float(m["Total Loss"]) for _, m, _ in rec.logs]
    if not all(math.isfinite(x) for x in losses) or launches != per_episode * PR_EPISODES:
        fail(f"pr {kind} episodes: losses {losses}, {launches} attention launches")
    # one episode repeated: the episodic loss must fall
    system.load_state_dict(start, strict=False)
    rec = LossRecorder()
    with attention_shapes(attn, attn_checked, f"pr {kind} fit"):
        Trainer(system, train_cfg, callbacks=[rec]).fit(system.init_state(),
                                                        itertools.repeat(host_ep),
                                                        max_steps=PR_FIT_STEPS)
    fit_losses = [float(m["Total Loss"]) for _, m, _ in rec.logs]
    if not all(math.isfinite(x) for x in fit_losses) or not falling(fit_losses):
        fail(f"pr {kind} one-episode fit: losses {fit_losses}")
    log(f"pr {kind}: {PR_EPISODES} episodes of {PR_SHOTS} + {PR_QUERIES} in {wall:.2f} s = "
        f"{PR_EPISODES / wall:.3f} episodes/s (loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
        f"{per_episode} attention launches each); one episode: upstream "
        f"{split['upstream_ms']:.1f} ms, downstream fwd + bwd {split['downstream_ms']:.1f}, "
        f"optimizer {split['optimizer_ms']:.1f}; one episode repeated: {fit_losses[0]:.3f} -> "
        f"{fit_losses[-1]:.3f}")
    return system, {"episodes": PR_EPISODES, "episodes_per_s": PR_EPISODES / wall,
                        "losses": losses, "attention_launches": launches, "split": split,
                        "fit_losses": fit_losses}


def pr_supervised(dc, upstream, seed: int, attn_checked):
    """pr-ssl-linear, -baseline and -cluster: PR_SUP_STEPS steps each at
    B = PR_SUP_B through PRDataModule; steps/s; every loss finite (the
    losses are recorded, not gated: a random upstream gives them nothing to
    learn in so few steps)."""
    import torch
    from fscl_tpu_torch.data.datamodules import PRDataModule
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.systems.pr import SSLBaselineSystem, SSLClusterSystem, SSLLinearSystem
    from fscl_tpu_torch.train.trainer import Trainer

    cfg = train_model_config(True, "fscl-fastspeech2.yaml")
    train_cfg = t2u_train_config(PR_SUP_B, log_step=1, save_step=10**9, val_step=10**9,
                                 synth_step=10**9)
    out = {}
    for name, cls in (("linear", SSLLinearSystem), ("baseline", SSLBaselineSystem),
                      ("cluster", SSLClusterSystem)):
        torch.manual_seed(seed)
        system = cls(cfg, (("en", 152),), device=CARD, optim_cfg=train_cfg.optim,
                     upstream=upstream)
        dm = PRDataModule([dc], cfg, train_cfg)
        dm.setup()
        rec = LossRecorder()
        attn.LAUNCHES = 0
        with attention_shapes(attn, attn_checked, f"pr {name}"):
            state = system.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Trainer(system, train_cfg, callbacks=[rec]).fit(state, dm.train_batches(),
                                                            max_steps=PR_SUP_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        losses = [float(m["Total Loss"]) for _, m, _ in rec.logs]
        if not all(math.isfinite(x) for x in losses):
            fail(f"pr {name}: losses {losses}")
        out[name] = {"steps_per_s": PR_SUP_STEPS / wall, "losses": losses,
                     "attention_launches": attn.LAUNCHES}
        del system
    log("pr supervised at B=8 through PRDataModule: " + "; ".join(
        f"{k} {v['steps_per_s']:.2f} steps/s, loss {v['losses'][0]:.3f} -> {v['losses'][-1]:.3f}"
        for k, v in out.items()))
    return out


def pr_eval(root: Path, target: str, systems, attn_checked):
    """TaskGenerator over the target corpus, then zero-shot transcription
    of every task's queries by the protonet and the TransHead system, then
    `python -m fscl_tpu_torch.cli evaluate` on each output: PER and FER,
    query utterances/s split into the card (with the host's collates) and
    the host's DPDP."""
    import torch
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.feature_store import FeatureStore
    from fscl_tpu_torch.eval import protonet_eval
    from fscl_tpu_torch.eval.task_generation import TaskGenerator
    from fscl_tpu_torch.ops import attention as attn

    dc = read_data_config(target)
    tasks = root / "tasks"
    t0 = time.perf_counter()
    TaskGenerator(dc.name, FeatureStore(dc.data_dir), dc.lang_id, dc.symbol_id, seed=4).generate(
        dc.subset_path("train"), str(tasks), shots=(PR_TASK_SHOTS,), n_qry=PR_TASK_QUERIES,
        n_tasks=PR_TASKS)
    gen_s = time.perf_counter() - t0
    out = {"task_generation_s": gen_s}
    decode = protonet_eval.evaluate_pr_task
    for name, system in systems.items():
        dpdp = [0.0]

        def timed_decode(*args, **kw):
            t = time.perf_counter()
            res = decode(*args, **kw)
            dpdp[0] += time.perf_counter() - t
            return res

        run = (protonet_eval.run_protonet_eval if name == "protonet"
               else protonet_eval.run_trans_head_eval)
        attn.LAUNCHES = 0
        with mock.patch.object(protonet_eval, "evaluate_pr_task", timed_decode), \
                attention_shapes(attn, attn_checked, f"pr eval {name}"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths = run(system, str(tasks / f"{PR_TASK_SHOTS}-shot"), str(root / f"eval-{name}"),
                        batch_size=PR_EVAL_BATCH)
            wall = time.perf_counter() - t0
        n = PR_TASKS * PR_TASK_QUERIES
        stdout, ev_s = pr_subprocess(["evaluate", str(root / f"eval-{name}")], f"evaluate {name}")
        rates = {}
        for line in stdout.splitlines():
            for metric in ("PER", "FER"):
                if f"] {metric}: " in line:
                    rates[metric] = float(line.split(f"{metric}: ")[1].split("%")[0])
        if len(paths) != PR_TASKS or set(rates) != {"PER", "FER"} or \
                not all(0.0 <= x and math.isfinite(x) for x in rates.values()):
            fail(f"pr eval {name}: {paths}, evaluate printed {stdout!r}")
        out[name] = {"queries": n, "wall_s": wall, "dpdp_s": dpdp[0],
                     "queries_per_s": n / wall, "card_queries_per_s": n / (wall - dpdp[0]),
                     "per": rates["PER"], "fer": rates["FER"], "evaluate_s": ev_s,
                     "attention_launches": attn.LAUNCHES}
        log(f"pr eval {name}: {PR_TASKS} tasks of {PR_TASK_SHOTS} shots, {n} queries in "
            f"{wall:.2f} s = {n / wall:.2f} utterances/s (card and collates "
            f"{wall - dpdp[0]:.2f} s, DPDP on the host {dpdp[0]:.2f} s); evaluate: PER "
            f"{rates['PER']:.2f} %, FER {rates['FER']:.2f} % (random weights)")
    return out, tasks


def pr_check_task(root: Path, tasks: Path) -> Path:
    """A task of the generated tree's config with the 4 + 2 shortest target
    utterances (one wav bucket), so that its eval also runs on the CPU."""
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.feature_store import FeatureStore, write_queries_to_txt
    first = sorted((tasks / f"{PR_TASK_SHOTS}-shot").glob("task-*"))[0]
    dc = read_data_config(str(first / "config.yaml"))
    store = FeatureStore(dc.data_dir)
    qs = sorted(store.load_metadata(),
                key=lambda q: store.wav_trim_16000.read_from_query(q).shape[0])[:6]
    task = root / "check-task" / "task-0"
    task.mkdir(parents=True)
    (task / "config.yaml").write_text((first / "config.yaml").read_text())
    write_queries_to_txt(store, qs[:4], str(task / "train.txt"))
    write_queries_to_txt(store, qs[4:], str(task / "val.txt"))
    return task.parent


def pr_card_vs_cpu(systems, check_ep, check_task: Path, attn_checked):
    """The protonet and TransHead systems on the card and on the CPU with the
    same weights (dropout off) on one small episode: logits, loss, one train
    step's gradient norm; then one task's eval frame logits."""
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.eval import protonet_eval
    from fscl_tpu_torch.models.hubert import make_upstream
    from fscl_tpu_torch.ops import attention as attn

    up = next(iter(systems.values())).model_cfg.upstream
    with torch.device("meta"):
        shell = make_upstream(up.name, up)
    cpu_up = shell.to_empty(device="cpu")
    # the systems share the frozen upstream: on the CPU each distinct input
    # runs through it once (the first system's forwards serve the second's)
    if len({id(s.upstream) for s in systems.values()}) != 1:
        fail("pr card vs CPU: the systems held here share one upstream")
    memo, forward = {}, cpu_up.forward

    def forward_once(wav, wav_valid=None):
        key = tuple(None if t is None else (tuple(t.shape), t.dtype, t.numpy().tobytes())
                    for t in (wav, wav_valid))
        if key not in memo:
            memo[key] = forward(wav, wav_valid)
        return memo[key]

    cpu_up.forward = forward_once
    out = {}
    for name, system in systems.items():
        cpu = type(system)(system.model_cfg, system.id2symbols, device="cpu",
                           optim_cfg=system.optim_cfg, upstream=cpu_up)
        cpu.load_state_dict(system.state_dict(), strict=True)
        run = (protonet_eval.run_protonet_eval if name == "protonet"
               else protonet_eval.run_trans_head_eval)
        got = {}
        for where, s, dev in (("card", system, CARD), ("cpu", cpu, "cpu")):
            for m in s.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
            ep = to_device(check_ep, dev)
            frames = []

            def tap(predict, samples, *args, **kw):
                frames.extend(predict(x) for x in samples)
                return []
            shapes = (attention_shapes(attn, attn_checked, f"pr {name} card vs CPU")
                      if where == "card" else contextlib.nullcontext())
            with shapes:
                with torch.no_grad():
                    logits = (s.classify(s.build_prototypes(ep.sup), ep.qry)
                              if name == "protonet" else s.logits(ep))
                mask = s.trainable_mask()
                params = [p for n, p in s.named_parameters() if mask[n]]
                s.train()
                loss, _ = s.loss_and_metrics(ep)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                s.eval()
                norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads if g is not None))
                with mock.patch.object(protonet_eval, "evaluate_pr_task", tap), \
                        mock.patch.object(protonet_eval, "dump_task_results", lambda *a: ""):
                    run(s, str(check_task), "unused", batch_size=PR_EVAL_BATCH)
            got[where] = (logits.cpu(), float(loss.detach()), float(norm), frames)
        (lc, lsc, nc, fc), (lp, lsp, np_, fp) = got["card"], got["cpu"]
        rec = {"logits_max_abs": float((lc - lp).abs().max()),
               "logits_max_magnitude": float(lp.abs().max()),
               "loss_rel": abs(lsc - lsp) / abs(lsp), "grad_norm_rel": abs(nc - np_) / np_,
               "loss_cuda": lsc, "loss_cpu": lsp,
               "eval_logits_max_abs": max(float(abs(a - b).max()) for a, b in zip(fc, fp))}
        log(f"pr {name} card vs CPU (4 + 2, one wav bucket): logits max |d| "
            f"{rec['logits_max_abs']:.3g} of |logits| up to {rec['logits_max_magnitude']:.4g} "
            f"(atol {PR_LOGIT_ATOL}); loss {lsc:.6f} / {lsp:.6f}, relative {rec['loss_rel']:.3g} "
            f"(bar {PR_LOSS_RTOL}); gradient norm relative {rec['grad_norm_rel']:.3g} (bar "
            f"{PR_GRAD_NORM_RTOL}); one task's eval frame logits max |d| "
            f"{rec['eval_logits_max_abs']:.3g} (atol {PR_LOGIT_ATOL})")
        if not (rec["logits_max_abs"] <= PR_LOGIT_ATOL and rec["loss_rel"] <= PR_LOSS_RTOL
                and rec["grad_norm_rel"] <= PR_GRAD_NORM_RTOL
                and rec["eval_logits_max_abs"] <= PR_LOGIT_ATOL and len(fc) == len(fp) == 2):
            fail(f"pr {name} card vs CPU: {rec}")
        out[name] = rec
        del cpu
    return out


def phase_pr(seed: int, card: str, attn_checked):
    """Main path, the PR family at full width: corpora from the seed,
    `pack` / `clean`, the readers' host times, training from the shard,
    `train --system pr-ssl-protonet` through the CLI, 32 + 8 episodes of the
    protonet and TransHead systems, the three supervised systems, task
    generation, zero-shot transcription and `evaluate`, card vs CPU."""
    import shutil
    import tempfile
    import torch
    from fscl_tpu_torch.core.config import read_data_config
    from fscl_tpu_torch.data.shards import PackedShard
    from fscl_tpu_torch.frontend import n_symbols

    root = Path(tempfile.mkdtemp(prefix="fscl_pr_"))
    summary = {}
    try:
        t0 = time.perf_counter()
        meta, target = pr_corpora(root, seed)
        log(f"pr: wrote a meta corpus of {PR_TRAIN} + {PR_VAL} and a target corpus of "
            f"{PR_TARGET_UTTS} utterances of {PR_FRAMES[0]}-{PR_FRAMES[1]} mel frames in "
            f"{time.perf_counter() - t0:.2f} s")
        summary["pack"] = pr_pack_and_clean(meta)
        summary["host_reads"] = pr_host_reads(meta)
        summary["shard_steps"] = pr_shard_steps(meta, seed)
        cli_system, summary["cli"] = pr_cli_train(root, meta, attn_checked)
        upstream = cli_system.upstream
        del cli_system
        torch.cuda.empty_cache()
        dc = read_data_config(meta)
        systems = {}
        for kind in ("protonet", "trans_head"):
            systems[kind], summary[kind] = pr_episodic(kind, dc, upstream, seed, attn_checked)
        summary["supervised"] = pr_supervised(dc, upstream, seed, attn_checked)
        summary["eval"], tasks = pr_eval(root, target, systems, attn_checked)
        shard = PackedShard(dc.subset_path("train") + ".fscl.shard")
        shortest = sorted(range(len(shard)),
                          key=lambda i: shard.records[i]["offsets"]["raw_feat"][1][0])[:6]
        check_ep = shard.collate_pr_episode(shortest, 4, 2, dc.symbol_id, n_symbols(dc.symbol_id))
        summary["card_vs_cpu"] = pr_card_vs_cpu(systems, check_ep, pr_check_task(root, tasks),
                                                attn_checked)
        del systems, upstream
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return summary


# -- phase 16: rehearse and the meta-learning variants -------------------------------------

# `rehearse --preset full` through the CLI, each flow in a fresh interpreter
# on synthetic corpora in one cache: the fscl flow at its defaults (40
# episodes) but --adapt_steps 100 (200 by default; its gates are enforced
# from 100, cut for phase 14's T2U configurations); the t2u and pr flows cut
# in depth (their gates advisory below 100 steps or episodes, as in fscl_tpu).
REHEARSE_FLOWS = (("fscl", ("--adapt_steps", "100")),
                  ("t2u", ("--episodes", "5", "--u2s_steps", "5", "--tune_steps", "5")),
                  ("pr", ("--episodes", "5")))
# The meta systems at config/model/fscl-fastspeech2.yaml's widths with
# HuBERT-large (f32) drawn on the card: meta.yaml's 32 + 8 with one
# second-order inner step (train steps 0, the factory's max(., 1)), imaml.yaml's
# 20 + 5 with K = 5 CG steps (reg_param 1) and its 50 inner steps cut to 20
# (to make room for phase 18: 64 -> 37 s; at 10 still 37 s, the CG's
# HVPs taking the rest), the ADA,
# SSL-ADA and semi systems on phase 10's 32 + 8 episodes, ContiAE at B = 8.
# Each takes META_STEPS steps on one episode (or batch) repeated: all but
# the last through `Trainer.fit`, the last split by synchronizes; its loss
# must fall. Adam at META_LR, warm-up 5: half config/train/*.yaml's peak of
# 1e-3, which they reach after 4000 warm-up steps; at 2e-3 from the first
# step, ContiAE's and semi-FSCL's losses rose over their first steps.
META_SHOTS = {"meta": (32, 8), "imaml": (20, 5)}
META_INNER_LR, IMAML_INNER, IMAML_K, IMAML_REG = 1e-3, 20, 5, 1.0
META_KEYS = ("meta", "imaml", "fscl_ada1", "fscl_ada2", "fscl_ssl_ada1", "conti_ae", "semi_fscl")
META_STEPS = 5
# imaml takes 2 and meta 3 (the loss falls over them in every run: imaml's
# first step to its second, meta's first to its third; cut to make room for
# phase 18, then for phase 14's T2U configurations: an imaml step is 7-9 s,
# the CG's HVPs most of it, a meta step 1.6-1.8 s)
META_STEPS_BY_KEY = {"imaml": 2, "meta": 3}
META_LR = 5e-4
CONTI_B = 8
# Card vs CPU at a reduced size (the trunk at full width, a 3-layer custom
# upstream of dim 256 in place of HuBERT-large, dropout off, a small
# episode: S, samples, B, L, T; iMAML's inner loop cut to 1 step (3 until
# the T2U configurations came to phase 14) and K to 2): losses 1e-4
# relative, gradient norms 1e-3 relative (the bars of phases 14 and 15).
META_CHECK = (4, 32000, 4, 32, 128)
META_CHECK_IMAML = (1, 2)
META_LOSS_RTOL, META_GRAD_NORM_RTOL = 1e-4, 1e-3

REHEARSE_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from fscl_tpu_torch.ops import attention as attn
seen = set()
launch = attn.attention_cuda


def recording(q, *args):
    seen.add((*q.shape, str(q.dtype).split(".")[-1]))
    return launch(q, *args)


attn.attention_cuda = recording
from fscl_tpu_torch.cli import main
rc = main(sys.argv[2:])
print("ATTENTION_SHAPES " + json.dumps(sorted(seen)), flush=True)
sys.exit(rc)
"""


def hold_attention_shapes(shapes, checked, what: str) -> int:
    """Hold the attention kernel to its plain version at every key split at
    each (B, H, L, Dh, dtype) of `shapes` that phase 3 did not, right after
    the run that launched it; add them to `checked`. Returns how many."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    new = sorted({tuple(s) for s in shapes} - checked)
    gen = torch.Generator(device="cuda").manual_seed(len(checked))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B, H, L, Dh, dname in new:
        dtype = getattr(torch, dname)
        q, k, v, valid = attention_inputs(gen, B, H, L, Dh, dtype)
        auto = attn.choose_key_split((B, H, L, Dh), dtype, n_sm, False)
        for s in attn.key_splits(Dh):
            check_attention(attn, q, k, v, valid, None if s == auto else s,
                            f"{what}: {dname} B={B} H={H} L={L} Dh={Dh} key_split={s}")
        checked.add((B, H, L, Dh, dname))
    if new:
        log(f"{what}: held {len(new)} attention shapes phase 3 did not hold to the plain "
            f"version at every key split: {new}")
    return len(new)


def rehearse_flow(flow: str, extra, root: Path, attn_checked):
    """`python -m fscl_tpu_torch.cli rehearse --flow <flow> --preset full` in a
    fresh interpreter (its `main` wrapped so that it reports the attention
    shapes it launched): exit code 0 (every enforced gate ok), its phases'
    seconds and launches, its rehearsal.json metrics and gates."""
    import re
    exp = root / f"rehearse_{flow}"
    cmd = [sys.executable, "-c", REHEARSE_CHILD, str(REPO), "rehearse", "--flow", flow,
           "--preset", "full", "--exp_dir", str(exp), "--corpus_cache", str(root / "cache"),
           "--device", CARD, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    report_path = exp / "rehearsal.json"
    report = json.loads(report_path.read_text()) if report_path.is_file() else {}
    for name, g in report.get("gates", {}).items():
        log(f"rehearse {flow}: gate {name}: "
            f"{'ok' if g['ok'] else 'FAIL' if g['enforced'] else 'fail (advisory)'} — "
            f"{g['detail']}")
    if proc.returncode != 0:
        fail(f"rehearse {flow} exited {proc.returncode}:\n{proc.stdout[-3000:]}"
             f"{proc.stderr[-3000:]}")
    phases = re.findall(r"\[rehearse\] (\S+) done in ([\d.]+)s \(launches: attention_fwd (\d+), "
                        r"mrf_stage (\d+), dio_contour (\d+)\)", proc.stdout)
    shapes = next((json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
                   if line.startswith("ATTENTION_SHAPES ")), None)
    if not phases or shapes is None or set(p[0] for p in phases) != set(report["phase_seconds"]):
        fail(f"rehearse {flow}: phases or shapes not reported:\n{proc.stdout[-3000:]}")
    LAUNCHED.setdefault(f"rehearse {flow}", set()).update(tuple(s) for s in shapes)
    hold_attention_shapes(shapes, attn_checked, f"rehearse {flow}")
    launches = {name: {"attention_fwd": int(a), "mrf_stage": int(m), "dio_contour": int(d)}
                for name, _, a, m, d in phases}
    if not sum(v["attention_fwd"] for v in launches.values()):
        fail(f"rehearse {flow}: the attention kernel was never launched")
    metrics = {k: v for k, v in report.items() if isinstance(v, (int, float))}
    log(f"rehearse {flow} (--preset full, {' '.join(extra) or 'defaults'}): {wall:.1f} s wall; "
        + ", ".join(f"{k} {v:.2f} s" for k, v in report["phase_seconds"].items())
        + "; attention launches by phase "
        + ", ".join(f"{k} {v['attention_fwd']}" for k, v in launches.items() if v["attention_fwd"])
        + "; " + ", ".join(f"{k} {v:.4g}" for k, v in metrics.items()))
    return {"wall_s": wall, "phase_seconds": report["phase_seconds"], "launches": launches,
            "attention_launches": sum(v["attention_fwd"] for v in launches.values()),
            "metrics": metrics, "gates": report["gates"]}


def meta_batch(seed: int, B: int):
    """A B-line numpy TTS batch as phase 10's queries (L = 128, T = 512,
    DvecRefs of 10 slices): the support set's own batch."""
    return fscl_episodes(seed, 1, 1, 16000, B, FSCL_L, FSCL_T)[0].qry


def query_speech(seed: int, B: int):
    """B float 16 kHz wavs of 4 s (the last two cut to 3 s) and their lengths."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = np.full(B, FSCL_WAV, np.int32)
    lens[-2:] = 3 * FSCL_WAV // 4
    wavs = (0.1 * rng.normal(size=(B, FSCL_WAV))).astype(np.float32)
    wavs[np.arange(FSCL_WAV)[None, :] >= lens[:, None]] = 0.0
    return wavs, lens


def conti_batch(seed: int, B: int):
    import numpy as np
    from fscl_tpu_torch.systems.conti_ae import ContiAEBatch
    rng = np.random.default_rng(seed)
    wavs, lens = query_speech(seed, B)
    mel_lens = (lens * 22050 // 16000 // 256).astype(np.int32)
    mels = rng.normal(size=(B, FSCL_T, 80)).astype(np.float32)
    mels[np.arange(FSCL_T)[None, :] >= mel_lens[:, None]] = 0.0
    return ContiAEBatch(wavs, lens, mels, mel_lens)


def meta_batches(key: str, seed: int, n: int):
    """`n` numpy batches of the key's kind."""
    from fscl_tpu_torch.systems.ada import SSLEpisode
    from fscl_tpu_torch.systems.conti_ae import SemiEpisode
    S, Q = META_SHOTS.get(key, (FSCL_S, FSCL_B))
    if key == "conti_ae":
        return [conti_batch(seed + i, CONTI_B) for i in range(n)]
    eps = fscl_episodes(seed, n, S, FSCL_WAV, Q, FSCL_L, FSCL_T)
    if key in META_SHOTS:
        return [e._replace(sup_batch=meta_batch(seed + 50 + i, S)) for i, e in enumerate(eps)]
    if key == "fscl_ssl_ada1":
        return [SSLEpisode(e.sup, e.qry, *query_speech(seed + 60 + i, Q))
                for i, e in enumerate(eps)]
    if key == "semi_fscl":
        return [SemiEpisode(e, conti_batch(seed + 70 + i, CONTI_B)) for i, e in enumerate(eps)]
    return eps


def build_meta_system(key: str, cfg, seed: int, device, upstream=None, optim=None, **kw):
    """The port's system for `key` as the factory builds it from the key's
    algorithm YAML (config/algorithm/language/{meta,imaml,fscl-ada*}.yaml)."""
    import torch
    from fscl_tpu_torch.systems.ada import TransEmbADASystem, TransEmbSSLADASystem
    from fscl_tpu_torch.systems.conti_ae import ContiAESystem, SemiTransEmbSystem
    from fscl_tpu_torch.systems.maml import IMAMLTransEmbSystem, MAMLTransEmbSystem
    torch.manual_seed(seed)
    common = dict(device=device, optim_cfg=optim, upstream=upstream, upstream_seed=seed)
    if key == "meta":
        return MAMLTransEmbSystem(cfg, FSCL_NSYM, adaptation_lr=META_INNER_LR,
                                  adaptation_steps=kw.get("steps", 1), **common)
    if key == "imaml":
        steps, k = kw.get("imaml", (IMAML_INNER, IMAML_K))
        return IMAMLTransEmbSystem(cfg, FSCL_NSYM, adaptation_lr=META_INNER_LR,
                                   adaptation_steps=steps, cg_steps=k, reg_param=IMAML_REG,
                                   **common)
    if key in ("fscl_ada1", "fscl_ada2"):
        return TransEmbADASystem(cfg, FSCL_NSYM, ada_stage="matching" if key == "fscl_ada1"
                                 else "unsup_tuning", **common)
    if key == "fscl_ssl_ada1":
        return TransEmbSSLADASystem(cfg, FSCL_NSYM, ada_stage="matching", **common)
    if key == "conti_ae":
        return ContiAESystem(cfg, **common)
    return SemiTransEmbSystem(cfg, FSCL_NSYM, **common)


def meta_split(system, state, batch):
    """One step split by synchronizes at the frozen upstream's forwards, the
    inner loop (`inner_adapt`) and iMAML's CG with its Hessian-vector
    products (`cg_solve`); the rest is the table, the outer (query) loss,
    the backward and the optimizer."""
    import torch
    from fscl_tpu_torch.systems import maml
    spent = {"upstream": 0.0, "inner": 0.0, "hvp_cg": 0.0}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    with mock.patch.object(maml, "inner_adapt", timed("inner", maml.inner_adapt)), \
            mock.patch.object(maml, "cg_solve", timed("hvp_cg", maml.cg_solve)), \
            mock.patch.object(system, "extract_ssl", timed("upstream", system.extract_ssl)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = system.train_step(state, batch)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    out = {f"{k}_ms": 1e3 * v for k, v in spent.items()}
    out["outer_ms"] = 1e3 * (total - sum(spent.values()))
    out["step_ms"] = 1e3 * total
    out["loss"] = float(metrics["Total Loss"])
    return out


def meta_run(key: str, cfg, seed: int, upstream, attn_checked, profile: bool = False):
    """META_STEPS steps (META_STEPS_BY_KEY's for a key there) on one episode
    (or batch) repeated: all but the last
    through `Trainer.fit`, the last split by synchronizes; every loss finite
    and the last below the first; steps/s, the split, peak memory,
    attention launches and shapes; with --profile for `meta`, a traced step
    (busy share, kernel launches; no trace file). An `imaml` step is not
    traced: on an H100 the profiler did not finish three of them within 15
    minutes."""
    import itertools
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.train.trainer import Trainer

    steps = META_STEPS_BY_KEY.get(key, META_STEPS)
    n = steps - 1
    train_cfg = t2u_train_config(FSCL_B, log_step=1, save_step=10**9, val_step=10**9,
                                 synth_step=10**9)
    train_cfg = dataclasses.replace(train_cfg, optim=dataclasses.replace(train_cfg.optim,
                                                                         lr=META_LR))
    system = build_meta_system(key, cfg, seed, CARD, upstream, train_cfg.optim)
    batch = meta_batches(key, seed + 3, 1)[0]
    rec = LossRecorder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, f"meta {key}") as seen:
        state = system.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = Trainer(system, train_cfg, callbacks=[rec]).fit(state, itertools.repeat(batch),
                                                                max_steps=n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = attn.LAUNCHES
        split = meta_split(system, state, to_device(batch, CARD))
        peak = torch.cuda.max_memory_allocated() / 2**30
        hold_attention_shapes(seen, attn_checked, f"meta {key}")
    traced = None
    if profile and key == "meta":
        traced = profile_steps(lambda: system.train_step(state, to_device(batch, CARD)), 1, None,
                               f"meta {key}")
    losses = [float(m["Total Loss"]) for _, m, _ in rec.logs] + [split["loss"]]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"meta {key}: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"meta {key}: one episode repeated {steps} times, the loss did not fall: "
             f"{losses}")
    log(f"meta {key}: one episode repeated, {n} steps in {wall:.2f} s = {n / wall:.3f} steps/s, "
        f"loss {' -> '.join(f'{x:.4f}' for x in losses)}; step {steps} "
        f"{split['step_ms']:.1f} ms: upstream {split['upstream_ms']:.1f}, inner loop "
        f"{split['inner_ms']:.1f}, CG + HVPs {split['hvp_cg_ms']:.1f}, outer "
        f"{split['outer_ms']:.1f}; peak {peak:.2f} GiB; {launches} attention launches "
        f"({launches / n:.0f} per step)")
    return system, {"steps": n, "steps_per_s": n / wall, "losses": losses, "split": split,
                    "peak_gib": peak, "attention_launches": launches, "profile": traced}


def meta_card_vs_cpu(cfg, seed: int):
    """At a reduced size (META_CHECK), dropout off: one `meta` episode
    (second order), one `imaml` episode (META_CHECK_IMAML) and one
    `fscl_ada1` step on the card and on the CPU from the same weights:
    losses 1e-4 relative, gradient norms 1e-3 relative; the PostNet's
    running statistics unchanged by the MAML step on both."""
    import torch
    from fscl_tpu_torch.core.config import UpstreamConfig
    from fscl_tpu_torch.data.batch import to_device
    small = dataclasses.replace(cfg, upstream=UpstreamConfig(name="custom", dim=256, n_layers=3))
    S, n_samples, B, L, T = META_CHECK
    ep = fscl_episodes(seed + 9, 1, S, n_samples, B, L, T)[0]
    ep = ep._replace(sup_batch=fscl_episodes(seed + 10, 1, 1, 16000, S, L, T)[0].qry)
    out = {}
    for key in ("meta", "imaml", "fscl_ada1"):
        got = {}
        card = build_meta_system(key, small, seed, CARD, imaml=META_CHECK_IMAML)
        cpu = build_meta_system(key, small, seed, "cpu", imaml=META_CHECK_IMAML)
        cpu.load_state_dict(card.state_dict(), strict=True)
        for system in (card, cpu):
            for m in system.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
            stats = {k: v.clone() for k, v in system.state_dict().items() if "running" in k}
            mask = system.trainable_mask()
            params = [p for n, p in system.named_parameters() if mask[n]]
            system.train()
            loss, metrics = system.loss_and_metrics(to_device(ep, system.device))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            system.eval()
            norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads if g is not None))
            value = float(metrics["Total Loss"])
            moved = [k for k, v in system.state_dict().items()
                     if "running" in k and not torch.equal(v, stats[k])]
            if key in ("meta", "imaml") and moved:
                fail(f"meta card vs CPU: the {key} step wrote BatchNorm statistics {moved[:3]} "
                     f"on {system.device}")
            got["card" if system is card else "cpu"] = (value, norm)
        (v_card, n_card), (v_cpu, n_cpu) = got["card"], got["cpu"]
        loss_rel = abs(v_card - v_cpu) / abs(v_cpu)
        norm_rel = abs(n_card - n_cpu) / n_cpu
        if loss_rel > META_LOSS_RTOL or norm_rel > META_GRAD_NORM_RTOL:
            fail(f"meta card vs CPU, {key}: loss {v_card} vs {v_cpu} ({loss_rel:.3g}), gradient "
                 f"norm {n_card} vs {n_cpu} ({norm_rel:.3g})")
        out[key] = {"loss_rel": loss_rel, "grad_norm_rel": norm_rel, "loss": v_cpu}
        log(f"meta card vs CPU, {key}: loss rel {loss_rel:.3g} (bar {META_LOSS_RTOL:g}), "
            f"gradient norm rel {norm_rel:.3g} (bar {META_GRAD_NORM_RTOL:g})"
            + ("; PostNet BatchNorm statistics unchanged on both" if key != "fscl_ada1" else ""))
        del card, cpu
    return out


def phase_meta(seed: int, card: str, attn_checked, profile: bool = False):
    """Phase 16: `rehearse --preset full`, its three flows through the CLI;
    the meta systems in process at full width; card vs CPU."""
    import shutil
    import tempfile
    import torch

    root = Path(tempfile.mkdtemp(prefix="fscl_meta_"))
    summary = {"rehearse": {}, "systems": {}}
    try:
        for flow, extra in REHEARSE_FLOWS:
            summary["rehearse"][flow] = rehearse_flow(flow, extra, root, attn_checked)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = fscl_model_config("float32")
    upstream = None
    for key in META_KEYS:
        system, summary["systems"][key] = meta_run(key, cfg, seed, upstream, attn_checked,
                                                   profile)
        upstream = system.upstream
        del system
        torch.cuda.empty_cache()
    del upstream
    torch.cuda.empty_cache()
    summary["card_vs_cpu"] = meta_card_vs_cpu(fscl_model_config("float32"), seed)
    torch.cuda.empty_cache()
    return summary


# -- phase 17: precision, remat and observability -------------------------------

def precision_system(cfg, seed: int, device: str):
    """BaselineSystem at `cfg` with torch's init under `seed` (the same
    weights whatever cfg's compute dtype and remat), the PostNet's dropout
    off, Adam at PREC_LR / PREC_EPS after a 10-step warmup."""
    import torch
    from fscl_tpu_torch.core.config import OptimConfig
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.systems.baseline import BaselineSystem

    optim = OptimConfig(batch_size=TRAIN_B, lr=PREC_LR, eps=PREC_EPS, warmup_step=10,
                        anneal_steps=())
    torch.manual_seed(seed)
    system = BaselineSystem(cfg, (("en", n_symbols("en")),), device=device, optim_cfg=optim)
    system.model.postnet.dropout.p = 0.0
    return system


def phase_precision_kernel(seed: int, attn_checked):
    """The attention kernel in bf16 under `AttentionFunction` at the shapes
    the bf16 runs launch (B = 16, H = 2, L = 128 and 512, Dh = 128): the
    forward against the plain version at every key split (phase 3's bf16
    bars), and each gradient against autograd through the plain version
    within BF16_GRAD_REL of that gradient's largest |entry| (the Function's
    backward recomputes in f32 and rounds each gradient to bf16; the plain
    version's autograd rounds the weights to bf16 first; measured on the CPU
    about 5e-3); dk of the sample with no valid key exactly 0. The backward
    is the backward kernel (one launch each). The shapes join the sets the
    recorders accept."""
    import torch
    from fscl_tpu_torch.ops import attention as attn

    gen = torch.Generator(device=CARD).manual_seed(seed + 17)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    H, Dh, worst = 2, 128, {"fwd": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for L in (TRAIN_L, TRAIN_T):
        q, k, v, valid = attention_inputs(gen, TRAIN_B, H, L, Dh, torch.bfloat16)
        auto = attn.choose_key_split((TRAIN_B, H, L, Dh), torch.bfloat16, n_sm, False)
        errs = {"fwd": max(check_attention(attn, q, k, v, valid, None if s == auto else s,
                                           f"precision bfloat16 B={TRAIN_B} L={L} key_split={s}")
                           for s in attn.key_splits(Dh))}
        attn_checked.add((TRAIN_B, H, L, Dh, "bfloat16"))
        g = torch.randn(q.shape, generator=gen, device=CARD).to(torch.bfloat16)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        bwd_before = attn.BWD_LAUNCHES
        out = attn.attend(*leaves, valid)
        if out.grad_fn is None or out.dtype != torch.bfloat16:
            fail("attend in bf16 under autograd: no grad_fn or not bf16")
        got = torch.autograd.grad(out, leaves, g)
        if attn.BWD_LAUNCHES - bwd_before != 2:
            fail(f"precision Function at L={L}: {attn.BWD_LAUNCHES - bwd_before} backward "
                 f"kernel launches, expected 2")
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(attn.attention_reference(*ref_leaves, valid), ref_leaves, g)
        for n, a, b in zip("qkv", got, want):
            if a.dtype != torch.bfloat16 or not torch.isfinite(a.float()).all():
                fail(f"precision Function d{n} at L={L}: {a.dtype}, or non-finite")
            errs[f"d{n}"] = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        dead = float(got[1][-1].float().abs().max())
        log(f"attention Function B={TRAIN_B} H={H} L={L} Dh={Dh} bf16: max |kernel - plain| "
            f"{errs['fwd']:.3g} (bar {BF16_TOL}); gradients against autograd of the plain "
            f"version, relative to each one's max: dq {errs['dq']:.3g}, dk {errs['dk']:.3g}, "
            f"dv {errs['dv']:.3g} (bar {BF16_GRAD_REL}); dk of the all-invalid sample {dead:.3g}")
        if max(errs[n] for n in ("dq", "dk", "dv")) > BF16_GRAD_REL or dead != 0.0:
            fail(f"precision: bf16 Function gradients at L={L}: {errs}, dead {dead}")
        BWD_CHECKED.add((TRAIN_B, H, L, L, Dh, "bfloat16"))
        BWD_MAX_ERR["bfloat16"] = max(BWD_MAX_ERR["bfloat16"],
                                      *(errs[n] for n in ("dq", "dk", "dv")))
        worst = {n: max(worst[n], errs[n]) for n in worst}
    return worst


def precision_run(cfg, dtype: str, remat: bool, seed: int, batches, check, card: str,
                  attn_checked):
    """One of the four runs: the first step's loss and gradient norm on
    `check` before any update, then PREC_STEPS steps through `Trainer.fit`
    with a loss read per step; steps/s over the steps after the fifth,
    peak memory, attention launches (each block once per step, again in the
    backward under remat)."""
    import torch
    from fscl_tpu_torch.core.config import TrainConfig
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.train.trainer import Trainer

    name = f"{dtype}{' + remat' if remat else ''}"
    system = precision_system(dataclasses.replace(cfg, compute_dtype=dtype, remat=remat),
                              seed, CARD)
    system.train()
    loss, _ = system.loss_and_metrics(to_device(check, CARD))
    params = [p for p in system.parameters() if p.requires_grad]
    grads = [g for g in torch.autograd.grad(loss, params, allow_unused=True) if g is not None]
    loss0 = float(loss.detach())
    gnorm0 = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    system.eval()
    del loss, grads
    state = system.init_state()
    rec = LossRecorder()
    train_cfg = TrainConfig(optim=system.optim_cfg, total_step=PREC_STEPS, log_step=1,
                            val_step=10 ** 9, save_step=10 ** 9, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, f"precision {name}"):
        t0 = time.perf_counter()
        state = Trainer(system, train_cfg, [rec]).fit(state, iter(batches))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = attn.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["Total Loss"] for _, m, _ in rec.logs]
    t = cfg.transformer
    want = (t.encoder_layer + t.decoder_layer) * PREC_STEPS * (2 if remat else 1)
    if state.step != PREC_STEPS or len(losses) != PREC_STEPS:
        fail(f"precision {name}: {state.step} steps, {len(losses)} losses")
    if not all(math.isfinite(x) for x in losses):
        fail(f"precision {name}: non-finite loss in {losses}")
    head, tail = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not tail < head:
        fail(f"precision {name}: loss did not fall (first 5 mean {head:.4f}, last 5 {tail:.4f})")
    if launches != want:
        fail(f"precision {name}: {launches} attention launches, expected {want}")
    timed = [sps for step, _, sps in rec.logs if step > 5]
    steps_per_s = len(timed) / sum(1.0 / s for s in timed)
    log(f"precision {name}: {PREC_STEPS} steps at B={TRAIN_B} L={TRAIN_L} T={TRAIN_T}, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {steps_per_s:.2f} steps/s over steps 6-"
        f"{PREC_STEPS} (a loss read per step), {wall:.2f} s in all, peak {peak:.2f} GiB, "
        f"{launches} attention launches; first-step loss {loss0:.6f}, gradient norm "
        f"{gnorm0:.6f}; on {card}")
    del system, state
    torch.cuda.empty_cache()
    return {"dtype": dtype, "remat": remat, "losses": losses, "loss0": loss0, "gnorm0": gnorm0,
            "steps_per_s": steps_per_s, "seconds": wall, "peak_gib": peak,
            "attention_launches": launches, "card": card}


def precision_runs(seed: int, card: str, attn_checked):
    """The four runs on the same weights and batches; remat against no remat
    (first-step loss and gradient norm), bf16 against f32 (the trajectory
    bars)."""
    from fscl_tpu_torch.frontend.define import n_symbols

    cfg = train_model_config(dropout=False)
    stream = train_batches(seed + 17, TRAIN_B, n_symbols("en"), cfg.variance)
    batches = [next(stream) for _ in range(PREC_STEPS)]
    runs = {}
    for dtype, remat in PREC_RUNS:
        runs[(dtype, remat)] = precision_run(cfg, dtype, remat, seed, batches, batches[0], card,
                                             attn_checked)
    checks = {}
    for dtype in ("float32", "bfloat16"):
        a, b = runs[(dtype, False)], runs[(dtype, True)]
        loss_rel = abs(b["loss0"] - a["loss0"]) / abs(a["loss0"])
        gnorm_rel = abs(b["gnorm0"] - a["gnorm0"]) / abs(a["gnorm0"])
        traj = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"]))
        log(f"precision {dtype}: remat against no remat: first-step loss relative |d| "
            f"{loss_rel:.3g} (bar {REMAT_LOSS_RTOL}), gradient norm {gnorm_rel:.3g} (bar "
            f"{REMAT_GNORM_RTOL}); over {PREC_STEPS} steps the losses at most {traj:.3g} apart; "
            f"peak {a['peak_gib']:.2f} -> {b['peak_gib']:.2f} GiB, {a['steps_per_s']:.2f} -> "
            f"{b['steps_per_s']:.2f} steps/s; on {card}")
        if not (loss_rel <= REMAT_LOSS_RTOL and gnorm_rel <= REMAT_GNORM_RTOL):
            fail(f"precision {dtype}: remat moved the first step: loss {loss_rel:.3g}, gradient "
                 f"norm {gnorm_rel:.3g}")
        checks[f"remat_{dtype}"] = {"loss_rel": loss_rel, "gnorm_rel": gnorm_rel,
                                    "trajectory_rel": traj}
    for remat in (False, True):
        f32 = runs[("float32", remat)]["losses"]
        bf16 = runs[("bfloat16", remat)]["losses"]
        rel = [abs(x - y) / max(abs(y), 1e-3) for x, y in zip(bf16, f32)]
        name = "bf16 + remat against f32 + remat" if remat else "bf16 against f32"
        log(f"precision {name}: relative |d| of the losses first {rel[0]:.3g} (bar "
            f"{BF16_FIRST}), last {rel[-1]:.3g} (bar {BF16_LAST}), largest {max(rel):.3g} "
            f"(bar {BF16_ANY}); on {card}")
        if not (rel[0] < BF16_FIRST and rel[-1] < BF16_LAST and max(rel) < BF16_ANY):
            fail(f"precision {name}: trajectory outside the bars: {rel}")
        checks[f"bf16_vs_f32{'_remat' if remat else ''}"] = {
            "first": rel[0], "last": rel[-1], "max": max(rel)}
    return {"runs": {f"{d}{'_remat' if r else ''}": v for (d, r), v in runs.items()},
            "checks": checks}


def precision_serving(seed: int, card: str, attn_checked):
    """`synthesize` of phase 4's 32 lines in bf16 against f32, the same
    weights (duration head pinned as phase 4) and the same mel bucket per
    batch. Bars: every mel finite; the rounded durations equal on at least
    half of the lines; on those lines mean |d| over valid frames within
    SERVE_BF16_MEAN. No max bar: a pitch or energy prediction that crosses a
    bin edge swaps that frame's embedding (on the CPU at full width max |d|
    reached 1.2 at values up to 2.1), and a duration rounded the other way
    shifts the frames after it. The mean is pooled over the lines' frames:
    a short line's own mean is a few frames' swaps."""
    import numpy as np
    import torch
    from fscl_tpu_torch.frontend import text_to_sequence
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.serve import CLEANERS, L_BUCKETS, pack_batch
    from fscl_tpu_torch.systems.baseline import BaselineSystem

    cfg, f32 = build_system(seed, CARD)
    bf16 = BaselineSystem(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                          (("en", n_symbols("en")),), device=CARD)
    bf16.load_state_dict(f32.state_dict(), strict=True)
    seqs = [text_to_sequence(line, list(CLEANERS), "en") for line in LINES]
    same, means, maxes, ms = 0, [], [], {"float32": 0.0, "bfloat16": 0.0}
    total, frames = 0.0, 0
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "precision serve bf16"):
        for start in range(0, len(seqs), 8):
            texts, lens = pack_batch(seqs[start:start + 8], L_BUCKETS)
            B = len(lens)
            spk, lang = np.zeros(B, np.int64), np.zeros(B, np.int64)
            T = f32.pick_mel_bucket(texts, lens, spk, lang, "en")
            outs = {}
            for name, s in (("float32", f32), ("bfloat16", bf16)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = s.synthesize(texts, lens, T, spk, lang, symbol_id="en")
                torch.cuda.synchronize()
                ms[name] += 1e3 * (time.perf_counter() - t0)
            a, b = outs["float32"], outs["bfloat16"]
            if not torch.isfinite(b.postnet_mel).all() or b.postnet_mel.dtype != torch.float32:
                fail("precision serve: bf16 mel non-finite or not f32")
            for i in range(B):
                if not torch.equal(a.duration_rounded[i], b.duration_rounded[i]):
                    continue
                same += 1
                n = int(a.mel_len[i])
                d = (a.postnet_mel[i, :n] - b.postnet_mel[i, :n]).abs()
                means.append(float(d.mean()))
                maxes.append(float(d.max()))
                total += float(d.sum())
                frames += d.numel()
    launches = attn.LAUNCHES
    pooled = total / frames if frames else math.inf
    log(f"precision serve: {len(LINES)} lines in bf16 against f32: {same} with equal rounded "
        f"durations, on them mean |d| {pooled:.3g} over all their frames (bar "
        f"{SERVE_BF16_MEAN}), a line's mean up to {max(means) if means else 0:.3g}, max |d| up "
        f"to {max(maxes) if maxes else 0:.3g}; synthesize {ms['float32']:.1f} ms f32, "
        f"{ms['bfloat16']:.1f} ms bf16 for the 4 batches; {launches} attention launches; "
        f"on {card}")
    if same < len(LINES) // 2 or pooled > SERVE_BF16_MEAN:
        fail(f"precision serve: {same} lines with equal durations, mean |d| {pooled:.3g}")
    del f32, bf16
    torch.cuda.empty_cache()
    return {"lines": len(LINES), "equal_durations": same, "mean_abs": pooled,
            "max_line_mean_abs": max(means) if means else None,
            "max_abs": max(maxes) if maxes else None, "ms": ms, "attention_launches": launches}


def synth_saver_run(seed: int, root: Path, card: str, attn_checked, stage_checked):
    """`Trainer.fit` with a SynthSaver (HiFi-GAN V1 of random weights from
    the seed) for one step and one validation: the saver's teacher-forced
    forward and `synthesize` of the first validation line, both vocoded
    through the MRF stage kernel; its mels against a CPU copy of the system
    (SAVER_MEL_ATOL) and its wavs finite and bounded."""
    import numpy as np
    import torch
    from fscl_tpu_torch.audio_out.vocoder import Vocoder
    from fscl_tpu_torch.core.config import TrainConfig
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.obs import SynthSaver
    from fscl_tpu_torch.obs.figures import have_matplotlib
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops import mrf_stage as mrf
    from fscl_tpu_torch.train.trainer import Trainer

    figures = have_matplotlib()
    cfg = train_model_config(dropout=False)
    system = precision_system(cfg, seed, CARD)
    stream = train_batches(seed + 19, CHECK_B, n_symbols("en"), cfg.variance)
    train, val = next(stream), next(stream)
    vocoder = Vocoder(build_vocoder(seed, CARD), "HifiGAN", device=CARD)
    saver = SynthSaver(str(root / "synth"), system, vocoder=vocoder, synth_step=1,
                       write_figures=figures)
    stages = []
    launch = mrf.mrf_stage_cuda

    def record_stage(x, *args, **kwargs):
        stages.append(tuple(x.shape))
        return launch(x, *args, **kwargs)

    train_cfg = TrainConfig(optim=system.optim_cfg, total_step=1, log_step=1, val_step=1,
                            save_step=10 ** 9, seed=seed)
    attn.LAUNCHES = mrf.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "synth saver") as seen, \
            mock.patch.object(mrf, "mrf_stage_cuda", record_stage):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Trainer(system, train_cfg, [saver]).fit(system.init_state(), iter([train]),
                                                val_loader=lambda: [val])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hold_attention_shapes(seen, attn_checked, "synth saver")
    launches = {"attention_fwd": attn.LAUNCHES, "mrf_stage": mrf.LAUNCHES}
    hold_stage_shapes(stages, stage_checked, vocoder.model, "synth saver")
    if launches["mrf_stage"] != 8 or not launches["attention_fwd"]:
        fail(f"synth saver: launches {launches}, expected 8 stage launches (2 wavs)")
    for tag in ("recon", "synth"):
        wav = saver.last[tag]["wav"]
        if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0):
            fail(f"synth saver: {tag} wav non-finite or |wav| > 1")
    cpu = precision_system(cfg, seed, "cpu")
    cpu.load_state_dict(system.state_dict(), strict=True)
    cpu_saver = SynthSaver(str(root / "synth-cpu"), cpu, synth_step=1, write_audio=False,
                           write_figures=False)
    cpu_saver.on_validation_sample(1, None, val)
    errs = {}
    for tag in ("recon", "synth"):
        a, b = saver.last[tag]["mel"], cpu_saver.last[tag]["mel"]
        if a.shape != b.shape:
            fail(f"synth saver: {tag} mel {a.shape} on the card, {b.shape} on the CPU")
        errs[tag] = float(np.abs(a - b).max())
    files = sorted(p.name for p in (root / "synth").iterdir())
    log(f"synth saver: Trainer.fit 1 step + 1 validation in {wall:.2f} s, launches {launches}; "
        f"mels card vs CPU max |d| recon {errs['recon']:.3g}, synth {errs['synth']:.3g} (bar "
        f"{SAVER_MEL_ATOL}); files {files} (matplotlib {'present: PNGs written' if figures else 'missing: no PNG'}); on {card}")
    if max(errs.values()) > SAVER_MEL_ATOL:
        fail(f"synth saver: card vs CPU mels {errs}")
    want = {f"step1-{t}.wav" for t in ("recon", "synth")} | (
        {f"step1-{t}.png" for t in ("recon", "synth")} if figures else set())
    if set(files) != want:
        fail(f"synth saver: files {files}, expected {sorted(want)}")
    del system, cpu, vocoder
    torch.cuda.empty_cache()
    return {"seconds": wall, "launches": launches, "mel_max_abs_err": errs, "files": files,
            "figures": figures}


def fscl_saver_run(seed: int, root: Path, card: str, attn_checked):
    """`Trainer.fit` on phase 10's FSCL system (fscl-fastspeech2.yaml,
    HuBERT-large f32 drawn from the seed) with an FSCLSaver, for one episode
    and one validation on FSCL_CHECK-sized episodes: the codebook attention
    per head and the softmax layer weights against a CPU copy (SAVER_ATTN_ATOL)."""
    import numpy as np
    import torch
    from fscl_tpu_torch.core.config import TrainConfig
    from fscl_tpu_torch.models.hubert import make_upstream
    from fscl_tpu_torch.obs.figures import have_matplotlib
    from fscl_tpu_torch.obs.fscl_saver import FSCLSaver
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.train.trainer import Trainer

    figures = have_matplotlib()
    cfg = fscl_model_config("float32")
    system = build_fscl_system(cfg, seed, CARD)
    train, val = fscl_episodes(seed + 23, 2, *FSCL_CHECK)
    saver = FSCLSaver(str(root / "fscl"), system, synth_step=1, write_figures=figures)
    train_cfg = TrainConfig(optim=system.optim_cfg, total_step=1, log_step=1, val_step=1,
                            save_step=10 ** 9, seed=seed)
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "fscl saver") as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Trainer(system, train_cfg, [saver]).fit(system.init_state(), iter([train]),
                                                val_loader=lambda: [val])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hold_attention_shapes(seen, attn_checked, "fscl saver")
    launches = attn.LAUNCHES
    up = cfg.upstream
    with torch.device("meta"):
        shell = make_upstream(up.name, up)
    cpu = build_fscl_system(cfg, seed, "cpu", upstream=shell.to_empty(device="cpu"))
    cpu.load_state_dict(system.state_dict(), strict=True)
    cpu_saver = FSCLSaver(str(root / "fscl-cpu"), cpu, synth_step=1, write_figures=False)
    cpu_saver.on_validation_sample(1, None, val)
    errs = {k: float(np.abs(saver.last[k] - cpu_saver.last[k]).max())
            for k in ("attn", "layer_weights")}
    files = sorted(p.name for p in (root / "fscl").iterdir())
    heads = saver.last["attn"].shape[0]
    log(f"fscl saver: Trainer.fit 1 episode + 1 validation in {wall:.2f} s, {launches} "
        f"attention launches; codebook attention {saver.last['attn'].shape} and layer weights "
        f"card vs CPU max |d| {errs['attn']:.3g}, {errs['layer_weights']:.3g} (bar "
        f"{SAVER_ATTN_ATOL}); files {files} (matplotlib "
        f"{'present: PNGs written' if figures else 'missing: no PNG'}); on {card}")
    if max(errs.values()) > SAVER_ATTN_ATOL or not launches:
        fail(f"fscl saver: card vs CPU {errs}, {launches} attention launches")
    want = ({f"matching-1-step1-head-{h}.png" for h in range(heads)}
            | {"step1-layer-weights.png"}) if figures else set()
    if set(files) != want:
        fail(f"fscl saver: files {files}, expected {sorted(want)}")
    del system, cpu
    torch.cuda.empty_cache()
    return {"seconds": wall, "attention_launches": launches, "max_abs_err": errs,
            "files": files, "figures": figures}


def tracker_cli(seed: int, root: Path, card: str, attn_checked):
    """`train --use_tracker` through the CLI for 3 steps on a small corpus
    (base.yaml with a 2-row speaker table), then `--resume --exp_key <key>`
    to 5: metrics.jsonl holds steps 1-5, meta.json counts one resume."""
    import torch
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.ops import attention as attn

    sys.path.insert(0, str(REPO / "tests"))
    from torch_corpus import write_corpus
    en = write_corpus(str(root), "en-trk", "en", 0, seed + 29, n_train=16, n_val=4,
                      speakers=CLI_SPEAKERS, frames=(172, 400), n_phones=(30, 60))
    model = root / "base-2spk.yaml"
    model.write_text((REPO / "config" / "model" / "base.yaml").read_text()
                     + f"\nspeaker:\n  n_speakers: {len(CLI_SPEAKERS)}\n")
    overlay = cli_train_overlay(root, "tracker-overlay",
                                "optimizer:\n  lr: 0.002\n  warm_up_step: 10\n  anneal_steps: []\n"
                                "step:\n  log_step: 1\n  val_step: 1000\n  save_step: 1000\n")
    exp = root / "exp-tracker"
    args = ["train", "--system", "baseline", "--data_config", en, "--model_config", str(model),
            "--train_config", str(REPO / "config" / "train" / "baseline.yaml"),
            "--train_config", overlay, "--exp_dir", str(exp), "--use_tracker",
            "--device", CARD]
    attn.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "tracker cli") as seen:
        t0 = time.perf_counter()
        cli(args + ["--total_step", "3"])
        (key,) = [p.name for p in (exp / "experiments").iterdir()]
        cli(args + ["--resume", "--exp_key", key, "--total_step", "5"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hold_attention_shapes(seen, attn_checked, "tracker cli")
    launches = attn.LAUNCHES
    exp_dir = exp / "experiments" / key
    meta = json.loads((exp_dir / "meta.json").read_text())
    rows = [json.loads(line) for line in (exp_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in rows if r["name"] == "Train/Total Loss"]
    log(f"tracker cli: train --use_tracker 3 steps, then --resume --exp_key {key} to 5, in "
        f"{wall:.2f} s: resumed {meta.get('resumed')}, params {meta.get('params')}, "
        f"{len(rows)} scalars, losses at steps {[r['step'] for r in losses]}; {launches} "
        f"attention launches; on {card}")
    if meta.get("resumed") != 1 or [r["step"] for r in losses] != [1, 2, 3, 4, 5] \
            or not all(math.isfinite(r["value"]) for r in rows):
        fail(f"tracker cli: meta {meta}, loss steps {[r['step'] for r in losses]}")
    return {"seconds": wall, "exp_key": key, "resumed": meta["resumed"],
            "loss_steps": [r["step"] for r in losses], "attention_launches": launches}


def tacotron2_run(seed: int, card: str):
    """The mel Tacotron2 at Tacotron2Config's defaults (28.4 M parameters):
    a teacher-forced forward at B = TACO_B (L = TACO_L, T = TACO_T mel
    frames, TACO_T / 3 decoder steps) with the same prenet masks on the card
    and on the CPU, each output within TACO_REL of its largest |value|; then
    `infer` for 10 and TACO_INFER_STEPS steps, its decoder steps timed and
    their kernel launches counted by difference (encoder and PostNet cancel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fscl_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config

    cfg = Tacotron2Config()
    torch.manual_seed(seed)
    cpu = Tacotron2(cfg).eval()
    model = Tacotron2(cfg).to(CARD).eval()
    model.load_state_dict(cpu.state_dict(), strict=True)
    g = torch.Generator().manual_seed(seed + 31)
    emb = torch.randn(TACO_B, TACO_L, cfg.symbols_embedding_dim, generator=g)
    lens = torch.tensor([TACO_L, TACO_L - 5, TACO_L // 2, TACO_L // 3])[:TACO_B]
    mels = torch.randn(TACO_B, TACO_T, cfg.n_mels, generator=g)
    n_steps = TACO_T // cfg.n_frames_per_step
    masks = cpu.draw_masks(TACO_B, TACO_L, n_steps, False, g, "cpu")
    on_card = type(masks)(*(None if m is None else m.to(CARD) for m in masks))
    with torch.no_grad():
        want = cpu(emb, lens, mels, masks)
        got = model(emb.to(CARD), lens.to(CARD), mels.to(CARD), on_card)
    errs = {}
    for name, a, b in zip(want._fields, got, want):
        errs[name] = float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-12))
    log(f"tacotron2: teacher-forced B={TACO_B} L={TACO_L} T={TACO_T} ({n_steps} decoder steps) "
        "card vs CPU, max |d| relative to each output's max: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (bar {TACO_REL})")
    if max(errs.values()) > TACO_REL or not torch.isfinite(got.postnet_mel).all():
        fail(f"tacotron2 card vs CPU: {errs}")

    def run(steps):
        m = model.draw_masks(TACO_B, TACO_L, steps, False, None, CARD)
        return model.infer(emb.to(CARD), lens.to(CARD), steps, masks=m)

    run(10)
    times, counts = {}, {}
    for steps in (10, TACO_INFER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(steps)
        torch.cuda.synchronize()
        times[steps] = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
        counts[steps] = sum(e.count for e in prof.key_averages()
                            if e.key.startswith("cudaLaunchKernel"))
    span = TACO_INFER_STEPS - 10
    ms_step = (times[TACO_INFER_STEPS] - times[10]) / span
    launches_step = (counts[TACO_INFER_STEPS] - counts[10]) / span
    if not torch.isfinite(out.postnet_mel).all() or out.mel.shape[1] != \
            TACO_INFER_STEPS * cfg.n_frames_per_step:
        fail("tacotron2 infer: non-finite mel or wrong length")
    log(f"tacotron2: infer {TACO_INFER_STEPS} steps at B={TACO_B}: "
        f"{times[TACO_INFER_STEPS]:.1f} ms in all, {ms_step:.3f} ms and {launches_step:.1f} "
        f"kernel launches per decoder step; frames emitted {out.n_frames.tolist()}; on {card}")
    return {"card_vs_cpu_rel": errs, "infer_ms": times, "ms_per_step": ms_step,
            "launches_per_step": launches_step}


def phase_precision(seed: int, card: str, attn_checked, stage_checked):
    """Phase 17: the bf16 attention Function, the four precision and remat
    runs, bf16 serving, the savers through `Trainer.fit`, the tracker through
    the CLI, and the mel Tacotron2."""
    import shutil
    import tempfile
    import torch
    from fscl_tpu_torch.obs.figures import have_matplotlib

    t0 = time.perf_counter()
    log(f"precision: matplotlib {'present' if have_matplotlib() else 'missing'}: the savers "
        f"{'write' if have_matplotlib() else 'skip'} their PNGs; their device outputs are held "
        "either way")
    summary = {"kernel_grads": phase_precision_kernel(seed, attn_checked)}
    summary.update(precision_runs(seed, card, attn_checked))
    summary["serve_bf16"] = precision_serving(seed, card, attn_checked)
    root = Path(tempfile.mkdtemp(prefix="fscl_obs_"))
    try:
        summary["synth_saver"] = synth_saver_run(seed, root, card, attn_checked, stage_checked)
        summary["fscl_saver"] = fscl_saver_run(seed, root, card, attn_checked)
        summary["tracker"] = tracker_cli(seed, root, card, attn_checked)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["tacotron2"] = tacotron2_run(seed, card)
    torch.cuda.empty_cache()
    summary["seconds"] = time.perf_counter() - t0
    log(f"phase 17 (precision, remat, observability, mel Tacotron2): {summary['seconds']:.1f} s")
    return summary


# -- phase 18: the parallel layer ----------------------------------------------------
# The attention kernel at Lq != Lk (18a): the sequence-parallel upstream's
# shape, HuBERT-large at 4 s (T' = 199, padded to 200) on 2 ranks, 100 local
# frames against 200 gathered at B = 32; a head dim of 128; a ragged pair; and
# the shapes of 18c's CLI run (16 support wavs per data rank in the 4 s and
# 8 s buckets). Timed at the first and, as a control against phase 9's row,
# at Lq = Lk = 199.
PAR_CROSS = ((32, 16, 100, 200, 64), (8, 2, 64, 128, 128), (4, 16, 37, 199, 64),
             (16, 16, 100, 200, 64), (16, 16, 200, 400, 64))
PAR_TIMED = ((32, 16, 100, 200, 64), (32, 16, 199, 199, 64))
# Two ranks sharing the card over gloo (18b), each check against the same
# computation in one process on the card (rank 0 runs it, outside the windows
# that count and time the parallel calls): phase 8's batch shape and rate,
# dropout off, PAR_STEPS steps. First loss 1e-5 relative, its gradient norm
# 1e-4; each first gradient against the same step in float64 on the host,
# tensor by tensor, within 1e-4 of the tensor's own largest entry plus twice
# the one process's own distance from float64 (plus 1e-6 where the gradient
# is 0 in exact arithmetic, tests/test_torch_meta.py's floor): the one
# process on the card is itself up to 2.2e-3 of a tensor's max off float64
# (the decoder's conv FFN, the energy embedding: cuDNN picks its algorithms
# by shape, and half the batch or half the channels is another shape), so a
# bar between the two float32 runs alone would fail a correct step. The
# BatchNorm running statistics after the first step 1e-5 of their largest
# |value|, later losses 1e-3 (phase 8's card-vs-CPU bar) at Adam eps PAR_EPS.
# At phase 8's eps 1e-9 the same data-parallel steps run once more beside the
# one process with each batch's rows reversed, with no bar: Adam's first step
# moves every entry whose gradient exceeds eps by the full rate, so an entry
# whose gradient is rounding alone moves either way, as the summation order
# decides, and the script names the parameters that came out apart after one
# step. HuBERT-large over PAR_WAVS wavs of 4 s (hidden states on valid frames
# within 1e-4 of each layer's max |h|); phase 10's episode (32 + 8) with the
# upstream pipelined and sequence-parallel (table and loss 1e-4 relative);
# phase 11's adaptation shape, PAR_TASKS tasks of PAR_TASK_STEPS steps split
# over the ranks (each task 1e-4 relative); phase 4's 32 lines in batches of
# 8 (mels 1e-3, equal lengths).
# (PR 17 cut PAR_STEPS 5 -> 3, PAR_WAVS and PAR_TASKS 8 -> 4 for its
# attention checks.)
PAR_RANKS, PAR_STEPS, PAR_WAVS, PAR_TASKS, PAR_TASK_STEPS = 2, 3, 4, 4, 3
PAR_LOSS_RTOL, PAR_GNORM_RTOL, PAR_STATS_REL, PAR_HIDDEN_REL = 1e-5, 1e-4, 1e-5, 1e-4
PAR_GRAD_REL, PAR_F32_FACTOR, PAR_ZERO_ATOL = 1e-4, 10.0, 1e-6
PAR_EPS, PHASE8_EPS = 1e-3, 1e-9
# The CLI (18c): `train --system fscl --n_devices 2 --upstream_parallel sp`
# (2 data x 2 model ranks) on phase 12's corpus, then `--resume`.
PAR_CLI_STEPS, PAR_CLI_RESUME = 2, 3
PAR_LABEL = "2 ranks sharing one H100 over gloo: correctness, not scaling"


def cross_bound(B, H, Lq, Lk, Dh, dtype_name, itemsize):
    """Least time for one Lq x Lk attention call: split TF32 is 3 * 4 B H Lq
    Lk Dh operations at 495 TFLOP/s, bf16 4 B H Lq Lk Dh at 989; the bytes
    (2 Lq + 2 Lk) B H Dh x itemsize + B Lk key flags at 3.35 TB/s."""
    flops = 4 * B * H * Lq * Lk * Dh
    t_ops = (3 * flops / PEAK_TF32_FLOPS if dtype_name == "float32"
             else flops / PEAK_FLOPS["bfloat16"]) * 1e3
    t_bytes = ((2 * Lq + 2 * Lk) * B * H * Dh * itemsize + B * Lk) / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cross_inputs(gen, B, H, Lq, Lk, Dh, dtype):
    import torch
    q = torch.randn(B, H, Lq, Dh, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, H, Lk, Dh, generator=gen, device="cuda").to(dtype) for _ in range(2))
    lens = torch.randint(1, Lk + 1, (B,), generator=gen, device="cuda")
    lens[0] = Lk
    lens[-1] = 0
    return q, k, v, torch.arange(Lk, device="cuda")[None, :] < lens[:, None]


def hold_cross_shapes(shapes, checked, what: str) -> list:
    """The kernel against its plain version at every key split, in f32 and
    bf16 at phase 3's bars, at each (B, H, Lq, Lk, Dh) of `shapes` (dtype
    too when given) not yet in `checked`; returns the max |err| per dtype."""
    import torch
    from fscl_tpu_torch.ops import attention as attn
    gen = torch.Generator(device="cuda").manual_seed(len(checked) + 18)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for shape in shapes:
        for dname in ((shape[5],) if len(shape) > 5 else ("float32", "bfloat16")):
            key = (*shape[:5], dname)
            if key in checked:
                continue
            B, H, Lq, Lk, Dh = shape[:5]
            q, k, v, valid = cross_inputs(gen, B, H, Lq, Lk, Dh, getattr(torch, dname))
            for s in attn.key_splits(Dh):
                errs[dname] = max(errs[dname], check_attention(
                    attn, q, k, v, valid, s,
                    f"{what}: {dname} B={B} H={H} Lq={Lq} Lk={Lk} Dh={Dh} key_split={s}"))
            checked.add(key)
    return errs


def phase_parallel_kernel(seed: int, cross_checked):
    """18a: the attention kernel at Lq != Lk held and timed."""
    import torch
    import torch.nn.functional as F
    from fscl_tpu_torch.ops import attention as attn

    errs = hold_cross_shapes(PAR_CROSS, cross_checked, "parallel kernel")
    log(f"parallel kernel: Lq != Lk held to the plain version at every key split at "
        f"{len(PAR_CROSS)} shapes: max err f32 {errs['float32']:.3g} (bar {F32_ATOL}), bf16 "
        f"{errs['bfloat16']:.3g}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.Stream()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, H, Lq, Lk, Dh in PAR_TIMED:
            q, k, v, valid = cross_inputs(gen, B, H, Lq, Lk, Dh, dtype)
            mask4 = valid[:, None, None, :]
            split_ms = {s: graph_time_ms(lambda: attn._launch(q, k, v, valid, None, s), 50,
                                         stream) for s in attn.key_splits(Dh)}
            key_split = attn.choose_key_split((B, H, Lq, Dh), dtype, n_sm, False)
            plain_ms = graph_time_ms(lambda: attn.attention_reference(q, k, v, valid), 10, stream)
            library_ms = graph_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4), 50, stream)
            bound_ms, bound_by = cross_bound(B, H, Lq, Lk, Dh, dname, q.element_size())
            row = {"B": B, "H": H, "Lq": Lq, "Lk": Lk, "Dh": Dh, "dtype": dname,
                   "key_split": key_split, "ms": split_ms[key_split], "ms_by_key_split": split_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bound_share": bound_ms / split_ms[key_split]}
            rows.append(row)
            log(f"attention {dname:8s} B={B} H={H} Lq={Lq} Lk={Lk} Dh={Dh}: kernel "
                f"{row['ms']:.4f} ms (key_split {key_split}; " + "/".join(map(str, split_ms)) + ": "
                + "/".join(f"{split_ms[s]:.4f}" for s in split_ms)
                + f"), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {100 * row['bound_share']:.1f}% of bound")
    return {"max_abs_err": errs, "timed": rows}


def par_probe_gloo(device):
    """Which collectives gloo takes on CUDA tensors here: each is tried on
    both ranks at once (a refusal is raised before any message is sent)."""
    import torch
    import torch.distributed as dist
    t = torch.ones(4, device=device)
    out = {}
    for name, fn in (("broadcast", lambda: dist.broadcast(t, 0)),
                     ("all_reduce", lambda: dist.all_reduce(t)),
                     ("all_gather", lambda: dist.all_gather([torch.empty_like(t)] * 2, t))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except (RuntimeError, ValueError) as e:
            out[name] = f"refuses CUDA tensors ({str(e).splitlines()[0][:80]})"
        dist.barrier()
    return out


class _GradRecorder:
    """Records the first update's gradients by parameter name, and every
    global gradient norm the optimizer clips by."""

    def __init__(self, system):
        opt = system.optimizer
        names = {id(p): n for n, p in system.named_parameters()}
        self.norm, self.update, self.norms, self.grads = opt.grad_norm, opt.update, [], None

        def update(state, grads):
            if self.grads is None:
                self.grads = {names[id(p)]: g.detach().float().cpu().clone()
                              for p, g in zip(opt.params, grads)}
            return self.update(state, grads)

        opt.grad_norm, opt.update = self, update

    def __call__(self, grads):
        n = self.norm(grads)
        self.norms.append(float(n))
        return n


def par_train(system, batches, step, device):
    """PAR_STEPS steps; (losses, the first step's gradient norm, its
    gradients by name, the PostNet's running statistics after it, the
    parameters after it)."""
    import torch
    from fscl_tpu_torch.data.batch import to_device
    rec = _GradRecorder(system)
    state = system._par_state
    losses, stats, after = [], None, None
    for i, b in enumerate(batches):
        state, m = step(state, to_device(b, device))
        losses.append(float(m["Total Loss"]))
        if i == 0:
            stats = torch.cat([t.detach().float().flatten() for n, t in system.named_buffers()
                               if "running" in n]).cpu()
            after = {n: p.detach().cpu().clone() for n, p in system.named_parameters()}
    return losses, rec.norms[0], rec.grads, stats, after


def zero_in_exact_arithmetic(name: str) -> bool:
    """A gradient that is 0 in exact arithmetic, so rounding alone
    (tests/test_torch_meta.py's list): an attention key's bias (softmax
    ignores a shift of every score) and a conv bias before the PostNet's
    train-mode BatchNorm (the batch mean takes the shift away)."""
    return name.endswith("attn.w_ks.bias") or (
        ".postnet.convolutions." in name and name.endswith(".conv.bias"))


def grads_rel(got: dict, want: dict):
    """(the worst tensor's |got - want| over its own max |want| plus
    PAR_ZERO_ATOL / PAR_GRAD_REL where the gradient is 0 in exact
    arithmetic, that tensor's name): within PAR_GRAD_REL is each tensor
    within PAR_GRAD_REL of its own largest entry (+ PAR_ZERO_ATOL)."""
    worst, at = 0.0, None
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        denom = float(w.abs().max()) + (PAR_ZERO_ATOL / PAR_GRAD_REL
                                        if zero_in_exact_arithmetic(k) else 0.0)
        r = err / denom if denom > 0 else (0.0 if err == 0 else math.inf)
        if r >= worst:
            worst, at = r, k
    return worst, at


def diverged_leaves(after: dict, want: dict, rate: float, top: int = 8) -> list:
    """The parameters that one Adam step left more than half the step's
    rate apart: (name, entries apart, entries), most first."""
    rows = [(k, int(((after[k] - w).abs() > 0.5 * rate).sum()), w.numel())
            for k, w in want.items()]
    return sorted((r for r in rows if r[1]), key=lambda r: -r[1])[:top]


def float64_gradients(cfg, seed: int, card_system, batch) -> dict:
    """The first step's gradients by name in float64 on the host (the plain
    versions) from `card_system`'s initial weights."""
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.train.precision import cast_floating
    cpu = build_train_system(cfg, seed, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card_system.state_dict().items()})
    cpu.model.postnet.dropout.p = 0.0
    cpu.double()
    cpu.init_state()
    grads, _ = cpu.grads_and_metrics(cast_floating(to_device(batch, "cpu"), torch.float64))
    names = {id(p): n for n, p in cpu.named_parameters()}
    return {names[id(p)]: torch.zeros_like(p) if g is None else g
            for p, g in zip(cpu.optimizer.params, grads)}


def against_float64(got: dict, one: dict, truth: dict) -> dict:
    """Each tensor of a run's first gradients against float64 (`truth`),
    beside the one process's on the card (`one`): the worst tensor's |got -
    truth| over PAR_GRAD_REL of its own max |truth| plus PAR_F32_FACTOR
    times the one process's own |one - truth| (plus PAR_ZERO_ATOL where the
    gradient is 0 in exact arithmetic); within 1 is every tensor within its
    bound. With both runs' errors over the tensor's max there too, and the
    largest |got - truth| / |one - truth| over the tensors whose one-process
    error is above 1e-5 of their max (how far two float32 roundings of one
    gradient lie apart)."""
    worst = {"ratio": 0.0}
    spread = 0.0
    for k, t in truth.items():
        scale = float(t.abs().max())
        err = float((got[k].double() - t).abs().max())
        err_one = float((one[k].double() - t).abs().max())
        if not zero_in_exact_arithmetic(k) and err_one > 1e-5 * scale:
            spread = max(spread, err / err_one)
        bound = PAR_GRAD_REL * scale + PAR_F32_FACTOR * err_one + (
            PAR_ZERO_ATOL if zero_in_exact_arithmetic(k) else 0.0)
        ratio = err / bound if bound > 0 else (0.0 if err == 0 else math.inf)
        if ratio >= worst["ratio"]:
            worst = {"ratio": ratio, "tensor": k, "rel": err / scale if scale else err,
                     "one_rel": err_one / scale if scale else err_one}
    return {**worst, "spread": spread}


def float64_worst(one: dict, truth: dict, top: int = 4) -> list:
    """The one process's `top` tensors furthest from float64, each over its
    own max (the tensors whose gradient is 0 in exact arithmetic left out)."""
    rows = [(k, float((one[k].double() - t).abs().max()) / float(t.abs().max()))
            for k, t in truth.items() if not zero_in_exact_arithmetic(k) and t.abs().max() > 0]
    return sorted(rows, key=lambda r: -r[1])[:top]


def par_rank(rank: int, device, seed: int):
    """18b, one rank: every parallel entry point, and on rank 0 the same
    computation in one process, outside the windows that time and count the
    parallel calls; returns the numbers the parent checks."""
    import dataclasses
    import itertools
    import numpy as np
    import torch
    from fscl_tpu_torch.core.device import resolve_device
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.models.hubert import frozen_upstream_features
    from fscl_tpu_torch.ops import attention as attn
    from fscl_tpu_torch.ops.masking import length_mask
    from fscl_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from fscl_tpu_torch.parallel.pipeline import (attach_parallel_upstream,
                                                   pipeline_upstream_features)
    from fscl_tpu_torch.parallel.sequence_parallel import sequence_parallel_upstream_features
    from fscl_tpu_torch.parallel.serving import make_parallel_synth
    from fscl_tpu_torch.parallel.tensor_parallel import (fastspeech2_param_spec,
                                                          make_tp_train_step, shard_state,
                                                          shard_tensor)
    from fscl_tpu_torch.systems.tune import (adapt_many_on_chip, adapt_many_sharded,
                                             adaptable_params)
    from fscl_tpu_torch.train.trainer import make_parallel_train_step

    resolve_device(str(device))          # TF32 off, as every entry point sets it
    lead = rank == 0
    out = {"backend": torch.distributed.get_backend(), "seconds": {}, "launches": {},
           "shapes": set()}
    out["bwd_shapes"], out["bwd_launches"] = set(), {}
    launch, launch_bwd = attn.attention_cuda, attn.attention_bwd_cuda

    def recording(q, k, *a):
        out["shapes"].add((*q.shape, k.shape[2], str(q.dtype).split(".")[-1]))
        return launch(q, k, *a)

    def recording_bwd(q, k, *a):
        out["bwd_shapes"].add((*q.shape[:3], k.shape[2], q.shape[3],
                               str(q.dtype).split(".")[-1]))
        return launch_bwd(q, k, *a)

    attn.attention_cuda = recording
    attn.attention_bwd_cuda = recording_bwd
    out["gloo_cuda"] = par_probe_gloo(device)
    dp, tp = make_mesh(PAR_RANKS, 1, device), make_mesh(1, PAR_RANKS, device)

    def parallel(name, fn, *args):
        """One call of a parallel entry point, both ranks started together:
        its attention launches (the count set to 0 just before the call and
        read just after) and its wall seconds, added to the part's."""
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        attn.LAUNCHES = 0
        attn.BWD_LAUNCHES = 0
        res = fn(*args)
        n, n_bwd = attn.LAUNCHES, attn.BWD_LAUNCHES
        torch.cuda.synchronize()
        out["seconds"][name] = out["seconds"].get(name, 0.0) + time.perf_counter() - t0
        out["launches"][name] = out["launches"].get(name, 0) + n
        out["bwd_launches"][name] = out["bwd_launches"].get(name, 0) + n_bwd
        return res

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # -- the data-parallel and the tensor-parallel train step
    cfg = train_model_config(dropout=False)
    batches = list(itertools.islice(train_batches(seed + 18, TRAIN_B, n_symbols("en"),
                                                  cfg.variance), PAR_STEPS))

    def train_system(eps):
        s = build_train_system(cfg, seed, str(device))
        s.optim_cfg = dataclasses.replace(s.optim_cfg, eps=eps)
        s.model.postnet.dropout.p = 0.0
        s._par_state = s.init_state()
        return s

    def reversed_rows(b):
        return type(b)(*(np.ascontiguousarray(x[::-1]) if isinstance(x, np.ndarray) and x.ndim
                         else x for x in b))

    runs = {}
    for eps, tag in ((PAR_EPS, ""), (PHASE8_EPS, "_eps_1e-9")):
        ref = ref_reversed = None
        if lead:
            s = train_system(eps)
            ref = par_train(s, batches, s.train_step, device)
            rate = s.optimizer.schedule(0)
            del s
            if tag:       # the same steps with each batch's rows in reverse order
                s = train_system(eps)
                ref_reversed = par_train(s, [reversed_rows(b) for b in batches], s.train_step,
                                         device)
                del s
        s = train_system(eps)
        replicate(s, dp)
        runs["dp" + tag] = (parallel("dp_train" + tag, par_train, s,
                                     [shard_batch(b, dp) for b in batches],
                                     make_parallel_train_step(s, dp), device), ref)
        del s
        if tag:
            runs["reversed" + tag] = (ref_reversed, ref)
            continue
        s = train_system(eps)
        s._par_state = shard_state(s, s._par_state, tp)
        runs["tp"] = (parallel("tp_train", par_train, s, batches, make_tp_train_step(s, tp),
                               device), ref)
        del s
    if lead:
        s = train_system(PAR_EPS)
        truth = float64_gradients(cfg, seed, s, batches[0])
        del s
        out["one_process_float64_worst"] = float64_worst(runs["dp"][1][2], truth)
        for name, ((losses, gnorm, grads, stats, after), ref) in runs.items():
            # rank 0's shard of each tensor-parallel gradient and parameter
            want, want_after, want64 = ({k: shard_tensor(g, fastspeech2_param_spec(k)
                                                         if name == "tp" else None, PAR_RANKS, 0)
                                         for k, g in d.items()}
                                        for d in (ref[2], ref[4], truth))
            worst, at = grads_rel(grads, want)
            out[name] = {
                "losses": losses, "ref_losses": ref[0],
                "first_loss_rel": abs(losses[0] - ref[0][0]) / abs(ref[0][0]),
                "later_loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref[0])),
                "gnorm_rel": abs(gnorm - ref[1]) / ref[1],
                "grads_rel": worst, "grads_worst": at,
                "float64": against_float64(grads, want, want64),
                "stats_rel": float((stats - ref[3]).abs().max() / ref[3].abs().max()),
                "diverged_after_step_1": diverged_leaves(after, want_after, rate)}

    # -- the pipelined and the sequence-parallel upstream
    fsys = build_fscl_system(fscl_model_config("float32"), seed, str(device))
    ep = to_device(fscl_episodes(seed + 18, 1, FSCL_S, FSCL_WAV, FSCL_B, FSCL_L, FSCL_T)[0],
                   device)
    wavs, wav_lens = ep.sup.wavs[:PAR_WAVS], ep.sup.wav_lens[:PAR_WAVS]
    valid = length_mask(wav_lens, wavs.shape[-1])
    up_out = {"pp": parallel("pp_upstream", pipeline_upstream_features, fsys.upstream, wavs,
                             valid, tp)[0],
              "sp": parallel("sp_upstream", sequence_parallel_upstream_features, fsys.upstream,
                             wavs, valid, tp)[0]}
    if lead:
        want, fv = frozen_upstream_features(fsys.upstream, wavs, valid)
        m = fv[:, :, None, None]
        scale = (want * m).abs().amax(dim=(0, 1, 3))           # each layer's max |h|
        for mode, got in up_out.items():
            err = ((got - want) * m).abs().amax(dim=(0, 1, 3)) / scale
            out[f"upstream_{mode}"] = {"rel": float(err.max()), "shape": tuple(got.shape)}
    del up_out

    # -- the FSCL episode's table and loss with the upstream hook
    if lead:
        ref_table, ref_loss = fscl_table_and_loss(fsys, ep)
    for mode in ("pp", "sp"):
        attach_parallel_upstream(fsys, mode, tp)
        table, loss = parallel(f"fscl_{mode}", fscl_table_and_loss, fsys, ep)
        if lead:
            out[f"fscl_{mode}"] = {"table_rel": rel(table, ref_table),
                                   "loss_rel": abs(loss - ref_loss) / abs(ref_loss)}
    attach_parallel_upstream(fsys, "none", tp)
    del fsys, ep
    torch.cuda.empty_cache()

    # -- the task axis of the adaptation split over the ranks
    from fscl_tpu_torch.core.config import SpeakerConfig
    from fscl_tpu_torch.systems.baseline import BaselineSystem
    acfg = dataclasses.replace(cfg, speaker=SpeakerConfig(n_speakers=8))
    torch.manual_seed(seed)
    asys = BaselineSystem(acfg, (("ko", 100),), device=str(device))
    params = adaptable_params(asys)
    tasks = many_tasks(seed + 18, PAR_TASKS, PAR_TASK_STEPS, False)
    got, got_losses = parallel("adapt_many_sharded",
                               lambda: adapt_many_sharded(asys, params, tasks, dp, lr=MANY_LR,
                                                          symbol_id="ko"))
    if lead:
        want, want_losses = adapt_many_on_chip(asys, params, tasks, lr=MANY_LR, symbol_id="ko")
        out["adapt"] = {
            "loss_rel": float(((got_losses - want_losses).abs() / want_losses.abs()).max()),
            "params_rel": max(params_rel({k: v[i] for k, v in got.items()},
                                         {k: v[i] for k, v in want.items()})
                              for i in range(PAR_TASKS))}
    del asys, params, got

    # -- data-parallel serving
    from fscl_tpu_torch.frontend import text_to_sequence
    from fscl_tpu_torch.serve import CLEANERS, L_BUCKETS, pack_batch
    _, ssys = build_system(seed, str(device))
    worst, same_len = 0.0, True
    for start in range(0, len(LINES), 8):
        seqs = [text_to_sequence(line, list(CLEANERS), "en") for line in LINES[start:start + 8]]
        texts, src_lens = pack_batch(seqs, L_BUCKETS)
        spk, lang = np.zeros(len(seqs), np.int64), np.zeros(len(seqs), np.int64)
        T = ssys.pick_mel_bucket(texts, src_lens, spk, lang, "en")
        mel, mel_len = parallel("serving", make_parallel_synth(ssys, dp, T, "en"),
                                texts, src_lens, spk, lang)
        if lead:
            with torch.inference_mode():
                want = ssys.synthesize(texts, src_lens, T, spk, lang, symbol_id="en")
            worst = max(worst, float((mel - want.postnet_mel).abs().max()))
            same_len = same_len and bool(torch.equal(mel_len, want.mel_len))
    if lead:
        out["serving"] = {"mel_max_abs_err": worst, "same_mel_len": same_len}
    attn.attention_cuda, attn.attention_bwd_cuda = launch, launch_bwd
    return out


def phase_parallel_ranks(seed: int, attn_checked, cross_checked):
    """18b: one spawn of PAR_RANKS ranks on the card; every check's largest
    difference against its bar, the backend, what gloo takes on CUDA, each
    part's wall seconds. Every attention shape a rank launched is then held
    to the plain version here (those phase 3 and 18a did not hold)."""
    import tempfile
    import shutil
    from fscl_tpu_torch.parallel.multihost import launch

    work = tempfile.mkdtemp(prefix="fscl_ranks_")
    t0 = time.perf_counter()
    try:
        res = launch(par_rank, PAR_RANKS, seed, device_type="cuda", workdir=work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    r0 = res[0]
    checks = []
    for name in ("dp", "tp"):
        got = r0[name]
        checks += [(f"{name} first loss", got["first_loss_rel"], PAR_LOSS_RTOL),
                   (f"{name} first gradient norm", got["gnorm_rel"], PAR_GNORM_RTOL),
                   (f"{name} first gradients against float64, each tensor over its bound "
                    f"(worst {got['float64']['tensor']}: {got['float64']['rel']:.3g} of its max, "
                    f"the one process {got['float64']['one_rel']:.3g}; distance over the one "
                    f"process's at most {got['float64']['spread']:.3g})",
                    got["float64"]["ratio"], 1.0),
                   (f"{name} later losses (Adam eps {PAR_EPS})", got["later_loss_rel"],
                    TRAIN_LATER_RTOL),
                   (f"{name} BatchNorm statistics", got["stats_rel"], PAR_STATS_REL)]
    checks += [
        ("dp at eps 1e-9 first loss", r0["dp_eps_1e-9"]["first_loss_rel"], PAR_LOSS_RTOL),
        ("pp upstream hidden", r0["upstream_pp"]["rel"], PAR_HIDDEN_REL),
        ("sp upstream hidden", r0["upstream_sp"]["rel"], PAR_HIDDEN_REL),
        ("pp episode table", r0["fscl_pp"]["table_rel"], FSCL_TABLE_REL),
        ("pp episode loss", r0["fscl_pp"]["loss_rel"], FSCL_LOSS_RTOL),
        ("sp episode table", r0["fscl_sp"]["table_rel"], FSCL_TABLE_REL),
        ("sp episode loss", r0["fscl_sp"]["loss_rel"], FSCL_LOSS_RTOL),
        ("adapt_many_sharded losses", r0["adapt"]["loss_rel"], TUNE_RTOL),
        ("adapt_many_sharded parameters", r0["adapt"]["params_rel"], TUNE_RTOL),
        ("parallel synth mels", r0["serving"]["mel_max_abs_err"], CARD_VS_CPU_ATOL)]
    for name, got, bar in checks:
        log(f"parallel {name}: {got:.3g} (bar {bar})")
    # Phase 8's Adam (eps 1e-9), no bar: the data-parallel steps and the one
    # process with each batch's rows reversed, each against the one process
    for name in ("dp_eps_1e-9", "reversed_eps_1e-9"):
        got = r0[name]
        log(f"parallel {name} (no bar): first gradients' distance from float64 over the one "
            f"process's at most {got['float64']['spread']:.3g}; first gradients "
            f"{got['grads_rel']:.3g} of their own "
            f"max (worst {got['grads_worst']}), later losses {got['later_loss_rel']:.3g} relative "
            f"({got['losses']} against {got['ref_losses']}); parameters more than half the "
            f"first step's rate apart after it (name, entries, of): "
            f"{got['diverged_after_step_1']}")
    log(f"parallel: the one process's first gradients on the card against float64 on the "
        f"host, each tensor over its own max, worst {r0['one_process_float64_worst']}; the "
        f"parallel runs against the one process, each tensor over its own max (no bar): dp "
        f"{r0['dp']['grads_rel']:.3g} ({r0['dp']['grads_worst']}), tp {r0['tp']['grads_rel']:.3g}"
        f" ({r0['tp']['grads_worst']})")
    bad = [(n, g, b) for n, g, b in checks if not g <= b]
    if bad or not r0["serving"]["same_mel_len"]:
        fail(f"parallel: checks over their bars {bad}, equal mel_len "
             f"{r0['serving']['same_mel_len']}")
    for r in res[1:]:
        if r["backend"] != r0["backend"]:
            fail("parallel: the ranks run different backends")
    per_rank = [r["launches"] for r in res]
    # every part does the same work on each rank: its own rows, stage,
    # frames or tasks
    if any(n == 0 for r in per_rank for n in r.values()) or \
            any(r != per_rank[0] for r in per_rank):
        fail(f"parallel: a part launched no attention kernel on a rank, or the ranks "
             f"launched different counts: {per_rank}")
    shapes = set().union(*(r["shapes"] for r in res))
    cross = {s for s in shapes if s[2] != s[4]}
    same = {(B, H, Lq, Dh, d) for B, H, Lq, Dh, Lk, d in shapes if Lq == Lk}
    n_held = hold_attention_shapes(same, attn_checked, "parallel ranks")
    errs = hold_cross_shapes([(B, H, Lq, Lk, Dh, d) for B, H, Lq, Dh, Lk, d in cross],
                             cross_checked, "parallel ranks")
    hold_backward_shapes(set().union(*(r["bwd_shapes"] for r in res)), "parallel ranks")
    log(f"parallel ranks: backend {r0['backend']} ({PAR_LABEL}); gloo on CUDA tensors: "
        f"{r0['gloo_cuda']}; attention launches of each parallel call, per rank "
        f"{per_rank[0]}; {len(shapes)} attention shapes, {n_held} + "
        f"{len(cross)} (Lq != Lk) held after the run; wall seconds of the parallel calls "
        "(rank 0) " + ", ".join(f"{k} {v:.2f}" for k, v in r0["seconds"].items())
        + f"; the spawn {wall:.2f} s")
    return {"label": PAR_LABEL, "backend": r0["backend"], "gloo_cuda": r0["gloo_cuda"],
            "checks": {n: {"value": g, "bar": b} for n, g, b in checks},
            "seconds": r0["seconds"], "spawn_s": wall,
            "launches_per_rank": per_rank[0],
            "launches": {p: sum(r[p] for r in per_rank) for p in per_rank[0]},
            "bwd_launches": {p: sum(r["bwd_launches"].get(p, 0) for r in res)
                             for p in res[0]["bwd_launches"]},
            "shapes": sorted(shapes), "cross_err_after": errs,
            "eps_1e-9": {n: {k: r0[n][k] for k in ("losses", "ref_losses", "later_loss_rel",
                                                   "grads_rel", "grads_worst",
                                                   "diverged_after_step_1")}
                         for n in ("dp_eps_1e-9", "reversed_eps_1e-9")},
            "dp_losses": r0["dp"]["losses"], "tp_losses": r0["tp"]["losses"],
            "ref_losses": r0["dp"]["ref_losses"],
            "one_process_float64_worst": r0["one_process_float64_worst"],
            "float64": {n: r0[n]["float64"] for n in ("dp", "tp", "dp_eps_1e-9",
                                                      "reversed_eps_1e-9")}}


def phase_parallel_cli(seed: int):
    """18c: `train --system fscl --n_devices 2 --upstream_parallel sp` on
    phase 12's corpus (2 data x 2 model ranks on the card), then `--resume`;
    one checkpoint from rank 0 each time. Then an NCCL group of one rank:
    one all_reduce and one broadcast (NCCL at 2 or more ranks needs a card
    per rank, which this machine does not have)."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from fscl_tpu_torch.cli import main as cli
    from fscl_tpu_torch.core.checkpoint import CheckpointManager

    root = Path(tempfile.mkdtemp(prefix="fscl_par_cli_"))
    out = {}
    try:
        sys.path.insert(0, str(REPO / "tests"))
        from torch_corpus import write_corpus
        en, zh = (write_corpus(str(root), f"{sid}-cli", sid, lang, seed + 40 + lang,
                               n_train=CLI_TRAIN, n_val=CLI_VAL, speakers=CLI_SPEAKERS,
                               frames=CLI_FRAMES, n_phones=CLI_PHONES,
                               n_slices=(DVEC_N, DVEC_N), tune=CLI_TUNE_K)
                  for sid, lang in CLI_LANGS)
        overlay = cli_train_overlay(root, "par-overlay",
                                    "optimizer:\n  lr: 0.002\n  warm_up_step: 5\n"
                                    "  anneal_steps: []\nstep:\n  log_step: 1\n"
                                    f"  save_step: {PAR_CLI_RESUME}\n")
        exp = root / "exp-par"
        argv = ["train", "--system", "fscl", "--data_config", en, "--data_config", zh,
                "--model_config", str(REPO / "config" / "model" / "fscl-fastspeech2.yaml"),
                "--algorithm_config",
                str(REPO / "config" / "algorithm" / "language" / "fscl.yaml"),
                "--train_config", str(REPO / "config" / "train" / "fscl.yaml"),
                "--train_config", overlay, "--exp_dir", str(exp),
                "--n_devices", "2", "--upstream_parallel", "sp"]
        for name, extra, steps in (("first", ["--total_step", str(PAR_CLI_STEPS)], [2]),
                                   ("resume", ["--total_step", str(PAR_CLI_RESUME),
                                               "--resume"], [2, 3])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                ret = cli(argv + extra)
            wall = time.perf_counter() - t0
            printed = buf.getvalue()
            sys.stdout.write(printed)
            got = CheckpointManager(str(exp / "ckpt")).all_steps()
            if ret is not None or got != steps or "[parallel] 4 ranks (2 data x 2 model)" \
                    not in printed:
                fail(f"parallel cli {name}: returned {ret!r}, checkpoints {got} (want {steps}), "
                     f"printed {printed[-400:]!r}")
            out[name] = {"wall_s": wall, "checkpoints": got}
            log(f"parallel cli {name}: 4 ranks, checkpoints {got} from rank 0, {wall:.2f} s "
                f"({PAR_LABEL})")
        with open(exp / "log" / "log.txt") as f:
            lines = f.read().splitlines()
        losses = [float(line.split("Total Loss: ")[1].split(" ")[0]) for line in lines]
        if len(losses) != PAR_CLI_RESUME or not all(math.isfinite(x) for x in losses):
            fail(f"parallel cli: losses {losses}")
        out["losses"] = losses
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # NCCL, one rank: the path loads and runs on this card
    store = dist.HashStore()
    dist.init_process_group("nccl", store=store, world_size=1, rank=0)
    try:
        t = torch.arange(4.0, device="cuda")
        dist.all_reduce(t)
        dist.broadcast(t, 0)
        torch.cuda.synchronize()
        if not torch.equal(t.cpu(), torch.arange(4.0)):
            fail(f"parallel: NCCL at world size 1 changed the tensor: {t}")
    finally:
        dist.destroy_process_group()
    out["nccl_world_1"] = "all_reduce and broadcast ran"
    log("parallel: NCCL at world size 1 ran one all_reduce and one broadcast; NCCL at 2 or "
        "more ranks needs a card per rank and is not run here")
    return out


def phase_parallel(seed: int, attn_checked):
    """Phase 18: the kernel at Lq != Lk (18a), two ranks on the card (18b),
    the CLI on four (18c); the phase's seconds."""
    t0 = time.perf_counter()
    cross_checked = set()
    out = {"kernel": phase_parallel_kernel(seed, cross_checked)}
    t1 = time.perf_counter()
    out["ranks"] = phase_parallel_ranks(seed, attn_checked, cross_checked)
    t2 = time.perf_counter()
    out["cli"] = phase_parallel_cli(seed)
    t3 = time.perf_counter()
    out["seconds"] = {"kernel": t1 - t0, "ranks": t2 - t1, "cli": t3 - t2, "phase": t3 - t0}
    out["cross_checked"] = sorted(cross_checked)
    log(f"phase 18 took {t3 - t0:.1f} s: kernel {t1 - t0:.1f} s, ranks {t2 - t1:.1f} s, "
        f"cli {t3 - t2:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one text -> mel and one text -> wav batch "
                         "with torch.profiler")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for a JSON record (and the trace with --profile)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    card = phase_device()
    import torch
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    phase_build()
    mark("1-2 device, build")
    max_err, attn_checked = phase_attention(args.seed)
    mark("3 attention")
    stage_err, stage_timings, stage_checked, stage_big = phase_mrf_stage(args.seed)
    mark("3 mrf stage")
    system, main_path = phase_main_path(args.seed, card, attn_checked, args.profile, args.out)
    mark("4 text -> mel")
    card_vs_cpu = phase_card_vs_cpu(system, LINES[-8:], attn_checked)
    mark("5 card vs CPU")
    vocoder, wav_records, text_to_wav = phase_text_to_wav(
        system, args.seed, card, attn_checked, stage_checked, args.profile, args.out)
    mark("6 text -> wav")
    vocoder_check = phase_vocoder_card_vs_cpu(vocoder, wav_records)
    mark("7 vocoder card vs CPU")
    del system, vocoder, wav_records     # out of the training phase's peak memory
    train = phase_train(args.seed, card, attn_checked, args.profile, args.out)
    mark("8 train")
    train["attention_dh192_e2e"] = attention_wide_e2e(args.seed, attn_checked, DH192_WIDTH,
                                                      DH192_HEADS)
    mark("8 attention Dh 192 end to end")
    train["attention_dh512_e2e"] = attention_wide_e2e(args.seed, attn_checked, DH512_WIDTH,
                                                      DH512_HEADS)
    mark("8 attention Dh 512 end to end")
    train["long_upstream_forward"] = long_upstream_forward(args.seed)
    mark("8 long upstream forward")
    fscl = phase_fscl(args.seed, card, attn_checked, args.profile, args.out)
    mark("10 fscl")
    tune = phase_tune(args.seed, card, attn_checked, args.profile, args.out)
    mark("11 tune")
    cli = phase_cli(args.seed, card, attn_checked, stage_checked, train, fscl)
    mark("12 cli")
    check_f32_precision("phase 12")
    pre = phase_preprocess(args.seed, card, attn_checked, stage_checked, args.profile, args.out)
    mark("13 preprocess")
    check_f32_precision("phase 13")
    t2u = phase_t2u(args.seed, card, attn_checked, stage_checked, args.profile, args.out)
    mark("14 t2u")
    check_f32_precision("phase 14")
    pr = phase_pr(args.seed, card, attn_checked)
    mark("15 pr")
    check_f32_precision("phase 15")
    meta = phase_meta(args.seed, card, attn_checked, args.profile)
    mark("16 meta")
    check_f32_precision("phase 16")
    prec = phase_precision(args.seed, card, attn_checked, stage_checked)
    mark("17 precision")
    check_f32_precision("phase 17")
    par = phase_parallel(args.seed, attn_checked)
    mark("18 parallel")
    check_f32_precision("phase 18")
    timings = phase_attention_timing(args.seed, {
        shape[:4] for what, seen in LAUNCHED.items()
        if what.startswith(("t2u", "pr ", "rehearse ", "meta "))
        for shape in seen if shape[4] == "float32"}, {
        shape[:4] for what, seen in LAUNCHED.items()
        if what.startswith("precision ") for shape in seen if shape[4] == "bfloat16"})
    mark("9 attention timing")

    # the backward kernel's launches on each path, counted by `attention_shapes`
    for path in ("train", "fscl episode float32", "fscl episode bfloat16", "tune adapt sgd",
                 "tune adapt adam", f"tune adapt_many N={max(MANY_TASKS)}"):
        if BWD_BY_PATH.get(path, 0) == 0:
            fail(f"{path}: the attention backward kernel was not launched")
    log("attention backward kernel launches by path: "
        + ", ".join(f"{k} {v}" for k, v in BWD_BY_PATH.items() if v))
    main_row = next(r for r in timings
                    if r["dtype"] == "float32" and r["L"] == 1000 and r["H"] == 2)
    bwd_row = next(r for r in train["attention_fwd_bwd"] if r["L"] == TRAIN_T)
    f32_stages = [r for r in stage_timings if r["dtype"] == "float32"]
    kernels = [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "fscl_tpu_torch/csrc/attention.cu",
        "replaces": "fscl_tpu/ops/attention.py:48",
        "launches": text_to_wav["launches"]["attention_fwd"],
        "launches_by_path": {"text_to_mel": main_path["attention_launches"],
                             "text_to_wav": text_to_wav["launches"]["attention_fwd"],
                             "train": train["attention_launches"],
                             "attention_dh192_e2e": train["attention_dh192_e2e"][
                                 "attention_launches"],
                             "attention_dh512_e2e": train["attention_dh512_e2e"][
                                 "attention_launches"],
                             "long_upstream_forward": train["long_upstream_forward"][
                                 "attention_launches"],
                             "fscl_episode": fscl["float32"]["attention_launches"],
                             "fscl_episode_bf16_upstream": fscl["bfloat16"]["attention_launches"],
                             "tune_reference_table": tune["reference_table"]["float32"][
                                 "attention_launches"],
                             "tune_reference_table_bf16_upstream": tune["reference_table"][
                                 "bfloat16"]["attention_launches"],
                             "tune_adapt_sgd": tune["sgd"]["attention_launches"],
                             "tune_adapt_adam": tune["adam"]["attention_launches"],
                             "tune_adapt_many_n8": tune["many"]["n8"]["attention_launches"],
                             "tune_synthesis": tune["synthesis"]["adam"]["attention_launches"],
                             "cli_train": cli["train"]["first"]["attention_launches"]
                             + cli["train"]["resume"]["attention_launches"],
                             "cli_synth": cli["synth"]["launches"]["attention_fwd"],
                             "cli_fscl": cli["fscl"]["attention_launches"],
                             "cli_tune": cli["tune"]["attention_launches"],
                             "preprocess_train": pre["train"]["base"]["attention_launches"],
                             "preprocess_train_dvec": pre["train"]["dvec"]["attention_launches"],
                             "preprocess_synth_ref_wav": pre["synth"]["launches"][
                                 "attention_fwd"],
                             "t2u_make_units": t2u["make_units"]["attention_launches"],
                             "t2u_make_units_hubert_base": t2u["make_units_sources"]["hubert"][
                                 "attention_launches"],
                             "t2u_upstream_layouts": t2u["upstream_layouts"][
                                 "attention_launches"],
                             "t2u_make_units_ckpt": t2u["make_units_ckpt"]["attention_launches"],
                             "t2u_u2s_train": t2u["u2s"]["attention_launches"],
                             "t2u_fscl_cli": t2u["fscl"]["cli_attention_launches"],
                             "t2u_fscl_episodes": t2u["fscl"]["attention_launches"],
                             "t2u_fscl_c": t2u["fscl_variants"]["fscl-t2u-c"][
                                 "attention_launches"],
                             "t2u_fscl_c2": t2u["fscl_variants"]["fscl-t2u-c2"][
                                 "attention_launches"],
                             "t2u_fscl_bf16_upstream": t2u["bf16_upstream"]["attention_launches"],
                             "t2u_tune_table_bf16_upstream": t2u["bf16_upstream"][
                                 "reference_table_attention_launches"],
                             "t2u_da_tune_cli": t2u["da_tune_cli"]["attention_launches"],
                             "t2u_dae2e_tune": t2u["dae2e"]["attention_launches"],
                             "t2u_tune_init": t2u["e2e"]["tune_init_attention_launches"],
                             "t2u_e2e_tune": t2u["e2e"]["attention_launches"],
                             "t2u_chained": t2u["chained"]["launches"]["attention_fwd"],
                             "pr_cli_train": pr["cli"]["attention_launches"],
                             "pr_protonet_episodes": pr["protonet"]["attention_launches"],
                             "pr_trans_head_episodes": pr["trans_head"]["attention_launches"],
                             **{f"pr_{k}": v["attention_launches"]
                                for k, v in pr["supervised"].items()},
                             "pr_eval_protonet": pr["eval"]["protonet"]["attention_launches"],
                             "pr_eval_trans_head": pr["eval"]["trans_head"][
                                 "attention_launches"],
                             **{f"rehearse_{flow}": r["attention_launches"]
                                for flow, r in meta["rehearse"].items()},
                             **{key: r["attention_launches"]
                                for key, r in meta["systems"].items()},
                             **{f"precision_{key}": r["attention_launches"]
                                for key, r in prec["runs"].items()},
                             "precision_serve_bf16": prec["serve_bf16"]["attention_launches"],
                             "synth_saver": prec["synth_saver"]["launches"]["attention_fwd"],
                             "fscl_saver": prec["fscl_saver"]["attention_launches"],
                             "tracker_cli": prec["tracker"]["attention_launches"],
                             # phase 18: each parallel call's launches, summed
                             # over the 2 ranks sharing the card
                             **{f"parallel_{part}": n
                                for part, n in par["ranks"]["launches"].items()}},
        "max_abs_err": max_err["float32"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "bound_route": main_row["bound_route"],
        "fma_bound_ms": main_row["fma_bound_ms"],
        "timed_at": {k: main_row[k] for k in ("B", "H", "L", "Dh", "dtype")},
        "max_abs_err_bf16": max_err["bfloat16"],
        "by_shape": timings,
        # training: the Function (kernel forward, recompute backward) at
        # B = 16, H = 2, L = 128 and 512, f32; SDPA's forward + backward as
        # library_ms
        "train_grads_max_abs_err": train["kernel_grads_max_abs_err"],
        "train_fwd_bwd": train["attention_fwd_bwd"],
        # bf16 under the Function (phase 17): forward max |kernel - plain|,
        # gradients relative to each one's max
        "train_bf16_grads_rel_err": prec["kernel_grads"],
        # Lq != Lk (phase 18): the sequence-parallel upstream's local frames
        # against the gathered ones; every (B, H, Lq, Lk, Dh, dtype) held at
        # every key split, and timed at the SP shape beside Lq = Lk = 199
        "lq_ne_lk_checked": par["cross_checked"],
        "lq_ne_lk_max_abs_err": par["kernel"]["max_abs_err"],
        "lq_ne_lk_by_shape": par["kernel"]["timed"],
    }, {
        "name": "attention_bwd",
        "route": "cuda",
        "source": "fscl_tpu_torch/csrc/attention_bwd.cu",
        # no Pallas kernel: _pallas_attention_bwd is jax.vjp of xla_attention,
        # which XLA fuses outside any Pallas call
        "replaces": "fscl_tpu/ops/attention.py:120",
        "launches": train["attention_bwd_launches"],
        # every path's launches, read inside `attention_shapes`; phase 18's
        # summed over the 2 ranks sharing the card
        "launches_by_path": {**{k: v for k, v in BWD_BY_PATH.items()},
                             **{f"parallel_{part}": n
                                for part, n in par["ranks"]["bwd_launches"].items()}},
        # against `attention_bwd` (and the Function's against autograd of the
        # plain version): f32 absolute; bf16 relative to each gradient's max
        "max_abs_err": BWD_MAX_ERR["float32"],
        "max_rel_err_bf16": BWD_MAX_ERR["bfloat16"],
        "shapes_checked": sorted(BWD_CHECKED),
        # the train step's decoder shape (B = 16, H = 2, T = 512, Dh = 128,
        # f32): the kernel's device time in a CUDA graph; by CUDA events over
        # back-to-back calls (the host's per-call cost included) as call_ms
        "ms": bwd_row["bwd_kernel_graph_ms"],
        "call_ms": bwd_row["bwd_kernel_ms"],
        "plain_ms": bwd_row["bwd_ms"],
        "bound_ms": bwd_row["bwd_bound_ms"],
        "bound_by": bwd_row["bwd_bound_by"],
        # the library's backward alone (SDPA's efficient-attention backward
        # from its forward's output and log-sum-exp) in a CUDA graph, as
        # "ms"; None with its error's text if torch refused it
        "library_ms": bwd_row["bwd_library"]["graph_ms"],
        "library_call_ms": bwd_row["bwd_library"]["ms"],
        "library_error": bwd_row["bwd_library"]["error"],
        "library_max_abs_diff": bwd_row["bwd_library"]["max_abs_diff_from_kernel"],
        "timed_at": {k: bwd_row[k] for k in ("B", "H", "L", "Dh", "dtype")},
        "function_fwd_bwd_ms": bwd_row["ms"],
        "sdpa_fwd_bwd_ms": bwd_row["library_ms"],
        "by_shape": train["attention_fwd_bwd"],
    }, {
        "name": "mrf_stage",
        "route": "cuda",
        "source": "fscl_tpu_torch/csrc/mrf_stage.cu",
        "replaces": "fscl_tpu/ops/hifigan_fused.py:52",
        "launches": text_to_wav["launches"]["mrf_stage"],
        "launches_by_path": {"text_to_wav": text_to_wav["launches"]["mrf_stage"],
                             "train": train["mrf_stage_launches"],
                             "tune": tune["mrf_stage_launches"],
                             "cli_synth": cli["synth"]["launches"]["mrf_stage"],
                             "cli_synth_melgan": cli["synth"]["melgan"]["launches"]["mrf_stage"],
                             "preprocess_synth_ref_wav": pre["synth"]["launches"]["mrf_stage"],
                             "t2u_chained": t2u["chained"]["launches"]["mrf_stage"],
                             "synth_saver": prec["synth_saver"]["launches"]["mrf_stage"]},
        "max_abs_err": stage_err["float32"],
        # the four V1 stages of one vocoded batch at B = 8, T_mel = 1000, f32
        "ms": sum(r["ms"] for r in f32_stages),
        "plain_ms": sum(r["plain_ms"] for r in f32_stages),
        "bound_ms": sum(r["bound_ms"] for r in f32_stages),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in f32_stages)
        else "bytes",
        "library_ms": None,
        "bound_route": "split TF32",
        "fma_bound_ms": sum(r["fma_bound_ms"] for r in f32_stages),
        "timed_at": {"B": 8, "T_mel": 1000, "stages": [r["C"] for r in f32_stages],
                     "dtype": "float32"},
        # no single library call computes a stage: its convs alone in cuDNN
        # (f32 with TF32 off, and bf16 tensors) as the yardstick instead
        "cudnn_convs_ms": {d: sum(r["cudnn_convs_ms"] for r in stage_timings if r["dtype"] == d)
                           for d in ("float32", "bfloat16")},
        # one sample of C * T > 2^31 elements in one launch, held on windows
        "past_2_31": stage_big,
        "ms_bf16": sum(r["ms"] for r in stage_timings if r["dtype"] == "bfloat16"),
        "bound_ms_bf16": sum(r["bound_ms"] for r in stage_timings if r["dtype"] == "bfloat16"),
        "post_ms": {r["dtype"]: r["post_ms"] for r in stage_timings if r["post"]},
        "max_abs_err_bf16": stage_err["bfloat16"],
        # ptxas's spill bytes (stores, loads) of each instance (phase 2: all 0)
        "spills": mrf_spills(),
        # by (dtype, C) at B = 8, T_mel = 1000: the kernels one stage queued
        # (fused pairs, or two a pair, + conv_post), as the library counted them
        "launches_per_stage": {f"{r['dtype']} C={r['C']}": r["launches_per_stage"]
                               for r in stage_timings},
        "by_shape": stage_timings,
    }, {
        "name": "dio_contour",
        "route": "cuda",
        "source": "fscl_tpu_torch/csrc/dio_contour.cu",
        # no Pallas kernel: the lax.scan of fix_step in world_f0_batched
        "replaces": "fscl_tpu/dsp/world_device.py:211",
        "launches": pre["dio_contour_launches"],
        "launches_by_path": {"preprocess_in_process_world_device": pre["dio_contour_launches"],
                             "preprocess_cli_world_device": pre["cli"]["dio_contour_launches"],
                             # rehearse's corpora run DIO on the host (pitch
                             # method "world", as fscl_tpu's make_synthetic_corpus)
                             "rehearse_corpus": meta["rehearse"]["fscl"]["launches"]["corpus"][
                                 "dio_contour"]},
        "max_abs_err": max(r["max_abs_err"] for r in pre["kernel"]),
        # B = 16 in the 20 s wav bucket (F = 1723), the largest shape
        **{k: pre["kernel"][-1][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "call_ms")},
        "library_ms": None,
        "timed_at": {k: pre["kernel"][-1][k] for k in ("B", "F", "bucket_s")},
        "by_bucket": pre["kernel"],
    }]
    record = {"card": card, "kernels": kernels, "text_to_mel": main_path,
              "card_vs_cpu": card_vs_cpu, "text_to_wav": text_to_wav,
              "vocoder_check": vocoder_check, "train": train, "fscl": fscl, "tune": tune,
              "cli": cli, "preprocess": pre, "t2u": t2u, "pr": pr, "meta": meta,
              "precision": prec, "parallel": par,
              "seconds_by_phase": {name: t - t_prev for (_, t_prev), (name, t)
                                   in zip(marks, marks[1:])},
              "seconds": time.perf_counter() - t_start}
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in record["seconds_by_phase"].items()))
    log(f"all phases passed in {record['seconds']:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
