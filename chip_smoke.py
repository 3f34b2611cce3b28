#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`fscl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile] [--out DIR]

Run from the root of a checkout. Phases, each of which ends the run with a
non-zero exit code when it fails:

1. Device: require CUDA, print the card's name and power limit, turn TF32
   off for matrix products and convolutions.
2. Build: compile every kernel under `fscl_tpu_torch/csrc/` with nvcc, one
   nvcc per source, all at once.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main path's shapes, in float32 and bfloat16; then the
   kernel, the plain version and (where one exists) the library call are
   timed. The attention kernel at every L and T bucket the FFT blocks are
   served at, a few edge lengths and HuBERT-large's head layout (at
   L = 1000 and at phase 10's (32, 16, 199, 64) and card-vs-CPU shapes), at
   each key split, held to f32 2e-5 / bf16 1e-2 and the all-invalid sample
   to the mean of V (timed in phase 9); phases 4-10 fail if a main path
   launches it at a shape not held here. The MRF stage
   kernel at the four HiFiGAN V1 stages, at B = 2 with a ragged T and at
   B = 8 in every mel bucket, then timed at B = 8, T_mel = 1000 beside its
   route's bound (split TF32 or bf16 tensor cores) and the f32 FMA bound,
   its plain version, its conv_post + tanh kernel alone, the stage's convs
   alone in cuDNN (no single library call computes a stage), and one conv
   pair at each kernel size (time per tap and per conv launch).
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
8. Training: `attend` under autograd (the kernel forward through a
   `torch.autograd.Function`, the recompute backward) against autograd
   through the plain version at B = 16 and 4, L = 128 and 512; then
   `Trainer.fit` on `BaselineSystem` at base.yaml width, B = 16, L = 128,
   T = 512, f32, with batches from `collate_batch`: 30 steps counted (every
   loss finite, the last five below the first five, 10 attention launches
   per step at shapes held to the plain version), 20 timed, one pass split
   into forward, backward and optimizer, peak memory, a traced step with
   --profile; 5 steps at B = 4 without dropout on the card and on the CPU;
   the Function's forward + backward timed beside SDPA's.
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
9. Attention timing (run last, after phase 10): the kernel at each key
   split, its plain version and SDPA (with SDPA's own error against the
   plain version), each in a CUDA graph, at the encoder's and decoder's
   lengths and HuBERT-large's head layout (L = 1000 and phase 10's
   (32, 16, 199, 64)), beside its route's bound (split TF32 or bf16 tensor cores) and
   the f32 FMA bound of the earlier design. The kernel also through its
   public wrapper with CUDA events over back-to-back calls (how the main
   path calls it, and how earlier versions of this script timed it), and
   the wrapper's host time per call.

The line before the last holds the kernels' numbers; the last line is
`{"ok": true, "device": {...}}`. It imports nothing of JAX or `fscl_tpu`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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
# HiFiGAN V1 stages: (channels, upsampling so far, conv_post fused)
V1_STAGES = ((256, 8, False), (128, 64, False), (64, 128, False), (32, 256, True))

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


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; TF32 off")
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
    return built


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
    mean_v = v[-1].float().mean(dim=1, keepdim=True).expand(v.shape[1:])
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
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    checked = set()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, H, L, Dh in shapes:
            q, k, v, valid = attention_inputs(gen, B, H, L, Dh, dtype)
            auto = attn.choose_key_split(B * H, L, n_sm, dtype)
            errs = {s: check_attention(attn, q, k, v, valid, None if s == auto else s,
                                       f"{dname} B={B} H={H} L={L} Dh={Dh} key_split={s}")
                    for s in attn.KEY_SPLITS}
            max_err[dname] = max(max_err[dname], *errs.values())
            checked.add((B, H, L, Dh, dname))
            log(f"attention {dname:8s} B={B} H={H:2d} L={L:4d} Dh={Dh:3d}: max |kernel - plain| "
                + ", ".join(f"{e:.3g}" + ("*" if s == auto else "") for s, e in errs.items())
                + " at key_split 1, 2, 4 (* the wrapper's choice) ok")
    return max_err, checked


@contextlib.contextmanager
def attention_shapes(attn, checked, what: str):
    """Record the (B, H, L, Dh, dtype) of every `attention_cuda` call made
    inside (through `attend`, which looks the wrapper up at call time); on
    leaving, fail if one of them was not held to the plain version."""
    launch = attn.attention_cuda
    seen = set()

    def recording(q, *args):
        seen.add((*q.shape, str(q.dtype).split(".")[-1]))
        return launch(q, *args)

    attn.attention_cuda = recording
    try:
        yield seen
    finally:
        attn.attention_cuda = launch
    if not seen:
        fail(f"{what}: no attention launch recorded")
    if seen - checked:
        fail(f"{what}: attention launched at {sorted(seen - checked)}, shapes phases 3 and 8 "
             f"did not hold to the plain version")
    log(f"{what}: attention launched at {sorted(seen)}, all held to the plain version")


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


def phase_attention_timing(seed: int):
    """The attention kernel at each key split, the plain version and SDPA,
    timed at the encoder's and decoder's lengths of the served layout and at
    HuBERT-large's head layout (16 heads of 64). Runs after the main path:
    the captures' cuBLAS workspace stays allocated and would count in its
    peak memory. The kernel is also timed through `attention_cuda` with CUDA
    events over 50 back-to-back calls, as the script of PR 2 timed the
    earlier design: a call shorter than the wrapper's host time reads as that
    time there."""
    import torch
    import torch.nn.functional as F
    from fscl_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.Stream()
    from fscl_tpu_torch.models.hubert import ssl_num_frames
    timed = [(8, 2, L, 128) for L in (64, 128, 256, 512, 1000)] + [
        (8, 16, 1000, 64), (FSCL_S, 16, ssl_num_frames(FSCL_WAV), 64)]
    timings = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, H, L, Dh in timed:
            q, k, v, valid = attention_inputs(gen, B, H, L, Dh, dtype)
            mask4 = valid[:, None, None, :]
            iters = 100 if L <= 256 else 20
            split_ms = {s: graph_time_ms(lambda: attn._launch(q, k, v, valid, None, s),
                                         iters, stream) for s in attn.KEY_SPLITS}
            key_split = attn.choose_key_split(B * H, L, n_sm, dtype)
            kernel_ms = split_ms[key_split]
            events_ms = cuda_time_ms(lambda: attn.attention_cuda(q, k, v, valid), 50)
            host_us = host_us_per_call(lambda: attn.attention_cuda(q, k, v, valid))
            plain_ms = graph_time_ms(lambda: attn.attention_reference(q, k, v, valid), 10, stream)
            library_ms = graph_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4), iters, stream)
            # SDPA's own agreement with the plain version, on the samples
            # with a valid key (a boolean mask with none gives NaN there)
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=mask4)
            lib_err = float((lib[:-1].float() - attn.attention_reference(q, k, v, valid)[:-1]
                             .float()).abs().max())
            bound_ms, bound_by, fma_ms = attention_bound(B, H, L, Dh, dname, q.element_size())
            row = {"B": B, "H": H, "L": L, "Dh": Dh, "dtype": dname,
                   "key_split": key_split,
                   "ms": kernel_ms, "ms_by_key_split": split_ms,
                   "events_ms": events_ms, "host_us": host_us, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_max_abs_err": lib_err,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_route": "split TF32" if dname == "float32" else "bf16 tensor cores",
                   "fma_bound_ms": fma_ms, "bound_share": bound_ms / kernel_ms}
            timings.append(row)
            log(f"attention {dname:8s} B={B} H={H:2d} L={L:4d} Dh={Dh}: kernel {kernel_ms:.4f} ms "
                f"(key_split {row['key_split']}; 1/2/4: "
                + "/".join(f"{split_ms[s]:.4f}" for s in attn.KEY_SPLITS)
                + f"; events {events_ms:.4f} ms, host {host_us:.1f} us per call)"
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
                # T = 37 * up is not a multiple of the kernel's 256- or 512-row tile
                for B, T_mel in [(2, 37)] + [(8, t) for t in MEL_BUCKETS]:
                    x = torch.randn(B, C, T_mel * up, generator=gen_x, device="cuda")
                    err = check_stage(mrf, x, rbs, conv_post, dtype, f"T_mel={T_mel:4d}")
                    max_err[dname] = max(max_err[dname], err)
                    if dtype == torch.float32:
                        checked.add((B, C, T_mel * up))
                # timed on the last, largest input (B = 8, T_mel = 1000)
                B, T = x.shape[0], x.shape[2]
                kernel_ms = cuda_time_ms(lambda: mrf.mrf_stage_cuda(x, rbs, conv_post, dtype), 3, 1)
                plain_ms = cuda_time_ms(lambda: mrf.mrf_stage_reference(x, rbs, conv_post, dtype),
                                        3, 1)
                post_ms = (cuda_time_ms(lambda: mrf._launch_post(x, conv_post, dtype), 10, 2)
                           if post else None)
                convs, n_convs_run = cudnn_convs(x, rbs, dtype)
                cudnn_ms = cuda_time_ms(convs, 3, 1)
                # one resblock of one dilation-1 pair (two conv launches) at
                # each kernel size: a straight line through the three splits
                # a conv's time into a part per tap and a part per launch
                pair_ms = {k: cuda_time_ms(lambda: mrf.mrf_stage_cuda(x, [rb], None, dtype), 3, 1)
                           for k, rb in pairs[C].items()}
                tap_ms = (pair_ms[11] - pair_ms[3]) / (2 * 8)
                launch_ms = pair_ms[3] / 2 - 3 * tap_ms
                bound_ms, bound_by, flops, route, fma_ms = stage_bound(B, T, C, post, dname, taps,
                                                                       n_convs)
                row = {"B": B, "T_mel": T // up, "T": T, "C": C, "post": post, "dtype": dname,
                       "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
                       "post_ms": post_ms, "cudnn_convs_ms": cudnn_ms, "cudnn_convs": n_convs_run,
                       "conv_pair_ms": pair_ms, "conv_ms_per_tap": tap_ms,
                       "conv_ms_per_launch": launch_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "bound_route": route,
                       "fma_bound_ms": fma_ms, "bound_share": bound_ms / kernel_ms,
                       "tflops": flops / kernel_ms / 1e9}
                timings.append(row)
                log(f"mrf_stage {dname:8s} B={B} C={C:3d} T={T:6d}: kernel {kernel_ms:.3f} ms "
                    f"({row['tflops']:.1f} TFLOP/s"
                    + (f"; conv_post + tanh alone {post_ms:.3f} ms" if post else "")
                    + f"), plain {plain_ms:.3f} ms, its {n_convs_run} convs alone in cuDNN "
                    f"{cudnn_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, {route}), "
                    f"{100 * row['bound_share']:.1f}% of bound; f32 FMA bound {fma_ms:.3f} ms; "
                    f"a conv pair at k = 3/7/11 "
                    + "/".join(f"{pair_ms[k]:.3f}" for k in (3, 7, 11))
                    + f" ms: {tap_ms:.4f} ms per tap + {launch_ms:.4f} ms per conv")
                del convs
                del x
    return max_err, timings, checked


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
        prof.export_chrome_trace(str(out_dir / "chip_smoke_trace.json"))
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
        prof.export_chrome_trace(str(out_dir / "chip_smoke_wav_trace.json"))
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


def phase_card_vs_cpu(system, lines, attn_checked):
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
        shapes = (attention_shapes(attn, attn_checked, "card vs CPU") if name == "cuda"
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with shapes:
            o = s.synthesize_bucketed(texts, src_lens, spk, lang, symbol_id="en")
        outs[name] = {k: getattr(o, k).cpu() for k in ("duration_rounded", "mel_len", "postnet_mel")}
        log(f"card vs CPU: {name} run {time.perf_counter() - t0:.2f} s, "
            f"T={o.postnet_mel.shape[1]}")
    a, b = outs["cuda"], outs["cpu"]
    for key in ("duration_rounded", "mel_len"):
        if not torch.equal(a[key], b[key]):
            fail(f"card vs CPU: {key} differs")
    if a["postnet_mel"].shape != b["postnet_mel"].shape:
        fail(f"card vs CPU: shapes {tuple(a['postnet_mel'].shape)} vs {tuple(b['postnet_mel'].shape)}")
    err = float((a["postnet_mel"] - b["postnet_mel"]).abs().max())
    scale = float(b["postnet_mel"].abs().max())
    log(f"card vs CPU: durations and mel_len equal; max |postnet_mel| diff {err:.3g} "
        f"(atol {CARD_VS_CPU_ATOL}, mel range {scale:.3g})")
    if not err <= CARD_VS_CPU_ATOL:
        fail(f"card vs CPU: postnet_mel differs by {err:.3g} > {CARD_VS_CPU_ATOL}")
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


def phase_train_kernel_grads(seed: int, attn_checked):
    """`attend` under autograd on the card (the Function: the kernel forward,
    the recompute backward) against autograd through the plain version, at
    the training phase's shapes: H = 2, Dh = 128, f32, B = 16 (and B = 4 of
    the card-vs-CPU check) at L = 128 and T = 512, ragged keys and one sample
    with none. The forward is first held at every key split as phase 3 holds
    the served shapes; the shapes join the set the recorders accept."""
    import torch
    from fscl_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    H, Dh = 2, 128
    worst = {"fwd": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for B in (TRAIN_B, CHECK_B):
        for L in (TRAIN_L, TRAIN_T):
            q, k, v, valid = attention_inputs(gen, B, H, L, Dh, torch.float32)
            auto = attn.choose_key_split(B * H, L, n_sm, torch.float32)
            for s in attn.KEY_SPLITS:
                check_attention(attn, q, k, v, valid, None if s == auto else s,
                                f"train float32 B={B} L={L} key_split={s}")
            attn_checked.add((B, H, L, Dh, "float32"))
            g = torch.randn(q.shape, generator=gen, device="cuda")
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = attn.attend(*leaves, valid)
            if out.grad_fn is None:
                fail("attend on CUDA under autograd returned an output without grad_fn")
            got = torch.autograd.grad(out, leaves, g)
            ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = attn.attention_reference(*ref_leaves, valid)
            want = torch.autograd.grad(ref, ref_leaves, g)
            torch.cuda.synchronize()
            errs = {"fwd": float((out - ref).detach().abs().max())}
            errs.update({f"d{n}": float((a - b).abs().max()) for n, a, b in zip("qkv", got, want)})
            if not all(torch.isfinite(t).all() for t in got):
                fail(f"attention gradients B={B} L={L}: non-finite")
            # no gradient reaches a key of the sample that has none valid
            dead = float(got[1][-1].abs().max())
            log(f"attention Function B={B} H={H} L={L} Dh={Dh} f32: max |d| fwd {errs['fwd']:.3g} "
                f"(bar {F32_ATOL}), dq {errs['dq']:.3g}, dk {errs['dk']:.3g}, dv {errs['dv']:.3g} "
                f"(bar {GRAD_ATOL}); dk of the all-invalid sample {dead:.3g}")
            if errs["fwd"] > F32_ATOL or max(errs[n] for n in ("dq", "dk", "dv")) > GRAD_ATOL \
                    or dead != 0.0:
                fail(f"attention Function disagrees with autograd of the plain version at B={B} "
                     f"L={L}: {errs}, dk of the all-invalid sample {dead:.3g}")
            worst = {n: max(worst[n], errs[n]) for n in worst}
    return worst


def time_train_attention():
    """The Function's forward + backward, its backward alone, autograd
    through the plain version and SDPA's forward + backward (the yardstick),
    each by CUDA events over back-to-back calls, at B = 16, H = 2, Dh = 128,
    f32, L = 128 and 512; every sample has a valid key (SDPA gives NaN for a
    row with none)."""
    import torch
    import torch.nn.functional as F
    from fscl_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for L in (TRAIN_L, TRAIN_T):
        B, H, Dh = TRAIN_B, 2, 128
        q, k, v, valid = attention_inputs(gen, B, H, L, Dh, torch.float32)
        valid[-1, 0] = True
        g = torch.randn(q.shape, generator=gen, device="cuda")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        mask4 = valid[:, None, None, :]

        def fwd_bwd(f):
            return lambda: torch.autograd.grad(f(*leaves), leaves, g)

        iters = 50 if L <= 128 else 20
        kernel_ms = cuda_time_ms(fwd_bwd(lambda a, b, c: attn.attend(a, b, c, valid)), iters)
        fwd_ms = cuda_time_ms(lambda: attn.attention_cuda(q, k, v, valid), iters)
        bwd_ms = cuda_time_ms(lambda: attn.attention_bwd(q, k, v, valid, None, g), iters)
        plain_ms = cuda_time_ms(
            fwd_bwd(lambda a, b, c: attn.attention_reference(a, b, c, valid)), iters)
        library_ms = cuda_time_ms(fwd_bwd(
            lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=mask4)), iters)
        bound_ms, bound_by, fma_ms = train_attention_bound(B, H, L, Dh)
        row = {"B": B, "H": H, "L": L, "Dh": Dh, "dtype": "float32", "ms": kernel_ms,
               "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "fma_bound_ms": fma_ms}
        rows.append(row)
        log(f"attention fwd + bwd B={B} H={H} L={L} Dh={Dh} f32: Function {kernel_ms:.4f} ms "
            f"(kernel forward {fwd_ms:.4f} + recompute backward {bwd_ms:.4f}), plain autograd "
            f"{plain_ms:.4f} ms, SDPA fwd + bwd {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; f32 FMA bound {fma_ms:.4f} ms)")
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


def profile_train_step(system, state, batch, out_dir, name: str = "train"):
    """Device time by kernel over two train steps (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    system.train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            system.train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(({"name": e.key[:90], "calls": e.count / 2,
                    "ms": e.self_device_time_total / 2e3} for e in events),
                  key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    union = busy_union_ms(prof) / 2
    # the host's side of one step: the kernels it launched, its copies, and
    # the times a copy made it wait for the device (cudaStreamSynchronize);
    # the window's own closing synchronizes are cudaDeviceSynchronize, counted
    # apart. Per step over two steps, so a single wait reads 0.5.
    host = {e.key: e.count / 2 for e in prof.key_averages()
            if e.key.startswith(("cudaLaunchKernel", "cudaStreamSynchronize",
                                 "cudaDeviceSynchronize", "cudaMemcpyAsync"))}
    launches = sum(n for k, n in host.items() if k.startswith("cudaLaunchKernel"))
    syncs = host.get("cudaStreamSynchronize", 0)
    log(f"profile {name} step: wall {1e3 * wall:.2f} ms, kernel time {busy:.2f} ms, device "
        f"busy {union:.2f} ms ({100 * union / (1e3 * wall):.1f}%); per step {launches:g} "
        f"kernel launches, "
        f"{syncs:g} host waits for the device, {host.get('cudaMemcpyAsync', 0):g} copies; "
        f"{2 * host.get('cudaDeviceSynchronize', 0):g} device synchronizes at the window's end")
    for r in rows[:15]:
        log(f"  {r['ms']:9.3f} ms {r['calls']:7.1f}x  {r['name']}")
    if out_dir is not None:
        prof.export_chrome_trace(str(out_dir / f"chip_smoke_{name}_trace.json"))
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
    mrf.LAUNCHES = 0
    with attention_shapes(attn, attn_checked, "train"):
        t0 = time.perf_counter()
        state = Trainer(system, train_cfg, [rec]).fit(state, iter(counted))
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
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
    log(f"train: {TRAIN_STEPS} steps through Trainer.fit at B={TRAIN_B} L={TRAIN_L} "
        f"T={TRAIN_T} ({n_params / 1e6:.2f} M parameters), loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (first 5 mean {head:.4f}, last 5 mean {tail:.4f}), {launches} "
        f"attention launches ({per_step} per step), {counted_s:.2f} s with a loss read per "
        f"step, peak {peak:.2f} GiB")

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
        "mrf_stage_launches": stage_launches,
        "counted_seconds": counted_s, "peak_mem_gib": peak,
        "timed_steps": TIMED_STEPS, "timed_seconds": timed_s,
        "steps_per_s": TIMED_STEPS / timed_s, "ms_per_step": step_ms,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms, "optimizer_ms": opt_ms,
        "kernel_grads_max_abs_err": grads,
    }
    if profile:
        summary["profile"] = profile_train_step(system, state, batch, out_dir)
    del system, state, batch
    summary["card_vs_cpu"] = phase_train_card_vs_cpu(seed, attn_checked)
    summary["attention_fwd_bwd"] = time_train_attention()
    return summary


def phase_train_card_vs_cpu(seed: int, attn_checked):
    """CARD_STEPS train steps at B = 4 without dropout from the same weights
    on the card and on the CPU (where the plain versions run): the per-step
    losses against TRAIN_FIRST_RTOL at the first step and TRAIN_LATER_RTOL
    after it."""
    import torch
    from fscl_tpu_torch.data.batch import to_device
    from fscl_tpu_torch.frontend.define import n_symbols
    from fscl_tpu_torch.ops import attention as attn

    cfg = train_model_config(dropout=False)
    card = build_train_system(cfg, seed, "cuda")
    cpu = build_train_system(cfg, seed, "cpu")
    cpu.load_state_dict(card.state_dict(), strict=True)
    stream = train_batches(seed + 7, CHECK_B, n_symbols("en"), cfg.variance)
    batches = [next(stream) for _ in range(CARD_STEPS)]
    losses = {}
    for name, system in (("cuda", card), ("cpu", cpu)):
        system.model.postnet.dropout.p = 0.0
        state = system.init_state()
        shapes = (attention_shapes(attn, attn_checked, "train card vs CPU") if name == "cuda"
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with shapes:
            losses[name] = [float(system.train_step(state, to_device(b, name))[1]["Total Loss"])
                            for b in batches]
        log(f"train card vs CPU: {name} {CARD_STEPS} steps in {time.perf_counter() - t0:.2f} s")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    log("train card vs CPU: losses " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(losses["cuda"], losses["cpu"]))
        + " (card/CPU), relative |d| " + ", ".join(f"{r:.3g}" for r in rel)
        + f" (bars {TRAIN_FIRST_RTOL} at step 1, {TRAIN_LATER_RTOL} after)")
    if not (rel[0] <= TRAIN_FIRST_RTOL and max(rel[1:]) <= TRAIN_LATER_RTOL):
        fail(f"train card vs CPU: relative loss differences {rel}")
    return {"B": CHECK_B, "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
            "rel": rel}


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
        summary["profile"] = profile_train_step(system, state, ep, out_dir,
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

    card = phase_device()
    import torch
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    phase_build()
    max_err, attn_checked = phase_attention(args.seed)
    stage_err, stage_timings, stage_checked = phase_mrf_stage(args.seed)
    system, main_path = phase_main_path(args.seed, card, attn_checked, args.profile, args.out)
    card_vs_cpu = phase_card_vs_cpu(system, LINES[-8:], attn_checked)
    vocoder, wav_records, text_to_wav = phase_text_to_wav(
        system, args.seed, card, attn_checked, stage_checked, args.profile, args.out)
    vocoder_check = phase_vocoder_card_vs_cpu(vocoder, wav_records)
    del system, vocoder, wav_records     # out of the training phase's peak memory
    train = phase_train(args.seed, card, attn_checked, args.profile, args.out)
    fscl = phase_fscl(args.seed, card, attn_checked, args.profile, args.out)
    timings = phase_attention_timing(args.seed)

    main_row = next(r for r in timings
                    if r["dtype"] == "float32" and r["L"] == 1000 and r["H"] == 2)
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
                             "fscl_episode": fscl["float32"]["attention_launches"],
                             "fscl_episode_bf16_upstream": fscl["bfloat16"]["attention_launches"]},
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
    }, {
        "name": "mrf_stage",
        "route": "cuda",
        "source": "fscl_tpu_torch/csrc/mrf_stage.cu",
        "replaces": "fscl_tpu/ops/hifigan_fused.py:52",
        "launches": text_to_wav["launches"]["mrf_stage"],
        "launches_by_path": {"text_to_wav": text_to_wav["launches"]["mrf_stage"],
                             "train": train["mrf_stage_launches"]},
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
        "ms_bf16": sum(r["ms"] for r in stage_timings if r["dtype"] == "bfloat16"),
        "bound_ms_bf16": sum(r["bound_ms"] for r in stage_timings if r["dtype"] == "bfloat16"),
        "post_ms": {r["dtype"]: r["post_ms"] for r in stage_timings if r["post"]},
        "max_abs_err_bf16": stage_err["bfloat16"],
        "by_shape": stage_timings,
    }]
    record = {"card": card, "kernels": kernels, "text_to_mel": main_path,
              "card_vs_cpu": card_vs_cpu, "text_to_wav": text_to_wav,
              "vocoder_check": vocoder_check, "train": train, "fscl": fscl,
              "seconds": time.perf_counter() - t_start}
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    log(f"all phases passed in {record['seconds']:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
