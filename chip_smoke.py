#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`fscl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile] [--out DIR]

Run from the root of a checkout. Phases, each of which ends the run with a
non-zero exit code when it fails:

1. Device: require CUDA, print the card's name and power limit, turn TF32
   off for matrix products and convolutions.
2. Build: compile every kernel under `fscl_tpu_torch/csrc/` with nvcc.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main path's shapes, in float32 and bfloat16; then the
   kernel, the plain version and the library call are timed.
4. Main path: text -> mel serving (`fscl_tpu_torch.serve`) through
   `BaselineSystem.synthesize_bucketed` at the full width of
   `config/model/base.yaml`, with random weights made from --seed; checks
   shapes, finiteness and that every batch launched the attention kernel
   once per FFT block.
5. Card vs CPU: one full-width batch run on the card and on the CPU (where
   the plain versions run) with the same weights.

The line before the last holds the kernels' numbers; the last line is
`{"ok": true, "device": {...}}`. It imports nothing of JAX or `fscl_tpu`.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): float32 on the
# CUDA cores, bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

F32_ATOL = 2e-5            # the bar tests/test_ops.py holds the TPU kernel to
BF16_TOL = 1e-2            # one bf16 rounding of the output
# Card vs CPU: the same float32 math summed in another order (cuBLAS, cuDNN
# and the kernel's online softmax against the CPU's kernels) through ten
# FFT blocks and the PostNet; 1e-3 is about 1e-4 of the mels' range.
CARD_VS_CPU_ATOL = 1e-3

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
    flops = 4 * B * H * L * L * Dh
    nbytes = 4 * B * H * L * Dh * itemsize + B * L
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_attention(seed: int):
    import torch
    import torch.nn.functional as F
    from fscl_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(8, 2, L, 128) for L in (1, 16, 64, 77, 128, 256, 512, 1000)]
    shapes.append((8, 2, 2048, 64))
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for B, H, L, Dh in shapes:
            q, k, v, valid = attention_inputs(gen, B, H, L, Dh, dtype)
            got = attn.attend(q, k, v, valid)
            want = attn.attention_reference(q, k, v, valid)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != q.shape:
                fail(f"attention {dname} L={L} Dh={Dh}: got {got.dtype} {tuple(got.shape)}")
            if not torch.isfinite(got.float()).all():
                fail(f"attention {dname} L={L} Dh={Dh}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            max_err[dname] = max(max_err[dname], err)
            if dtype == torch.float32:
                ok = err <= F32_ATOL
            else:
                ok = torch.allclose(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
            log(f"attention {dname:8s} B={B} H={H} L={L:4d} Dh={Dh:3d}: "
                f"max |kernel - plain| = {err:.3g} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"attention kernel disagrees with its plain version "
                     f"({dname}, L={L}, Dh={Dh}, max err {err:.3g})")

    timings = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for L in (512, 1000):
            B, H, Dh = 8, 2, 128
            q, k, v, valid = attention_inputs(gen, B, H, L, Dh, dtype)
            mask4 = valid[:, None, None, :]
            kernel_ms = cuda_time_ms(lambda: attn.attention_cuda(q, k, v, valid), 50)
            plain_ms = cuda_time_ms(lambda: attn.attention_reference(q, k, v, valid), 20)
            library_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4), 50)
            bound_ms, bound_by = attention_bound(B, H, L, Dh, dname, q.element_size())
            row = {"B": B, "H": H, "L": L, "Dh": Dh, "dtype": dname,
                   "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_share": bound_ms / kernel_ms}
            timings.append(row)
            log(f"attention {dname:8s} B={B} H={H} L={L:4d} Dh={Dh}: kernel {kernel_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {100 * bound_ms / kernel_ms:.1f}% of bound")
    return max_err, timings


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


def phase_main_path(seed: int, card: str, profile: bool, out_dir):
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


def phase_card_vs_cpu(system, lines):
    import torch
    from fscl_tpu_torch.frontend import text_to_sequence
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
        t0 = time.perf_counter()
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one served batch with torch.profiler")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for a JSON record (and the trace with --profile)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    card = phase_device()
    import torch
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    phase_build()
    max_err, timings = phase_attention(args.seed)
    system, main_path = phase_main_path(args.seed, card, args.profile, args.out)
    card_vs_cpu = phase_card_vs_cpu(system, LINES[-8:])

    main_row = next(r for r in timings if r["dtype"] == "float32" and r["L"] == 1000)
    kernels = [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "fscl_tpu_torch/csrc/attention.cu",
        "replaces": "fscl_tpu/ops/attention.py:48",
        "launches": main_path["attention_launches"],
        "max_abs_err": max_err["float32"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "timed_at": {k: main_row[k] for k in ("B", "H", "L", "Dh", "dtype")},
        "max_abs_err_bf16": max_err["bfloat16"],
        "by_shape": timings,
    }]
    record = {"card": card, "kernels": kernels, "main_path": main_path,
              "card_vs_cpu": card_vs_cpu, "seconds": time.perf_counter() - t_start}
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
