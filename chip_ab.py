#!/usr/bin/env python3
"""Time two checkouts of the port on one GPU in turns.

    python3 chip_ab.py OTHER_DIR [--parts attention,mrf] [--out FILE]

OTHER_DIR is the root of another checkout (say, the parent commit unpacked
with `git archive`). The two run alternately, the other first (other, this,
this, other), each in a process of its own that imports its own
`chip_smoke.py`. Two parts, both by default (`--parts`):
- attention: phases 1 (device), 2 (build), 3 (the attention kernel against
  its plain version, which phase 8 needs), 8 (training, with the attention
  Function's and the backward kernel's timings) and 9 (the attention forward
  kernel at each key split, its plain version and SDPA, graph ms), then the
  forward with row stats (the training path's) in a CUDA graph at the train
  decoder's and encoder's shapes and the vmapped adaptation's; after the
  four runs this tree alone times the narrow route at both key splits,
  without and with row stats, at the shapes that set `narrow_split`'s
  limits (the sweep);
- mrf: phases 1, 2 and the MRF stage's phase 3 (`phase_mrf_stage`: each V1
  stage in f32 and bf16 at B = 8, T_mel = 1000 against its plain version,
  its bound and its convs in cuDNN), then phase 6's four served batches
  (phase 4's 32 lines) through the text -> wav path twice after a warm-up,
  each batch's mel and vocoder ms apart (`run_wav_lines`).
The last line of standard output is one JSON object: each run's results
under the card's name and power limit. Compare two versions only inside
one call of this script: machines differ by more than the versions do.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

RUN = """
import json, torch, chip_smoke as c
from fscl_tpu_torch.ops import attention as attn
card = c.phase_device()
c.phase_build()
_, checked = c.phase_attention(0)
train = c.phase_train(0, card, checked, False, None)
timing = c.phase_attention_timing(0)
keep = ("steps_per_s", "ms_per_step", "forward_ms", "backward_ms", "optimizer_ms",
        "attention_fwd_bwd")
fwd_keep = ("B", "H", "L", "Dh", "dtype", "key_split", "ms", "ms_by_key_split", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share")
gen = torch.Generator(device="cuda").manual_seed(7)
stream = torch.cuda.Stream()
stats_fwd = []
for dtype in (torch.float32, torch.bfloat16):
    for B, H, L, Dh in ((16, 2, 512, 128), (16, 2, 128, 128), (32, 2, 256, 128)):
        q, k, v, valid = c.attention_inputs(gen, B, H, L, Dh, dtype)
        stats = torch.empty(B, H, L, 2, device="cuda")
        ms = c.graph_time_ms(lambda: attn.attention_cuda(q, k, v, valid, None, stats), 20, stream)
        stats_fwd.append({"B": B, "H": H, "L": L, "Dh": Dh, "dtype": str(dtype)[6:], "ms": ms})
print("CHIP_AB " + json.dumps({**{k: train[k] for k in keep},
                               "attention_fwd": [{k: r[k] for k in fwd_keep} for r in timing],
                               "attention_fwd_stats": stats_fwd}))
"""
# The sweep: graph ms of the narrow route at key split 1 and 2, without and
# with row stats, and the split the wrapper picks. The shapes: head dims at
# most 48 (2 heads, padded to 64) over the query lengths and batches an
# upstream gives them; HuBERT's 16 heads of 64; the FFT blocks' 2 heads of
# 128 at the training and adaptation shapes.
SWEEP = """
import json, torch, chip_smoke as c
from fscl_tpu_torch.ops import attention as attn
c.phase_build()
shapes = [(8, 2, L, 40) for L in (64, 128, 199, 256, 399, 512, 1000)]
shapes += [(8, 2, 199, 48)] + [(B, 2, L, 40) for B in (4, 16, 32) for L in (199, 399)]
shapes += [(B, 16, L, 64) for B in (4, 32) for L in (64, 128, 199)]
shapes += [(16, 2, L, 128) for L in (128, 199, 256, 512)]
shapes += [(4, 2, 128, 128), (32, 2, 128, 128), (32, 2, 256, 128)]
n_sm = torch.cuda.get_device_properties(0).multi_processor_count
gen = torch.Generator(device="cuda").manual_seed(9)
stream = torch.cuda.Stream()
rows = []
for dtype in (torch.float32, torch.bfloat16):
    for B, H, L, Dh in shapes:
        q, k, v, valid = c.attention_inputs(gen, B, H, L, Dh, dtype)
        for with_stats in (False, True):
            st = torch.empty(B, H, L, 2, device="cuda") if with_stats else None
            ms = {s: c.graph_time_ms(lambda: attn._launch(q, k, v, valid, None, s, st),
                                     100 if L <= 256 else 20, stream) for s in (1, 2)}
            rows.append({"B": B, "H": H, "L": L, "Dh": Dh, "dtype": str(dtype)[6:],
                         "stats": with_stats, "ms_by_key_split": ms,
                         "rule": attn.choose_key_split((B, H, L, Dh), dtype, n_sm, with_stats)})
print("CHIP_AB " + json.dumps({"sweep": rows}))
"""
RUN_MRF = """
import json, torch, chip_smoke as c
from fscl_tpu_torch.audio_out.vocoder import Vocoder
c.phase_device()
c.phase_build()
_, timings, _, _ = c.phase_mrf_stage(0)
_, system = c.build_system(0, "cuda")
vocoder = Vocoder(c.build_vocoder(0, "cuda"), device="cuda")
c.run_wav_lines(system, vocoder, c.LINES)
runs = [c.run_wav_lines(system, vocoder, c.LINES) for _ in range(2)]
keep = ("dtype", "C", "T", "ms", "plain_ms", "cudnn_convs_ms", "bound_ms", "bound_share")
print("CHIP_AB " + json.dumps({
    "mrf_stage": [{k: r[k] for k in keep} for r in timings],
    "vocoder_ms": [[1e3 * r["voc_s"] for r in rs] for rs in runs],
    "mel_ms": [[1e3 * r["mel_s"] for r in rs] for rs in runs],
    "mel_frames": [int(r["batch"].postnet_mel.shape[1]) for r in runs[0]]}))
"""
TIMEOUT = 900.0   # seconds one run may take


def run(root: Path, code: str = RUN) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=TIMEOUT)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("CHIP_AB ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"chip_ab: the run in {root} failed (exit {proc.returncode})")
    result = json.loads(lines[-1][len("CHIP_AB "):])
    result["seconds"] = time.perf_counter() - t0
    return result


def report_attention(label: str, r: dict) -> None:
    bwd = {row["L"]: row["bwd_kernel_graph_ms"] for row in r["attention_fwd_bwd"]}
    fb = {row["L"]: row["ms"] for row in r["attention_fwd_bwd"]}
    fwd = {f"{x['dtype'][0]}{x['B']},{x['H']},{x['L']},{x['Dh']}": round(x["ms"], 4)
           for x in r["attention_fwd"]}
    stats_fwd = {f"{x['dtype'][0]}{x['B']},{x['H']},{x['L']},{x['Dh']}": round(x["ms"], 4)
                 for x in r["attention_fwd_stats"]}
    print(f"{label}: {r['steps_per_s']:.2f} steps/s, backward pass "
          f"{r['backward_ms']:.2f} ms, backward kernel (graph) ms by L {bwd}, the "
          f"Function's fwd + bwd ms by L {fb}; forward kernel (graph) ms {fwd}, with row "
          f"stats {stats_fwd}; {r['seconds']:.0f} s", flush=True)


def report_mrf(label: str, r: dict) -> None:
    stages = ", ".join(f"{x['dtype'][0]}{x['C']} {x['ms']:.3f}" for x in r["mrf_stage"])
    sums = {d: sum(x["ms"] for x in r["mrf_stage"] if x["dtype"] == d)
            for d in ("float32", "bfloat16")}
    voc = "; ".join(", ".join(f"{ms:.2f}" for ms in run) for run in r["vocoder_ms"])
    print(f"{label}: MRF stage ms (B = 8, T_mel = 1000) {stages}; all four f32 "
          f"{sums['float32']:.3f}, bf16 {sums['bfloat16']:.3f}; vocoder ms by served batch "
          f"(T_mel {r['mel_frames']}) {voc}; {r['seconds']:.0f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--parts", default="attention,mrf",
                    help="comma-separated: attention, mrf (default both)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    parts = [p for p in args.parts.split(",") if p]
    if not parts or any(p not in ("attention", "mrf") for p in parts):
        raise SystemExit(f"chip_ab: --parts takes attention and / or mrf, got {args.parts}")
    here = Path(__file__).resolve().parent
    other = args.other.resolve()
    if not (other / "chip_smoke.py").is_file():
        raise SystemExit(f"chip_ab: {other} holds no chip_smoke.py")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise SystemExit("chip_ab: nvidia-smi failed: this script measures a GPU")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    record = {"card": card}
    for part in parts:
        code, report = (RUN, report_attention) if part == "attention" else (RUN_MRF, report_mrf)
        runs = []
        for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
            r = run(root, code)
            runs.append({"tree": label, **r})
            report(label, r)
        record["runs" if part == "attention" else "mrf_runs"] = runs
        if part == "attention":
            sweep = run(here, SWEEP)["sweep"]
            for x in sweep:
                print(f"sweep {x['dtype']:8s} B={x['B']} H={x['H']} L={x['L']} Dh={x['Dh']} "
                      f"stats {x['stats']:d}: split 1 {x['ms_by_key_split']['1']:.4f}, 2 "
                      f"{x['ms_by_key_split']['2']:.4f} ms; the rule takes {x['rule']}",
                      flush=True)
            record["sweep"] = sweep
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
