#!/usr/bin/env python3
"""Time two checkouts of the port on one GPU in turns.

    python3 chip_ab.py OTHER_DIR [--out FILE]

OTHER_DIR is the root of another checkout (say, the parent commit unpacked
with `git archive`). The two run alternately, the other first (other, this,
this, other), each in a process of its own that imports its own
`chip_smoke.py` and runs its phases 1 (device), 2 (build), 3 (the attention
kernel against its plain version, which phase 8 needs) and 8 (training,
with the attention Function's and the backward kernel's timings). The last
line of standard output is one JSON object: each run's train steps/s, its
synchronised backward pass and the rows of its attention timings, under
the card's name and power limit. Compare two versions only inside one call
of this script: machines differ by more than the versions do.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

RUN = """
import json, chip_smoke as c
card = c.phase_device()
c.phase_build()
_, checked = c.phase_attention(0)
train = c.phase_train(0, card, checked, False, None)
keep = ("steps_per_s", "ms_per_step", "forward_ms", "backward_ms", "optimizer_ms",
        "attention_fwd_bwd")
print("CHIP_AB " + json.dumps({k: train[k] for k in keep}))
"""
TIMEOUT = 600.0   # seconds one run may take


def run(root: Path) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, capture_output=True, text=True,
                          timeout=TIMEOUT)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("CHIP_AB ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"chip_ab: the run in {root} failed (exit {proc.returncode})")
    result = json.loads(lines[-1][len("CHIP_AB "):])
    result["seconds"] = time.perf_counter() - t0
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
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
    runs = []
    for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        r = run(root)
        runs.append({"tree": label, **r})
        bwd = {row["L"]: row["bwd_kernel_graph_ms"] for row in r["attention_fwd_bwd"]}
        fb = {row["L"]: row["ms"] for row in r["attention_fwd_bwd"]}
        print(f"{label}: {r['steps_per_s']:.2f} steps/s, backward pass "
              f"{r['backward_ms']:.2f} ms, backward kernel (graph) ms by L {bwd}, the "
              f"Function's fwd + bwd ms by L {fb}, {r['seconds']:.0f} s", flush=True)
    record = {"card": card, "runs": runs}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
