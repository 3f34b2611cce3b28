"""Profiling: a trace of a region and a per-phase wall timer for the train
loop (port of `fscl_tpu/obs/profiling.py`).

`trace(log_dir)` records the enclosed region with `torch.profiler` (host
ops, and the card's kernels when CUDA is available) and writes a Chrome
trace into `log_dir`, where fscl_tpu writes a `jax.profiler` trace.
`PhaseTimer` is the counterpart of the reference's always-on Lightning
`profiler: 'simple'` (main.py:39). A phase given a tensor to block on ends
with a `torch.cuda.synchronize` of that tensor's device, so the phase's time
includes the card's work and not only its launch.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed region into
    `log_dir/trace.json`; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Simple-profiler-style accumulated wall times per phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on: Optional[torch.Tensor] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                torch.cuda.synchronize(block_on.device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["Phase timing (total s | calls | mean ms):"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            n = self.counts[name]
            lines.append(
                f"  {name:30s} {total:9.3f} | {n:6d} | {total / n * 1e3:9.2f}")
        return "\n".join(lines)
