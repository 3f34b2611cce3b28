"""Per-phase wall timer for the train loop (port of `fscl_tpu/obs/profiling.py:28-54`).

The counterpart of the reference's always-on Lightning `profiler: 'simple'`
(main.py:39). A phase given a tensor to block on ends with a
`torch.cuda.synchronize` of that tensor's device, so the phase's time
includes the card's work and not only its launch.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


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
