"""Observability: loss tables, TensorBoard, CSV artifacts (port of
`fscl_tpu/obs/loggers.py`).

Re-provides the reference's saver/logger stack (§2.7): pandas loss tables to
stdout + log.txt (baseline_saver.py:31-208), CSV per-sample validation
tables, TensorBoard scalar routing (Comet is optional in the reference and
out of scope offline), and a step-based progress line
(callbacks/progressbar.py).

`TensorBoardLogger` falls back, as fscl_tpu's does, to a `metrics.jsonl`
file when `torch.utils.tensorboard` cannot be imported (no `tensorboard`
package). That choice is about a log format only: it touches neither the
device nor a kernel. `CheckpointCallback` saves the system it is given with
its `TrainState` (the port's parameters live in the module, not the state).
"""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Iterable, Optional


class Callback:
    def on_log(self, step: int, metrics: Dict[str, float], **kw): ...
    def on_validation(self, step: int, metrics: Dict[str, float]): ...
    def on_save(self, step: int, state): ...


class LossTableLogger(Callback):
    """Loss table to stdout + log.txt (the reference's pandas table,
    baseline_saver.py:52-66)."""

    def __init__(self, log_dir: str, prefix: str = "Train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "log.txt")
        self.prefix = prefix
        self._t0 = time.time()

    def _emit(self, step: int, metrics: Dict[str, float], prefix: str,
              extra: str = ""):
        # lr is tiny during warmup — scientific notation keeps it readable
        cols = " | ".join(
            f"{k}: {v:.3e}" if k == "lr" else f"{k}: {v:.4f}"
            for k, v in metrics.items())
        line = f"[{prefix}] step {step} | {cols}{extra}"
        print(line)
        with open(self.path, "a") as f:
            f.write(line + "\n")

    def on_log(self, step, metrics, steps_per_sec: Optional[float] = None, **kw):
        extra = f" | {steps_per_sec:.2f} it/s" if steps_per_sec else ""
        self._emit(step, metrics, self.prefix, extra)

    def on_validation(self, step, metrics):
        self._emit(step, metrics, "Val")


class TensorBoardLogger(Callback):
    """TB scalars through torch's SummaryWriter; falls back to JSONL
    (`metrics.jsonl`, one {"tag", "value", "step"} per line) if tensorboard
    isn't importable."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._writer = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(log_dir)
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
        if self._jsonl is not None:
            self._jsonl.close()

    def _scalar(self, tag: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": value, "step": step}) + "\n")
            self._jsonl.flush()

    def on_log(self, step, metrics, **kw):
        for k, v in metrics.items():
            self._scalar(f"Train/{k}", float(v), step)

    def on_validation(self, step, metrics):
        for k, v in metrics.items():
            self._scalar(f"Val/{k}", float(v), step)


class CSVSaver(Callback):
    """Per-sample validation CSVs (the reference's saver _save_csv)."""

    def __init__(self, result_dir: str):
        self.result_dir = result_dir
        os.makedirs(result_dir, exist_ok=True)

    def save_rows(self, name: str, step: int, rows: Iterable[Dict[str, Any]]):
        rows = list(rows)
        if not rows:
            return
        path = os.path.join(self.result_dir, f"{name}-{step}.csv")
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)


class AdaptationSaver(Callback):
    """Test-time adaptation artifacts: per-task CSV of the loss at every
    inner fine-tuning step, keyed by the task id from SQids2Tid — the
    reference meta saver's per-ft-step loss curves
    (lightning/callbacks/saver.py:23-321). Feed it the losses returned by
    `systems.tune.adapt_on_chip` / `adapt_many_on_chip`."""

    def __init__(self, result_dir: str):
        self.result_dir = result_dir
        os.makedirs(result_dir, exist_ok=True)

    def save_curve(self, tid: str, losses) -> str:
        import numpy as np
        losses = np.asarray(losses)
        task_dir = os.path.join(self.result_dir, tid)
        os.makedirs(task_dir, exist_ok=True)
        path = os.path.join(task_dir, "adaptation.csv")
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["ft_step", "Total Loss"])
            for i, v in enumerate(losses.tolist()):
                writer.writerow([i, v])
        return path

    def save_many(self, tids, losses) -> list:
        """losses: (n_tasks, n_steps) from adapt_many_on_chip."""
        import numpy as np
        losses = np.asarray(losses)
        return [self.save_curve(t, losses[i]) for i, t in enumerate(tids)]


class CheckpointCallback(Callback):
    def __init__(self, manager, system):
        self.manager = manager
        self.system = system

    def on_save(self, step, state):
        self.manager.save(step, self.system, state)
