"""Experiment tracking, the reference's Comet role (main.py:117-137), on local
disk (port of `fscl_tpu/obs/tracking.py`).

`ExperimentTracker` gives the surface of a tracked experiment (scalars,
params, text, figures, audio, a persistent experiment key that `--exp_key`
reuses to resume) in fscl_tpu's layout, so that either package reads the
other's experiments; `sink` is the extension point for a remote backend (any
object with `log_metrics(metrics, step=)`). None is bundled.

Layout under <root>/<exp_key>/:
    meta.json        {exp_key, name, created, params..., resumed (count)}
    metrics.jsonl    one {"step", "name", "value"} per scalar
    assets/          figures (.png), audio (.wav), text (.txt)
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional

from fscl_tpu_torch.obs.loggers import Callback


class ExperimentTracker(Callback):
    def __init__(self, root: str, name: str = "exp",
                 exp_key: Optional[str] = None, params: Optional[Dict] = None,
                 sink: Any = None):
        # reuse the key to RESUME an experiment (reference main.py:91-96)
        self.exp_key = exp_key or uuid.uuid4().hex[:16]
        self.name = name
        self.dir = os.path.join(root, self.exp_key)
        self.assets_dir = os.path.join(self.dir, "assets")
        os.makedirs(self.assets_dir, exist_ok=True)
        self.sink = sink
        meta_path = os.path.join(self.dir, "meta.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            meta["resumed"] = meta.get("resumed", 0) + 1
        else:
            meta = {"exp_key": self.exp_key, "name": name,
                    "created": time.strftime("%Y-%m-%d %H:%M:%S")}
        if params:
            meta.setdefault("params", {}).update(
                {k: v for k, v in params.items()
                 if isinstance(v, (int, float, str, bool, type(None)))})
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=2)
        self._metrics = open(os.path.join(self.dir, "metrics.jsonl"), "a")

    # --- scalar stream ------------------------------------------------------
    def log_metrics(self, metrics: Dict[str, float], step: int,
                    prefix: str = "") -> None:
        for k, v in metrics.items():
            self._metrics.write(json.dumps(
                {"step": int(step), "name": f"{prefix}{k}", "value": float(v)}) + "\n")
        self._metrics.flush()
        if self.sink is not None:
            self.sink.log_metrics({f"{prefix}{k}": float(v)
                                   for k, v in metrics.items()}, step=step)

    # Callback protocol (beside LossTableLogger / TensorBoardLogger)
    def on_log(self, step, metrics, **kw):
        self.log_metrics(metrics, step, prefix="Train/")

    def on_validation(self, step, metrics):
        self.log_metrics(metrics, step, prefix="Val/")

    # --- assets ---------------------------------------------------------
    def log_text(self, name: str, text: str, step: int = 0) -> str:
        path = os.path.join(self.assets_dir, f"{step:08d}_{name}.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        return path

    def log_figure(self, name: str, fig, step: int = 0) -> str:
        path = os.path.join(self.assets_dir, f"{step:08d}_{name}.png")
        fig.savefig(path)
        return path

    def log_audio(self, name: str, wav, sr: int = 22050,
                  step: int = 0) -> str:
        from fscl_tpu_torch.dsp.audio_io import save_wav
        path = os.path.join(self.assets_dir, f"{step:08d}_{name}.wav")
        save_wav(path, wav, sr)
        return path

    def close(self):
        self._metrics.close()


def read_metrics(exp_dir: str):
    """Load a tracked experiment's scalar stream back (list of dicts)."""
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]
