"""Global pitch/energy normalization statistics.

Replaces the reference's module-import-time `stats.json` load
(`Define.py:15-17`) with an explicit frozen object. The 8-tuple layout
`(pitch_min, pitch_max, pitch_mean, pitch_std, energy_min, energy_max,
energy_mean, energy_std)` matches `Define.ALLSTATS["global"]` as consumed by
the variance adaptor (`lightning/model/modules.py:41`).

The port's own copy of `fscl_tpu/core/stats.py:16-74`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, Tuple


@dataclass(frozen=True)
class FeatureStats:
    min: float
    max: float
    mean: float
    std: float

    def normalized_range(self) -> Tuple[float, float]:
        return (self.min - self.mean) / self.std, (self.max - self.mean) / self.std


@dataclass(frozen=True)
class GlobalStats:
    pitch: FeatureStats
    energy: FeatureStats

    def as_flat(self) -> Tuple[float, ...]:
        """The reference 8-tuple layout (Define.ALLSTATS["global"])."""
        return (
            self.pitch.min, self.pitch.max, self.pitch.mean, self.pitch.std,
            self.energy.min, self.energy.max, self.energy.mean, self.energy.std,
        )

    @staticmethod
    def from_flat(flat: Iterable[float]) -> "GlobalStats":
        p_min, p_max, p_mean, p_std, e_min, e_max, e_mean, e_std = flat
        return GlobalStats(
            pitch=FeatureStats(p_min, p_max, p_mean, p_std),
            energy=FeatureStats(e_min, e_max, e_mean, e_std),
        )

    @staticmethod
    def from_json(path: str) -> "GlobalStats":
        with open(path) as f:
            raw = json.load(f)
        return GlobalStats(
            pitch=FeatureStats(*raw["pitch"]),
            energy=FeatureStats(*raw["energy"]),
        )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "pitch": [self.pitch.min, self.pitch.max, self.pitch.mean, self.pitch.std],
                "energy": [self.energy.min, self.energy.max, self.energy.mean, self.energy.std],
            }, f, indent=4)


# The corpus-merged global stats shipped with the reference (stats.json:1-16).
DEFAULT_STATS = GlobalStats(
    pitch=FeatureStats(
        56.88630676269531, 953.1358032226562,
        186.0852184530204, 46.16604905177577,
    ),
    energy=FeatureStats(
        0.0, 533.1392211914062,
        51.08978468237829, 40.48262468172912,
    ),
)
