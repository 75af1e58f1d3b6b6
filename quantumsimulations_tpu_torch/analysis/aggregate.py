"""Cross-sweep aggregation: discover sweep dirs, collect metric points.

Mirrors the reference's aggregation loader (2D_sweep_report.py:199-303):
sweeps are discovered by walking for ``summary.json``, each sweep contributes
one point per detuning with (eta, contrast, delta, f1A, |Delta slope|), and
rows with non-finite essentials or zero f1A are dropped.

Port of ``quantumsimulations_tpu/analysis/aggregate.py`` (host numpy, the
same arrays bit for bit).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SweepPoints:
    eta: list = field(default_factory=list)  # DeltaOmega / |g_eff|
    contrast: list = field(default_factory=list)  # contrast_rare_center
    delta_Hz: list = field(default_factory=list)
    f1A_Hz: list = field(default_factory=list)
    abs_delta_slope: list = field(default_factory=list)  # |slope_on - slope_off|

    def arrays(self) -> dict[str, np.ndarray]:
        return {
            "eta": np.asarray(self.eta, dtype=float),
            "contrast": np.asarray(self.contrast, dtype=float),
            "delta_Hz": np.asarray(self.delta_Hz, dtype=float),
            "f1A_Hz": np.asarray(self.f1A_Hz, dtype=float),
            "abs_delta_slope": np.asarray(self.abs_delta_slope, dtype=float),
        }


def find_sweep_summaries(root: str) -> list[str]:
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if "summary.json" in filenames:
            out.append(os.path.join(dirpath, "summary.json"))
    return sorted(out)


def load_points_from_summary(path: str, points: SweepPoints) -> int:
    """Append one aggregation point per sweep row; returns rows added."""
    with open(path, "r", encoding="utf-8") as f:
        summary = json.load(f)
    gp = summary.get("global_params", {})
    f1A = float(gp.get("f1A_Hz", float("nan")))
    n = 0
    for row in summary.get("sweep_results", []):
        eta = float(row.get("DeltaOmega_over_geff", float("nan")))
        contrast = float(row.get("contrast_rare_center", float("nan")))
        delta = float(row.get("delta_Hz", float("nan")))
        s_on = float(row.get("I_z_slope_on_center", float("nan")))
        s_off = float(row.get("I_z_slope_off_center", float("nan")))
        abs_ds = abs(s_on - s_off) if np.isfinite(s_on) and np.isfinite(s_off) else float("nan")
        if not (np.isfinite(eta) and np.isfinite(contrast) and np.isfinite(delta)):
            continue
        if not np.isfinite(f1A) or f1A == 0.0:
            continue
        points.eta.append(eta)
        points.contrast.append(contrast)
        points.delta_Hz.append(delta)
        points.f1A_Hz.append(f1A)
        points.abs_delta_slope.append(abs_ds)
        n += 1
    return n


def aggregate_points(root: str) -> dict[str, np.ndarray]:
    points = SweepPoints()
    for path in find_sweep_summaries(root):
        load_points_from_summary(path, points)
    return points.arrays()
