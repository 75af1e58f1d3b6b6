"""Stable-region statistics over the scaled-detuning axis.

Mirrors the reference's pass-fraction analysis
(2D_sweep_report_stable_region.py:251-364): bin x = delta_A/f1A by rounding
to ``bin_decimals``; per bin compute N, the pass fraction of points with
(contrast < 0) and |contrast| >= c_min, median contrast and MAD; then find
contiguous runs of bins with pass fraction >= p_min and rank them by
(run length, total N, most-negative median contrast).

Port of ``quantumsimulations_tpu/analysis/stable_region.py`` (host numpy;
the same ``stable_region_stats.json`` bit for bit).
"""

from __future__ import annotations

from dataclasses import dataclass, asdict

import numpy as np


@dataclass
class BinStats:
    x: float
    n: int
    pass_fraction: float
    median_contrast: float
    mad_contrast: float


@dataclass
class StableRegion:
    x_lo: float
    x_hi: float
    n_bins: int
    total_points: int
    median_contrast: float


def compute_bin_stats(
    x: np.ndarray,
    contrast: np.ndarray,
    c_min: float = 0.2,
    bin_decimals: int = 3,
) -> list[BinStats]:
    x = np.asarray(x, dtype=float)
    contrast = np.asarray(contrast, dtype=float)
    finite = np.isfinite(x) & np.isfinite(contrast)
    x, contrast = x[finite], contrast[finite]
    xb = np.round(x, bin_decimals)
    out = []
    for val in np.unique(xb):
        sel = xb == val
        c = contrast[sel]
        passes = (c < 0.0) & (np.abs(c) >= c_min)
        med = float(np.median(c))
        mad = float(np.median(np.abs(c - med)))
        out.append(
            BinStats(
                x=float(val),
                n=int(sel.sum()),
                pass_fraction=float(passes.mean()) if c.size else float("nan"),
                median_contrast=med,
                mad_contrast=mad,
            )
        )
    return out


def find_stable_regions(
    bins: list[BinStats], p_min: float = 0.8
) -> list[StableRegion]:
    """Contiguous runs of qualifying bins, best-ranked first."""
    regions: list[StableRegion] = []
    run: list[BinStats] = []

    def close_run():
        if run:
            regions.append(
                StableRegion(
                    x_lo=run[0].x,
                    x_hi=run[-1].x,
                    n_bins=len(run),
                    total_points=sum(b.n for b in run),
                    median_contrast=float(np.median([b.median_contrast for b in run])),
                )
            )

    for b in bins:
        if np.isfinite(b.pass_fraction) and b.pass_fraction >= p_min:
            run.append(b)
        else:
            close_run()
            run = []
    close_run()
    regions.sort(
        key=lambda r: (r.n_bins, r.total_points, -r.median_contrast), reverse=True
    )
    return regions


def stable_region_stats(
    x: np.ndarray,
    contrast: np.ndarray,
    c_min: float = 0.2,
    p_min: float = 0.8,
    bin_decimals: int = 3,
) -> dict:
    """Full stats dict in the reference's stable_region_stats.json shape."""
    bins = compute_bin_stats(x, contrast, c_min=c_min, bin_decimals=bin_decimals)
    regions = find_stable_regions(bins, p_min=p_min)
    return {
        "criteria": {
            "c_min": c_min,
            "p_min": p_min,
            "bin_decimals": bin_decimals,
            "pass_rule": "contrast < 0 and |contrast| >= c_min",
        },
        "per_bin": [asdict(b) for b in bins],
        "best_region": asdict(regions[0]) if regions else None,
        "all_regions": [asdict(r) for r in regions],
    }
