"""On-disk artifact contract (SURVEY.md §2.5).

The artifact tree is the de-facto API between the sweep layer and the
post-processing layer; the reference's report/reprocess scripts discover and
consume it purely through the filesystem (2D_sweep_report.py:199-285,
reprocess_sweep_results.py:291-319).  Layout per sweep:

    <out_root>/sea_detuning_sweep_<YYYYMMDD_HHMMSS>/
      geometry_and_couplings.npz
      global_params.json
      summary.json
      sweep_results.csv              (promised by the reference README but
                                      never written by its code — we emit it)
      sea_detuning_report.pdf
      contrast_rare_center_vs_DeltaOmega_over_geff.png
      delta_{p|m}<x.y>Hz/
        time_and_obs_{center_off|center_on|shell_off}.npz
        params_{tag}.json  freqs_{tag}.json  metrics.json
        4x PNG plots
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import asdict
from typing import Any

import numpy as np

from ..models.params import DipolarRareParams

TAGS = ("center_off", "center_on", "shell_off")

METRICS_COLUMNS = (
    "delta_Hz",
    "f_rf_sea_Hz",
    "I_z_slope_off_center",
    "R_off_center",
    "t_off_center",
    "I_z_slope_on_center",
    "R_on_center",
    "t_on_center",
    "contrast_rare_center",
    "I_z_slope_off_sea_center",
    "R_off_sea_center",
    "t_off_sea_center",
    "contrast_sea_center",
    "DeltaOmega_Hz",
    "g_eff_Hz",
    "DeltaOmega_over_geff",
)


def json_dump(path: str, obj: Any) -> None:
    """JSON with the reference's formatting (indent=2, floats coerced)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, default=float)


def json_load(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_geometry_npz(
    base_dir: str,
    positions: np.ndarray,
    b: np.ndarray,
    n_sea: int,
) -> None:
    idx_rare = b.shape[0] - 1
    sea_indices = np.arange(n_sea, dtype=int)
    sea_rare_vals = b[:n_sea, idx_rare].astype(float)
    iu = np.triu_indices(n_sea, k=1)
    sea_sea_vals = b[:n_sea, :n_sea][iu].astype(float)
    np.savez(
        os.path.join(base_dir, "geometry_and_couplings.npz"),
        positions=positions,
        b=b,
        sea_indices=sea_indices,
        idx_rare=int(idx_rare),
        sea_rare_vals=sea_rare_vals,
        sea_sea_vals=sea_sea_vals,
    )


def save_trace_npz(det_dir: str, tag: str, t: np.ndarray, obs: dict[str, np.ndarray]) -> str:
    path = os.path.join(det_dir, f"time_and_obs_{tag}.npz")
    np.savez(path, t=t, **obs)
    return path


def save_params_and_freqs(det_dir: str, tag: str, params: DipolarRareParams, freqs: dict) -> None:
    d = asdict(params)
    # framework-internal field; keep provenance dumps key-compatible with the
    # reference dataclass (dipolar_ensemble_with_rare.py:307-384)
    d.pop("solver_method", None)
    json_dump(os.path.join(det_dir, f"params_{tag}.json"), d)
    json_dump(os.path.join(det_dir, f"freqs_{tag}.json"), freqs)


def write_sweep_csv(base_dir: str, rows: list[dict]) -> None:
    """sweep_results.csv — one row per per-detuning metrics dict."""
    path = os.path.join(base_dir, "sweep_results.csv")
    with open(path, "w", newline="", encoding="utf-8") as f:
        wr = csv.DictWriter(f, fieldnames=METRICS_COLUMNS, extrasaction="ignore")
        wr.writeheader()
        for row in rows:
            wr.writerow(row)



def load_trace_npz(det_dir: str, tag: str) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    with np.load(os.path.join(det_dir, f"time_and_obs_{tag}.npz"), allow_pickle=False) as data:
        return data["t"], {k: data[k] for k in data.files if k != "t"}
