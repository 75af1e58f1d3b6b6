"""Re-analysis of saved sweeps — change the coarse window without re-solving.

Framework version of the reference's reprocessor
(reprocess_sweep_results.py:95-804).  The run-vs-reprocess boundary is a
design invariant (reference README "re-run vs reprocess"): geometry /
Hamiltonian / time-grid changes require re-solving; analysis-choice changes
(coarse window, fit windows, thresholds) only require this layer, which
reads the NPZ traces back from disk.

Outputs ``summary_reprocessed_win{N}.json`` (or ``summary_reprocessed.json``
when window <= 0 means "keep the original window"), with the original metric
keys plus the reprocessor's extra fields delta_I_z_slope_center /
abs_delta_I_z_slope_center (reference :362-363).

Port of ``quantumsimulations_tpu/sweep/reprocess.py``: host numpy on the
traces saved by either package, the same calls in the same order, so the
JSON equals the JAX package's bit for bit.  matplotlib is imported only
with ``make_plots``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from ..analysis.metrics import (
    contrast_michelson_with_t_gate,
    coarse_grain,
    detuning_label,
    eta_mismatch,
    iz_slope_from_coarse,
)
from ..artifacts.writer import json_dump, load_trace_npz


def find_sweep_dirs(root: str) -> list[str]:
    """Recursively find sweep dirs by the presence of summary.json."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        if "summary.json" in files:
            out.append(dirpath)
    return sorted(out)


def _reprocess_param_lines(gp: dict, f1A: float, f1R: float, window: int) -> list[str]:
    """Global-parameter page text for the reprocessed report, matching the
    reference's page-1 content (reprocess_sweep_results.py:151-248)."""
    lines = [
        "Sea detuning sweep report (REPROCESSED)",
        "",
        f"Reprocessed coarse-grain window = {window}",
        "",
        "Global parameters (from original sweep):",
    ]

    def add(fmt: str, key: str, scale: float = 1.0):
        v = gp.get(key)
        if v is not None:
            lines.append(fmt.format(v * scale if isinstance(v, (int, float)) else v))

    add("  f_Az (sea Larmor)     = {:.3f} MHz", "f_Az_Hz", 1e-6)
    add("  f_Rz (rare Larmor)    = {:.3f} MHz", "f_Rz_Hz", 1e-6)
    if np.isfinite(f1A):
        lines.append(f"  f1A (sea Rabi)        = {f1A / 1e3:.3f} kHz")
    if np.isfinite(f1R):
        lines.append(f"  f1R (rare Rabi)       = {f1R / 1e3:.3f} kHz")
    add("  Target sea detuning   = {:.3f} kHz", "target_sea_detuning", 1e-3)
    add("  gamma_sea             = {:.3e} rad·s⁻¹·T⁻¹", "gamma_sea")
    add("  gamma_rare            = {:.3e} rad·s⁻¹·T⁻¹", "gamma_rare")
    add("  B0_common             = {:.3f} T", "B0_common_T")
    add("  B1_sea                = {:.3e} T", "B1_sea_T")
    add("  B1_rare               = {:.3e} T", "B1_rare_T")
    add("  dipolar_scale_SI      = {:.3e}", "dipolar_scale_SI")
    add("  shell_scale           = {:.3f} nm", "shell_scale_m", 1e9)
    add("  t_final               = {:.3e} s", "t_final_s")
    if gp.get("steps") is not None:
        lines.append(f"  steps                 = {int(gp['steps']):d}")
    if gp.get("n_sea") is not None:
        lines.append(f"  n_sea                 = {int(gp['n_sea']):d}")
    add("  phi_sea               = {:.3f} rad", "phi_sea_rad")
    add("  phi_rare              = {:.3f} rad", "phi_rare_rad")
    add("  sea_spin_type         = {}", "sea_spin_type")
    add("  rare_spin_type        = {}", "rare_spin_type")
    lines.append("")
    for key in ("solver_atol", "solver_rtol", "solver_nsteps", "solver_max_step"):
        lines.append(f"  {key:<21} = {gp.get(key)}")
    lines.append("")
    lines.append(f"  coarse_window (orig)  = {gp.get('coarse_window', 'NA')}")
    lines.append(f"  coarse_window (this)  = {window}")
    lines.append("")
    dets = gp.get("sea_detunings_Hz") or []
    if dets:
        lines.append("Sea detunings (δ_A = f_Az - f_rf,A) in Hz:")
        det_strs = [f"{d:+.1f}" for d in dets]
        for i in range(0, len(det_strs), 6):
            lines.append("  " + ", ".join(det_strs[i : i + 6]))
    return lines


def reprocess_sweep(sweep_dir: str, coarse_window: int, make_plots: bool = False) -> str:
    """Recompute slope/contrast/eta metrics for one sweep dir; returns the
    path of the written summary JSON.

    With ``make_plots`` the full report PDF is regenerated — the same four
    per-point plot pages the sweep itself writes, plus the summary table and
    contrast-vs-eta pages (the reference reprocessor regenerates its full
    PDF the same way, reprocess_sweep_results.py:436-786).
    """
    with open(os.path.join(sweep_dir, "summary.json"), "r", encoding="utf-8") as f:
        summary = json.load(f)
    gp = summary.get("global_params", {})
    f1A = float(gp.get("f1A_Hz", float("nan")))
    f1R = float(gp.get("f1R_Hz", float("nan")))
    rms_b_AR = float(gp.get("rms_b_AR_Hz", float("nan")))
    window = coarse_window if coarse_window > 0 else int(gp.get("coarse_window", 100))

    pdf = None
    suffix = f"_win{window}" if coarse_window > 0 else ""
    if make_plots:
        from matplotlib.backends.backend_pdf import PdfPages

        from ..artifacts import report as rpt

        pdf_path = os.path.join(sweep_dir, f"reprocessed{suffix}_report.pdf")
        pdf = PdfPages(pdf_path)
        # page 1: global-parameter summary for the reprocessed run
        # (reference reprocess_sweep_results.py:151-248)
        rpt.param_page(pdf, _reprocess_param_lines(gp, f1A, f1R, window))

    new_rows: list[dict[str, Any]] = []
    rows = sorted(summary.get("sweep_results", []), key=lambda r: r.get("delta_Hz", 0.0))
    for row in rows:
        delta_Hz = float(row["delta_Hz"])
        det_dir = os.path.join(sweep_dir, detuning_label(delta_Hz))
        if not os.path.isdir(det_dir):
            print(f"  [skip] missing detuning dir for {delta_Hz:+.1f} Hz")
            continue
        try:
            t_off, obs_off = load_trace_npz(det_dir, "center_off")
            t_on, obs_on = load_trace_npz(det_dir, "center_on")
            t_sc, obs_sc = load_trace_npz(det_dir, "shell_off")
        except FileNotFoundError as exc:
            print(f"  [skip] {delta_Hz:+.1f} Hz: {exc}")
            continue

        t_c_off, iz_c_off = coarse_grain(t_off, obs_off["Iz_sea"], window)
        t_c_on, iz_c_on = coarse_grain(t_on, obs_on["Iz_sea"], window)
        t_c_sc, iz_c_sc = coarse_grain(t_sc, obs_sc["Iz_sea"], window)
        slope_off = iz_slope_from_coarse(t_c_off, iz_c_off)
        slope_on = iz_slope_from_coarse(t_c_on, iz_c_on)
        slope_sc = iz_slope_from_coarse(t_c_sc, iz_c_sc)

        contrast_rare = contrast_michelson_with_t_gate(
            slope_on["I_z_slope"], slope_off["I_z_slope"],
            slope_on["t_value"], slope_off["t_value"],
        )
        contrast_sea = contrast_michelson_with_t_gate(
            slope_on["I_z_slope"], slope_sc["I_z_slope"],
            slope_on["t_value"], slope_sc["t_value"],
        )
        eta = eta_mismatch(delta_Hz, f1A, f1R, rms_b_AR)
        d_slope = slope_on["I_z_slope"] - slope_off["I_z_slope"]

        if pdf is not None:
            from ..artifacts import report as rpt

            rpt.raw_iz_page(pdf, det_dir, delta_Hz, t_off, obs_off["Iz_sea"],
                            t_on, obs_on["Iz_sea"])
            rpt.envelopes_center_page(
                pdf, det_dir, delta_Hz, t_c_off, iz_c_off, t_c_on, iz_c_on,
                slope_off, slope_on, contrast_rare, eta["DeltaOmega_over_geff"],
            )
            rpt.envelopes_sea_center_page(
                pdf, det_dir, delta_Hz, t_c_sc, iz_c_sc, slope_sc, contrast_sea
            )
            rpt.norm_page(pdf, det_dir, delta_Hz,
                          t_off, obs_off["state_norm"], t_on, obs_on["state_norm"])

        new_rows.append(
            {
                "delta_Hz": delta_Hz,
                "f_rf_sea_Hz": float(row.get("f_rf_sea_Hz", float("nan"))),
                "I_z_slope_off_center": float(slope_off["I_z_slope"]),
                "R_off_center": float(slope_off["R_value"]),
                "t_off_center": float(slope_off["t_value"]),
                "I_z_slope_on_center": float(slope_on["I_z_slope"]),
                "R_on_center": float(slope_on["R_value"]),
                "t_on_center": float(slope_on["t_value"]),
                "contrast_rare_center": float(contrast_rare),
                "I_z_slope_off_sea_center": float(slope_sc["I_z_slope"]),
                "R_off_sea_center": float(slope_sc["R_value"]),
                "t_off_sea_center": float(slope_sc["t_value"]),
                "contrast_sea_center": float(contrast_sea),
                "DeltaOmega_Hz": eta["DeltaOmega_Hz"],
                "g_eff_Hz": eta["g_eff_Hz"],
                "DeltaOmega_over_geff": eta["DeltaOmega_over_geff"],
                "delta_I_z_slope_center": float(d_slope),
                "abs_delta_I_z_slope_center": float(abs(d_slope)),
            }
        )

    out = {
        "global_params": {**gp, "coarse_window_reprocessed": window},
        "sweep_results": new_rows,
    }
    out_path = os.path.join(sweep_dir, f"summary_reprocessed{suffix}.json")
    json_dump(out_path, out)

    if pdf is not None:
        from ..artifacts import report as rpt

        # Final pages match the reference reprocessor's tail exactly: full
        # metrics table (incl. delta-slope columns), addendum table, then the
        # contrast-vs-eta and |delta slope|-vs-eta scatters, all PDF-only
        # (reprocess_sweep_results.py:636-786).
        rpt.reprocess_summary_table_page(pdf, new_rows)
        rpt.addendum_table_page(pdf, new_rows)
        rpt.contrast_vs_eta_page(pdf, None, new_rows)
        rpt.abs_delta_slope_vs_eta_page(pdf, new_rows)
        pdf.close()
    return out_path
