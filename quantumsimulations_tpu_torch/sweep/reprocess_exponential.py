"""Exponential-metric reprocessing of a sweep directory (tau / t90 report).

Framework version of reprocess_detuning_sweep_exponential.py:303-649:
discovers per-detuning dirs by the presence of ``metrics.json``, reloads the
center_off / center_on coarse envelopes, fits the exponential-to-plateau
model (analysis/exponential.py), emits per-point plot pages + a summary
table + tau/t90-vs-eta scatter pages, and writes
``summary_exponential_metrics.json``.

Port of ``quantumsimulations_tpu/sweep/reprocess_exponential.py`` (host
numpy, the same JSON bit for bit); matplotlib is imported only with
``make_plots``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from ..analysis.exponential import fit_exponential_to_plateau
from ..analysis.metrics import coarse_grain
from ..artifacts.writer import json_dump, load_trace_npz


def discover_detuning_dirs(root: str) -> list[str]:
    out = []
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if os.path.isdir(p) and os.path.isfile(os.path.join(p, "metrics.json")):
            out.append(p)
    return out


def reprocess_exponential(
    sweep_dir: str,
    coarse_window: int | None = None,
    make_plots: bool = True,
    out_pdf: str | None = None,
    graphs_subdir: str = "graphs_exponential",
) -> str:
    """Run the exponential re-analysis over one sweep dir; returns the
    summary JSON path."""
    gp_path = os.path.join(sweep_dir, "global_params.json")
    gp: dict[str, Any] = {}
    if os.path.isfile(gp_path):
        with open(gp_path, "r", encoding="utf-8") as f:
            gp = json.load(f)
    window = coarse_window if coarse_window else int(gp.get("coarse_window", 100))

    det_dirs = discover_detuning_dirs(sweep_dir)
    if not det_dirs:
        print(f"Warning: no detuning directories (metrics.json) under {sweep_dir}")
    rows: list[dict[str, Any]] = []

    plots = None
    if make_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.backends.backend_pdf import PdfPages

        out_pdf = out_pdf or os.path.join(sweep_dir, "exponential_metrics_report.pdf")
        graphs_dir = os.path.join(sweep_dir, graphs_subdir)
        os.makedirs(graphs_dir, exist_ok=True)
        plots = (plt, PdfPages(out_pdf), graphs_dir)

    try:
        for det_dir in det_dirs:
            with open(os.path.join(det_dir, "metrics.json"), "r", encoding="utf-8") as f:
                metrics = json.load(f)
            delta_Hz = float(metrics.get("delta_Hz", float("nan")))
            row: dict[str, Any] = {
                "delta_Hz": delta_Hz,
                "DeltaOmega_over_geff": metrics.get("DeltaOmega_over_geff", float("nan")),
            }
            for tag, label in (("center_off", "off"), ("center_on", "on")):
                try:
                    t, obs = load_trace_npz(det_dir, tag)
                except FileNotFoundError:
                    row[f"status_{label}"] = "MISSING"
                    continue
                t_c, iz_c = coarse_grain(t, obs["Iz_sea"], window)
                fit = fit_exponential_to_plateau(t_c, iz_c)
                for k, v in dataclasses.asdict(fit).items():
                    row[f"{k}_{label}"] = v
                if plots is not None:
                    plt, pdf, graphs_dir = plots
                    fig, ax = plt.subplots()
                    ax.plot(t_c, iz_c, ".", markersize=3, label=f"envelope ({label})")
                    if np.isfinite(fit.tau_s):
                        sign0 = np.sign(
                            np.median(iz_c[: max(3, len(iz_c) // 10)]) - fit.I_inf
                        ) or 1.0
                        ax.plot(
                            t_c,
                            fit.I_inf + sign0 * fit.A * np.exp(-t_c / fit.tau_s),
                            "-",
                            label=f"fit: tau={fit.tau_s:.3g}s r2={fit.r2:.3f}",
                        )
                    ax.axhline(fit.I_inf, linestyle="--", alpha=0.4, label="plateau")
                    ax.set_xlabel("Time (s)")
                    ax.set_ylabel(r"$\langle I^z_{sea}\rangle$ (coarse)")
                    ax.set_title(
                        f"δ_A = {delta_Hz:+.1f} Hz ({label}) — status {fit.status}, "
                        f"t90 = {fit.t90_s:.3g} s"
                    )
                    ax.legend(fontsize=7)
                    fig.tight_layout()
                    fig.savefig(
                        os.path.join(
                            graphs_dir,
                            f"exp_fit_{label}_{delta_Hz:+.1f}Hz.png".replace("+", "p").replace(
                                "-", "m"
                            ),
                        ),
                        dpi=200,
                    )
                    pdf.savefig(fig)
                    plt.close(fig)
            rows.append(row)

        if plots is not None:
            plt, pdf, graphs_dir = plots
            # tau / t90 vs eta scatter pages
            for key, label in (("tau_s", "tau (s)"), ("t90_s", "t90 (s)")):
                x = np.array([r.get("DeltaOmega_over_geff", np.nan) for r in rows], float)
                for suffix, style in (("off", "o"), ("on", "s")):
                    y = np.array([r.get(f"{key}_{suffix}", np.nan) for r in rows], float)
                    m = np.isfinite(x) & np.isfinite(y)
                    if not m.any():
                        continue
                    fig, ax = plt.subplots(figsize=(6, 4))
                    order = np.argsort(x[m])
                    ax.plot(x[m][order], y[m][order], style + "-", markersize=4)
                    ax.set_xlabel(r"$\Delta\Omega / |g_{eff}|$")
                    ax.set_ylabel(label)
                    ax.set_title(f"{label} vs mismatch ({suffix})")
                    ax.grid(True, alpha=0.3)
                    fig.tight_layout()
                    fig.savefig(
                        os.path.join(graphs_dir, f"{key}_vs_eta_{suffix}.png"), dpi=200
                    )
                    pdf.savefig(fig)
                    plt.close(fig)
    finally:
        if plots is not None:
            plots[1].close()

    out = {
        "coarse_window": window,
        "sweep_dir": os.path.abspath(sweep_dir),
        "rows": rows,
    }
    out_path = os.path.join(sweep_dir, "summary_exponential_metrics.json")
    json_dump(out_path, out)
    return out_path
