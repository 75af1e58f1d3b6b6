"""Matplotlib PDF/PNG report pages for sweep output.

Headless-safe (Agg backend forced — compute hosts have no display; the
reference already does this in its reprocessor,
reprocess_sweep_results.py:76-77).  Page set and PNG filenames match the
reference sweep driver (sweep_sea_detuning.py:557-1150): a parameter page,
four plots per detuning point, a summary metrics table, and the
contrast-vs-eta scatter.

Not yet ported: the reprocessor's pages (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import os
from typing import Optional

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def param_page(pdf, lines: list[str]) -> None:
    fig, ax = plt.subplots(figsize=(8.27, 11.69))  # A4 portrait
    ax.axis("off")
    ax.text(0.02, 0.98, "\n".join(lines), transform=ax.transAxes, va="top", family="monospace")
    pdf.savefig(fig)
    plt.close(fig)


def _slope_segment(ax, info: dict, style: str, label: str) -> None:
    if np.isnan(info["I_z_slope"]):
        return
    ax.plot(
        [info["t_start"], info["t_end"]],
        [info["I_z_start"], info["I_z_end"]],
        style,
        linewidth=2.0,
        markersize=6,
        label=label,
    )


def _slope_text(ax, info: dict, value: float, dy: float, sign: float, label: Optional[str] = None):
    if np.isnan(value) or np.isnan(info["t_start"]):
        return
    t_mid = 0.5 * (info["t_start"] + info["t_end"])
    y_mid = 0.5 * (info["I_z_start"] + info["I_z_end"]) + sign * 0.03 * dy
    ax.text(
        t_mid,
        y_mid,
        label or f"{value:+.2e}",
        fontsize=6,
        ha="center",
        va="bottom",
        family="monospace",
        bbox=dict(boxstyle="round", alpha=0.2, linewidth=0),
    )


def raw_iz_page(pdf, det_dir, delta_Hz, t_off, iz_off, t_on, iz_on) -> None:
    fig, ax = plt.subplots()
    ax.plot(t_off, iz_off, label=r"$\langle I^z_{\mathrm{sea}}\rangle$, rare OFF (center)")
    ax.plot(t_on, iz_on, label=r"$\langle I^z_{\mathrm{sea}}\rangle$, rare ON (center)")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel(r"$\langle I^z_{\mathrm{sea}}\rangle$")
    ax.set_title(f"δ_A = {delta_Hz:+.1f} Hz (rare at center)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(det_dir, "Iz_sea_off_on_center.png"), dpi=300)
    pdf.savefig(fig)
    plt.close(fig)


def envelopes_center_page(
    pdf,
    det_dir,
    delta_Hz,
    t_c_off,
    iz_c_off,
    t_c_on,
    iz_c_on,
    slope_off: dict,
    slope_on: dict,
    contrast: float,
    eta: float,
) -> None:
    fig, ax = plt.subplots()
    fig.subplots_adjust(right=0.75)
    ax.plot(t_c_off, iz_c_off, "o-", markersize=3, label="OFF, rare center (envelope)")
    ax.plot(t_c_on, iz_c_on, "o--", markersize=3, label="ON, rare center (envelope)")
    _slope_segment(ax, slope_off, "s-", "OFF slope, rare center")
    _slope_segment(ax, slope_on, "s--", "ON slope, rare center")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel(r"$\langle I^z_{\mathrm{sea}}\rangle$")
    ax.set_title(f"δ_A = {delta_Hz:+.1f} Hz (coarse envelopes, rare at center)")

    env = np.concatenate([iz_c_off, iz_c_on])
    y0, y1 = float(np.min(env)), float(np.max(env))
    if y1 > y0:
        pad = 0.05 * (y1 - y0)
        ax.set_ylim(y0 - pad, y1 + pad)
    dy = max(1e-8, y1 - y0)
    _slope_text(ax, slope_off, slope_off["I_z_slope"], dy, -1.0,
                f"OFF slope = {slope_off['I_z_slope']:+.2e}")
    _slope_text(ax, slope_on, slope_on["I_z_slope"], dy, +1.0,
                f"ON slope = {slope_on['I_z_slope']:+.2e}")
    txt = (
        f"I_z_slope_off(center)   = {slope_off['I_z_slope']:+.3e}\n"
        f"t_off(center)           = {slope_off['t_value']:+.3f}\n"
        f"I_z_slope_on(center)    = {slope_on['I_z_slope']:+.3e}\n"
        f"t_on(center)            = {slope_on['t_value']:+.3f}\n"
        f"contrast_rare_center    = {contrast:+.3e}\n"
        f"ΔΩ/|g_eff|              = {eta:+.3e}"
    )
    ax.text(1.02, 0.98, txt, transform=ax.transAxes, va="top", ha="left", fontsize=7,
            family="monospace", bbox=dict(boxstyle="round", alpha=0.08), clip_on=False)
    ax.legend(fontsize=7, loc="upper left")
    fig.tight_layout()
    fig.savefig(os.path.join(det_dir, "Iz_sea_detection_envelopes_center.png"), dpi=300)
    pdf.savefig(fig)
    plt.close(fig)


def envelopes_sea_center_page(
    pdf, det_dir, delta_Hz, t_c, iz_c, slope_info: dict, contrast_sea: float
) -> None:
    fig, ax = plt.subplots()
    fig.subplots_adjust(right=0.75)
    ax.plot(t_c, iz_c, "x-", markersize=3, label="Sea-center control (envelope)")
    _slope_segment(ax, slope_info, "D-", "Slope, sea-center control")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel(r"$\langle I^z_{\mathrm{sea}}\rangle$")
    ax.set_title(f"δ_A = {delta_Hz:+.1f} Hz (coarse envelope, sea-center control)")
    y0, y1 = float(np.min(iz_c)), float(np.max(iz_c))
    if y1 > y0:
        pad = 0.05 * (y1 - y0)
        ax.set_ylim(y0 - pad, y1 + pad)
    dy = max(1e-8, y1 - y0)
    _slope_text(ax, slope_info, slope_info["I_z_slope"], dy, +1.0,
                f"Slope = {slope_info['I_z_slope']:+.2e}")
    txt = (
        f"I_z_slope_sea-center    = {slope_info['I_z_slope']:+.3e}\n"
        f"t_sea-center            = {slope_info['t_value']:+.3f}\n"
        f"contrast_sea_center     = {contrast_sea:+.3e}"
    )
    ax.text(1.02, 0.98, txt, transform=ax.transAxes, va="top", ha="left", fontsize=7,
            family="monospace", bbox=dict(boxstyle="round", alpha=0.08), clip_on=False)
    ax.legend(fontsize=7, loc="upper left")
    fig.tight_layout()
    fig.savefig(os.path.join(det_dir, "Iz_sea_detection_envelopes_sea_center.png"), dpi=300)
    pdf.savefig(fig)
    plt.close(fig)


def norm_page(pdf, det_dir, delta_Hz, t_off, norm_off, t_on, norm_on) -> None:
    fig, ax = plt.subplots()
    ax.plot(t_off, norm_off, label=r"$\|\psi(t)\|$, rare OFF (center)")
    ax.plot(t_on, norm_on, label=r"$\|\psi(t)\|$, rare ON (center)")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel(r"State norm $\|\psi\|$")
    ax.set_title(f"δ_A = {delta_Hz:+.1f} Hz (state norm, rare at center)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(det_dir, "state_norm_off_on_center.png"), dpi=300)
    pdf.savefig(fig)
    plt.close(fig)


def summary_table_page(pdf, rows: list[dict]) -> None:
    fig, ax = plt.subplots(figsize=(8.27, 11.69))
    ax.axis("off")
    col_labels = [
        "δ_A (Hz)",
        "slope_off(center)",
        "t_off(center)",
        "slope_on(center)",
        "t_on(center)",
        "contrast_rare_center",
        "slope_sea-center",
        "t_sea-center",
        "contrast_sea_center",
    ]
    table_vals = [
        [
            f"{r['delta_Hz']:+.1f}",
            f"{r['I_z_slope_off_center']:+.3e}",
            f"{r['t_off_center']:+.3f}",
            f"{r['I_z_slope_on_center']:+.3e}",
            f"{r['t_on_center']:+.3f}",
            f"{r['contrast_rare_center']:+.3e}",
            f"{r['I_z_slope_off_sea_center']:+.3e}",
            f"{r['t_off_sea_center']:+.3f}",
            f"{r['contrast_sea_center']:+.3e}",
        ]
        for r in rows
    ]
    table = ax.table(cellText=table_vals, colLabels=col_labels, loc="center")
    table.auto_set_font_size(False)
    table.set_fontsize(6)
    table.scale(1.0, 1.3)
    ax.set_title("Contrast metrics from coarse-grained ⟨I^z_sea⟩ slopes", pad=20)
    pdf.savefig(fig)
    plt.close(fig)


def contrast_vs_eta_page(pdf, base_dir: Optional[str], rows: list[dict]) -> None:
    """Contrast-vs-eta scatter; PNG written only when ``base_dir`` is given
    (the sweep driver saves it, the reprocessor emits a PDF-only page —
    reference sweep_sea_detuning.py:1143-1146 vs reprocess_sweep_results.py:726)."""
    if not rows:
        return
    x = np.array([r.get("DeltaOmega_over_geff", np.nan) for r in rows], dtype=float)
    y = np.array([r.get("contrast_rare_center", np.nan) for r in rows], dtype=float)
    mask = ~np.isnan(x) & ~np.isnan(y)
    x, y = x[mask], y[mask]
    if x.size == 0:
        return
    order = np.argsort(x)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(x[order], y[order], "o-", markersize=4)
    ax.set_xlabel(r"$\Delta\Omega / |g_{\mathrm{eff}}|$")
    ax.set_ylabel(r"$\mathrm{contrast\_rare\_center}$")
    ax.set_title(r"Rare-center contrast vs $\Delta\Omega/|g_{\mathrm{eff}}|$")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if base_dir is not None:
        fig.savefig(
            os.path.join(base_dir, "contrast_rare_center_vs_DeltaOmega_over_geff.png"), dpi=300
        )
    pdf.savefig(fig)
    plt.close(fig)
