"""CLI: cross-sweep 2D aggregation report (+ optional stable-region stats).

``python -m quantumsimulations_tpu_torch.cli.report2d <root> -o out.pdf
     [--stable] [--c-min X --p-min Y --bin-decimals N]``

Framework version of both 2D_sweep_report.py and
2D_sweep_report_stable_region.py: four scatter pages (contrast / |Δslope| vs
eta and vs scaled detuning, colored by f1A) plus, with ``--stable``, the
pass-fraction analysis, console table, stable_region_stats.json and a
pass-fraction page.

Port of ``quantumsimulations_tpu/cli/report2d.py``.  Its pages always need
matplotlib, which is imported in :func:`main` (and the page helpers it
calls), so the module itself imports where matplotlib is not installed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..analysis.aggregate import aggregate_points
from ..analysis.stable_region import stable_region_stats
from ..artifacts.writer import json_dump

F1A_CLAMP_KHZ = (5.0, 50.0)  # colorbar clamp, as in 2D_sweep_report.py:47-51


def _percentile_limits(v: np.ndarray, lo=1.0, hi=99.0, pad=0.05):
    v = v[np.isfinite(v)]
    if v.size == 0:
        return None
    a, b = np.percentile(v, [lo, hi])
    if a == b:
        return None
    d = (b - a) * pad
    return a - d, b + d


def _scatter_points(ax, x, y, color_khz) -> int:
    """Colored scatter with gray fallback for color-missing points
    (2D_sweep_report.py:180-189); returns the number of gray points."""
    have_color = np.isfinite(color_khz)
    sc = ax.scatter(
        x[have_color], y[have_color],
        c=np.clip(color_khz[have_color], *F1A_CLAMP_KHZ),
        vmin=F1A_CLAMP_KHZ[0], vmax=F1A_CLAMP_KHZ[1],
        s=16, cmap="viridis",
    )
    n_gray = int((~have_color).sum())
    if n_gray:
        ax.scatter(x[~have_color], y[~have_color], color="0.5", s=16,
                   label="color missing")
        ax.legend(loc="best")
    ax.figure.colorbar(sc, ax=ax, label="f1A (kHz)")
    return n_gray


def _scatter_page(pdf, graphs_dir, idx, name, x, y, color_khz, xlabel, ylabel, zoom=False):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    _scatter_points(ax, x, y, color_khz)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    if zoom:
        xl = _percentile_limits(x)
        yl = _percentile_limits(y)
        if xl:
            ax.set_xlim(*xl)
        if yl:
            ax.set_ylim(*yl)
    fig.tight_layout()
    fig.savefig(os.path.join(graphs_dir, f"{idx:02d}_{name}.png"), dpi=200)
    pdf.savefig(fig)
    plt.close(fig)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", nargs="?", default=None,
                   help="directory tree containing sweep folders; omitted = "
                        "interactive pick (reference zero-arg workflow)")
    p.add_argument("-o", "--output", default=None, help="output PDF path")
    p.add_argument("--stable", action="store_true", help="add stable-region analysis")
    p.add_argument("--c-min", type=float, default=0.2)
    p.add_argument("--p-min", type=float, default=0.8)
    p.add_argument("--bin-decimals", type=int, default=3)
    p.add_argument("--stable-json", default=None)
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    if args.root is None:
        # reference zero-argument workflow (2D_sweep_report.py:54-77)
        from ._interactive import pick_root_dir

        args.root = pick_root_dir("Select the detuning sweep results folder")
        if not args.root:
            print("No directory selected. Exiting.")
            raise SystemExit(1)

    root = os.path.abspath(args.root)
    pts = aggregate_points(root)
    n = len(pts["eta"])
    if n == 0:
        print(f"No valid data points found under {root!r}")
        raise SystemExit(2)
    print(f"Aggregated {n} points from sweeps under {root}")

    pdf_path = args.output or os.path.join(root, "contrast_vs_coupling_summary.pdf")
    graphs_dir = os.path.join(os.path.dirname(pdf_path) or ".", "graphs")
    os.makedirs(graphs_dir, exist_ok=True)

    x_ratio = pts["delta_Hz"] / pts["f1A_Hz"]
    color = pts["f1A_Hz"] / 1e3

    with PdfPages(pdf_path) as pdf:
        _scatter_page(pdf, graphs_dir, 1, "contrast_vs_eta",
                      pts["eta"], pts["contrast"], color,
                      r"$\Delta\Omega/|g_{eff}|$", "contrast_rare_center")
        _scatter_page(pdf, graphs_dir, 2, "contrast_vs_scaled_detuning",
                      x_ratio, pts["contrast"], color,
                      r"$\delta_A / f_{1A}$", "contrast_rare_center")
        # Pages 3-4 use only points with a finite |Δslope| and are skipped
        # entirely when none exist (legacy summaries without slope fields) —
        # matching 2D_sweep_report.py:405-411.
        m_slope = np.isfinite(pts["abs_delta_slope"])
        if m_slope.any():
            _scatter_page(pdf, graphs_dir, 3, "abs_slope_diff_vs_eta_zoom",
                          pts["eta"][m_slope], pts["abs_delta_slope"][m_slope],
                          color[m_slope],
                          r"$\Delta\Omega/|g_{eff}|$", r"$|\Delta$slope$|$", zoom=True)
            _scatter_page(pdf, graphs_dir, 4, "abs_slope_diff_vs_scaled_detuning_zoom",
                          x_ratio[m_slope], pts["abs_delta_slope"][m_slope],
                          color[m_slope],
                          r"$\delta_A / f_{1A}$", r"$|\Delta$slope$|$", zoom=True)

        if args.stable:
            stats = stable_region_stats(
                x_ratio, pts["contrast"],
                c_min=args.c_min, p_min=args.p_min, bin_decimals=args.bin_decimals,
            )
            print(f"{'x':>10} {'N':>5} {'pass':>6} {'medC':>9} {'madC':>9}")
            for b in stats["per_bin"]:
                print(f"{b['x']:>10.4g} {b['n']:>5d} {b['pass_fraction']:>6.2f} "
                      f"{b['median_contrast']:>9.3g} {b['mad_contrast']:>9.3g}")
            best = stats["best_region"]
            if best:
                print(f"Best stable region: x in [{best['x_lo']}, {best['x_hi']}], "
                      f"{best['n_bins']} bins, {best['total_points']} points, "
                      f"median contrast {best['median_contrast']:.3g}")
            else:
                print("No contiguous stable region found for the chosen thresholds.")
            json_dump(args.stable_json or os.path.join(root, "stable_region_stats.json"), stats)

            xs = np.array([b["x"] for b in stats["per_bin"]])
            ps = np.array([b["pass_fraction"] for b in stats["per_bin"]])
            fig, ax = plt.subplots(figsize=(6.5, 4.5))
            ax.plot(xs, ps, "o-", markersize=4)
            ax.axhline(args.p_min, linestyle="--", color="r", alpha=0.5,
                       label=f"p_min = {args.p_min}")
            if best:
                ax.axvspan(best["x_lo"], best["x_hi"], alpha=0.15, color="g",
                           label="best stable region")
            ax.set_xlabel(r"$\delta_A / f_{1A}$")
            ax.set_ylabel("pass fraction")
            ax.legend(fontsize=8)
            ax.grid(True, alpha=0.3)
            fig.tight_layout()
            fig.savefig(os.path.join(graphs_dir, "05_pass_fraction_vs_scaled_detuning.png"),
                        dpi=200)
            pdf.savefig(fig)
            plt.close(fig)

    print(f"Wrote summary PDF to: {pdf_path}")


if __name__ == "__main__":
    main()
