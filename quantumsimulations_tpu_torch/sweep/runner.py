"""Sea-detuning sweep driver — the framework's main workload.

Reference workload: sweep_sea_detuning.py:356-1165.  For each detuning three
simulation variants run (rare-at-center drive OFF / ON, and the sea-as-center
control), followed by coarse-grain -> slope -> t-gated contrast metrics and
the §2.5 artifact tree.

Every variant of every detuning is solved in one BATCH through the exact
eigendecomposition propagator: the host eigensolves are the only serial
part, and all trace computation runs batched on the device.  Artifacts,
metrics, plots, summary.json and sweep_results.csv are written per point
after the batched solve; a crash during the solve loses that batch, a crash
during the artifact loop loses at most one point, and resume=True skips
points whose metrics.json already exists.

Differences from the JAX package's runner:
  * ``device=`` picks the torch device (default "cuda"; never a silent CPU
    fallback).
  * The stepping solvers are solved one by one, as in the JAX runner
    (:func:`_solve_one_stepping`): "expm" (the dense complex128 step
    operator at every dim, as the JAX runner does), "ext" (with mid-solve
    snapshots under ``<base_dir>/.solver_ckpt/simNNNN``, cleared as each
    solve succeeds), "krylov", "chebyshev" and "dopri" (at its default
    tolerances, as the JAX runner calls it).  As in the JAX package,
    "cheb_step" (like "auto") is solved on the batched eigendecomposition
    route.  ``mesh`` (the data-parallel sharded batch) raises
    NotImplementedError before anything is written (ROADMAP.md queue 1
    item 5).
  * A sweep without ``base_dir`` is named to the second, as in the JAX
    package, but never writes into the directory of a sweep started earlier
    in the same second: it claims its directory atomically and, where the
    name is taken, waits for the next second (the JAX package's rows of a
    2D grid merge into one directory when a row takes under a second).
  * matplotlib is imported only when ``make_plots`` is on, so a sweep
    without plots runs where matplotlib is not installed.  (With plots off
    the reference opens an empty PdfPages, which writes no file, so the
    artifact trees still match.)
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import os
import time
from dataclasses import replace
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..analysis.metrics import (
    contrast_michelson_with_t_gate,
    coarse_grain,
    detuning_label,
    eta_mismatch,
    f1R_for_resonance,
    iz_slope_from_coarse,
)
from ..artifacts.writer import (
    json_dump,
    save_geometry_npz,
    save_params_and_freqs,
    save_trace_npz,
    write_sweep_csv,
)
from ..dynamics.eig_propagator import (
    eig_traces_assembled_batched,
    eig_traces_assembled_batched32,
    eigh_host,
    traces_dict,
)
from ..dynamics.evolve import check_method
from ..models.dipolar import build_model
from ..models.geometry import (
    coupling_statistics,
    dipolar_couplings_from_positions,
    shell_positions_with_rare_center,
)
from ..models.params import DipolarRareParams, get_derived_frequencies
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer

TAGS = ("center_off", "center_on", "shell_off")

# cap batched eigenvector stacks (B * dim^2 * 16 bytes * ~3 buffers)
_MAX_BATCH_BYTES = 2 << 30


def _solve_one_stepping(
    model, times, method: str, ckpt_dir: str | None = None, device="cuda"
) -> dict[str, np.ndarray]:
    """One simulation through a stepping backend, as a named trace dict.

    ``ckpt_dir`` ("ext" only) enables mid-solve advance snapshots, so a
    killed sweep resumes inside a long solve, not only at point granularity
    (dynamics/checkpoint.py)."""
    args = (model.hamiltonian, model.psi0, times, model.dims,
            model.n_sea_effective, model.idx_rare)
    if method in ("expm", "dopri"):
        from ..dynamics.observables import assemble_traces

        if method == "expm":
            from ..dynamics.expm_propagator import expm_propagate_traces

            out = expm_propagate_traces(*args[:4], device=device)
        else:
            from ..dynamics.dopri import dopri_propagate_traces

            out = dopri_propagate_traces(*args[:4], device=device)
        tr = assemble_traces(out["site_xyz"], out["norm"], model.n_sea_effective, model.idx_rare)
        tr["energy"] = out.get("energy", np.zeros_like(out["norm"]))
        return tr
    if method == "ext":
        from ..dynamics.expm_propagator import expm_traces_assembled_ext

        rows = expm_traces_assembled_ext(*args, ckpt_dir=ckpt_dir, device=device)
    elif method == "krylov":
        from ..dynamics.krylov import krylov_traces_assembled

        rows = krylov_traces_assembled(*args, device=device)
    elif method == "chebyshev":
        from ..dynamics.chebyshev import chebyshev_traces_assembled

        rows = chebyshev_traces_assembled(*args, device=device)
    else:
        raise ValueError(f"{method!r} is not a stepping solver")
    return traces_dict(rows)


def _solve_group(
    models, times, log=print, solver_method="auto", device="cuda", ckpt_dirs=None
) -> list[dict[str, np.ndarray]]:
    """Batched exact solve for models sharing identical Hilbert dims.

    Returns one reference-named trace dict per model; the observables are
    assembled on the device and only the (B, 8, T) rows come back.  The
    stepping solvers solve model by model instead (``ckpt_dirs``: one
    snapshot directory per model, or None).
    """
    method = "eig" if solver_method == "auto" else solver_method
    check_method(method)
    if method in ("expm", "ext", "krylov", "chebyshev", "dopri"):
        ckpt_dirs = ckpt_dirs or [None] * len(models)
        return [_solve_one_stepping(m, times, method, ckpt_dir=ck, device=device)
                for m, ck in zip(models, ckpt_dirs)]
    solve_fn = eig_traces_assembled_batched32 if method == "eig32" else eig_traces_assembled_batched

    dims = models[0].dims
    dim = int(np.prod(dims))
    B = len(models)
    chunk = max(1, min(B, _MAX_BATCH_BYTES // (dim * dim * 16 * 3)))
    outs: list[dict[str, np.ndarray]] = []
    for s in range(0, B, chunk):
        grp = models[s : s + chunk]
        t0 = time.perf_counter()
        ws, Vs = [], []
        for m in grp:
            w, V = eigh_host(m.hamiltonian.to_dense())
            ws.append(w)
            Vs.append(V)
        t1 = time.perf_counter()
        rows = solve_fn(
            np.stack(ws), np.stack(Vs), np.stack([m.psi0 for m in grp]),
            times=times,
            dims=dims,
            n_sea_effective=np.asarray([m.n_sea_effective for m in grp]),
            idx_rare=grp[0].idx_rare,
            device=device,
        )
        t2 = time.perf_counter()
        log(
            f"  [solve] {len(grp)} sims (dim {dim}): "
            f"eigh {t1 - t0:.2f}s host, traces {t2 - t1:.2f}s device",
        )
        outs.extend(traces_dict(rows[i]) for i in range(len(grp)))
    return outs


def run_sweep_sea_detuning(
    *,
    f_Az: float,
    f1A: float,
    target_sea_detuning: float,
    gamma_sea: float,
    gamma_rare: float,
    sea_detunings_Hz: Sequence[float],
    n_sea: int = 12,
    t_final: float = 3.0e-2,
    steps: int = 2000,
    phi_sea: float = 0.0,
    phi_rare: float = 0.0,
    out_root: str = "results",
    is_spin_three_half: bool = False,
    solver_atol: float | None = None,
    solver_rtol: float | None = None,
    solver_nsteps: int | None = None,
    solver_max_step: float | None = None,
    coarse_window: int = 50,
    solver_method: str = "auto",
    make_plots: bool = True,
    resume: bool = False,
    base_dir: Optional[str] = None,
    mesh=None,
    device: str | torch.device = "cuda",
) -> str:
    """Run a sweep over sea detunings δ_A = f_Az - f_rf,A.  Returns base_dir.

    Signature is keyword-compatible with the reference driver
    (sweep_sea_detuning.py:356-376) plus framework extensions
    (solver_method / make_plots / resume / base_dir / device).
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded sweep (mesh=) is not ported to PyTorch yet: "
            "ROADMAP.md queue 1 item 5 (parallel)"
        )
    check_method("eig" if solver_method == "auto" else solver_method)
    dev = resolve_device(device)
    f1R = f1R_for_resonance(f1A, target_sea_detuning, 0.0)
    sea_detunings_Hz = np.asarray(sea_detunings_Hz, dtype=float)
    n_det = len(sea_detunings_Hz)

    # -------- derive B fields from target frequencies --------
    B0_common = 2 * np.pi * f_Az / gamma_sea
    omega_Rz = gamma_rare * B0_common
    f_Rz = omega_Rz / (2 * np.pi)
    B1_sea = 2 * np.pi * f1A / gamma_sea
    B1_rare = 2 * np.pi * f1R / gamma_rare if gamma_rare != 0.0 else 0.0

    mu0_over_4pi = 1.0e-7
    hbar = 1.054571817e-34
    dipolar_scale_SI = mu0_over_4pi * hbar
    shell_scale = 0.282393e-9

    # -------- one-shot geometry + couplings --------
    positions = shell_positions_with_rare_center(n_sea=n_sea, radius=shell_scale)
    b = dipolar_couplings_from_positions(
        positions=positions, scale=dipolar_scale_SI, gamma_sea=gamma_sea, gamma_rare=gamma_rare
    )
    stats = coupling_statistics(b, n_sea)

    print("Estimated dipolar couplings from geometry + physical scales:")
    print("  Sea–rare b_ij (all sea ↔ rare), |b| in Hz:")
    print(f"    avg |b_AR| ≈ {stats['avg_b_AR_Hz']:.2f} Hz")
    print(f"    rms |b_AR| ≈ {stats['rms_b_AR_Hz']:.2f} Hz")
    print(f"    min |b_AR| ≈ {stats['min_b_AR_Hz']:.2f} Hz")
    print(f"    max |b_AR| ≈ {stats['max_b_AR_Hz']:.2f} Hz")
    print("  Sea–sea b_ij (all i<j), |b| in Hz:")
    print(f"    avg |b_AA| ≈ {stats['avg_b_AA_Hz']:.2f} Hz")
    print(f"    rms |b_AA| ≈ {stats['rms_b_AA_Hz']:.2f} Hz")
    print(f"    min |b_AA| ≈ {stats['min_b_AA_Hz']:.2f} Hz")
    print(f"    max |b_AA| ≈ {stats['max_b_AA_Hz']:.2f} Hz")
    print("------------------------------------------------------------", flush=True)

    # -------- output directory --------
    if base_dir is None:
        # named to the second, as the JAX package names it; where the name
        # is taken (a sweep started earlier in the same second, such as the
        # previous row of a 2D grid) this sweep waits for the next second
        # instead of writing into that sweep's directory
        while True:
            timestamp = _dt.datetime.now().strftime("%Y%m%d_%H%M%S")
            base_dir = os.path.join(out_root, f"sea_detuning_sweep_{timestamp}")
            try:
                os.makedirs(base_dir)
                break
            except FileExistsError:
                time.sleep(0.05)
    os.makedirs(base_dir, exist_ok=True)
    pdf_path = os.path.join(base_dir, "sea_detuning_report.pdf")

    save_geometry_npz(base_dir, positions, b, n_sea)

    global_params: dict[str, Any] = {
        "f_Az_Hz": float(f_Az),
        "f_Rz_Hz": float(f_Rz),
        "f1A_Hz": float(f1A),
        "f1R_Hz": float(f1R),
        "gamma_sea": float(gamma_sea),
        "gamma_rare": float(gamma_rare),
        "B0_common_T": float(B0_common),
        "B1_sea_T": float(B1_sea),
        "B1_rare_T": float(B1_rare),
        "dipolar_scale_SI": float(dipolar_scale_SI),
        "shell_scale_m": float(shell_scale),
        "t_final_s": float(t_final),
        "steps": int(steps),
        "n_sea": int(n_sea),
        "phi_sea_rad": float(phi_sea),
        "phi_rare_rad": float(phi_rare),
        "sea_detunings_Hz": [float(x) for x in sea_detunings_Hz],
        "sea_spin_type": "1/2",
        "rare_spin_type": "3/2" if is_spin_three_half else "1/2",
        "solver_atol": solver_atol,
        "solver_rtol": solver_rtol,
        "solver_nsteps": solver_nsteps,
        "solver_max_step": solver_max_step,
        "target_sea_detuning": target_sea_detuning,
        "coarse_window": int(coarse_window),
        "avg_b_AR_Hz": stats["avg_b_AR_Hz"],
        "rms_b_AR_Hz": stats["rms_b_AR_Hz"],
        "avg_b_AA_Hz": stats["avg_b_AA_Hz"],
        "rms_b_AA_Hz": stats["rms_b_AA_Hz"],
    }
    summary: dict[str, Any] = {"global_params": global_params, "sweep_results": []}

    print("------------------------------------------------------------")
    print("Starting sea detuning sweep (Ga sea, Al rare)")
    print(f"  Output directory    : {base_dir}")
    print(f"  Number of points    : {n_det}")
    print(f"  f_Az (Ga Larmor)    : {f_Az/1e6:.3f} MHz")
    print(f"  f_Rz (Al Larmor)    : {f_Rz/1e6:.3f} MHz")
    print(f"  Target sea detuning : {target_sea_detuning/1e6:.3f} MHz")
    print(f"  f1A (sea Rabi)      : {f1A/1e3:.3f} kHz")
    print(f"  f1R (rare Rabi)     : {f1R/1e3:.3f} kHz")
    print(f"  B0 (common)         : {B0_common:.3f} T")
    print("  Detunings δ_A (Hz):")
    print("   ", ", ".join(f"{d:+.1f}" for d in sea_detunings_Hz))
    print("------------------------------------------------------------", flush=True)

    times = np.linspace(0.0, t_final, steps)
    timer = StageTimer(device=dev)

    # -------- build all variant params / models --------
    def variant_params(delta_Hz: float) -> dict[str, DipolarRareParams]:
        f_rf_sea = f_Az - delta_Hz
        base = DipolarRareParams(
            n_sea=n_sea,
            gamma_sea=gamma_sea,
            gamma_rare=gamma_rare,
            B0_sea=B0_common,
            B0_rare=B0_common,
            B1_sea=B1_sea,
            B1_rare=B1_rare,
            omega_rf_sea=2 * np.pi * f_rf_sea,
            omega_rf_rare=2 * np.pi * f_Rz,
            phi_sea=phi_sea,
            phi_rare=phi_rare,
            dipolar_scale=dipolar_scale_SI,
            shell_scale=shell_scale,
            t_final=t_final,
            steps=steps,
            drive_sea=True,
            drive_rare=False,
            init_x_sign=-1,
            init_rare_level=3,
            is_spin_three_half=is_spin_three_half,
            is_center_rare=True,
            solver_atol=solver_atol,
            solver_rtol=solver_rtol,
            solver_nsteps=solver_nsteps,
            solver_max_step=solver_max_step,
            solver_method=solver_method,
        )
        return {
            "center_off": replace(base, drive_rare=False, is_center_rare=True),
            "center_on": replace(base, drive_rare=True, is_center_rare=True),
            "shell_off": replace(base, drive_rare=False, is_center_rare=False),
        }

    todo: list[tuple[int, float]] = []
    resumed_rows: dict[int, dict] = {}
    for idx, delta_Hz in enumerate(sea_detunings_Hz):
        det_dir = os.path.join(base_dir, detuning_label(delta_Hz))
        metrics_path = os.path.join(det_dir, "metrics.json")
        if resume and os.path.isfile(metrics_path):
            with open(metrics_path, "r", encoding="utf-8") as f:
                resumed_rows[idx] = json.load(f)
            print(f"[{idx + 1}/{n_det}] resume: skipping δ_A = {delta_Hz:+.1f} Hz", flush=True)
        else:
            todo.append((idx, float(delta_Hz)))

    # group (detuning, tag) sims by Hilbert dims for batching
    sims = []  # (idx, tag, params, model)
    with timer.stage("build_models"):
        for idx, delta_Hz in todo:
            pv = variant_params(delta_Hz)
            for tag in TAGS:
                sims.append((idx, tag, pv[tag], build_model(pv[tag])))

    solved: dict[tuple[int, str], dict] = {}
    by_dims: dict[tuple[int, ...], list[int]] = {}
    for i, (_, _, _, m) in enumerate(sims):
        by_dims.setdefault(m.dims, []).append(i)
    t_solve0 = time.perf_counter()
    with timer.stage("solve"):
        for dims_key, sim_ids in by_dims.items():
            # the stepping solver snapshots mid-solve under the sweep dir, so
            # a killed run resumes inside a long solve (cleared on success)
            ckpt_dirs = [
                os.path.join(base_dir, ".solver_ckpt", f"sim{i:04d}")
                for i in sim_ids
            ] if solver_method == "ext" else None
            outs = _solve_group(
                [sims[i][3] for i in sim_ids], times,
                solver_method=solver_method, device=dev, ckpt_dirs=ckpt_dirs,
            )
            for i, out in zip(sim_ids, outs):
                idx, tag, _, _ = sims[i]
                solved[(idx, tag)] = out
    solve_wall = time.perf_counter() - t_solve0
    n_solved = len(sims)
    if n_solved:
        print(
            f"Solved {n_solved} simulations in {solve_wall:.2f} s "
            f"({solve_wall / n_solved:.3f} s/sim amortized)",
            flush=True,
        )

    # -------- per-point artifacts / metrics / plots --------
    if make_plots:
        from matplotlib.backends.backend_pdf import PdfPages

        from ..artifacts import report as rpt

        pdf_pages = PdfPages(pdf_path)
    else:
        pdf_pages = contextlib.nullcontext()
    with pdf_pages as pdf:
        lines = [
            "Sea detuning sweep report (Ga sea / Al rare)",
            "",
            "Global parameters (constant across sweep):",
            f"  f_Az (sea Larmor)     = {f_Az/1e6:.3f} MHz",
            f"  f_Rz (rare Larmor)    = {f_Rz/1e6:.3f} MHz",
            f"  f1A (sea Rabi)        = {f1A/1e3:.3f} kHz",
            f"  f1R (rare Rabi)       = {f1R/1e3:.3f} kHz",
            f"  Target sea detuning   = {target_sea_detuning / 1e3:.3f} kHz",
            f"  gamma_sea             = {gamma_sea:.3e} rad·s⁻¹·T⁻¹",
            f"  gamma_rare            = {gamma_rare:.3e} rad·s⁻¹·T⁻¹",
            f"  B0_common             = {B0_common:.3f} T",
            f"  B1_sea                = {B1_sea:.3e} T",
            f"  B1_rare               = {B1_rare:.3e} T",
            f"  dipolar_scale_SI      = {dipolar_scale_SI:.3e}",
            f"  shell_scale           = {shell_scale*1e9:.3f} nm",
            f"  t_final               = {t_final:.3e} s",
            f"  steps                 = {steps:d}",
            f"  n_sea                 = {n_sea:d}",
            f"  phi_sea               = {phi_sea:.3f} rad",
            f"  phi_rare              = {phi_rare:.3f} rad",
            "  sea_spin_type         = 1/2",
            "  rare_spin_type        = " + ("3/2" if is_spin_three_half else "1/2"),
            "",
            f"  solver_atol           = {solver_atol}",
            f"  solver_rtol           = {solver_rtol}",
            f"  solver_nsteps         = {solver_nsteps}",
            f"  solver_max_step       = {solver_max_step}",
            "",
            f"  coarse_window         = {coarse_window}",
            "",
            "Sea detunings (δ_A = f_Az - f_rf,A) in Hz:",
        ]
        det_strs = [f"{d:+.1f}" for d in sea_detunings_Hz]
        for i in range(0, len(det_strs), 6):
            lines.append("  " + ", ".join(det_strs[i : i + 6]))
        if make_plots:
            rpt.param_page(pdf, lines)

        for idx, delta_Hz in enumerate(sea_detunings_Hz):
            if idx in resumed_rows:
                summary["sweep_results"].append(resumed_rows[idx])
                continue
            delta_Hz = float(delta_Hz)
            f_rf_sea = f_Az - delta_Hz
            det_dir = os.path.join(base_dir, detuning_label(delta_Hz))
            os.makedirs(det_dir, exist_ok=True)
            pv = variant_params(delta_Hz)

            traces: dict[str, dict[str, np.ndarray]] = {}
            for tag in TAGS:
                params_tag = pv[tag]
                tr = dict(solved[(idx, tag)])
                tr.pop("energy", None)  # diagnostic; not part of the NPZ contract
                traces[tag] = tr
                save_trace_npz(det_dir, tag, times, tr)
                save_params_and_freqs(det_dir, tag, params_tag, get_derived_frequencies(params_tag))
                print(f"[{idx + 1}/{n_det}] |||| Finished {tag}", flush=True)

            # coarse envelopes + slope fits
            t_c_off, iz_c_off = coarse_grain(times, traces["center_off"]["Iz_sea"], coarse_window)
            t_c_on, iz_c_on = coarse_grain(times, traces["center_on"]["Iz_sea"], coarse_window)
            t_c_sc, iz_c_sc = coarse_grain(times, traces["shell_off"]["Iz_sea"], coarse_window)
            slope_off = iz_slope_from_coarse(t_c_off, iz_c_off)
            slope_on = iz_slope_from_coarse(t_c_on, iz_c_on)
            slope_sc = iz_slope_from_coarse(t_c_sc, iz_c_sc)

            contrast_rare_center = contrast_michelson_with_t_gate(
                slope_on["I_z_slope"], slope_off["I_z_slope"],
                slope_on["t_value"], slope_off["t_value"],
            )
            contrast_sea_center = contrast_michelson_with_t_gate(
                slope_on["I_z_slope"], slope_sc["I_z_slope"],
                slope_on["t_value"], slope_sc["t_value"],
            )
            eta = eta_mismatch(delta_Hz, f1A, f1R, stats["rms_b_AR_Hz"])

            metrics = {
                "delta_Hz": float(delta_Hz),
                "f_rf_sea_Hz": float(f_rf_sea),
                "I_z_slope_off_center": float(slope_off["I_z_slope"]),
                "R_off_center": float(slope_off["R_value"]),
                "t_off_center": float(slope_off["t_value"]),
                "I_z_slope_on_center": float(slope_on["I_z_slope"]),
                "R_on_center": float(slope_on["R_value"]),
                "t_on_center": float(slope_on["t_value"]),
                "contrast_rare_center": float(contrast_rare_center),
                "I_z_slope_off_sea_center": float(slope_sc["I_z_slope"]),
                "R_off_sea_center": float(slope_sc["R_value"]),
                "t_off_sea_center": float(slope_sc["t_value"]),
                "contrast_sea_center": float(contrast_sea_center),
                "DeltaOmega_Hz": eta["DeltaOmega_Hz"],
                "g_eff_Hz": eta["g_eff_Hz"],
                "DeltaOmega_over_geff": eta["DeltaOmega_over_geff"],
            }
            json_dump(os.path.join(det_dir, "metrics.json"), metrics)
            summary["sweep_results"].append(metrics)

            if make_plots:
                rpt.raw_iz_page(
                    pdf, det_dir, delta_Hz,
                    times, traces["center_off"]["Iz_sea"],
                    times, traces["center_on"]["Iz_sea"],
                )
                rpt.envelopes_center_page(
                    pdf, det_dir, delta_Hz, t_c_off, iz_c_off, t_c_on, iz_c_on,
                    slope_off, slope_on, contrast_rare_center,
                    eta["DeltaOmega_over_geff"],
                )
                rpt.envelopes_sea_center_page(
                    pdf, det_dir, delta_Hz, t_c_sc, iz_c_sc, slope_sc, contrast_sea_center
                )
                rpt.norm_page(
                    pdf, det_dir, delta_Hz,
                    times, traces["center_off"]["state_norm"],
                    times, traces["center_on"]["state_norm"],
                )

            print(
                f"[{idx + 1}/{n_det}] Finished δ_A = {delta_Hz:+.1f} Hz, results in {det_dir}",
                flush=True,
            )

        if make_plots:
            rpt.summary_table_page(pdf, summary["sweep_results"])
            try:
                rpt.contrast_vs_eta_page(pdf, base_dir, summary["sweep_results"])
            except Exception as exc:  # parity with reference's guard (:1149-1150)
                print(f"Warning: could not build ΔΩ/|g_eff| contrast plot: {exc}")

    json_dump(os.path.join(base_dir, "global_params.json"), global_params)
    json_dump(os.path.join(base_dir, "summary.json"), summary)
    write_sweep_csv(base_dir, summary["sweep_results"])
    timer.dump(os.path.join(base_dir, "timings.json"))

    print("------------------------------------------------------------")
    print("Sweep complete.")
    print(f"  Results directory: {base_dir}")
    print(f"  PDF report       : {pdf_path}")
    print("------------------------------------------------------------", flush=True)
    return base_dir
