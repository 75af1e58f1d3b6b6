"""2D sweep: drive amplitude (f1A) x sea detuning grid (BASELINE config 4).

The reference produces 2D data by manually re-running its sweep script with
edited constants into a shared out_root, then aggregating with
2D_sweep_report.py.  Here the full grid is one call: one standard sweep per
f1A row, run one row after another through
:func:`~quantumsimulations_tpu_torch.sweep.runner.run_sweep_sea_detuning`
(each row's 3 x n_detunings simulations solved in one batch on ``device``),
each row written as a standard sweep directory under one root, so the
aggregation/stable-region tooling (ours and the reference's, unchanged)
consumes the result directly.

Port of ``quantumsimulations_tpu/sweep/grid2d.py``, which loops the same
way.  Each row's directory is named to the second by the runner, as in the
JAX package; where a row starts within the second of the previous one, the
runner waits for the next second rather than share its directory (the JAX
package merges the two rows there).  ``mesh`` (each row's batch sharded over devices) raises NotImplementedError
(ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .runner import run_sweep_sea_detuning


def run_grid2d(
    *,
    f_Az: float,
    f1A_values_Hz: Sequence[float],
    gamma_sea: float,
    gamma_rare: float,
    detuning_max_factor: float = 3.0,
    n_detunings: int = 13,
    target_equals_f1A: bool = True,
    n_sea: int = 6,
    t_final: float = 30.0,
    steps: int = 20_000,
    phi_sea: float = np.pi / 2,
    phi_rare: float = np.pi / 2,
    out_root: str = "results/grid2d",
    is_spin_three_half: bool = False,
    coarse_window: int = 100,
    solver_method: str = "auto",
    make_plots: bool = True,
    resume: bool = False,
    mesh=None,
    device: str | torch.device = "cuda",
) -> list[str]:
    """Run one sweep per f1A value under a shared root; returns sweep dirs.

    The detuning list of each row scales with its f1A (0 .. factor * target),
    mirroring how the reference's 2D datasets are produced.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded sweep (mesh=) is not ported to PyTorch yet: "
            "ROADMAP.md queue 1 item 5 (parallel)"
        )
    resolve_device(device)  # raise before anything is written
    os.makedirs(out_root, exist_ok=True)
    dirs = []
    for i, f1A in enumerate(f1A_values_Hz):
        target = f1A if target_equals_f1A else f1A_values_Hz[0]
        detunings = np.linspace(0.0, detuning_max_factor * target, n_detunings)
        print(f"=== grid2d row {i + 1}/{len(f1A_values_Hz)}: f1A = {f1A / 1e3:.3f} kHz ===",
              flush=True)
        base = run_sweep_sea_detuning(
            f_Az=f_Az,
            f1A=f1A,
            target_sea_detuning=target,
            gamma_sea=gamma_sea,
            gamma_rare=gamma_rare,
            sea_detunings_Hz=detunings,
            n_sea=n_sea,
            t_final=t_final,
            steps=steps,
            phi_sea=phi_sea,
            phi_rare=phi_rare,
            out_root=out_root,
            is_spin_three_half=is_spin_three_half,
            coarse_window=coarse_window,
            solver_method=solver_method,
            make_plots=make_plots,
            resume=resume,
            device=device,
        )
        dirs.append(base)
    return dirs
