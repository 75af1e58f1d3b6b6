"""CLI: 2D (f1A x detuning) grid sweep + aggregation (BASELINE config 4).

``python -m quantumsimulations_tpu_torch.cli.sweep2d --f1a-khz 5 10 20 50 ...``

Runs one standard sweep per drive amplitude under a shared root, then
invokes the 2D aggregation + stable region analysis on the root.

Port of ``quantumsimulations_tpu/cli/sweep2d.py``: the same flags and
defaults, with ``--device cuda|cpu`` (default cuda, raising without CUDA) in
place of ``--platform``.  ``--mesh-devices N > 0`` (each row's batch sharded
over a device mesh) raises NotImplementedError (ROADMAP.md queue 1 item 5).
matplotlib is imported only for the plots and the report, so
``--no-plots --skip-report`` runs where it is not installed.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.params import GAMMA_27AL, GAMMA_71GA
from ..sweep.grid2d import run_grid2d


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--f1a-khz", type=float, nargs="+", default=[10.0, 20.0, 50.0],
                   help="drive amplitude rows of the grid, in kHz")
    p.add_argument("--gamma-sea", type=float, default=GAMMA_71GA)
    p.add_argument("--gamma-rare", type=float, default=GAMMA_27AL)
    p.add_argument("--b0", type=float, default=3.0)
    p.add_argument("--n-detunings", type=int, default=13)
    p.add_argument("--detuning-max-factor", type=float, default=3.0)
    p.add_argument("--n-sea", type=int, default=6)
    p.add_argument("--t-final", type=float, default=30.0)
    p.add_argument("--steps", type=int, default=20_000)
    p.add_argument("--coarse-window", type=int, default=100)
    p.add_argument("--out-root", default="results/grid2d")
    p.add_argument("--spin-three-half", action="store_true")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="shard each row's batch over this many devices (0 = off; "
                        "not ported yet)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device for the propagation (cuda is required "
                        "unless 'cpu' is given)")
    p.add_argument("--skip-report", action="store_true")
    args = p.parse_args(argv)

    from ..utils.cache import enable_persistent_compile_cache

    enable_persistent_compile_cache()

    if args.mesh_devices > 0:
        raise NotImplementedError(
            "--mesh-devices (the sharded sweep) is not ported to PyTorch yet: "
            "ROADMAP.md queue 1 item 5 (parallel)"
        )

    f_Az = args.gamma_sea * args.b0 / (2 * np.pi)
    dirs = run_grid2d(
        f_Az=f_Az,
        f1A_values_Hz=[k * 1e3 for k in args.f1a_khz],
        gamma_sea=args.gamma_sea,
        gamma_rare=args.gamma_rare,
        detuning_max_factor=args.detuning_max_factor,
        n_detunings=args.n_detunings,
        n_sea=args.n_sea,
        t_final=args.t_final,
        steps=args.steps,
        out_root=args.out_root,
        is_spin_three_half=args.spin_three_half,
        coarse_window=args.coarse_window,
        make_plots=not args.no_plots,
        resume=args.resume,
        device=args.device,
    )
    print(f"grid2d complete: {len(dirs)} sweep rows under {args.out_root}")

    if not args.skip_report:
        from .report2d import main as report_main

        report_main([args.out_root, "--stable"])


if __name__ == "__main__":
    main()
