"""CLI sweep entry point: ``python -m quantumsimulations_tpu_torch.cli.sweep``.

The reference is configured by editing constants in its ``__main__`` block
(sweep_sea_detuning.py:1201-1252, README "edit the source" workflow); here the
same physical defaults are proper command-line flags.  Running with no
arguments reproduces the reference's shipped production configuration
(71Ga sea / 27Al rare at 3 T, f1A = 50 kHz, 13 detunings to 3*f1A, 30 s
horizon, 20000 output steps) on the CUDA device; ``--device cpu`` runs it on
the host instead.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.params import GAMMA_27AL, GAMMA_71GA
from ..sweep.runner import run_sweep_sea_detuning


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Sea-detuning sweep of the driven dipolar sea + rare-spin ensemble."
    )
    p.add_argument("--gamma-sea", type=float, default=GAMMA_71GA, help="sea gyromagnetic ratio (rad/s/T)")
    p.add_argument("--gamma-rare", type=float, default=GAMMA_27AL, help="rare gyromagnetic ratio (rad/s/T)")
    p.add_argument("--b0", type=float, default=3.0, help="static field B0 (T)")
    p.add_argument("--f1a", type=float, default=50_000.0, help="sea Rabi frequency (Hz)")
    p.add_argument("--target-detuning", type=float, default=None,
                   help="sea detuning (Hz) at which f1R satisfies Hartmann-Hahn (default: f1A)")
    p.add_argument("--detuning-max-factor", type=float, default=3.0,
                   help="sweep detunings up to this multiple of the target detuning")
    p.add_argument("--n-detunings", type=int, default=13)
    p.add_argument("--detunings", type=float, nargs="*", default=None,
                   help="explicit detuning list (Hz); overrides the linspace")
    p.add_argument("--n-sea", type=int, default=6)
    p.add_argument("--t-final", type=float, default=30.0, help="horizon (s)")
    p.add_argument("--steps", type=int, default=20_000)
    p.add_argument("--phi-sea", type=float, default=np.pi / 2)
    p.add_argument("--phi-rare", type=float, default=np.pi / 2)
    p.add_argument("--out-root", default="results/sweep_f1A_3x_target_detune_extra_long")
    p.add_argument("--spin-three-half", action="store_true",
                   help="model the rare spin as J=3/2 (coherent, unlike the reference)")
    p.add_argument("--coarse-window", type=int, default=100)
    p.add_argument("--solver", default="auto",
                   choices=("auto", "eig", "eig32", "expm", "krylov", "dopri"))
    p.add_argument("--atol", type=float, default=1e-10)
    p.add_argument("--rtol", type=float, default=1e-9)
    p.add_argument("--nsteps", type=int, default=10_000_000)
    p.add_argument("--max-step", type=float, default=1e-5)
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip detuning points whose metrics.json already exists")
    p.add_argument("--base-dir", default=None,
                   help="write into this sweep directory instead of a fresh timestamped one")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device for the propagation (cuda is required "
                        "unless 'cpu' is given)")
    return p


def main(argv: list[str] | None = None) -> str:
    args = build_parser().parse_args(argv)
    f_Az = args.gamma_sea * args.b0 / (2 * np.pi)
    target = args.target_detuning if args.target_detuning is not None else args.f1a
    if args.detunings is not None and len(args.detunings) > 0:
        detunings = np.asarray(args.detunings, dtype=float)
    else:
        detunings = np.linspace(0.0, args.detuning_max_factor * target, args.n_detunings)
    return run_sweep_sea_detuning(
        f_Az=f_Az,
        f1A=args.f1a,
        target_sea_detuning=target,
        gamma_sea=args.gamma_sea,
        gamma_rare=args.gamma_rare,
        sea_detunings_Hz=detunings,
        n_sea=args.n_sea,
        t_final=args.t_final,
        steps=args.steps,
        phi_sea=args.phi_sea,
        phi_rare=args.phi_rare,
        out_root=args.out_root,
        is_spin_three_half=args.spin_three_half,
        solver_atol=args.atol,
        solver_rtol=args.rtol,
        solver_nsteps=args.nsteps,
        solver_max_step=args.max_step,
        coarse_window=args.coarse_window,
        solver_method=args.solver,
        make_plots=not args.no_plots,
        resume=args.resume,
        base_dir=args.base_dir,
        device=args.device,
    )


if __name__ == "__main__":
    main()
