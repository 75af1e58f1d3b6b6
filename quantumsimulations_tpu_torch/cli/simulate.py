"""CLI: one time evolution -> NPZ trace (+ optional quick-look PNG).

``python -m quantumsimulations_tpu_torch.cli.simulate --n-sea 6 --delta 1000 -o out.npz``

Port of ``quantumsimulations_tpu/cli/simulate.py``, the single-simulation
counterpart of the sweep CLI: the same physical defaults as the reference
production configuration, one detuning point, one variant, and the same
flags, with ``--device cuda|cpu`` (default cuda, raising without CUDA) in
place of ``--platform``.  matplotlib is imported only for ``--png``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..analysis.metrics import f1R_for_resonance
from ..models.params import GAMMA_27AL, GAMMA_71GA, DipolarRareParams


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gamma-sea", type=float, default=GAMMA_71GA)
    p.add_argument("--gamma-rare", type=float, default=GAMMA_27AL)
    p.add_argument("--b0", type=float, default=3.0)
    p.add_argument("--f1a", type=float, default=50_000.0)
    p.add_argument("--f1r", type=float, default=None,
                   help="rare Rabi (Hz); default: Hartmann-Hahn match at --target-detuning")
    p.add_argument("--target-detuning", type=float, default=None)
    p.add_argument("--delta", type=float, default=0.0, help="sea detuning (Hz)")
    p.add_argument("--n-sea", type=int, default=6)
    p.add_argument("--t-final", type=float, default=30.0)
    p.add_argument("--steps", type=int, default=20_000)
    p.add_argument("--drive-rare", action="store_true")
    p.add_argument("--sea-center", action="store_true",
                   help="control geometry: every site is a sea spin")
    p.add_argument("--spin-three-half", action="store_true")
    p.add_argument("--lab-frame", action="store_true",
                   help="integrate the lab-frame cosine-drive H(t) instead of the rotating frame")
    p.add_argument("--solver", default="auto",
                   choices=("auto", "eig", "eig32", "expm", "krylov", "dopri"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device (cuda is required unless 'cpu' is given)")
    p.add_argument("-o", "--output", default="trace.npz")
    p.add_argument("--png", default=None, help="also write a quick-look Iz plot")
    return p


def params_from_args(args: argparse.Namespace) -> DipolarRareParams:
    """The DipolarRareParams the CLI runs for parsed ``args``."""
    f_Az = args.gamma_sea * args.b0 / (2 * np.pi)
    target = args.target_detuning if args.target_detuning is not None else args.f1a
    f1R = args.f1r if args.f1r is not None else f1R_for_resonance(args.f1a, target, 0.0)
    return DipolarRareParams(
        n_sea=args.n_sea,
        gamma_sea=args.gamma_sea,
        gamma_rare=args.gamma_rare,
        B0_sea=args.b0,
        B0_rare=args.b0,
        B1_sea=2 * np.pi * args.f1a / args.gamma_sea,
        B1_rare=2 * np.pi * f1R / args.gamma_rare,
        omega_rf_sea=2 * np.pi * (f_Az - args.delta),
        omega_rf_rare=args.gamma_rare * args.b0,
        phi_sea=np.pi / 2,
        phi_rare=np.pi / 2,
        dipolar_scale=1e-7 * 1.054571817e-34,
        shell_scale=0.282393e-9,
        t_final=args.t_final,
        steps=args.steps,
        drive_sea=True,
        drive_rare=args.drive_rare,
        is_spin_three_half=args.spin_three_half,
        is_center_rare=not args.sea_center,
        solver_method=args.solver,
    )


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    from ..utils.cache import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    params = params_from_args(args)

    if args.lab_frame:
        from ..models.labframe import simulate_lab_frame

        t, obs = simulate_lab_frame(params, device=args.device)
    else:
        from ..dynamics.evolve import simulate_rare

        t, obs = simulate_rare(params, device=args.device)

    np.savez(args.output, t=t, **obs)
    drift = float(np.abs(obs["state_norm"] - 1.0).max())
    print(f"Wrote {args.output}  (T={len(t)}, norm drift {drift:.2e})")

    if args.png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(t, obs["Iz_sea"], label=r"$\langle I^z_{sea}\rangle$")
        ax.plot(t, obs["Iz_R"], label=r"$\langle I^z_R\rangle$")
        ax.set_xlabel("Time (s)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.png, dpi=200)
        print(f"Wrote {args.png}")


if __name__ == "__main__":
    main()
