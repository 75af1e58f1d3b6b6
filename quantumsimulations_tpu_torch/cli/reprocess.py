"""CLI: re-analyze saved sweeps with a new coarse window (no re-solving).

``python -m quantumsimulations_tpu_torch.cli.reprocess <root> --window N``

Headless replacement for the reference's tkinter-picker + input() workflow
(reprocess_sweep_results.py:807-860); per-sweep failures are fenced so one
bad directory doesn't kill the batch (matching reference :856-860).  Port
of ``quantumsimulations_tpu/cli/reprocess.py``; host numpy, no device.
"""

from __future__ import annotations

import argparse

from ..sweep.reprocess import find_sweep_dirs, reprocess_sweep


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", nargs="?", default=None,
                   help="directory tree containing sweep folders (summary.json); "
                        "omitted = interactive pick (reference zero-arg workflow)")
    p.add_argument("--window", type=int, default=None,
                   help="new coarse window; <= 0 keeps each sweep's original window")
    p.add_argument("--plots", action="store_true", help="also regenerate summary PDF pages")
    args = p.parse_args(argv)

    if args.root is None:
        # reference zero-argument double-click workflow
        # (reprocess_sweep_results.py:837-849): pick the root, prompt window
        from ._interactive import pick_root_dir, prompt_int

        args.root = pick_root_dir(
            "Select ROOT directory containing sea-detuning sweeps", "results")
        if not args.root:
            print("No directory selected. Exiting.")
            raise SystemExit(1)
        if args.window is None:
            args.window = prompt_int("Coarse-grain window size", 50)
    if args.window is None:
        args.window = 0

    dirs = find_sweep_dirs(args.root)
    if not dirs:
        print(f"No sweep directories (summary.json) found under {args.root}")
        raise SystemExit(1)
    print(f"Found {len(dirs)} sweep dir(s)")
    for d in dirs:
        try:
            out = reprocess_sweep(d, args.window, make_plots=args.plots)
            print(f"  [ok] {d} -> {out}")
        except Exception as exc:  # per-sweep fencing
            print(f"  [fail] {d}: {type(exc).__name__}: {exc}")


if __name__ == "__main__":
    main()
