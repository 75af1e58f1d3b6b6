"""CLI: exponential tau/t90 re-analysis of one sweep directory.

``python -m quantumsimulations_tpu_torch.cli.reprocess_exponential --root <sweep_dir>``

Port of ``quantumsimulations_tpu/cli/reprocess_exponential.py``; host
numpy, no device.
"""

from __future__ import annotations

import argparse

from ..sweep.reprocess_exponential import reprocess_exponential


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True, help="one sweep directory (contains delta_* dirs)")
    p.add_argument("--window", type=int, default=None,
                   help="coarse window (default: the sweep's global_params value, else 100)")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--output", default=None, help="output PDF path")
    args = p.parse_args(argv)
    out = reprocess_exponential(
        args.root,
        coarse_window=args.window,
        make_plots=not args.no_plots,
        out_pdf=args.output,
    )
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
