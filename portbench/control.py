#!/usr/bin/env python3
"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's (complex64,
TF32 off), compared with the reference in complex128 by the same trace gap
and the cell's limit, on the evolutions a run with that seed times first.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] [--evolutions 1]

Prints one JSON line per seed: the control's gap, the limit, and whether
the control came out not correct (it must).  Not run by the benchmark's own
runs; ``test_portbench_card.py`` holds it at the cells' size on the card,
``test_portbench_reference.py`` at a small size on the CPU.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def control_gaps(cell, seed: int, n_evolutions: int, device: str) -> list[float]:
    """The control's trace gap on each of the first ``n_evolutions`` timed
    evolutions of ``seed``."""
    import torch

    import reference
    import traffic as gen

    order = gen.detuning_order(cell.config, seed)
    gaps = []
    for i in range(n_evolutions):
        rec = gen.timed_record(cell.config["params"], order, i)
        ref = reference.reference_rows(rec, device=device)
        low = reference.reference_rows(rec, dtype=torch.complex64, device=device)
        gaps.append(reference.trace_gap(dict(zip(reference.ROWS, low)), ref))
    return gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--evolutions", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    import harness

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    limit = float(cell.limits["trace_gap"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        gaps = control_gaps(cell, seed, args.evolutions, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "control_gaps": gaps,
                          "limit": limit, "control_fails": any(not g <= limit for g in gaps),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
