"""The n_sea 13 bath (dim 16384) through the port's ``ext`` route on the card,
held against the study's own full n13 production trace and the benchmark's
plain reference.

The record ``experiments/cheb_step_n13_trace.npz`` holds rows (8, 20000) of
the n13 bath at a 1 kHz sea detuning over 30 s (the JAX package's f64
Chebyshev stepper, 9.2 h on its TPU; ``cross_check_16384.json``).  This runs
``simulate_rare(solver_method="ext")`` on the same record (the benchmark
configuration ``bath-n13``'s physics at 1 kHz), with a timer that keeps each
stage's device-memory high water, then ``portbench/reference.py`` on the
same record, and prints one JSON line: the walls of both, the largest gap of
each of the seven observable rows against the stored record, the gap
against the reference, and each stage's seconds and ``memory.peak_bytes``.
The record is loaded with numpy only.

    python3 experiments/torch_n13_ext_check.py [--detuning-hz 1000] [--no-reference]

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]

RECORD = ROOT / "experiments" / "cheb_step_n13_trace.npz"
#: the record's first seven rows, as ``simulate_rare`` names them (its eighth
#: is the energy, which ``simulate_rare`` does not return)
ROWS = ("Ix_sea", "Iy_sea", "Iz_sea", "Iz_R", "Ix_R", "Iy_R", "state_norm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--detuning-hz", type=float, default=1000.0)
    ap.add_argument("--no-reference", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import harness
    import reference
    import traffic as gen
    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
    from quantumsimulations_tpu_torch.models.params import DipolarRareParams
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    cfg = json.loads((ROOT / "portbench" / "configs" / "bath-n13.json").read_text())
    params = cfg["params"]
    rec = gen.params_record(params, args.detuning_hz, params["t_final"], params["steps"])
    stored = np.load(RECORD)
    out = {"card": harness.card_line(), "torch": torch.__version__,
           "detuning_Hz": args.detuning_hz}

    timer = StageTimer(device=torch.device("cuda"), memory=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t, traces = simulate_rare(DipolarRareParams(**rec, solver_method="ext"), device="cuda",
                              timer=timer)
    torch.cuda.synchronize()
    out["ext_wall_s"] = time.perf_counter() - t0
    out["stages"] = {k: {"seconds": v, "calls": timer.counts[k],
                         "memory.peak_bytes": timer.counters.get(k, {}).get("memory.peak_bytes")}
                     for k, v in timer.stages.items()}
    out["memory_peak_bytes_max"] = max(
        (c["memory.peak_bytes"] for c in timer.counters.values() if "memory.peak_bytes" in c),
        default=None)
    same_grid = np.allclose(t, stored["t"], rtol=0, atol=1e-12)
    out["same_grid_as_record"] = bool(same_grid)
    got = np.stack([np.asarray(traces[k], dtype=np.float64) for k in ROWS])
    gaps = np.abs(got - stored["rows"][:7]).max(axis=1)
    out["gap_vs_record"] = {k: float(g) for k, g in zip(ROWS, gaps)}
    out["gap_vs_record_max"] = float(gaps.max())
    out["norm_drift"] = float(np.abs(got[6] - 1.0).max())
    print(json.dumps(out), flush=True)

    if not args.no_reference:
        t0 = time.perf_counter()
        ref = reference.reference_rows(rec, device="cuda")
        torch.cuda.synchronize()
        out["reference_wall_s"] = time.perf_counter() - t0
        out["gap_vs_reference"] = reference.trace_gap(traces, ref)
        out["record_vs_reference"] = float(np.abs(stored["rows"][:7] - ref).max())
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
