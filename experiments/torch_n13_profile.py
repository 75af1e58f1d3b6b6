"""Where the n13 Chebyshev stepping time goes on the card, per tier.

Runs n_sea=13 (dim 16384, the production dt's lambda) through the port's
stepper internals for a window of ``--terms`` Chebyshev terms (one output
step cut short), first without and then under ``torch.profiler``, and
prints per term: the host wall time, the summed device time of every CUDA
kernel (kernels of one stream do not overlap), the device's busy share
(device time / wall), launches per term, and the kernels that take the most
device time.  One JSON line per tier, preceded by the card's name and power
limit as nvidia-smi reports them.

    python3 experiments/torch_n13_profile.py [--terms 201] [--tiers f64 extp]

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--terms", type=int, default=201)
    ap.add_argument("--tiers", nargs="+", default=["f64", "extp"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from quantumsimulations_tpu_torch.dynamics import cheb_step as cs
    from quantumsimulations_tpu_torch.dynamics.chebyshev import chebyshev_coefficients
    from quantumsimulations_tpu_torch.models.dipolar import build_model

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    model = build_model(chip_smoke.n13_params(2))
    lam = cs._lambda_bound(model.hamiltonian, 1 << 14)
    C = chebyshev_coefficients(lam, np.asarray([chip_smoke.N13_DT]))[0][: args.terms]
    K = len(C)
    c_re, c_im = np.real(C).copy(), np.imag(C).copy()
    for arith in args.tiers:
        engine = cs._engine_for(model.hamiltonian, lam, arith, None, dev)
        so = engine["so"]
        coeffs = cs._step_coefficients(c_re, c_im, dev)

        def run(P, n, engine=engine, coeffs=coeffs):
            return engine["run"](P, n, *coeffs)

        psi = model.psi0
        P = torch.as_tensor(np.stack([psi.real, psi.imag]).reshape(2, so.DL, so.DR), device=dev)
        run(P, 1)  # warm-up: module loads, allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(P, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(P, 1)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        dev_us = sum(e.self_device_time_total for e in rows)
        n_kernels = sum(e.count for e in rows)
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
        terms = K - 1  # applies in the window
        out = {
            "tier": arith, "K_window": K, "applies": terms,
            "wall_ms_per_apply": wall / terms * 1e3,
            "wall_ms_per_apply_profiled": wall_prof / terms * 1e3,
            "device_ms_per_apply": dev_us / terms / 1e3 if dev_us else "not measured",
            "device_busy_share": (dev_us / 1e6) / wall_prof if dev_us else "not measured",
            "device_launches_per_apply": n_kernels / terms,
            "top_kernels_ms_per_apply": {
                e.key[:80]: e.self_device_time_total / terms / 1e3 for e in top},
        }
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
