"""First check of the matrix-free solvers' pieces on the card, and a
calibration of the krylov (n12) and chebyshev (n13) routes.

Builds csrc/z_expectations_f32.cu (ptxas report), holds the kernel against
its plain version at the smoke's shapes with CUDA-event timings, times the
qubit flip apply at dim 8192 and 16384 (device time per apply from CUDA
events, host wall per apply from a loop that ends in a synchronise), runs
``--substeps`` Lanczos substeps of the n12 workload at the production
spacing, and one global Chebyshev sweep of the n13 workload over
``--cheb-t`` seconds (21 output times), whose states go through the z kernel
and are held against the route's float64 rows.

    python3 experiments/torch_matrix_free_probe.py [--substeps 20] [--cheb-t 0.002] [--json out.json]

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from chip_smoke import N12_DT, cuda_ms, n12_params, n13_params


def zexp_check(n, dim, T, dtype, seed):
    from quantumsimulations_tpu_torch.ops import zexp

    gen = torch.Generator(device="cuda").manual_seed(seed)
    re, im = (torch.randn(dim, T, generator=gen, device="cuda", dtype=dtype) for _ in range(2))
    dims = (2,) * (n - 1) + (dim >> (n - 1),)
    signs = torch.as_tensor(zexp.z_sign_table(dims), device="cuda")
    got = zexp.z_expectations_f32(re, im, signs)
    want = zexp.z_expectations_f32_plain(re, im, signs)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    s32 = signs.float()
    p2 = (re * re + im * im).float()
    return {
        "shape": [n, dim, T, str(dtype)], "rel_err": rel,
        "ms": cuda_ms(lambda: zexp.z_expectations_f32(re, im, signs)),
        "plain_ms": cuda_ms(lambda: zexp.z_expectations_f32_plain(re, im, signs)),
        "library_ms": cuda_ms(lambda: torch.matmul(s32, p2)),
    }


def apply_times(model, reps=200):
    from quantumsimulations_tpu_torch.dynamics.krylov import default_matrix_free_apply

    apply_h = default_matrix_free_apply(model.hamiltonian, device="cuda")
    psi = torch.as_tensor(model.psi0, dtype=torch.complex128, device="cuda")
    dev_ms = cuda_ms(lambda: apply_h(psi), reps=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        apply_h(psi)
    torch.cuda.synchronize()
    return {"device_ms": dev_ms, "wall_ms": (time.perf_counter() - t0) / reps * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--substeps", type=int, default=20)
    ap.add_argument("--cheb-t", type=float, default=0.002)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from quantumsimulations_tpu_torch.dynamics import chebyshev as tc
    from quantumsimulations_tpu_torch.dynamics import krylov as tk
    from quantumsimulations_tpu_torch.kernels._build import build
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.ops import zexp

    out = {"card": subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        "torch": torch.__version__}
    print(out, flush=True)
    t0 = time.perf_counter()
    rep = build("z_expectations_f32", extra_flags=("-Xptxas", "-v"))
    out["build_s"] = time.perf_counter() - t0
    out["ptxas"] = [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
    print(out["ptxas"], flush=True)

    out["zexp"] = [zexp_check(*s, seed=i) for i, s in enumerate(
        [(4, 16, 37, torch.float64), (7, 128, 20000, torch.float32),
         (14, 16384, 2048, torch.float64), (14, 16384, 21, torch.float64)])]
    for r in out["zexp"]:
        print("zexp", r, flush=True)

    m12 = build_model(n12_params(3))
    m13 = build_model(n13_params(21))
    out["apply_n12"], out["apply_n13"] = apply_times(m12), apply_times(m13)
    print("apply", out["apply_n12"], out["apply_n13"], flush=True)

    t0 = time.perf_counter()
    est = tk.spectral_norm_estimate(m12.hamiltonian, device="cuda")
    bound = tk.spectral_norm_bound(m12.hamiltonian)
    est_s = time.perf_counter() - t0
    step, n_sub = tk.make_krylov_step(m12.hamiltonian, N12_DT, norm_bound=min(bound, est),
                                      device="cuda")
    psi = torch.as_tensor(m12.psi0, dtype=torch.complex128, device="cuda")
    psi = step.substeps(psi, 2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psi = step.substeps(psi, args.substeps)
    torch.cuda.synchronize()
    sub_s = (time.perf_counter() - t0) / args.substeps
    out["krylov_n12"] = {"bound": bound, "estimate": est, "estimate_s": est_s, "n_sub": n_sub,
                         "s_per_substep": sub_s, "norm": float(torch.linalg.vector_norm(psi))}
    print("krylov", out["krylov_n12"], flush=True)

    times = np.linspace(0.0, args.cheb_t, 21)
    lam = tk.spectral_norm_bound(m13.hamiltonian)
    K = tc.chebyshev_coefficients(lam, times).shape[1]
    t0 = time.perf_counter()
    states = tc.chebyshev_states(m13.hamiltonian, m13.psi0, times, device="cuda")
    wall = time.perf_counter() - t0
    rows = tc.rows_from_states(m13.hamiltonian, m13.psi0, states, m13.dims,
                               m13.n_sea_effective, m13.idx_rare, device="cuda")
    S = torch.as_tensor(states, device="cuda").T
    z = zexp.z_expectations_f32(S.real.contiguous(), S.imag.contiguous(),
                                torch.as_tensor(zexp.z_sign_table(m13.dims), device="cuda"))
    z = z.double().cpu().numpy()
    out["chebyshev_n13"] = {
        "lambda": lam, "K": K, "wall_s": wall, "s_per_apply": wall / K,
        "norm_dev": float(np.abs(rows[6] - 1).max()), "iz0": float(rows[2, 0]),
        "zexp_vs_rows": max(float(np.abs(z[: m13.n_sea_effective].sum(0) - rows[2]).max()),
                            float(np.abs(z[m13.idx_rare] - rows[3]).max())),
    }
    print("chebyshev", out["chebyshev_n13"], flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
