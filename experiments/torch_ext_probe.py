"""First check of the ext route's pieces on the card, and an n12 calibration.

Builds the CUDA kernels (nvcc in parallel, ptxas report), holds
ext_obs_diagonals_int8 against its plain version bit for bit at a ragged
small shape and at (15, 8192, 1024), times the kernel at the n12 advance
shape (15, 8192, 20480), times ``torch._int_mm`` at the ext chain's GEMM
shapes in two operand layouts, times one (8192)^3 ext product at several
column panels (their limbs must agree), holds a dim-256 ext product on the
card against the CPU bit for bit, and runs the n_sea = 12 ext evolution at
the production dt for ``--steps`` output steps with its stage split.

    python3 experiments/torch_ext_probe.py [--steps 1024] [--json out.json]

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def cuda_ms(fn, reps=5, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def limbs(shape, gen, dev="cuda"):
    """Random canonical limbs: limb 0 in [-33, 33], the others in [-16, 16]."""
    x = torch.randint(-16, 17, shape, generator=gen, device=dev, dtype=torch.int32)
    x[0] = torch.randint(-33, 34, shape[1:], generator=gen, device=dev, dtype=torch.int32)
    return x.to(torch.int8).contiguous()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--json", default=None, help="also write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from quantumsimulations_tpu_torch.kernels._build import build_all

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(torch.__version__, torch.version.cuda, flush=True)
    for k, (out, sec) in build_all(extra_flags=("-Xptxas", "-v")).items():
        print(k, f"{sec:.1f}s", [ln.strip() for ln in out.splitlines()
                                 if "registers" in ln or "spill" in ln], flush=True)

    from quantumsimulations_tpu_torch.dynamics.expm_propagator import _EXT_PAIRS
    from quantumsimulations_tpu_torch.ops import extprec as ep
    from quantumsimulations_tpu_torch.ops.ext_obs import (
        ext_obs_diagonals_int8,
        ext_obs_diagonals_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    jj, ii, _ = _EXT_PAIRS
    out = {}
    failed = []

    def section(name, fn):
        """Run one part; a failure is printed and recorded, and the next
        part still runs (this is a calibration, not a check)."""
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - reported below
            failed.append(name)
            print(f"[{name}] FAILED: {exc!r}", flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def obs_part():
        _obs(gen, jj, ii, out, ext_obs_diagonals_int8, ext_obs_diagonals_plain)

    section("obs", obs_part)
    section("int_mm", lambda: _int_mm_part(gen, out))
    section("ext product", lambda: _product_part(gen, out, ep))
    section("n12", lambda: _n12_part(args.steps, out))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    print("failed parts:", failed)
    return 1 if failed else 0


def _obs(gen, jj, ii, out, ext_obs_diagonals_int8, ext_obs_diagonals_plain):
    for shape in ((15, 64, 200), (15, 8192, 1024)):
        S_re, S_im = limbs(shape, gen), limbs(shape, gen)
        k = ext_obs_diagonals_int8(S_re, S_im, jj, ii, 11)
        p = ext_obs_diagonals_plain(S_re, S_im, jj, ii, 11)
        torch.cuda.synchronize()
        eq = bool(torch.equal(k, p))
        kms = cuda_ms(lambda: ext_obs_diagonals_int8(S_re, S_im, jj, ii, 11))
        pms = cuda_ms(lambda: ext_obs_diagonals_plain(S_re, S_im, jj, ii, 11), reps=2)
        out[f"obs {shape}"] = {"equal": eq, "kernel_ms": kms, "plain_ms": pms}
        print("obs", shape, out[f"obs {shape}"], flush=True)
        del S_re, S_im, k, p
    S_re, S_im = limbs((15, 8192, 20480), gen), limbs((15, 8192, 20480), gen)
    out["obs n12 path"] = {"kernel_ms": cuda_ms(
        lambda: ext_obs_diagonals_int8(S_re, S_im, jj, ii, 11), reps=3)}
    print("obs (15, 8192, 20480)", out["obs n12 path"], flush=True)


def _int_mm_part(gen, out):
    """torch._int_mm at the ext chain's GEMM shapes, two operand layouts."""
    M = 8192
    for n in (1, 8, 15):
        for N in (512, 2048):
            K = n * M
            A = torch.randint(-66, 67, (M, 15 * M), generator=gen, device="cuda",
                              dtype=torch.int8)[:, :K]
            BT = torch.randint(-66, 67, (N, 15 * M), generator=gen, device="cuda",
                               dtype=torch.int8)[:, :K]
            Ac, B = A.contiguous(), BT.t().contiguous()
            r = {}
            for name, (x, y) in {"strided A, column-major B": (A, BT.t()),
                                 "contiguous A, row-major B": (Ac, B)}.items():
                try:
                    t = cuda_ms(lambda: torch._int_mm(x, y))
                    r[name] = {"ms": t, "TOP/s": 2.0 * M * K * N / t / 1e9}
                except RuntimeError as exc:
                    r[name] = repr(exc)[:200]
            out[f"int_mm {M}x{K}x{N}"] = r
            print("int_mm", (M, K, N), r, flush=True)
            del A, BT, Ac, B


def _product_part(gen, out, ep):
    """One (8192)^3 ext product at several panels; card vs CPU at dim 256."""
    U_re, U_im = limbs((15, 8192, 8192), gen), limbs((15, 8192, 8192), gen)
    U_re[0] //= 2  # keep the value on the grid domain of a chain operand
    U_im[0] //= 2
    ref = None
    for panel in (512, 2048, 8192):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = ep.ext_cmatmul(U_re, U_im, U_re, U_im, panel=panel)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        same = True if ref is None else bool(torch.equal(c[0], ref[0]) and torch.equal(c[1], ref[1]))
        ref = ref or c
        out[f"ext product panel {panel}"] = {"s": sec, "same_as_first": same,
                                             "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
        print("ext product 8192^3 panel", panel, out[f"ext product panel {panel}"], flush=True)
    del U_re, U_im, ref, c
    torch.cuda.empty_cache()
    g2 = torch.Generator().manual_seed(1)
    a = [limbs((15, 256, 256), g2, "cpu") for _ in range(4)]
    cpu = ep.ext_cmatmul(*a, panel=128)
    gpu = ep.ext_cmatmul(*[x.cuda() for x in a], panel=128)
    out["ext product 256 card == cpu"] = bool(torch.equal(cpu[0], gpu[0].cpu())
                                             and torch.equal(cpu[1], gpu[1].cpu()))
    print("card == cpu at dim 256:", out["ext product 256 card == cpu"], flush=True)


def _n12_part(steps, out):
    """The n12 ext evolution at the production dt for ``steps`` output steps."""
    import chip_smoke
    from quantumsimulations_tpu_torch.dynamics.expm_propagator import expm_traces_assembled_ext
    from quantumsimulations_tpu_torch.kernels import launch_counts, reset_launch_counts
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    model = build_model(chip_smoke.n12_params(steps))
    timer = StageTimer(device=torch.device("cuda"))
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = expm_traces_assembled_ext(
        model.hamiltonian, model.psi0, chip_smoke.N12_DT * np.arange(steps), model.dims,
        model.n_sea_effective, model.idx_rare, device="cuda", timer=timer)
    wall = time.perf_counter() - t0
    out["n12"] = {"steps": steps, "wall_s": wall, "stages": timer.as_dict(),
                  "launches": dict(launch_counts),
                  "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
                  "max_norm_dev": float(np.abs(rows[6] - 1).max()),
                  "Iz_sea0": float(rows[2, 0])}
    print("n12", json.dumps(out["n12"]), flush=True)


if __name__ == "__main__":
    sys.exit(main())
