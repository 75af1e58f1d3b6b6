"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line as it finishes:

  1. the card's name and power limit (nvidia-smi); exit 1 without CUDA;
  2. build the hand-written kernels from csrc/ with nvcc (build seconds,
     ptxas register and spill report);
  3. each kernel against its plain PyTorch version on the card, at the
     main-path shape and at one large square shape, with CUDA-event timings
     of the kernel, the plain version and one PyTorch library call;
  4. the production sea-detuning sweep (the ``qst-sweep`` CLI defaults:
     n_sea=6, 13 detunings x 3 variants, 30 s, 20,000 steps) through the
     port's CLI with the "eig" solver and plots off, checked against the
     artifact contract, the physics invariants and a host longdouble oracle;
  5. the same sweep with the "eig32" solver, which must launch the f32
     kernel and stay within 2e-4 of phase 4's traces;
  6. a JSON line with every kernel's launches and timings.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero without it.  A watchdog ends the run with exit code 1 after
WATCHDOG_S seconds.  All sweep output goes to temporary directories outside
the repository, which are removed at the end.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

WATCHDOG_S = 600
REPO = os.path.dirname(os.path.abspath(__file__))

#: kernel-vs-plain bound: max |kernel - plain| / max |plain| (float32 sums
#: accumulated in another order; both are IEEE float32, no TF32)
KERNEL_REL_TOL = 1e-5
#: eig32 vs eig on every saved trace (the reference's bar for the f32 mode)
EIG32_ATOL = 2e-4
#: eig traces vs the host longdouble oracle (the reference's 30 s parity bar)
ORACLE_ATOL = 1e-8

#: (float32 FLOP/s without tensor cores, HBM bytes/s) from NVIDIA's data
#: sheets, dense rates at the full power limit
_PEAKS = {
    "H100 SXM": (67e12, 3.35e12),
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
}


def say(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> tuple[str, float, float]:
    if "PCIe" in name:
        key = "H100 PCIe"
    elif "NVL" in name:
        key = "H100 NVL"
    else:
        key = "H100 SXM"
    return (key, *_PEAKS[key])


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_cmatmul(shape, peaks, seed: int) -> dict:
    """Kernel vs plain version at one (B, M, K, N) shape, with timings."""
    import torch

    from quantumsimulations_tpu_torch.ops.cmatmul import cmatmul_f32, cmatmul_f32_plain

    B, M, K, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ar, ai = (torch.randn(B, M, K, generator=gen, device="cuda") for _ in range(2))
    br, bi = (torch.randn(B, K, N, generator=gen, device="cuda") for _ in range(2))
    cr, ci = cmatmul_f32(ar, ai, br, bi)
    pr, pi = cmatmul_f32_plain(ar, ai, br, bi)
    torch.cuda.synchronize()
    abs_err = float(torch.maximum((cr - pr).abs().max(), (ci - pi).abs().max()))
    scale = float(torch.maximum(pr.abs().max(), pi.abs().max()))
    rel_err = abs_err / scale
    if not (rel_err <= KERNEL_REL_TOL):
        raise AssertionError(f"cmatmul_f32 {shape}: rel err {rel_err:.3e} > {KERNEL_REL_TOL:g}")

    a_c, b_c = torch.complex(ar, ai), torch.complex(br, bi)
    ms = cuda_ms(lambda: cmatmul_f32(ar, ai, br, bi))
    plain_ms = cuda_ms(lambda: cmatmul_f32_plain(ar, ai, br, bi))
    library_ms = cuda_ms(lambda: torch.matmul(a_c, b_c))

    _, flops_peak, bytes_peak = peaks
    flops = 8.0 * B * M * K * N
    nbytes = 4.0 * (2 * B * M * K + 2 * B * K * N + 2 * B * M * N)
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bytes_peak * 1e3
    return {
        "shape": [B, M, K, N],
        "max_abs_err": abs_err,
        "max_rel_err": rel_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "gflop": flops / 1e9,
        "mbytes": nbytes / 1e6,
    }


def production_sweep(solver: str, base_dir: str) -> dict:
    """The qst-sweep CLI defaults through the port's CLI.

    Returns the wall seconds and the sweep's own stage split: model build
    and solve from its timings.json, the solve's host eigh and device trace
    seconds from its log line, and the rest (artifact writing)."""
    import torch

    from quantumsimulations_tpu_torch.cli.sweep import main as sweep_main

    log = os.path.join(os.path.dirname(base_dir), f"sweep_{solver}.log")
    t0 = time.perf_counter()
    with open(log, "w", encoding="utf-8") as f, contextlib.redirect_stdout(f):
        out = sweep_main(["--solver", solver, "--no-plots", "--base-dir", base_dir,
                          "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if out != base_dir:
        raise AssertionError(f"sweep wrote to {out}, asked for {base_dir}")
    with open(os.path.join(base_dir, "timings.json"), encoding="utf-8") as f:
        stages = {k: v["seconds"] for k, v in json.load(f).items()}
    with open(log, encoding="utf-8") as f:
        solve = [ln.split() for ln in f if "[solve]" in ln]
    # "[solve] 39 sims (dim 128): eigh 0.05s host, traces 0.41s device"
    stages["eigh"] = sum(float(w[w.index("eigh") + 1].rstrip("s")) for w in solve)
    stages["traces"] = sum(float(w[w.index("traces") + 1].rstrip("s")) for w in solve)
    stages["artifacts_and_rest"] = wall - stages["build_models"] - stages["solve"]
    return {"wall_s": wall, "stages_s": stages}


def _split(run: dict) -> str:
    st = run["stages_s"]
    return "(" + ", ".join(f"{k} {st[k]:.3f} s" for k in
                           ("build_models", "eigh", "traces", "artifacts_and_rest")) + ")"


def load_traces(base_dir: str) -> dict:
    """{(detuning dir, tag): npz arrays} for a finished sweep, checking the tree."""
    import numpy as np

    from quantumsimulations_tpu_torch.artifacts.writer import METRICS_COLUMNS, TAGS

    for name in ("geometry_and_couplings.npz", "global_params.json", "summary.json",
                 "sweep_results.csv", "timings.json"):
        if not os.path.isfile(os.path.join(base_dir, name)):
            raise AssertionError(f"missing {name} in {base_dir}")
    with open(os.path.join(base_dir, "summary.json"), encoding="utf-8") as f:
        rows = json.load(f)["sweep_results"]
    labels = sorted(d for d in os.listdir(base_dir) if d.startswith("delta_"))
    if len(rows) != 13 or len(labels) != 13:
        raise AssertionError(f"expected 13 detunings, got {len(rows)} rows / {len(labels)} dirs")
    for row in rows:
        if set(row) != set(METRICS_COLUMNS):
            raise AssertionError(f"metrics keys differ: {sorted(row)}")
    traces = {}
    for label in labels:
        det = os.path.join(base_dir, label)
        if not os.path.isfile(os.path.join(det, "metrics.json")):
            raise AssertionError(f"missing {label}/metrics.json")
        for tag in TAGS:
            for name in (f"params_{tag}.json", f"freqs_{tag}.json"):
                if not os.path.isfile(os.path.join(det, name)):
                    raise AssertionError(f"missing {label}/{name}")
            with np.load(os.path.join(det, f"time_and_obs_{tag}.npz")) as z:
                traces[(label, tag)] = {k: z[k] for k in z.files}
            tr = traces[(label, tag)]
            if tr["t"].shape != (20_000,) or any(
                tr[k].shape != (20_000,) or not np.isfinite(tr[k]).all() for k in tr
            ):
                raise AssertionError(f"{label}/{tag}: traces not finite of shape (20000,)")
    return traces


def oracle_check(base_dir: str, traces: dict) -> float:
    """Iz_sea of center_off at the first detuning against a host oracle.

    psi(t) = V exp(-i w t) V^dag psi0 with the phase w*t reduced in numpy
    longdouble, at 41 output times spread over the whole 30 s.
    """
    import numpy as np

    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.models.params import DipolarRareParams

    label = sorted(d for d in os.listdir(base_dir) if d.startswith("delta_"))[0]
    with open(os.path.join(base_dir, label, "params_center_off.json"), encoding="utf-8") as f:
        params = DipolarRareParams(**json.load(f))
    model = build_model(params)
    w, V = np.linalg.eigh(model.hamiltonian.to_dense())
    c = V.conj().T @ model.psi0
    tr = traces[(label, "center_off")]
    idx = np.unique(np.linspace(0, len(tr["t"]) - 1, 41).astype(int))
    two_pi = np.longdouble(2) * np.arccos(np.longdouble(-1))
    theta = np.mod(w.astype(np.longdouble)[:, None] * tr["t"][idx].astype(np.longdouble), two_pi)
    psi = V @ (c[:, None] * np.exp(-1j * theta.astype(np.float64)))
    n = len(model.dims)
    basis = np.arange(V.shape[0])
    iz_diag = sum(
        0.5 - ((basis >> (n - 1 - j)) & 1) for j in range(model.n_sea_effective)
    )
    want = iz_diag @ (np.abs(psi) ** 2)
    return float(np.abs(tr["Iz_sea"][idx] - want).max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device",
              file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    import numpy as np

    from quantumsimulations_tpu_torch.kernels import launch_counts, reset_launch_counts
    from quantumsimulations_tpu_torch.kernels._build import build

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    say("[1/6] card (nvidia-smi name, power.limit):")
    say(smi)
    peaks = card_peaks(name)
    say(f"      torch {torch.__version__}, CUDA {torch.version.cuda}, peaks from the "
        f"{peaks[0]} data sheet: {peaks[1] / 1e12:g} TFLOP/s f32, {peaks[2] / 1e12:g} TB/s")

    t0 = time.perf_counter()
    ptxas = build("cmatmul_f32", extra_flags=("-Xptxas", "-v"))
    report = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln]
    say(f"[2/6] built cmatmul_f32 in {time.perf_counter() - t0:.2f} s; ptxas: {' | '.join(report)}")

    main_shape = (39, 128, 128, 1680)
    at_main = check_cmatmul(main_shape, peaks, seed=1)
    at_large = check_cmatmul((1, 2048, 2048, 1024), peaks, seed=2)
    for r in (at_main, at_large):
        say(f"[3/6] cmatmul_f32 {tuple(r['shape'])}: rel err {r['max_rel_err']:.3e} "
            f"(bound {KERNEL_REL_TOL:g}), kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    tmp = tempfile.mkdtemp(prefix="qst_chip_smoke_")
    try:
        dir64, dir32 = os.path.join(tmp, "eig"), os.path.join(tmp, "eig32")

        reset_launch_counts()
        run64 = production_sweep("eig", dir64)
        launches_eig = dict(launch_counts)
        tr64 = load_traces(dir64)
        norm_dev = max(float(np.abs(t["state_norm"] - 1.0).max()) for t in tr64.values())
        if not norm_dev < 1e-12:
            raise AssertionError(f"eig: max |state_norm - 1| = {norm_dev:.3e}")
        iz0 = [t["Iz_sea"][0] for (_, tag), t in tr64.items() if tag == "center_off"]
        if not np.allclose(iz0, -3.0, rtol=0, atol=1e-12):
            raise AssertionError(f"eig: center_off Iz_sea[0] = {iz0}, want -3")
        oracle_err = oracle_check(dir64, tr64)
        if not oracle_err <= ORACLE_ATOL:
            raise AssertionError(f"eig: Iz_sea vs host oracle {oracle_err:.3e} > {ORACLE_ATOL:g}")
        say(f"[4/6] eig sweep (39 sims, dim 128, 20000 steps): {run64['wall_s']:.2f} s wall "
            f"{_split(run64)}; max|norm-1| {norm_dev:.2e}; Iz_sea vs longdouble oracle "
            f"{oracle_err:.2e}; launches {launches_eig}")

        reset_launch_counts()
        run32 = production_sweep("eig32", dir32)
        launches_eig32 = dict(launch_counts)
        if launches_eig32["cmatmul_f32"] <= 0:
            raise AssertionError("eig32 sweep did not launch cmatmul_f32")
        tr32 = load_traces(dir32)
        if tr32.keys() != tr64.keys():
            raise AssertionError("eig32 and eig sweeps wrote different trees")
        diff = max(
            float(np.abs(tr32[key][obs] - tr64[key][obs]).max())
            for key in tr64 for obs in tr64[key] if obs != "t"
        )
        if not diff <= EIG32_ATOL:
            raise AssertionError(f"eig32 vs eig: {diff:.3e} > {EIG32_ATOL:g}")
        say(f"[5/6] eig32 sweep: {run32['wall_s']:.2f} s wall {_split(run32)}; "
            f"max |eig32 - eig| {diff:.2e} "
            f"(bound {EIG32_ATOL:g}); launches {launches_eig32}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernel = {
        "name": "cmatmul_f32",
        "route": "cuda",
        "source": "quantumsimulations_tpu_torch/csrc/cmatmul_f32.cu",
        "replaces": "quantumsimulations_tpu/ops/pallas_kernels.py:30",
        "launches": launches_eig32["cmatmul_f32"],
        "max_abs_err": at_main["max_abs_err"],
        "ms": at_main["ms"],
        "kernel_ms": at_main["ms"],
        "plain_ms": at_main["plain_ms"],
        "bound_ms": at_main["bound_ms"],
        "bound_by": at_main["bound_by"],
        "library_ms": at_main["library_ms"],
        "library_call": "torch.matmul on complex64",
        "shapes": [at_main, at_large],
        "sweeps": {"eig": run64, "eig32": run32},
    }
    say(f"[6/6] total {time.perf_counter() - t_start:.1f} s; kernels:")
    say(json.dumps({"kernels": [kernel]}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
