"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line as it finishes:

  1. the card's name and power limit (nvidia-smi); exit 1 without CUDA;
  2. build the hand-written kernels from csrc/ with nvcc, one nvcc process
     per source, all started together (build seconds, ptxas register and
     spill report);
  3. cmatmul_f32 against its plain PyTorch version on the card, at the eig32
     main-path shape and at one large shape, with device times per call
     (CUDA-graph replay) of the kernel, the plain version and one PyTorch
     library call, the eager call's time, and the kernel's 3xTF32
     tensor-core bound beside the float32 CUDA-core one;
  4. limb_matmul_canon against its plain version, bit for bit (two calls),
     at the four shapes of the n13 extp apply and one large square shape,
     with each launch plan, device times per call of the kernel and of two
     yardsticks (the same 72 limb-pair products as 12 torch._int_mm calls
     without the carry; a float64 matmul of the same shape), the eager
     call's time and the plain version's;
  5. ext_obs_diagonals_int8 against its plain version, bit for bit, at a
     ragged small shape, at (15, 8192, 1024) and at the n12 advance's shape
     (15, 8192, 20480), on random canonical limbs with limb 0 at its full
     range, with CUDA-event timings of the kernel and the plain version;
  6. z_expectations_f32 against its plain version on the card (the plain
     version sums the same float32 products in float64), at the JAX test's
     ragged shape (4 sites, dim 16, T 37, float64), at one eig32 model's
     state block (7, 128, 20000) float32 and at (14, 16384, 2048) float64,
     with CUDA-event timings of the kernel, the plain version and one
     float32 matmul on a precomputed |psi|^2 (the library yardstick);
  7. the production sea-detuning sweep (the ``qst-sweep`` CLI defaults:
     n_sea=6, 13 detunings x 3 variants, 30 s, 20,000 steps) through the
     port's CLI with the "eig" solver and plots off, checked against the
     artifact contract, the physics invariants and a host longdouble oracle;
  8. the same sweep with the "eig32" solver, which must launch the f32
     kernel and stay within 2e-4 of phase 7's traces;
  9. n_sea=13 (dim 16384) at the production output spacing dt = 30/19999 s,
     N13_STEPS output steps, through ``simulate_rare`` ("auto" ->
     "cheb_step", the "f64" tier on cuda), plus a timed run of the same
     tier through ``chebyshev_step_traces`` for its time split;
 10. the same model and times through ``chebyshev_step_traces`` with
     ``arithmetic="extp"``, which must launch limb_matmul_canon six times
     per apply and agree with phase 9 within 1e-11; both tiers are held
     against a host oracle for the first interval (scipy expm_multiply,
     computed in a child process while the card works);
 11. n_sea=12 (dim 8192), the JAX package's n12 workload (bench.py:258):
     N12_STEPS output steps at the production spacing through
     ``simulate_rare`` ("auto" -> "ext"), which must launch
     ext_obs_diagonals_int8, keep the norm within N12_NORM_ATOL and agree within
     1e-10 with ``chebyshev_step_traces`` (f64) over the first 3 output
     steps and with a host expm_multiply oracle at t = dt (child process);
 12. the same n12 workload over its first N12_CHECK_STEPS output steps
     through ``simulate_rare(solver_method="krylov")`` (matrix-free
     Lanczos, ~273 substeps per output step), held against phase 11's f64
     stepper rows and oracle within 1e-10, its norm within KRYLOV_NORM_ATOL;
 13. the n13 workload of phase 9 over CHEB_STEPS output steps of the
     production spacing (~0.03 s, ~70,800 H applies): one global Chebyshev
     sweep (``chebyshev_states``) whose states are assembled into the
     route's rows as ``chebyshev_traces_assembled`` does, held against
     phase 9's f64 rows (first 3 columns) and phase 10's oracle within
     1e-10; then z_expectations_f32 on those states on the card, whose
     sea-site sum and rare row must be within 1e-5 of the route's float64
     Iz_sea and Iz_R, and within KERNEL_REL_TOL of its plain version; and
     the public route ``simulate_rare(solver_method="chebyshev")`` at that
     size, which must give the same rows;
 14. a JSON line with every kernel's launches and timings.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero without it.  A watchdog ends the run with exit code 1 after
WATCHDOG_S seconds.  All sweep output goes to temporary directories outside
the repository, which are removed at the end; the oracle's child process is
joined, or killed with the run.
"""

from __future__ import annotations

import contextlib
import ctypes
import faulthandler
import json
import multiprocessing
import os
import signal
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

WATCHDOG_S = 600
REPO = os.path.dirname(os.path.abspath(__file__))

#: kernel-vs-plain bound: max |kernel - plain| / max |plain| (cmatmul_f32's
#: 3xTF32 products are ~2^-21 relative per term against the plain version's
#: IEEE float32 ones, summed in another order; z_expectations_f32's float32
#: sums against the plain version's float64 sums)
KERNEL_REL_TOL = 1e-5
#: eig32 vs eig on every saved trace (the reference's bar for the f32 mode)
EIG32_ATOL = 2e-4
#: eig traces vs the host longdouble oracle (the reference's 30 s parity bar)
ORACLE_ATOL = 1e-8

#: n13 extp vs f64 rows (the JAX package's bar, tests/test_limb_kernels.py:161)
N13_TIER_ATOL = 1e-11
#: both n13 tiers vs the host expm_multiply oracle at t = dt
N13_ORACLE_ATOL = 1e-10
#: n12 ext vs the f64 stepper over the first N12_CHECK_STEPS output steps,
#: and vs the host expm_multiply oracle at t = dt
N12_ATOL = 1e-10
N12_CHECK_STEPS = 3
#: n12 ext max |state_norm - 1| over the 30 s horizon.  The limb chain's
#: truncation, amplified by 2^(n_sq + log2 block) = 2^25, shows as a norm
#: drift of 1.0373879533176478e-10 in the JAX package's own run of this
#: workload (BENCH_r04.json, bench.py:258); the port's limbs are the same bit
#: for bit, so its drift is held to that record with a factor 2 of room
N12_NORM_ATOL = 2e-10
#: krylov n12 max |state_norm - 1| over N12_CHECK_STEPS output steps: the
#: JAX unit test's 1e-12 (tests/test_steppers.py:68) covers a few dozen
#: substeps; here ~550 substeps each add rounding of order 1e-15
KRYLOV_NORM_ATOL = 1e-11
#: the global Chebyshev sweep at n13: output steps of the production spacing
#: (t_final = 20 dt, ~0.03 s) and its norm bar
CHEB_STEPS = 21
CHEB_NORM_ATOL = 1e-10
#: z_expectations_f32 on the route's states vs its float64 Iz rows (the JAX
#: test's bar, tests/test_pallas_kernels.py:65)
ZEXP_ROUTE_ATOL = 1e-5
#: z_expectations_f32 shapes (n_sites, dim, T, dtype) held against the plain
#: version before the route; the route's own is (14, 16384, CHEB_STEPS) float64
ZEXP_SHAPES = ((4, 16, 37, "float64"), (7, 128, 20_000, "float32"),
               (14, 16384, 2048, "float64"))
#: n13 output steps per tier (each step is one restarted Chebyshev sweep of
#: about 3,600 terms at the production dt)
N13_STEPS = 3
N13_DT = 30.0 / 19_999
#: the n12 ext evolution (bench.py:258): production spacing and horizon
N12_DT = 30.0 / 19_999
N12_STEPS = 20_000
N12_DETUNING_HZ = 1000.0

#: (float32 FLOP/s without tensor cores, dense int8 tensor-core OP/s, HBM
#: bytes/s, dense TF32 tensor-core FLOP/s) from NVIDIA's data sheets, dense
#: rates (half the sheets' sparsity figures) at the full power limit
_PEAKS = {
    "H100 SXM": (67e12, 1979e12, 3.35e12, 495e12),
    "H100 PCIe": (51e12, 1513e12, 2.0e12, 378e12),
    "H100 NVL": (60e12, 1671e12, 3.9e12, 417.5e12),
}
#: int32 operations/s on the CUDA cores (64 INT32 lanes per SM, half the
#: FP32 lanes, a multiply-add counted as two operations as the float32 rate
#: counts an FMA): half the float32 rate above
_INT32_SHARE_OF_F32 = 0.5


def say(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> tuple[str, float, float, float, float]:
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


def graph_ms(fn, n: int = 10, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``n`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times under CUDA events, the median
    divided by ``n``.  Unlike :func:`cuda_ms` it leaves out the host's work
    before each launch, which exceeds a small kernel's own time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    ms = cuda_ms(graph.replay, reps=reps, warmup=1) / n
    del graph
    return ms


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
    # device times of one call (graph replay), kernel and library alike; the
    # eager call time adds the wrapper's host work before the launch
    ms = graph_ms(lambda: cmatmul_f32(ar, ai, br, bi))
    plain_ms = graph_ms(lambda: cmatmul_f32_plain(ar, ai, br, bi))
    library_ms = graph_ms(lambda: torch.matmul(a_c, b_c))
    call_ms = cuda_ms(lambda: cmatmul_f32(ar, ai, br, bi))

    _, f32_peak, _, bytes_peak, tf32_peak = peaks
    flops = 8.0 * B * M * K * N
    nbytes = 4.0 * (2 * B * M * K + 2 * B * K * N + 2 * B * M * N)
    # the kernel's work: three TF32 products (hi*hi, hi*lo, lo*hi) per real
    # product on the tensor cores
    t_ops, t_bytes = 3 * flops / tf32_peak * 1e3, nbytes / bytes_peak * 1e3
    return {
        "shape": [B, M, K, N],
        "max_abs_err": abs_err,
        "max_rel_err": rel_err,
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "f32_core_bound_ms": max(flops / f32_peak * 1e3, t_bytes),
        "gflop": flops / 1e9,
        "tf32_gflop": 3 * flops / 1e9,
        "mbytes": nbytes / 1e6,
    }


#: the n13 extp apply's four products (A, B shapes), and one large square
LIMB_SHAPES = {
    "HL": ((10, 256, 128), (10, 128, 256), {}),
    "cross stage 1": ((10, 1792, 128), (10, 128, 128), {"tm": 128, "transpose_out": True}),
    "cross stage 2": ((10, 128, 1792), (10, 1792, 128), {}),
    "R": ((10, 256, 128), (10, 128, 256), {}),
    "square 2048": ((10, 2048, 2048), (10, 2048, 2048), {}),
}
#: launches of each main-path shape in one extp apply
LIMB_PER_APPLY = {"HL": 1, "cross stage 1": 2, "cross stage 2": 2, "R": 1}

#: ext_obs_diagonals_int8 shapes (L, dim, T): a ragged small one, a (dim
#: 8192) check, and the n12 advance's one launch (40 blocks of 512 columns);
#: the last one is the main path's, reported in the kernels line
EXT_OBS_SHAPES = ((15, 64, 200), (15, 8192, 1024), (15, 8192, 40 * 512))


def random_limbs(shape, gen):
    """Random canonical-range int8 limbs, negative values included: limb 0
    in [-64, 64], the others in [-32, 32]."""
    import torch

    x = torch.randint(-32, 33, shape, generator=gen, device="cuda", dtype=torch.int32)
    x[0] = torch.randint(-64, 65, shape[1:], generator=gen, device="cuda", dtype=torch.int32)
    return x.to(torch.int8).contiguous()


def int_mm_digits(a, b):
    """The same 72 limb-pair products as 12 ``torch._int_mm`` calls (the
    pairs of digit s side by side along K, both operands K-contiguous), no
    carry: a yardstick of what cuBLASLt's int8 path gives for the products,
    not the same function."""
    import torch

    L, M, K = a.shape
    N = b.shape[2]
    ops = []
    for s in range(L + 2):
        j0, j1 = max(0, s - L + 1), min(s + 1, L)
        a_s = a[j0:j1].permute(1, 0, 2).reshape(M, (j1 - j0) * K).contiguous()
        b_t = b[s - j1 + 1: s - j0 + 1].flip(0).permute(2, 0, 1).reshape(N, (j1 - j0) * K).contiguous()
        ops.append((a_s, b_t))
    return lambda: [torch._int_mm(x, y.t()) for x, y in ops]


def check_limb(name, peaks, seed: int) -> dict:
    """limb_matmul_canon vs its plain version at one shape (two calls, both
    bit for bit), with timings, its launch plan and the yardsticks."""
    import torch

    from quantumsimulations_tpu_torch.ops.limb_kernels import (
        limb_launch_plan,
        limb_matmul_canon,
        limb_matmul_canon_plain,
        live_pairs,
    )

    a_shape, b_shape, kw = LIMB_SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a, b = random_limbs(a_shape, gen), random_limbs(b_shape, gen)
    out = limb_matmul_canon(a, b, bits=6, **kw)
    again = limb_matmul_canon(a, b, bits=6, **kw)
    ref = limb_matmul_canon_plain(a, b, 6, **kw)
    torch.cuda.synchronize()
    n_diff = int((out != ref).sum())
    if not torch.equal(out, ref):
        raise AssertionError(f"limb_matmul_canon {name}: {n_diff} limbs differ from the plain version")
    if not torch.equal(out, again):
        raise AssertionError(f"limb_matmul_canon {name}: two calls on the same inputs differ")
    max_abs_err = float((out.to(torch.int32) - ref.to(torch.int32)).abs().max())

    L, M, K = a_shape
    N = b_shape[2]
    plan = limb_launch_plan(M, K, N, torch.cuda.get_device_properties(0).multi_processor_count)
    af, bf = a[0].double(), b[0].double()
    ms = graph_ms(lambda: limb_matmul_canon(a, b, bits=6, **kw))
    call_ms = cuda_ms(lambda: limb_matmul_canon(a, b, bits=6, **kw))
    plain_ms = cuda_ms(lambda: limb_matmul_canon_plain(a, b, 6, **kw), reps=5)
    f64_ms = graph_ms(lambda: torch.matmul(af, bf))
    int_mm_ms = graph_ms(int_mm_digits(a, b))

    _, _, int8_peak, bytes_peak, _ = peaks
    ops = 2.0 * live_pairs(L) * M * N * K
    nbytes = float(L * (M * K + K * N + M * N))
    t_ops, t_bytes = ops / int8_peak * 1e3, nbytes / bytes_peak * 1e3
    return {
        "shape": [list(a_shape), list(b_shape)],
        "transpose_out": bool(kw.get("transpose_out", False)),
        "plan": {"tile": [plan.tile_m, plan.tile_n], "ksplit": plan.ksplit,
                 "kslice": plan.kslice, "blocks": plan.blocks},
        "max_abs_err": max_abs_err,
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "library_ms": None,
        "f64_matmul_ms": f64_ms,
        "int_mm_digits_ms": int_mm_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "gop": ops / 1e9,
        "mbytes": nbytes / 1e6,
    }


def production_params(n_sea: int, delta_Hz: float, dt: float, T: int):
    """bench._params_production(n_sea, delta_Hz, True, True, dt*(T-1), T) of
    the JAX package, built in the port: n_sea sea spins + the rare spin at
    the center, both driven, rare on Hartmann-Hahn."""
    import numpy as np

    from quantumsimulations_tpu_torch.analysis.metrics import f1R_for_resonance
    from quantumsimulations_tpu_torch.models.params import DipolarRareParams

    gamma_sea, gamma_rare, B0, f1A = 8.1812e7, 6.976e7, 3.0, 50_000.0
    f_Az = gamma_sea * B0 / (2 * np.pi)
    f1R = f1R_for_resonance(f1A, f1A, 0.0)
    return DipolarRareParams(
        n_sea=n_sea, gamma_sea=gamma_sea, gamma_rare=gamma_rare, B0_sea=B0, B0_rare=B0,
        B1_sea=2 * np.pi * f1A / gamma_sea, B1_rare=2 * np.pi * f1R / gamma_rare,
        omega_rf_sea=2 * np.pi * (f_Az - delta_Hz), omega_rf_rare=gamma_rare * B0,
        phi_sea=np.pi / 2, phi_rare=np.pi / 2, dipolar_scale=1e-7 * 1.054571817e-34,
        shell_scale=0.282393e-9, t_final=dt * (T - 1), steps=T, drive_sea=True,
        drive_rare=True, is_spin_three_half=False, is_center_rare=True,
    )


def n13_params(T: int):
    """The n13 workload (bench.py:316-376) at zero sea detuning."""
    return production_params(13, 0.0, N13_DT, T)


def n12_params(T: int):
    """The n12 workload (bench.py:258, its measured evolution at 1 kHz sea
    detuning) over T output steps of the production spacing."""
    return production_params(12, N12_DETUNING_HZ, N12_DT, T)


def host_site_observables(psi, dims, n_sea_effective: int, idx_rare: int):
    """The seven observable rows of one state, in numpy, from each site's
    reduced density matrix (independent of the port's observables code)."""
    import numpy as np

    from quantumsimulations_tpu_torch.ops.spin import spin_matrix

    xyz = []
    for j, d in enumerate(dims):
        dl, dr = int(np.prod(dims[:j])), int(np.prod(dims[j + 1:]))
        p = psi.reshape(dl, d, dr)
        rho = np.einsum("adb,aeb->de", p, p.conj())
        s = (d - 1) / 2.0
        xyz.append([float(np.real(np.trace(rho @ spin_matrix(s, w)))) for w in "xyz"])
    xyz = np.asarray(xyz)
    sea = xyz[:n_sea_effective].sum(axis=0)
    rare = xyz[idx_rare]
    return np.array([sea[0], sea[1], sea[2], rare[2], rare[0], rare[1], np.linalg.norm(psi)])


def _die_with_parent() -> None:
    """Ask Linux to send this process SIGTERM when its parent ends, so the
    oracle child cannot outlive a run cut by the watchdog."""
    with contextlib.suppress(Exception):
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG


def oracle_first_interval(conn, n_sea: int) -> None:
    """Child process: psi(dt) = expm_multiply(-i H dt, psi0) on the CSR of
    to_coo for the n13 or n12 workload, and its seven observable rows;
    sends (rows, seconds) or an error."""
    _die_with_parent()
    try:
        sys.path.insert(0, REPO)
        import numpy as np
        import scipy.sparse as sparse
        from scipy.sparse.linalg import expm_multiply

        from quantumsimulations_tpu_torch.models.dipolar import build_model

        t0 = time.perf_counter()
        params, dt = (n13_params(N13_STEPS), N13_DT) if n_sea == 13 else (n12_params(3), N12_DT)
        model = build_model(params)
        dim = int(np.prod(model.dims))
        r, c, v = model.hamiltonian.to_coo()
        Hs = sparse.csr_matrix((v, (r, c)), shape=(dim, dim))
        psi = expm_multiply(-1j * dt * Hs, model.psi0.astype(np.complex128))
        rows = host_site_observables(psi, model.dims, model.n_sea_effective, model.idx_rare)
        conn.send(("ok", rows, time.perf_counter() - t0, int(Hs.nnz)))
    except Exception as exc:  # reported and raised by the parent
        conn.send(("error", repr(exc), 0.0, 0))
    finally:
        conn.close()


def start_oracle(ctx, n_sea: int):
    """Start :func:`oracle_first_interval` in a child; returns (process, pipe end)."""
    rx, tx = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=oracle_first_interval, args=(tx, n_sea), daemon=True)
    proc.start()
    tx.close()
    return proc, rx


def oracle_result(proc, rx, name: str):
    """(rows, seconds, nnz) from an oracle child, or raise."""
    if not rx.poll(WATCHDOG_S):
        raise AssertionError(f"{name} oracle sent nothing")
    status, rows, sec, nnz = rx.recv()
    proc.join(timeout=60)
    if status != "ok":
        raise AssertionError(f"{name} oracle failed: {rows}")
    return rows, sec, nnz


def check_ext_obs(shape, peaks, seed: int, reps: int = 10, plain_reps: int = 3) -> dict:
    """ext_obs_diagonals_int8 vs its plain version at one (L, dim, T) shape,
    bit for bit, with timings and the bound."""
    import torch

    from quantumsimulations_tpu_torch.dynamics.expm_propagator import _EXT_OBS_Q, _EXT_PAIRS
    from quantumsimulations_tpu_torch.ops.ext_obs import (
        ext_obs_diagonals_int8,
        ext_obs_diagonals_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def limbs():
        """Random canonical limbs, negative values included: limb 0 over its
        full range [-33, 33], the others in [-16, 16]."""
        x = torch.randint(-16, 17, shape, generator=gen, device="cuda", dtype=torch.int32)
        x[0] = torch.randint(-33, 34, shape[1:], generator=gen, device="cuda", dtype=torch.int32)
        x[0, 0, 0], x[0, -1, -1] = 33, -33
        return x.to(torch.int8).contiguous()

    jj, ii, _ = _EXT_PAIRS
    S_re, S_im = limbs(), limbs()
    out = ext_obs_diagonals_int8(S_re, S_im, jj, ii, _EXT_OBS_Q)
    ref = ext_obs_diagonals_plain(S_re, S_im, jj, ii, _EXT_OBS_Q)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"ext_obs_diagonals_int8 {shape}: {int((out != ref).sum())} sums "
                             "differ from the plain version")
    max_abs_err = float((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
    ms = cuda_ms(lambda: ext_obs_diagonals_int8(S_re, S_im, jj, ii, _EXT_OBS_Q), reps=reps)
    plain_ms = cuda_ms(lambda: ext_obs_diagonals_plain(S_re, S_im, jj, ii, _EXT_OBS_Q),
                       reps=plain_reps, warmup=1)

    L, dim, T = shape
    n = dim.bit_length() - 1
    P, R = len(jj), out.shape[1]
    # operations the function needs per pair and column: prod = Rj*Ri + Ij*Ii
    # on every row (2 multiply-adds), its norm and per-site z sums (1 + n
    # adds per row), x and y over the dim/2 level pairs of each site (4
    # multiply-adds per level pair); a multiply-add is two operations
    ops = float(P) * T * dim * (4 + 1 + n + 4 * n)
    nbytes = 2.0 * _EXT_OBS_Q * dim * T + 4.0 * _EXT_OBS_Q * R * T
    int32_peak = peaks[1] * _INT32_SHARE_OF_F32
    t_ops, t_bytes = ops / int32_peak * 1e3, nbytes / peaks[3] * 1e3
    return {
        "shape": list(shape),
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "gop": ops / 1e9,
        "cost_estimate_gop": float(P) * dim * T * (6 + 10 * n) / 1e9,
        "mbytes": nbytes / 1e6,
    }


def zexp_bound(n: int, dim: int, T: int, itemsize: int, peaks) -> tuple[float, str]:
    """Least time of z_expectations_f32 at one shape: both planes read once,
    the sign table read once, the output written once, over the HBM rate;
    (2n + 3) float32 operations per (d, t) (the square sum and n
    multiply-adds) over the float32 rate without tensor cores."""
    nbytes = 2.0 * dim * T * itemsize + 4.0 * n * dim + 4.0 * n * T
    ops = (2.0 * n + 3.0) * dim * T
    t_ops, t_bytes = ops / peaks[1] * 1e3, nbytes / peaks[3] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_zexp(re, im, signs, peaks) -> dict:
    """Kernel vs plain version on the card for one block of states: errors,
    CUDA-event timings of the kernel, the plain version and the library
    yardstick (one float32 matmul on a precomputed |psi|^2, which leaves out
    the square sum), and the bound."""
    import torch

    from quantumsimulations_tpu_torch.ops.zexp import z_expectations_f32, z_expectations_f32_plain

    got = z_expectations_f32(re, im, signs)
    want = z_expectations_f32_plain(re, im, signs)
    s32 = signs.to(torch.float32)
    p2 = (re * re + im * im).to(torch.float32)
    lib = torch.matmul(s32, p2)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / scale
    n, (dim, T) = signs.shape[0], re.shape
    bound_ms, bound_by = zexp_bound(n, dim, T, re.element_size(), peaks)
    return {
        "shape": [n, dim, T, str(re.dtype).replace("torch.", "")],
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "library_rel_err": float((lib - want).abs().max()) / scale,
        "ms": cuda_ms(lambda: z_expectations_f32(re, im, signs)),
        "plain_ms": cuda_ms(lambda: z_expectations_f32_plain(re, im, signs)),
        "library_ms": cuda_ms(lambda: torch.matmul(s32, p2)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_zexp(shape, peaks, seed: int) -> dict:
    """z_expectations_f32 vs its plain version at one (n, dim, T, dtype)
    shape, on random planes."""
    import torch

    from quantumsimulations_tpu_torch.ops.zexp import z_sign_table

    n, dim, T, dtype = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    re, im = (torch.randn(dim, T, generator=gen, device="cuda", dtype=getattr(torch, dtype))
              for _ in range(2))
    dims = (2,) * (n - 1) + (dim >> (n - 1),)
    signs = torch.as_tensor(z_sign_table(dims), device="cuda")
    r = time_zexp(re, im, signs, peaks)
    if not r["max_rel_err"] <= KERNEL_REL_TOL:
        raise AssertionError(f"z_expectations_f32 {shape}: rel err {r['max_rel_err']:.3e} > "
                             f"{KERNEL_REL_TOL:g}")
    return r


def n12_krylov(n12: dict) -> dict:
    """The n12 workload over its first N12_CHECK_STEPS output steps through
    ``simulate_rare(solver_method="krylov")``, held against phase 11's f64
    stepper rows and oracle."""
    import dataclasses

    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.dynamics.eig_propagator import TRACE_ROWS
    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
    from quantumsimulations_tpu_torch.dynamics.krylov import (
        KRYLOV_M,
        KRYLOV_THETA,
        spectral_norm_bound,
        spectral_norm_estimate,
    )
    from quantumsimulations_tpu_torch.kernels import launch_counts, reset_launch_counts
    from quantumsimulations_tpu_torch.models.dipolar import build_model

    T = N12_CHECK_STEPS
    params = dataclasses.replace(n12_params(T), solver_method="krylov")
    reset_launch_counts()
    t0 = time.perf_counter()
    t, named = simulate_rare(params, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    rows = np.stack([named[k] for k in TRACE_ROWS[:7]])
    if rows.shape != (7, T) or not np.isfinite(rows).all():
        raise AssertionError(f"n12 krylov: rows not finite of shape (7, {T}): {rows.shape}")
    if not np.allclose(np.diff(t), N12_DT, rtol=1e-9, atol=0.0):
        raise AssertionError("n12 krylov: simulate_rare ran another time grid")
    norm_dev = float(np.abs(rows[6] - 1.0).max())
    if not norm_dev < KRYLOV_NORM_ATOL:
        raise AssertionError(f"n12 krylov: max |norm - 1| = {norm_dev!r} >= {KRYLOV_NORM_ATOL:g}")
    if abs(rows[2, 0] - (-6.0)) > 1e-12:
        raise AssertionError(f"n12 krylov: Iz_sea[0] = {rows[2, 0]!r}, want -6")
    vs_cheb = float(np.abs(rows - n12["rows_ref"]).max())
    vs_oracle = float(np.abs(rows[:, 1] - n12["oracle_rows"]).max())
    if not max(vs_cheb, vs_oracle) <= N12_ATOL:
        raise AssertionError(f"n12 krylov vs cheb_step f64 {vs_cheb:.3e}, vs oracle at t=dt "
                             f"{vs_oracle:.3e} (bound {N12_ATOL:g})")
    # the route's substep count, from the same norm bound it takes
    H = build_model(params).hamiltonian
    nb = min(spectral_norm_bound(H), spectral_norm_estimate(H, device="cuda"))
    n_sub = max(1, int(np.ceil(nb * N12_DT / KRYLOV_THETA)))
    substeps = n_sub * (T - 1)  # no step after the last output row
    return {"wall_s": wall, "launches": launches, "norm_bound": nb, "n_sub": n_sub,
            "substeps": substeps, "s_per_substep": wall / substeps,
            "applies_per_s": substeps * KRYLOV_M / wall, "norm_dev": norm_dev,
            "iz0": float(rows[2, 0]), "vs_cheb_step": vs_cheb, "vs_oracle": vs_oracle}


def n13_chebyshev(f64_rows, oracle_rows, peaks) -> dict:
    """The n13 workload over CHEB_STEPS output steps: one global Chebyshev
    sweep assembled into the route's rows, z_expectations_f32 on its states,
    and the public route through ``simulate_rare``."""
    import dataclasses

    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.dynamics.chebyshev import (
        chebyshev_coefficients,
        chebyshev_states,
        rows_from_states,
    )
    from quantumsimulations_tpu_torch.dynamics.eig_propagator import TRACE_ROWS
    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
    from quantumsimulations_tpu_torch.dynamics.krylov import spectral_norm_bound
    from quantumsimulations_tpu_torch.kernels import launch_counts, reset_launch_counts
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.ops.zexp import z_expectations_f32, z_sign_table

    T = CHEB_STEPS
    params = n13_params(T)
    model = build_model(params)
    times = np.linspace(0.0, N13_DT * (T - 1), T)
    lam = spectral_norm_bound(model.hamiltonian)
    K = chebyshev_coefficients(lam, times).shape[1]

    reset_launch_counts()
    t0 = time.perf_counter()
    states = chebyshev_states(model.hamiltonian, model.psi0, times, device="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    rows = rows_from_states(model.hamiltonian, model.psi0, states, model.dims,
                            model.n_sea_effective, model.idx_rare, device="cuda")
    if rows.shape != (8, T) or not np.isfinite(rows).all():
        raise AssertionError(f"n13 chebyshev: rows not finite of shape (8, {T}): {rows.shape}")
    norm_dev = float(np.abs(rows[6] - 1.0).max())
    if not norm_dev < CHEB_NORM_ATOL:
        raise AssertionError(f"n13 chebyshev: max |norm - 1| = {norm_dev!r} >= {CHEB_NORM_ATOL:g}")
    if abs(rows[2, 0] - (-6.5)) > 1e-12:
        raise AssertionError(f"n13 chebyshev: Iz_sea[0] = {rows[2, 0]!r}, want -6.5")
    n_ref = f64_rows.shape[1]
    vs_f64 = float(np.abs(rows[:7, :n_ref] - f64_rows[:7]).max())
    vs_oracle = float(np.abs(rows[:7, 1] - oracle_rows).max())
    if not max(vs_f64, vs_oracle) <= N13_ORACLE_ATOL:
        raise AssertionError(f"n13 chebyshev vs cheb_step f64 {vs_f64:.3e}, vs oracle at t=dt "
                             f"{vs_oracle:.3e} (bound {N13_ORACLE_ATOL:g})")

    # kernel 4 on the route's states, on the card
    S = torch.as_tensor(states, device="cuda").T
    re, im = S.real.contiguous(), S.imag.contiguous()
    signs = torch.as_tensor(z_sign_table(model.dims), device="cuda")
    z = z_expectations_f32(re, im, signs)
    torch.cuda.synchronize()
    launches = dict(launch_counts)
    if launches["z_expectations_f32"] <= 0:
        raise AssertionError(f"n13 chebyshev: z_expectations_f32 was not launched: {launches}")
    z = z.double().cpu().numpy()
    vs_rows = max(float(np.abs(z[: model.n_sea_effective].sum(axis=0) - rows[2]).max()),
                  float(np.abs(z[model.idx_rare] - rows[3]).max()))
    if not vs_rows <= ZEXP_ROUTE_ATOL:
        raise AssertionError(f"z_expectations_f32 vs the route's float64 Iz rows: {vs_rows:.3e} > "
                             f"{ZEXP_ROUTE_ATOL:g}")
    at_path = time_zexp(re, im, signs, peaks)
    if not at_path["max_rel_err"] <= KERNEL_REL_TOL:
        raise AssertionError(f"z_expectations_f32 on the route's states: rel err "
                             f"{at_path['max_rel_err']:.3e} > {KERNEL_REL_TOL:g}")

    # the public route at the same size
    t0 = time.perf_counter()
    t_sim, named = simulate_rare(dataclasses.replace(params, solver_method="chebyshev"),
                                 device="cuda")
    torch.cuda.synchronize()
    sim_wall = time.perf_counter() - t0
    sim_rows = np.stack([named[k] for k in TRACE_ROWS[:7]])
    if not np.array_equal(t_sim, times):
        raise AssertionError("n13 chebyshev: simulate_rare ran another time grid")
    sim_vs = float(np.abs(sim_rows - rows[:7]).max())
    if not sim_vs <= 1e-13:
        raise AssertionError(f"n13 chebyshev: simulate_rare vs the sweep's rows {sim_vs:.3e}")
    return {"lambda": lam, "K": K, "sweep_s": sweep_s, "s_per_apply": sweep_s / K,
            "applies_per_s": K / sweep_s, "simulate_rare_wall_s": sim_wall,
            "launches": launches, "norm_dev": norm_dev, "iz0": float(rows[2, 0]),
            "vs_cheb_step": vs_f64, "vs_oracle": vs_oracle, "zexp_vs_rows": vs_rows,
            "simulate_rare_vs_sweep": sim_vs, "zexp": at_path}


def n13_tier(model, arith: str, lam: float, T: int) -> dict:
    """One timed run of chebyshev_step_traces at n13; returns rows, the
    stage split and the launch counts of that run."""
    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.dynamics.cheb_step import chebyshev_step_traces
    from quantumsimulations_tpu_torch.kernels import launch_counts, reset_launch_counts
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer(device=torch.device("cuda"))
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = chebyshev_step_traces(
        model.hamiltonian, model.psi0, N13_DT * np.arange(T), model.dims,
        model.n_sea_effective, model.idx_rare, norm_bound=lam, arithmetic=arith,
        device="cuda", timer=timer,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    return {"rows": rows, "wall_s": wall, "launches": launches,
            "stages_s": {k: v["seconds"] for k, v in timer.as_dict().items()}}


def check_n13_rows(rows, T: int, name: str) -> float:
    """Physics invariants of an n13 row block; returns max |norm - 1|."""
    import numpy as np

    if rows.shape != (8, T) or not np.isfinite(rows).all():
        raise AssertionError(f"n13 {name}: rows not finite of shape (8, {T}): {rows.shape}")
    norm_dev = float(np.abs(rows[6] - 1.0).max())
    if not norm_dev < 1e-12:
        raise AssertionError(f"n13 {name}: max |norm - 1| = {norm_dev:.3e}")
    if abs(rows[2, 0] - (-6.5)) > 1e-12:
        raise AssertionError(f"n13 {name}: Iz_sea[0] = {rows[2, 0]!r}, want -n_sea_effective/2 = -6.5")
    if not np.all(rows[7] == rows[7, 0]):
        raise AssertionError(f"n13 {name}: energy row not constant: {rows[7]}")
    return norm_dev


def n12_ext(oracle) -> dict:
    """The n12 workload through ``simulate_rare`` ("auto" -> "ext") with its
    launches and stage split, held against the f64 Chebyshev stepper over
    the first N12_CHECK_STEPS output steps and against the host oracle at
    t = dt."""
    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.dynamics.cheb_step import chebyshev_step_traces
    from quantumsimulations_tpu_torch.dynamics.eig_propagator import TRACE_ROWS
    from quantumsimulations_tpu_torch.dynamics.evolve import _auto_method, simulate_rare
    from quantumsimulations_tpu_torch.kernels import launch_counts, reset_launch_counts
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.ops.extprec import EXT_GUARD, EXT_LIMBS, _ext_pairs
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    params = n12_params(N12_STEPS)
    model = build_model(params)
    dim = int(np.prod(model.dims))
    if _auto_method(dim) != "ext":
        raise AssertionError(f"n12: auto picks {_auto_method(dim)!r} at dim {dim}, not 'ext'")
    timer = StageTimer(device=torch.device("cuda"))
    reset_launch_counts()
    t0 = time.perf_counter()
    t, named = simulate_rare(params, device="cuda", timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    if launches["ext_obs_diagonals_int8"] <= 0:
        raise AssertionError(f"n12: ext_obs_diagonals_int8 was not launched: {launches}")
    if "squarings" not in timer.stages:
        raise AssertionError(f"n12: simulate_rare did not take the ext route: {timer.stages}")
    rows = np.stack([named[k] for k in TRACE_ROWS[:7]])
    if rows.shape != (7, N12_STEPS) or not np.isfinite(rows).all():
        raise AssertionError(f"n12: rows not finite of shape (7, {N12_STEPS}): {rows.shape}")
    if not np.allclose(np.diff(t), N12_DT, rtol=1e-9, atol=0.0):
        raise AssertionError("n12: simulate_rare ran another time grid")
    norm_dev = float(np.abs(rows[6] - 1.0).max())
    if not norm_dev < N12_NORM_ATOL:
        raise AssertionError(f"n12: max |norm - 1| = {norm_dev:.3e} >= {N12_NORM_ATOL:g}")
    if abs(rows[2, 0] - (-6.0)) > 1e-12:
        raise AssertionError(f"n12: Iz_sea[0] = {rows[2, 0]!r}, want -n_sea/2 = -6")
    ref = chebyshev_step_traces(
        model.hamiltonian, model.psi0, t[:N12_CHECK_STEPS], model.dims, model.n_sea_effective,
        model.idx_rare, arithmetic="f64", device="cuda")
    vs_cheb = float(np.abs(rows[:, :N12_CHECK_STEPS] - ref[:7]).max())
    if not vs_cheb <= N12_ATOL:
        raise AssertionError(f"n12 ext vs cheb_step f64: {vs_cheb:.3e} > {N12_ATOL:g}")
    o_rows, o_sec, _ = oracle_result(*oracle, "n12")
    vs_oracle = float(np.abs(rows[:, 1] - o_rows).max())
    if not vs_oracle <= N12_ATOL:
        raise AssertionError(f"n12 ext vs expm_multiply oracle at t=dt: {vs_oracle:.3e} > {N12_ATOL:g}")
    stages = timer.as_dict()
    n_sq = stages["squarings"]["calls"]
    # int8 GEMM operations of one (dim)^3 ext product: 3 Karatsuba GEMMs per
    # limb pair, over the int8 tensor-core rate
    pairs = len(_ext_pairs(EXT_LIMBS)[0])
    product_ops = 3 * 2.0 * pairs * float(dim) ** 3
    return {
        "wall_s": wall, "stages_s": {k: v["seconds"] for k, v in stages.items()},
        "stage_calls": {k: v["calls"] for k, v in stages.items()},
        "launches": launches, "n_sq": n_sq,
        "products": stages["horner"]["calls"] + n_sq + stages["doubling"]["calls"],
        "s_per_product": stages["squarings"]["seconds"] / max(n_sq, 1),
        "product_bound_s": product_ops / card_peaks(torch.cuda.get_device_name(0))[2],
        "limb_pairs": pairs, "guard": EXT_GUARD,
        "norm_dev": norm_dev, "iz0": float(rows[2, 0]), "vs_cheb_step": vs_cheb,
        "vs_oracle": vs_oracle, "oracle_s": o_sec,
        "rows_ref": ref[:7], "oracle_rows": o_rows,
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

    from quantumsimulations_tpu_torch.dynamics.cheb_step import _lambda_bound
    from quantumsimulations_tpu_torch.dynamics.chebyshev import chebyshev_coefficients
    from quantumsimulations_tpu_torch.dynamics.eig_propagator import TRACE_ROWS
    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
    from quantumsimulations_tpu_torch.kernels import launch_counts, reset_launch_counts
    from quantumsimulations_tpu_torch.kernels._build import build_all
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.ops.split_apply import split_operator

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    say("[1/14] card (nvidia-smi name, power.limit):")
    say(smi)
    peaks = card_peaks(name)
    say(f"      torch {torch.__version__}, CUDA {torch.version.cuda}, peaks from the "
        f"{peaks[0]} data sheet: {peaks[1] / 1e12:g} TFLOP/s f32, {peaks[4] / 1e12:g} TFLOP/s "
        f"TF32 (dense), {peaks[2] / 1e12:g} TOP/s int8 (dense), {peaks[3] / 1e12:g} TB/s")

    t0 = time.perf_counter()
    built = build_all(extra_flags=("-Xptxas", "-v"))
    for kname, (out, sec) in built.items():
        report = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        say(f"[2/14] built {kname} in {sec:.2f} s; ptxas: {' | '.join(report)}")
    say(f"      all {len(built)} builds (in parallel): {time.perf_counter() - t0:.2f} s")

    main_shape = (39, 128, 128, 1680)
    at_main = check_cmatmul(main_shape, peaks, seed=1)
    at_large = check_cmatmul((1, 2048, 2048, 1024), peaks, seed=2)
    for r in (at_main, at_large):
        say(f"[3/14] cmatmul_f32 {tuple(r['shape'])}: rel err {r['max_rel_err']:.3e} "
            f"(bound {KERNEL_REL_TOL:g}), device ms per call: kernel {r['ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, library (complex64 matmul) {r['library_ms']:.4f}; eager call "
            f"{r['call_ms']:.4f} ms; 3xTF32 bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['tf32_gflop']:.1f} GFLOP), float32 CUDA-core bound {r['f32_core_bound_ms']:.4f} ms")

    limb = {}
    for i, lname in enumerate(LIMB_SHAPES):
        r = limb[lname] = check_limb(lname, peaks, seed=10 + i)
        say(f"[4/14] limb_matmul_canon {lname} {r['shape'][0]}@{r['shape'][1]}"
            f"{' transpose_out' if r['transpose_out'] else ''}: equal to plain bit for bit (two "
            f"calls), plan {r['plan']}; device ms per call: kernel {r['ms']:.4f}, 12 "
            f"torch._int_mm digit products (no carry) {r['int_mm_digits_ms']:.4f}, f64 matmul of "
            f"the same shape {r['f64_matmul_ms']:.4f}; eager call {r['call_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    per_apply = {key: sum(n * limb[s][key] for s, n in LIMB_PER_APPLY.items())
                 for key in ("ms", "call_ms", "plain_ms", "f64_matmul_ms", "int_mm_digits_ms",
                             "bound_ms")}
    say(f"      one extp apply (6 launches): kernel {per_apply['ms']:.4f} ms device "
        f"({per_apply['call_ms']:.4f} ms as eager calls), plain {per_apply['plain_ms']:.4f} ms, "
        f"_int_mm digits {per_apply['int_mm_digits_ms']:.4f} ms, f64 matmuls "
        f"{per_apply['f64_matmul_ms']:.4f} ms, bound {per_apply['bound_ms']:.5f} ms")

    # the n13 and n12 oracles run on the host in child processes while the
    # card works
    ctx = multiprocessing.get_context("spawn")
    oracles = {n: start_oracle(ctx, n) for n in (13, 12)}

    obs = {}
    for i, shape in enumerate(EXT_OBS_SHAPES):
        big = shape[2] > 4096
        r = obs[shape] = check_ext_obs(shape, peaks, seed=20 + i, reps=3 if big else 10,
                                       plain_reps=1 if big else 3)
        say(f"[5/14] ext_obs_diagonals_int8 {shape}: equal to plain bit for bit, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['gop']:.1f} G int32 operations, the JAX cost estimate "
            f"counts {r['cost_estimate_gop']:.1f} G)")
    at_path = obs[EXT_OBS_SHAPES[-1]]

    zexp = {}
    for i, zshape in enumerate(ZEXP_SHAPES):
        r = zexp[zshape] = check_zexp(zshape, peaks, seed=30 + i)
        say(f"[6/14] z_expectations_f32 {zshape}: rel err {r['max_rel_err']:.3e} (bound "
            f"{KERNEL_REL_TOL:g}; float32 matmul {r['library_rel_err']:.3e}), kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")

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
        say(f"[7/14] eig sweep (39 sims, dim 128, 20000 steps): {run64['wall_s']:.2f} s wall "
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
        say(f"[8/14] eig32 sweep: {run32['wall_s']:.2f} s wall {_split(run32)}; "
            f"max |eig32 - eig| {diff:.2e} "
            f"(bound {EIG32_ATOL:g}); launches {launches_eig32}")

        # ---- n13, the default tier through the user entry point ----
        T = N13_STEPS
        params = n13_params(T)
        reset_launch_counts()
        t0 = time.perf_counter()
        t_sim, named = simulate_rare(params, device="cuda")
        torch.cuda.synchronize()
        sim_wall = time.perf_counter() - t0
        launches_sim = dict(launch_counts)
        rows_sim = np.stack([named[k] for k in TRACE_ROWS[:7]])
        if not np.allclose(np.diff(t_sim), N13_DT, rtol=1e-9, atol=0.0):
            raise AssertionError("n13: simulate_rare ran another time grid")

        setup = {}
        t0 = time.perf_counter()
        model = build_model(params)
        setup["model_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        so = split_operator(model.hamiltonian)
        setup["split_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lam = _lambda_bound(model.hamiltonian, 1 << 14)
        setup["lambda_s"] = time.perf_counter() - t0
        K = max(2, chebyshev_coefficients(lam, np.asarray([N13_DT])).shape[1])
        applies = T * (K - 1) + 1  # K - 1 per step, plus the t=0 energy apply
        shape = {"dims": list(model.dims), "DL": so.DL, "DR": so.DR,
                 "A_re": int(so.cross_re_L.shape[0]), "A_im": int(so.cross_im_L.shape[0]),
                 "lambda": lam, "K": K, "T": T, "applies": applies}

        f64 = n13_tier(model, "f64", lam, T)
        if f64["launches"]["limb_matmul_canon"] != 0:
            raise AssertionError("n13 f64 tier launched the limb kernel")
        norm_f64 = check_n13_rows(f64["rows"], T, "f64")
        check_n13_rows(np.vstack([rows_sim, f64["rows"][7:]]), T, "simulate_rare")
        sim_vs_f64 = float(np.abs(rows_sim - f64["rows"][:7]).max())
        if not sim_vs_f64 <= 1e-12:
            raise AssertionError(f"n13: simulate_rare vs chebyshev_step_traces f64 {sim_vs_f64:.3e}")
        say(f"[9/14] n13 {shape}: simulate_rare (auto -> cheb_step, f64 on cuda) "
            f"{sim_wall:.2f} s wall, launches {launches_sim}; timed f64 run "
            f"{f64['wall_s']:.2f} s {f64['stages_s']}, {T / f64['stages_s']['stepping']:.4f} steps/s, "
            f"{T * (K - 1) / f64['stages_s']['stepping']:.1f} applies/s; host set-up {setup}; "
            f"max|norm-1| {norm_f64:.2e}")

        # ---- n13, extp: the limb kernel on the main path ----
        extp = n13_tier(model, "extp", lam, T)
        n_launch = extp["launches"]["limb_matmul_canon"]
        if n_launch <= 0 or n_launch != 6 * applies:
            raise AssertionError(f"n13 extp: {n_launch} limb_matmul_canon launches, "
                                 f"want 6 x {applies} applies = {6 * applies}")
        norm_extp = check_n13_rows(extp["rows"], T, "extp")
        tier_diff = float(np.abs(extp["rows"][:7] - f64["rows"][:7]).max())
        if not tier_diff <= N13_TIER_ATOL:
            raise AssertionError(f"n13 extp vs f64: {tier_diff:.3e} > {N13_TIER_ATOL:g}")
        e_diff = abs(extp["rows"][7, 0] - f64["rows"][7, 0])

        o_rows, o_sec, nnz = oracle_result(*oracles[13], "n13")
        o_err = {tier: float(np.abs(r["rows"][:7, 1] - o_rows).max())
                 for tier, r in (("f64", f64), ("extp", extp))}
        if not max(o_err.values()) <= N13_ORACLE_ATOL:
            raise AssertionError(f"n13 vs expm_multiply oracle at t=dt: {o_err} > {N13_ORACLE_ATOL:g}")
        say(f"[10/14] n13 extp: {extp['wall_s']:.2f} s {extp['stages_s']}, "
            f"{T / extp['stages_s']['stepping']:.4f} steps/s, "
            f"{T * (K - 1) / extp['stages_s']['stepping']:.1f} applies/s, "
            f"{n_launch} limb_matmul_canon launches ({6 * (K - 1)} per step); limb split of the "
            f"operator planes + upload {extp['stages_s']['engine'] - setup['split_s']:.3f} s "
            f"(engine - split); "
            f"max|norm-1| {norm_extp:.2e}; |extp - f64| {tier_diff:.2e} (bound {N13_TIER_ATOL:g}), "
            f"energy |extp - f64| {e_diff:.1e} rad/s; vs expm_multiply oracle at t=dt {o_err} "
            f"(bound {N13_ORACLE_ATOL:g}; oracle {o_sec:.1f} s on the host, nnz {nnz})")

        n12 = n12_ext(oracles[12])
        st = n12["stages_s"]
        say(f"[11/14] n12 ext (dim 8192, {N12_STEPS} steps, production dt): simulate_rare "
            f"(auto -> ext) {n12['wall_s']:.2f} s wall, stages {st}; n_sq {n12['n_sq']}: "
            f"{n12['products']} (8192)^3 ext products, {n12['s_per_product']:.3f} s each "
            f"(int8 tensor-core bound {n12['product_bound_s']:.3f} s); launches "
            f"{n12['launches']}; max|norm-1| {n12['norm_dev']!r} (bound {N12_NORM_ATOL:g}); Iz_sea[0] {n12['iz0']!r}; "
            f"vs cheb_step f64 over {N12_CHECK_STEPS} steps {n12['vs_cheb_step']:.2e}, vs "
            f"expm_multiply oracle at t=dt {n12['vs_oracle']:.2e} (bound {N12_ATOL:g}; oracle "
            f"{n12['oracle_s']:.1f} s on the host)")

        kry = n12_krylov(n12)
        say(f"[12/14] n12 krylov (dim 8192, {N12_CHECK_STEPS} output steps, production dt): "
            f"simulate_rare {kry['wall_s']:.2f} s wall, n_sub {kry['n_sub']} per output step "
            f"(norm bound {kry['norm_bound']:.6e} rad/s), {kry['substeps']} substeps, "
            f"{kry['s_per_substep']:.5f} s per substep, {kry['applies_per_s']:.1f} applies/s; "
            f"launches {kry['launches']}; max|norm-1| {kry['norm_dev']!r} (bound "
            f"{KRYLOV_NORM_ATOL:g}); Iz_sea[0] {kry['iz0']!r}; vs cheb_step f64 "
            f"{kry['vs_cheb_step']:.2e}, vs expm_multiply oracle at t=dt {kry['vs_oracle']:.2e} "
            f"(bound {N12_ATOL:g})")
        for key in ("rows_ref", "oracle_rows"):
            n12.pop(key)

        cheb = n13_chebyshev(f64["rows"], o_rows, peaks)
        zp = cheb["zexp"]
        say(f"[13/14] n13 chebyshev (dim 16384, {CHEB_STEPS} output steps, t_final "
            f"{N13_DT * (CHEB_STEPS - 1):.6f} s): lambda {cheb['lambda']:.6e} rad/s, K "
            f"{cheb['K']}, sweep {cheb['sweep_s']:.2f} s, {cheb['s_per_apply'] * 1e3:.4f} ms per "
            f"apply, {cheb['applies_per_s']:.1f} applies/s; simulate_rare (chebyshev) "
            f"{cheb['simulate_rare_wall_s']:.2f} s, vs the sweep's rows "
            f"{cheb['simulate_rare_vs_sweep']:.1e}; max|norm-1| {cheb['norm_dev']!r} (bound "
            f"{CHEB_NORM_ATOL:g}); Iz_sea[0] {cheb['iz0']!r}; vs cheb_step f64 "
            f"{cheb['vs_cheb_step']:.2e}, vs oracle at t=dt {cheb['vs_oracle']:.2e} (bound "
            f"{N13_ORACLE_ATOL:g}); launches {cheb['launches']}; z_expectations_f32 on the "
            f"route's states {tuple(zp['shape'])}: vs the float64 Iz rows "
            f"{cheb['zexp_vs_rows']:.2e} (bound {ZEXP_ROUTE_ATOL:g}), rel err vs plain "
            f"{zp['max_rel_err']:.3e}, kernel {zp['ms']:.4f} ms, plain {zp['plain_ms']:.4f} ms, "
            f"library {zp['library_ms']:.4f} ms, bound {zp['bound_ms']:.5f} ms ({zp['bound_by']})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for proc, _ in oracles.values():
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=30)

    n13 = {"shape": shape, "setup_s": setup, "simulate_rare_wall_s": sim_wall,
           "f64": {k: v for k, v in f64.items() if k != "rows"},
           "extp": {k: v for k, v in extp.items() if k != "rows"},
           "extp_vs_f64": tier_diff, "vs_oracle": o_err, "oracle_s": o_sec}
    kernels = [
        {
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
            "timing": "ms, plain_ms, library_ms: device time per call (CUDA-graph replay); "
                      "call_ms: one eager call under CUDA events (host work included)",
            "call_ms": at_main["call_ms"],
            "f32_core_bound_ms": at_main["f32_core_bound_ms"],
            "shapes": [at_main, at_large],
            "sweeps": {"eig": run64, "eig32": run32},
        },
        {
            "name": "limb_matmul_canon",
            "route": "cuda",
            "source": "quantumsimulations_tpu_torch/csrc/limb_matmul_canon.cu",
            "replaces": "quantumsimulations_tpu/ops/limb_kernels.py:51",
            "launches": n_launch,
            "unit": "one n13 extp apply: its 6 launches (HL, 2 x cross stage 1, "
                    "2 x cross stage 2, R) summed",
            "max_abs_err": max(r["max_abs_err"] for r in limb.values()),
            "ms": per_apply["ms"],
            "kernel_ms": per_apply["ms"],
            "plain_ms": per_apply["plain_ms"],
            "bound_ms": per_apply["bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes limb products with the carry",
            "timing": "ms: device time per call (CUDA-graph replay); call_ms: one eager call "
                      "under CUDA events (host work included); plain_ms: eager",
            "call_ms": per_apply["call_ms"],
            "yardsticks_ms": {"int_mm_digits": per_apply["int_mm_digits_ms"],
                              "f64_matmul": per_apply["f64_matmul_ms"],
                              "note": "12 torch._int_mm calls of the same 72 limb-pair products "
                                      "without the carry, and a float64 matmul of each launch's "
                                      "(M, K, N): not the same function"},
            "shapes": limb,
            "n13": n13,
        },
        {
            "name": "ext_obs_diagonals_int8",
            "route": "cuda",
            "source": "quantumsimulations_tpu_torch/csrc/ext_obs_diagonals.cu",
            "replaces": "quantumsimulations_tpu/ops/pallas_kernels.py:200",
            "launches": n12["launches"]["ext_obs_diagonals_int8"],
            "max_abs_err": max(r["max_abs_err"] for r in obs.values()),
            "ms": at_path["ms"],
            "kernel_ms": at_path["ms"],
            "plain_ms": at_path["plain_ms"],
            "bound_ms": at_path["bound_ms"],
            "bound_by": at_path["bound_by"],
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes the per-site limb-pair sums",
            "shapes": {str(k): v for k, v in obs.items()},
            "n12": n12,
        },
        {
            "name": "z_expectations_f32",
            "route": "cuda",
            "source": "quantumsimulations_tpu_torch/csrc/z_expectations_f32.cu",
            "replaces": "quantumsimulations_tpu/ops/pallas_kernels.py:128",
            "launches": cheb["launches"]["z_expectations_f32"],
            "max_abs_err": max([zp["max_abs_err"]] + [r["max_abs_err"] for r in zexp.values()]),
            "ms": zp["ms"],
            "kernel_ms": zp["ms"],
            "plain_ms": zp["plain_ms"],
            "bound_ms": zp["bound_ms"],
            "bound_by": zp["bound_by"],
            "library_ms": zp["library_ms"],
            "library_call": "torch.matmul of the float32 signs and a precomputed float32 "
                            "|psi|^2: leaves out the square sum",
            "shapes": {str(k): v for k, v in zexp.items()},
            "n13_chebyshev": {k: v for k, v in cheb.items() if k != "zexp"},
            "n12_krylov": kry,
        },
    ]
    say(f"[14/14] total {time.perf_counter() - t_start:.1f} s; kernels:")
    say(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
