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
  5. ext_obs_diagonals_int8 against its plain version, bit for bit, at two
     ragged small shapes, at (15, 8192, 1024), at the n12 advance's shape
     (15, 8192, 20480), and on its dim-16384 path (a column in two blocks of
     a cluster) at a ragged (15, 16384, 1000) and at the n13 advance's shape
     (15, 16384, 20480), on random canonical limbs with limb 0 at its full
     range, with device times per call (CUDA-graph replay) of the kernel and
     of its earlier SIMT design (experiments/torch_ext_obs_simt.cu, built
     beside the kernels, timed in turns with it), the eager call's time, the
     plain version's, and the least-time bound (bytes at the HBM rate or the
     operations at the int8 tensor-core rate) beside the int32 and __dp4a
     figures;
  6. z_expectations_f32 against its plain version on the card (both sum
     the same float32 products in float64), at the JAX test's ragged shape
     (4 sites, dim 16, T 37, float64), at one eig32 model's state block
     (7, 128, 20000) float32 and at (14, 16384, 2048) float64, with the
     launch plan, the share of outputs equal bit for bit, two calls equal,
     device times per call (CUDA-graph replay) of the kernel, the plain
     version and two yardsticks (the same-function PyTorch chain, and a
     float32 matmul on a precomputed |psi|^2), and the eager call's time;
 6b. int8_gemm (the limb products' GEMM, ops/int8_gemm.py) against
     torch._int_mm bit for bit (two calls) on the ext chain's operand
     layout, at the chain's longest and shortest diagonals at its panel
     (8192, 122880, 512) and (8192, 8192, 512), a doubling pass's N 8 and
     the Ozaki chain's longest diagonal at N 8192 and 128, with its launch
     plan, device times per call (CUDA-graph replay) of the kernel and of
     torch._int_mm on its own K-contiguous operands (the library yardstick;
     the port never calls it on the card), the eager call's time and the
     bound (operations at the int8 tensor-core rate or bytes at the HBM
     rate);
 6c. ext_carry (the ext chain's digit epilogue, ops/ext_carry.py) against
     its plain versions bit for bit (two calls): the panel form at the n12
     and n13 chains' panels (8192, 512) and (16384, 512), each written into
     the last columns of its (L, dim, dim) product, at a doubling pass's
     N 8 and at a ragged N 1000 at an odd offset; the Horner form over
     8192^2 and 16384^2 columns; with
     device times per call (CUDA-graph replay) of the kernel, the plain
     version's time (CUDA events: its scalar band goes up from the host),
     the eager call's time and the bytes bound at the HBM rate;
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
     Iz_sea and Iz_R, and within KERNEL_REL_TOL of its plain version (timed
     as in phase 6, and once more with a cold L2); and
     the public route ``simulate_rare(solver_method="chebyshev")`` at that
     size, which must give the same rows;
 14. A: the dense "expm" route (``simulate_rare(solver_method="expm")``,
     complex128) at n_sea=6 on the simulate CLI's production parameters (30
     s, 20,000 steps), within EXPM_ATOL of the "eig" route on the same
     parameters, its norm within EXPM_NORM_ATOL;
 15. B: ``dopri_propagate_traces`` in the rotating frame on phase A's
     parameters over DOPRI_T_FINAL (DOPRI_STEPS outputs, atol/rtol
     DOPRI_TOL), within DOPRI_ATOL of "eig", with its accepted and rejected
     steps and accepted steps/s;
 16. C: ``simulate_lab_frame`` at n_sea=6 with the lab-frame test's scaled
     frequencies, within LAB_ATOL of a host DOP853 oracle (child process);
     then the port's simulate CLI on phase A's flags, whose trace.npz must
     equal phase A's traces bit for bit;
 17. D: the n12 workload of phase 11 through ``simulate_rare(solver_method=
     "expm")`` on cuda, which takes the Ozaki limb-product route, within
     OZAKI_ATOL of phase 11's "ext" rows, with its stage split and seconds
     per real (8192)^3 product against the int8 tensor-core bound; then the
     dense complex128 route on the same workload, timed, with its error;
 18. E: the "limb" tier of the n13 stepper over LIMB_STEPS output steps,
     within LIMB_ATOL of phase 9's f64 rows, with steps/s, applies/s and
     the device kernels of one apply (torch.profiler);
 19. F: the 2D amplitude x detuning grid through the port's sweep2d CLI at
     its defaults (f1A 10, 20 and 50 kHz, each row phase 7's sweep: 3 x 39
     evolutions at dim 128 over 30 s / 20,000 steps; plots and report off):
     three row directories, each passing phase 7's artifact and invariant
     checks, the 50 kHz row's traces equal to phase 7's bit for bit, the
     other rows within ORACLE_ATOL of the longdouble oracle; then the
     post-processing on its tree: aggregation (equal to the summaries'
     finite rows), the stable-region statistics (written to the root), and
     per row ``reprocess_sweep`` at the original window (equal to its
     summary.json) and at window 35, and ``reprocess_exponential``;
 20. a JSON line with the solver phases' numbers;
  G. the parallel slice at world size 1: one NCCL process group on the card
     through the port's ``initialize_multihost`` (a single-rank rendezvous
     on 127.0.0.1) and a ('dp', 'sp') = (1, 1) mesh, then
     G1. the production sweep of phases 7 and 8, uncut, through
         ``run_sweep_sea_detuning(mesh=...)`` with "eig" and "eig32" (kernel
         1 launched and counted), and phase F's grid through ``sweep2d
         --mesh-devices 1``, every trace against phases 7, 8 and F;
     G2. the sharded apply against the matrix-free apply at n12, and the
         sharded Krylov trace over G2_STEPS output steps against phase 12;
     G3. the DR-sharded ext Chebyshev stepper at n13 over G3_STEPS output
         steps against phase 9's f64 rows;
     G4. the row-sharded Ozaki and ext expm chains at n12 over G4_STEPS
         output steps against phase 11's ext rows;
     G5. the native helpers (g++) on phase 7's traces against numpy;
     and a JSON line with phase G's numbers; then one with every kernel's
     launches and timings.

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
from concurrent.futures import ThreadPoolExecutor

WATCHDOG_S = 600
REPO = os.path.dirname(os.path.abspath(__file__))

#: kernel-vs-plain bound: max |kernel - plain| / max |plain| (cmatmul_f32's
#: 3xTF32 products are ~2^-21 relative per term against the plain version's
#: IEEE float32 ones, summed in another order; z_expectations_f32's float64
#: sums against the plain version's, in another order)
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

#: phases A-E (the solvers added after the kernels): the dense "expm" route
#: against the "eig" route over the production 30 s.  tests/test_steppers.py
#: :91-95 holds it to 1e-10 (norm 1e-11) over 51 steps; over 20,000 steps
#: the rounding of U^128 (amplified 2^(n_sq + 7) by the squarings) adds up
#: block by block: the JAX package's own expm on this workload is
#: 2.47581497525573e-08 from its eig route, its norm off by
#: 3.742884779889266e-09 (experiments/torch_expm_horizon_parity.py, both
#: packages on the CPU).  The bars hold the port to that record with a factor
#: 2 of room, as N12_NORM_ATOL does the ext route
EXPM_ATOL = 5e-8
EXPM_NORM_ATOL = 8e-9
#: the simulate CLI's flags of phase A's workload (n_sea = 6, production
#: physics, 30 s, 20,000 steps; the CLI's defaults otherwise)
SIM_ARGV = ["--n-sea", "6", "--drive-rare", "--solver", "expm", "--device", "cuda"]
#: dopri in the rotating frame against eig (tests/test_steppers.py:109-116's
#: bars at its tolerances atol 1e-12, rtol 1e-11 and its horizon, 0.5 ms
#: over 51 outputs): the 30 s one takes ~1e9 steps at these tolerances, and
#: over 1 ms the norm drifted 9.25e-10 against the 1e-9 bar, too close to it
#: on a card that may round otherwise
DOPRI_T_FINAL = 5e-4
DOPRI_STEPS = 51
DOPRI_TOL = (1e-12, 1e-11)
DOPRI_ATOL = 1e-8
DOPRI_NORM_ATOL = 1e-9
#: the lab frame at n_sea = 6 with tests/test_labframe.py's scaled
#: frequencies against a DOP853 oracle (its bar, :80)
LAB_ATOL = 1e-7
#: the Ozaki "expm" route at n12 against phase 11's "ext" rows: the
#: reference's own account of this route is ~1e-6 (README.md:121) and 5e-6
#: grade (BASELINE.md:49)
OZAKI_ATOL = 1e-5
#: the "limb" tier of cheb_step at n13 against phase 9's f64 rows
#: (the tiers agree to float64 rounding, dynamics/cheb_step.py:219 of the
#: JAX package), over LIMB_STEPS output steps
LIMB_ATOL = 1e-11
LIMB_STEPS = 2

#: phase G (the parallel slice at world size 1 over NCCL): G1's sharded rows
#: against the unsharded ones when not bit-equal (tests/test_sharding.py:167,
#: :237); G2's sharded apply against the matrix-free apply (relative), and
#: its Krylov rows against phase 12's over G2_STEPS output steps (the norm at
#: KRYLOV_NORM_ATOL); G3's sharded ext stepper against phase 9's f64 rows over
#: G3_STEPS output steps (tests/test_limb_kernels.py:161's tier bar); G4's
#: sharded ext chain against the single-card ext chain's states
#: (tests/test_expm_sharded.py:113; phase 11's own rows carry its
#: observables' limb-pair truncation, ~1e-11 at dim 8192, and are held at
#: N12_ATOL) and the sharded Ozaki chain against them at phase D's
#: OZAKI_ATOL, over G4_STEPS output steps; G5's native helpers against the numpy metrics
#: (tests/test_native.py's bars; the fit's fields that are differences of
#: trace values relative to the scale of their operands, g5_native)
G1_EIG_ATOL, G1_EIG32_ATOL = 1e-12, 1e-6
G2_APPLY_RTOL, G2_ATOL, G2_STEPS = 1e-12, 1e-10, 2
G3_ATOL, G3_STEPS = 1e-11, 2
G4_EXT_ATOL, G4_EXT_NORM_ATOL, G4_STEPS = 1e-12, 1e-12, 4
G5_COARSE_RTOL, G5_SLOPE_RTOL = 1e-13, 1e-12

#: (float32 FLOP/s without tensor cores, dense int8 tensor-core OP/s, HBM
#: bytes/s, dense TF32 tensor-core FLOP/s, float64 FLOP/s without tensor
#: cores) from NVIDIA's data sheets, dense rates (half the sheets' sparsity
#: figures) at the full power limit
_PEAKS = {
    "H100 SXM": (67e12, 1979e12, 3.35e12, 495e12, 34e12),
    "H100 PCIe": (51e12, 1513e12, 2.0e12, 378e12, 26e12),
    "H100 NVL": (60e12, 1671e12, 3.9e12, 417.5e12, 30e12),
}
#: int32 operations/s on the CUDA cores (64 INT32 lanes per SM, half the
#: FP32 lanes, a multiply-add counted as two operations as the float32 rate
#: counts an FMA): half the float32 rate above
_INT32_SHARE_OF_F32 = 0.5


def say(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> tuple[str, float, float, float, float, float]:
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


def cold_ms(fn, reps: int = 10, flush_bytes: int = 512 << 20) -> float:
    """Device time of one call of ``fn`` with a cold L2 cache: one call
    captured in a CUDA graph, replayed ``reps`` times under CUDA events,
    each replay after a read of ``flush_bytes`` (ten times the H100's 50 MB
    L2) has evicted what the call would find; the median.  The read runs
    long enough on the card for the host to enqueue the replay behind it."""
    import torch

    flush = torch.zeros(flush_bytes // 4, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    times = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph, flush
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
    # device times of one call (graph replay), kernel and library alike; the
    # eager call time adds the wrapper's host work before the launch
    ms = graph_ms(lambda: cmatmul_f32(ar, ai, br, bi))
    plain_ms = graph_ms(lambda: cmatmul_f32_plain(ar, ai, br, bi))
    library_ms = graph_ms(lambda: torch.matmul(a_c, b_c))
    call_ms = cuda_ms(lambda: cmatmul_f32(ar, ai, br, bi))

    _, f32_peak, _, bytes_peak, tf32_peak, _ = peaks
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

#: ext_obs_diagonals_int8 shapes (L, dim, T): ragged small ones (staged a
#: byte at a time; dim 16 below one 128-row tile), a (dim 8192) check, the
#: n12 advance's one launch (40 blocks of 512 columns), and the dim-16384
#: path at a ragged T and at the n13 advance's one launch; the two launches
#: are the main paths', reported in the kernels line (rows 3 and 3b)
EXT_OBS_PATH = (15, 8192, 40 * 512)
EXT_OBS_PATH_16384 = (15, 16384, 40 * 512)
EXT_OBS_SHAPES = ((15, 16, 33), (15, 64, 200), (15, 8192, 1024), EXT_OBS_PATH,
                  (15, 16384, 1000), EXT_OBS_PATH_16384)
#: the SIMT design kernel 3 had before its tensor-core redesign, built beside
#: the port's kernels and timed in phase 5 against the current one
EXT_OBS_SIMT_SRC = os.path.join("experiments", "torch_ext_obs_simt.cu")


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

    _, _, int8_peak, bytes_peak, _, _ = peaks
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


#: int8_gemm shapes (M, K, N): the ext chain's longest and shortest
#: diagonals at its panel (the first is the main path's, reported in the
#: kernels line), a doubling pass's state product, the Ozaki chain's longest
#: diagonal at a squaring and at an advance
INT8_GEMM_SHAPES = ((8192, 122880, 512), (8192, 8192, 512), (8192, 122880, 8),
                    (8192, 90112, 8192), (8192, 90112, 128))


def check_int8_gemm(shape, peaks, seed: int) -> dict:
    """int8_gemm against torch._int_mm at one (M, K, N), bit for bit (two
    calls), on the ext chain's layout (A a K slice of a 15-limb stack, B
    the transpose of a K-contiguous copy's slice), with timings."""
    import torch

    from quantumsimulations_tpu_torch.ops.int8_gemm import _sm_count, int8_gemm, int8_gemm_plan

    M, K, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    width = max(K, 15 * 8192)
    a = random_limbs((1, M, width), gen)[0, :, :K]
    b = random_limbs((1, N, width), gen)[0, :, :K].t()
    a_lib, b_lib = a.contiguous(), b.t().contiguous()  # the library's own K-contiguous operands
    got, again = int8_gemm(a, b), int8_gemm(a, b)
    want = torch._int_mm(a_lib, b_lib.t())
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, again)):
        raise AssertionError(f"int8_gemm {shape}: {int((got != want).sum())} sums differ from "
                             f"torch._int_mm, two calls equal: {torch.equal(got, again)}")
    ms = graph_ms(lambda: int8_gemm(a, b), n=5, reps=3)
    library_ms = graph_ms(lambda: torch._int_mm(a_lib, b_lib.t()), n=5, reps=3)
    call_ms = cuda_ms(lambda: int8_gemm(a, b), reps=10)
    _, _, int8_peak, bytes_peak, _, _ = peaks
    ops = 2.0 * M * K * N
    nbytes = float(M * K + K * N + 4 * M * N)
    t_ops, t_bytes = ops / int8_peak * 1e3, nbytes / bytes_peak * 1e3
    bound = max(t_ops, t_bytes)
    return {
        "shape": [M, K, N],
        "plan": list(int8_gemm_plan(M, N, K, _sm_count(a.device))),
        "max_abs_err": 0,
        "ms": ms,
        "call_ms": call_ms,
        "library_ms": library_ms,
        "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "roofline": bound / ms,
        "library_roofline": bound / library_ms,
        "gop": ops / 1e9,
        "mbytes": nbytes / 1e6,
    }


#: ext_carry cases: (form, M or L, N or dim, N_total, p0) -- the panel form at
#: the n12 chain's panel in its last columns of the (L, 8192, 8192) product
#: (reported in the kernels line), the n13 chain's in the last of (L, 16384,
#: 16384), a doubling pass's narrow N 8 and a ragged N at an odd offset; the
#: Horner form over the n12 and n13 chains' dim^2 columns
EXT_CARRY_CASES = (("panel", 8192, 512, 8192, 7680), ("panel", 16384, 512, 16384, 15872),
                   ("panel", 8192, 8, 8, 0), ("panel", 8192, 1000, 1003, 3),
                   ("horner", 15, 8192, None, None), ("horner", 15, 16384, None, None))


def check_ext_carry(case, peaks, seed: int) -> dict:
    """ext_carry's panel or Horner form against its plain version at one
    shape, bit for bit (two calls), with timings and the bytes bound."""
    import torch

    from quantumsimulations_tpu_torch.ops import ext_carry as ec
    from quantumsimulations_tpu_torch.ops.extprec import EXT_GUARD, EXT_LIMBS, taylor_coeff_limbs

    form, m, n, n_total, p0 = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if form == "panel":
        ws = torch.randint(-(1 << 28), 1 << 28, (3, EXT_LIMBS + EXT_GUARD, m, n), generator=gen,
                           device="cuda", dtype=torch.int32)
        outs = [torch.zeros((EXT_LIMBS, m, n_total), dtype=torch.int8, device="cuda")
                for _ in range(4)]
        ec.ext_carry_panel(ws, outs[0], outs[1], p0)
        ec.ext_carry_panel(ws, outs[2], outs[3], p0)
        got, again = outs[:2], outs[2:]
        want = [torch.zeros_like(outs[0]), torch.zeros_like(outs[0])]
        ec.ext_carry_panel_plain(ws, *want, p0)

        def kernel():
            ec.ext_carry_panel(ws, outs[0], outs[1], p0)

        def plain():
            ec.ext_carry_panel_plain(ws, want[0], want[1], p0)

        nbytes = float((3 * (EXT_LIMBS + EXT_GUARD) * 4 + 2 * EXT_LIMBS) * m * n)
        shape = [EXT_LIMBS + EXT_GUARD, m, n]
    else:
        a, p = (random_limbs((m, n, n), gen) for _ in range(2))
        cl = taylor_coeff_limbs(10)[7]
        got, again = [ec.ext_axpy_traced(a, p, cl)], [ec.ext_axpy_traced(a, p, cl)]
        want = [ec.ext_axpy_plain(a, p, cl)]

        def kernel():
            ec.ext_axpy_traced(a, p, cl)

        def plain():
            ec.ext_axpy_plain(a, p, cl)

        nbytes = 3.0 * m * n * n
        shape = [m, n * n]
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, again):
        if not (torch.equal(g, w) and torch.equal(g, r)):
            raise AssertionError(f"ext_carry {form} {shape}: {int((g != w).sum())} limbs differ "
                                 f"from plain, two calls equal: {torch.equal(g, r)}")
    ms = graph_ms(kernel, n=5, reps=3)
    call_ms = cuda_ms(kernel, reps=10)
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    bound = nbytes / peaks[3] * 1e3
    return {"form": form, "shape": shape, "n_total": n_total, "p0": p0, "max_abs_err": 0,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "roofline": bound / ms, "mbytes": nbytes / 1e6}


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


def build_ext_obs_simt() -> tuple[ctypes.CDLL, float]:
    """Build the earlier SIMT design of kernel 3 (EXT_OBS_SIMT_SRC) with nvcc
    into a temporary directory; (library, seconds)."""
    from quantumsimulations_tpu_torch.kernels._build import NVCC_FLAGS, nvcc_path

    t0 = time.perf_counter()
    out = os.path.join(tempfile.mkdtemp(prefix="qst_ext_obs_simt_"), "libext_obs_simt.so")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", out,
                           os.path.join(REPO, EXT_OBS_SIMT_SRC)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {EXT_OBS_SIMT_SRC}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.qst_ext_obs_diagonals.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.qst_ext_obs_diagonals.restype = ctypes.c_int
    return lib, time.perf_counter() - t0


def ext_obs_bounds(shape, R: int, n_pairs: int, peaks) -> dict:
    """Least times of ext_obs_diagonals_int8 at one (L, dim, T) shape: the
    limbs read once and the sums written once over the HBM rate; the
    operations the function needs (per limb pair, column and row the product
    Rj*Ri + Ij*Ii, its norm and per-site z sums, and x and y over each site's
    level pairs; a multiply-add is two operations) over the int8 tensor-core
    rate.  The bound is the larger of those two.  The same operations over
    the int32 CUDA-core rate and at four int8 multiply-adds per int32
    instruction (`__dp4a`, an assumed issue rate) are given beside it."""
    L, dim, T = shape
    n = dim.bit_length() - 1
    q = 11
    ops = float(n_pairs) * T * dim * (4 + 1 + n + 4 * n)
    nbytes = 2.0 * q * dim * T + 4.0 * q * R * T
    int32_rate = peaks[1] * _INT32_SHARE_OF_F32
    t_bytes, t_ops = nbytes / peaks[3] * 1e3, ops / peaks[2] * 1e3
    return {
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "bytes_ms": t_bytes, "int8_tensor_core_ms": t_ops,
        "int32_cuda_core_ms": max(ops / int32_rate * 1e3, t_bytes),
        "dp4a_ms": max(ops / (4 * int32_rate) * 1e3, t_bytes),
        "gop": ops / 1e9, "cost_estimate_gop": float(n_pairs) * dim * T * (6 + 10 * n) / 1e9,
        "mbytes": nbytes / 1e6,
    }


def check_ext_obs(shape, peaks, seed: int, simt, plain_reps: int = 3) -> dict:
    """ext_obs_diagonals_int8 vs its plain version at one (L, dim, T) shape,
    bit for bit, with device times per call (CUDA-graph replay) of the kernel
    and of the earlier SIMT design (``simt``, the library of
    build_ext_obs_simt, in turns with the kernel), the eager call's time, the
    plain version's and the bounds."""
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

    L, dim, T = shape
    n, R = dim.bit_length() - 1, out.shape[1]

    def old():
        o = torch.empty_like(out)
        rc = simt.qst_ext_obs_diagonals(S_re.data_ptr(), S_im.data_ptr(), o.data_ptr(), L, dim, T,
                                        n, R, _EXT_OBS_Q, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"SIMT ext_obs kernel: CUDA error {rc}")
        return o

    if not torch.equal(old(), ref):
        raise AssertionError(f"the SIMT ext_obs kernel {shape} differs from the plain version")
    kernel = lambda: ext_obs_diagonals_int8(S_re, S_im, jj, ii, _EXT_OBS_Q)  # noqa: E731
    big = T > 4096
    n_graph = 5 if big else 10
    times = {"kernel": [], "simt": []}
    for name in ("kernel", "simt", "simt", "kernel"):
        times[name].append(graph_ms(kernel if name == "kernel" else old, n=n_graph, reps=3))
    return {
        "shape": list(shape),
        "max_abs_err": max_abs_err,
        "ms": min(times["kernel"]),
        "ms_turns": times["kernel"],
        "call_ms": cuda_ms(kernel, reps=5 if big else 10),
        "simt_ms": min(times["simt"]),
        "simt_ms_turns": times["simt"],
        "plain_ms": cuda_ms(lambda: ext_obs_diagonals_plain(S_re, S_im, jj, ii, _EXT_OBS_Q),
                            reps=1 if big else plain_reps, warmup=1),
        **ext_obs_bounds(shape, R, len(jj), peaks),
    }


def zexp_bound(n: int, dim: int, T: int, itemsize: int, peaks,
               sign_itemsize: int = 8) -> tuple[float, str]:
    """Least time of z_expectations_f32 at one shape: both planes read once,
    the sign table read once, the output written once, over the HBM rate;
    the square sum (3 operations) and n float64 multiply-adds (2 each) per
    (d, t), the kernel's work, over the FP64 rate without tensor cores."""
    nbytes = 2.0 * dim * T * itemsize + sign_itemsize * n * dim + 4.0 * n * T
    ops = (2.0 * n + 3.0) * dim * T
    t_ops, t_bytes = ops / peaks[5] * 1e3, nbytes / peaks[3] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def zexp_chain(re, im, signs):
    """The PyTorch chain that computes the same function as
    z_expectations_f32 (the square sum in the planes' dtype, rounded to
    float32, and one float32 matmul with the float32 signs): the kernel's
    yardstick, summed in float32."""
    import torch

    s32 = signs.to(torch.float32)
    return lambda: torch.matmul(s32, (re * re + im * im).to(torch.float32))


def time_zexp(re, im, signs, peaks, cold: bool = False) -> dict:
    """Kernel vs plain version on the card for one block of states: errors,
    the share of outputs equal to the plain version's bit for bit, two calls
    equal to each other, the launch plan; device times per call (CUDA-graph
    replay) of the kernel, the plain version and two yardsticks (the
    same-function chain, and a float32 matmul on a |psi|^2 computed
    beforehand, which leaves out the square sum), the eager call's time,
    with ``cold`` the kernel's time after the L2 is flushed, and the bound."""
    import dataclasses

    import torch

    from quantumsimulations_tpu_torch.ops.zexp import (
        z_expectations_f32,
        z_expectations_f32_plain,
        zexp_launch_plan,
    )

    got = z_expectations_f32(re, im, signs)
    again = z_expectations_f32(re, im, signs)
    want = z_expectations_f32_plain(re, im, signs)
    chain = zexp_chain(re, im, signs)
    lib = chain()
    s32 = signs.to(torch.float32)
    p2 = (re * re + im * im).to(torch.float32)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("z_expectations_f32: two calls on the same inputs differ")
    scale = float(want.abs().max())
    abs_err = float((got - want).abs().max())
    n, (dim, T) = signs.shape[0], re.shape
    plan = zexp_launch_plan(n, dim, T, re.element_size(),
                            sms=torch.cuda.get_device_properties(0).multi_processor_count)
    bound_ms, bound_by = zexp_bound(n, dim, T, re.element_size(), peaks, signs.element_size())
    kernel = lambda: z_expectations_f32(re, im, signs)  # noqa: E731
    r = {
        "shape": [n, dim, T, str(re.dtype).replace("torch.", "")],
        "sign_dtype": str(signs.dtype).replace("torch.", ""),
        "max_abs_err": abs_err, "max_rel_err": abs_err / scale,
        "bit_equal_share": float((got == want).double().mean()),
        "chain_rel_err": float((lib - want).abs().max()) / scale,
        "plan": dict(dataclasses.asdict(plan), blocks=plan.blocks, threads=plan.threads,
                     partials=plan.partials),
        "ms": graph_ms(kernel),
        "call_ms": cuda_ms(kernel),
        "plain_ms": graph_ms(lambda: z_expectations_f32_plain(re, im, signs)),
        "yardsticks_ms": {"chain": graph_ms(chain),
                          "matmul_on_p2": graph_ms(lambda: torch.matmul(s32, p2))},
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if cold:
        r["cold_ms"] = cold_ms(kernel)
    return r


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
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches
    from quantumsimulations_tpu_torch.models.dipolar import build_model

    T = N12_CHECK_STEPS
    params = dataclasses.replace(n12_params(T), solver_method="krylov")
    t0 = time.perf_counter()
    with counting() as tr:
        t, named = simulate_rare(params, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(tr)
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
            "iz0": float(rows[2, 0]), "vs_cheb_step": vs_cheb, "vs_oracle": vs_oracle,
            "rows": rows}


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
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.ops.zexp import z_expectations_f32, z_sign_table

    T = CHEB_STEPS
    params = n13_params(T)
    model = build_model(params)
    times = np.linspace(0.0, N13_DT * (T - 1), T)
    lam = spectral_norm_bound(model.hamiltonian)
    K = chebyshev_coefficients(lam, times).shape[1]

    t0 = time.perf_counter()
    with counting() as tr:
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
    with counting(tr):
        z = z_expectations_f32(re, im, signs)
    torch.cuda.synchronize()
    launches = kernel_launches(tr)
    if launches["z_expectations_f32"] <= 0:
        raise AssertionError(f"n13 chebyshev: z_expectations_f32 was not launched: {launches}")
    z = z.double().cpu().numpy()
    vs_rows = max(float(np.abs(z[: model.n_sea_effective].sum(axis=0) - rows[2]).max()),
                  float(np.abs(z[model.idx_rare] - rows[3]).max()))
    if not vs_rows <= ZEXP_ROUTE_ATOL:
        raise AssertionError(f"z_expectations_f32 vs the route's float64 Iz rows: {vs_rows:.3e} > "
                             f"{ZEXP_ROUTE_ATOL:g}")
    at_path = time_zexp(re, im, signs, peaks, cold=True)
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
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer(device=torch.device("cuda"))
    t0 = time.perf_counter()
    with counting(timer):
        rows = chebyshev_step_traces(
            model.hamiltonian, model.psi0, N13_DT * np.arange(T), model.dims,
            model.n_sea_effective, model.idx_rare, norm_bound=lam, arithmetic=arith,
            device="cuda", timer=timer,
        )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(timer)
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
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.ops.extprec import EXT_GUARD, EXT_LIMBS, _ext_pairs
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    params = n12_params(N12_STEPS)
    model = build_model(params)
    dim = int(np.prod(model.dims))
    if _auto_method(dim) != "ext":
        raise AssertionError(f"n12: auto picks {_auto_method(dim)!r} at dim {dim}, not 'ext'")
    timer = StageTimer(device=torch.device("cuda"))
    t0 = time.perf_counter()
    t, named = simulate_rare(params, device="cuda", timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(timer)
    if min(launches[k] for k in ("ext_obs", "int8_gemm", "ext_carry")) <= 0:
        raise AssertionError(f"n12: ext_obs, int8_gemm or ext_carry was not launched: "
                             f"{launches}")
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
        "rows_ref": ref[:7], "oracle_rows": o_rows, "rows": rows,
    }


def sim_params(argv):
    """The DipolarRareParams the port's simulate CLI runs for ``argv``."""
    from quantumsimulations_tpu_torch.cli.simulate import build_parser, params_from_args

    return params_from_args(build_parser().parse_args(argv))


@contextlib.contextmanager
def counting(timer=None):
    """``timer`` (a new StageTimer without one), the active tracer inside the
    block: ``kernels.launches`` of it then reads the block's kernel launches."""
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing

    timer = StageTimer() if timer is None else timer
    with tracing(timer):
        yield timer


def timed(fn, *args, **kwargs):
    """(result, wall seconds) of fn(*args, **kwargs), ending in a device sync."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _max_diff(a: dict, b: dict, keys) -> float:
    import numpy as np

    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()) for k in keys)


def dense_expm() -> dict:
    """Phase A: ``simulate_rare(solver_method="expm")`` (dense complex128)
    at n_sea = 6 on the CLI's production parameters, against the "eig"
    route on the same parameters."""
    import dataclasses

    import numpy as np

    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches

    params = sim_params(SIM_ARGV)
    with counting() as tr:
        (t, named), wall = timed(simulate_rare, params, device="cuda")
    launches = kernel_launches(tr)
    (t2, ref), eig_wall = timed(simulate_rare, dataclasses.replace(params, solver_method="eig"),
                                device="cuda")
    keys = [k for k in ref if k != "state_norm"]
    if set(named) != set(ref) or not np.array_equal(t, t2):
        raise AssertionError(f"expm: keys {sorted(named)} or grid differ from eig's")
    if any(v.shape != (params.steps,) or not np.isfinite(v).all() for v in named.values()):
        raise AssertionError("expm: traces not finite of the grid's shape")
    vs_eig = _max_diff(named, ref, keys)
    norm_dev = float(np.abs(named["state_norm"] - 1.0).max())
    if not vs_eig <= EXPM_ATOL:
        raise AssertionError(f"expm vs eig: {vs_eig:.3e} > {EXPM_ATOL:g}")
    if not norm_dev <= EXPM_NORM_ATOL:
        raise AssertionError(f"expm: max |norm - 1| = {norm_dev:.3e} > {EXPM_NORM_ATOL:g}")
    return {"t": t, "named": named, "wall_s": wall, "eig_wall_s": eig_wall, "vs_eig": vs_eig,
            "norm_dev": norm_dev, "launches": launches}


def dopri_rotating() -> dict:
    """Phase B: ``dopri_propagate_traces`` in the rotating frame on phase
    A's parameters over DOPRI_T_FINAL, against the "eig" route."""
    import dataclasses

    import numpy as np

    from quantumsimulations_tpu_torch.dynamics.dopri import dopri_propagate_traces
    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
    from quantumsimulations_tpu_torch.dynamics.observables import assemble_traces
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches
    from quantumsimulations_tpu_torch.models.dipolar import build_model

    params = dataclasses.replace(sim_params(SIM_ARGV), t_final=DOPRI_T_FINAL, steps=DOPRI_STEPS)
    model = build_model(params)
    t = np.linspace(0.0, params.t_final, params.steps)
    with counting() as tr:
        out, wall = timed(dopri_propagate_traces, model.hamiltonian, model.psi0, t, model.dims,
                          atol=DOPRI_TOL[0], rtol=DOPRI_TOL[1], device="cuda")
    launches = kernel_launches(tr)
    named = assemble_traces(out["site_xyz"], out["norm"], model.n_sea_effective, model.idx_rare)
    _, ref = simulate_rare(dataclasses.replace(params, solver_method="eig"), device="cuda")
    vs_eig = _max_diff(named, ref, [k for k in ref if k != "state_norm"])
    norm_dev = float(np.abs(named["state_norm"] - 1.0).max())
    if not (vs_eig <= DOPRI_ATOL and norm_dev <= DOPRI_NORM_ATOL):
        raise AssertionError(f"dopri vs eig {vs_eig:.3e} (bound {DOPRI_ATOL:g}), max |norm - 1| "
                             f"{norm_dev:.3e} (bound {DOPRI_NORM_ATOL:g})")
    n_acc, n_rej = out["n_accepted"], out["n_rejected"]
    return {"wall_s": wall, "n_accepted": n_acc, "n_rejected": n_rej,
            "accepted_per_s": n_acc / wall, "attempted_ms": 1e3 * wall / (n_acc + n_rej),
            "vs_eig": vs_eig, "norm_dev": norm_dev, "launches": launches}


def labframe_params():
    """tests/test_labframe.py:12-38's scaled frequencies at n_sea = 6."""
    import numpy as np

    from quantumsimulations_tpu_torch.models.params import DipolarRareParams

    gamma, B0, f1 = 1.0e5, 1.0, 1.0e3
    return DipolarRareParams(
        n_sea=6, gamma_sea=gamma, gamma_rare=gamma * 0.8, B0_sea=B0, B0_rare=B0,
        B1_sea=2 * np.pi * f1 / gamma, B1_rare=2 * np.pi * f1 / (gamma * 0.8),
        phi_sea=0.3, phi_rare=1.1, dipolar_scale=1e-7 * 1.054571817e-34 * 7e5,
        shell_scale=0.282393e-9, t_final=2.0e-3, steps=81, drive_sea=True, drive_rare=True,
        is_spin_three_half=False, is_center_rare=True,
    )


def labframe_oracle(conn) -> None:
    """Child process: Iz_sea of the lab-frame H(t) at n_sea = 6 by scipy's
    DOP853 (rtol 1e-12, atol 1e-14) on the dense operators; sends
    (Iz_sea, seconds) or an error."""
    _die_with_parent()
    try:
        sys.path.insert(0, REPO)
        import numpy as np
        from scipy.integrate import solve_ivp

        from quantumsimulations_tpu_torch.models.dipolar import build_model
        from quantumsimulations_tpu_torch.models.labframe import build_lab_frame_model

        t0 = time.perf_counter()
        params = labframe_params()
        model = build_model(params)
        Ht, _ = build_lab_frame_model(params)
        H0 = Ht.H0.to_dense()
        Vs = [(V.to_dense(), fn) for V, fn in Ht.pieces]
        dim = H0.shape[0]

        def rhs(tt, y):
            psi = y[:dim] + 1j * y[dim:]
            H = H0.copy()
            for Vd, fn in Vs:
                H = H + float(fn(tt)) * Vd
            d = -1j * (H @ psi)
            return np.concatenate([d.real, d.imag])

        t = np.linspace(0.0, params.t_final, params.steps)
        sol = solve_ivp(rhs, (0, params.t_final), np.concatenate([model.psi0.real, model.psi0.imag]),
                        t_eval=t, method="DOP853", rtol=1e-12, atol=1e-14)
        if not sol.success:
            raise RuntimeError(sol.message)
        psis = sol.y[:dim] + 1j * sol.y[dim:]
        n = len(model.dims)
        basis = np.arange(dim)
        iz = sum(0.5 - ((basis >> (n - 1 - j)) & 1) for j in range(model.n_sea_effective))
        conn.send(("ok", iz @ (np.abs(psis) ** 2), time.perf_counter() - t0, 0))
    except Exception as exc:  # reported and raised by the parent
        conn.send(("error", repr(exc), 0.0, 0))
    finally:
        conn.close()


def labframe_and_cli(lab_oracle, expm_run: dict, tmp: str) -> dict:
    """Phase C: ``simulate_lab_frame`` at n_sea = 6 against the DOP853
    oracle; then the port's simulate CLI on phase A's flags, whose
    trace.npz must equal phase A's traces."""
    import numpy as np

    from quantumsimulations_tpu_torch.cli.simulate import main as simulate_main
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches
    from quantumsimulations_tpu_torch.models.labframe import simulate_lab_frame

    with counting() as tr:
        (t, lab), wall = timed(simulate_lab_frame, labframe_params(), atol=1e-12, rtol=1e-11,
                               device="cuda")
    launches = kernel_launches(tr)
    want, o_sec, _ = oracle_result(*lab_oracle, "lab frame")
    vs_oracle = float(np.abs(lab["Iz_sea"] - want).max())
    norm_dev = float(np.abs(lab["state_norm"] - 1.0).max())
    if not vs_oracle <= LAB_ATOL:
        raise AssertionError(f"lab frame vs DOP853: {vs_oracle:.3e} > {LAB_ATOL:g}")

    path = os.path.join(tmp, "trace.npz")
    log = os.path.join(tmp, "simulate_cli.log")
    with open(log, "w", encoding="utf-8") as f, contextlib.redirect_stdout(f):
        _, cli_wall = timed(simulate_main, SIM_ARGV + ["-o", path])
    with np.load(path) as z:
        cli = {k: z[k] for k in z.files}
    ref = dict(expm_run["named"], t=expm_run["t"])
    if set(cli) != set(ref) or not all(np.array_equal(cli[k], ref[k]) for k in ref):
        raise AssertionError(f"simulate CLI trace differs from phase A's: "
                             f"{_max_diff(cli, ref, ref) if set(cli) == set(ref) else sorted(cli)}")
    with open(log, encoding="utf-8") as f:
        cli_line = f.read().strip().splitlines()[-1]
    return {"wall_s": wall, "vs_oracle": vs_oracle, "norm_dev": norm_dev, "oracle_s": o_sec,
            "launches": launches, "cli_wall_s": cli_wall, "cli_line": cli_line}


def ozaki_n12(ext_rows, peaks) -> dict:
    """Phase D: ``simulate_rare(solver_method="expm")`` at n12 on cuda, which
    routes to the Ozaki limb products, against phase 11's "ext" rows; then
    the dense complex128 route (``expm_propagate_traces``) on the same
    workload, timed and held to the same rows for comparison."""
    import dataclasses

    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.dynamics.eig_propagator import TRACE_ROWS
    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
    from quantumsimulations_tpu_torch.dynamics.expm_propagator import expm_propagate_traces
    from quantumsimulations_tpu_torch.dynamics.observables import assemble_traces
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.ops.extprec import N_LIMBS
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    params = dataclasses.replace(n12_params(N12_STEPS), solver_method="expm")
    timer = StageTimer(device=torch.device("cuda"))
    torch.cuda.reset_peak_memory_stats()
    (t, named), wall = timed(simulate_rare, params, device="cuda", timer=timer)
    launches = kernel_launches(timer)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stages = timer.as_dict()
    if "squarings" not in stages:
        raise AssertionError(f"n12 expm did not take the Ozaki route: {stages}")
    rows = np.stack([named[k] for k in TRACE_ROWS[:7]])
    if rows.shape != (7, N12_STEPS) or not np.isfinite(rows).all():
        raise AssertionError(f"n12 Ozaki: rows not finite of shape (7, {N12_STEPS})")
    vs_ext = float(np.abs(rows[:6] - ext_rows[:6]).max())
    norm_dev = float(np.abs(rows[6] - 1.0).max())
    if not vs_ext <= OZAKI_ATOL:
        raise AssertionError(f"n12 Ozaki vs ext: {vs_ext:.3e} > {OZAKI_ATOL:g}")
    n_sq = stages["squarings"]["calls"]
    dim = 1 << 13
    pairs = N_LIMBS * (N_LIMBS + 1) // 2
    product_bound_s = pairs * 2.0 * float(dim) ** 3 / peaks[2]

    model = build_model(params)
    del named
    torch.cuda.empty_cache()
    out, dense_wall = timed(expm_propagate_traces, model.hamiltonian, model.psi0, t, model.dims,
                            device="cuda")
    dense = assemble_traces(out["site_xyz"], out["norm"], model.n_sea_effective, model.idx_rare)
    d_rows = np.stack([dense[k] for k in TRACE_ROWS[:7]])
    return {
        "wall_s": wall, "stages_s": {k: v["seconds"] for k, v in stages.items()},
        "stage_calls": {k: v["calls"] for k, v in stages.items()}, "n_sq": n_sq,
        "s_per_real_product": stages["squarings"]["seconds"] / max(4 * n_sq, 1),
        "real_product_bound_s": product_bound_s, "limb_pairs": pairs,
        "vs_ext": vs_ext, "norm_dev": norm_dev, "launches": launches, "peak_gb": peak_gb,
        "dense_wall_s": dense_wall, "dense_vs_ext": float(np.abs(d_rows[:6] - ext_rows[:6]).max()),
        "dense_norm_dev": float(np.abs(d_rows[6] - 1.0).max()),
    }


def device_kernels_per_call(fn) -> int | None:
    """CUDA kernels one call of ``fn`` launches, from a torch.profiler trace
    (None where the trace holds no device events)."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def limb_tier(model, lam: float, f64_rows) -> dict:
    """Phase E: the "limb" tier of ``chebyshev_step_traces`` at n13 over
    LIMB_STEPS output steps of the production spacing, against phase 9's
    f64 rows, with its rates and the device kernels of one apply."""
    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.dynamics.cheb_step import _ENGINE_CACHE
    from quantumsimulations_tpu_torch.dynamics.chebyshev import chebyshev_coefficients

    run = n13_tier(model, "limb", lam, LIMB_STEPS)
    rows = run.pop("rows")
    diff = float(np.abs(rows[:7] - f64_rows[:7, :LIMB_STEPS]).max())
    if not diff <= LIMB_ATOL:
        raise AssertionError(f"n13 limb vs f64: {diff:.3e} > {LIMB_ATOL:g}")
    K = max(2, chebyshev_coefficients(lam, np.asarray([N13_DT])).shape[1])
    key, entry = next((k, e) for k, e in _ENGINE_CACHE.items() if k[2] == "limb")
    P = torch.zeros((2, entry["so"].DL, entry["so"].DR), dtype=torch.float64,
                    device=torch.device(key[4]))
    P[0, 0, 0] = 1.0
    step_s = run["stages_s"]["stepping"]
    return dict(run, vs_f64=diff, K=K, steps_per_s=LIMB_STEPS / step_s,
                applies_per_s=LIMB_STEPS * (K - 1) / step_s,
                kernels_per_apply=device_kernels_per_call(lambda: entry["apply_ht"](P)))


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


def _same(a: float, b: float) -> bool:
    return a == b or (a != a and b != b)


def grid2d(tmp: str, phase7: dict) -> dict:
    """Phase F: the 2D amplitude x detuning grid through the port's sweep2d
    CLI at its defaults (3 rows x 13 detunings x 3 variants, dim 128, 30 s,
    20,000 steps; plots and report off), then the post-processing that reads
    its tree.

    Checks: three row directories (named to the second; a row that starts
    within the second of the previous one must not share its directory), each passing phase 7's artifact and invariant checks; the
    50 kHz row, which has phase 7's parameters, equal to phase 7's traces
    bit for bit; the other rows within ORACLE_ATOL of the longdouble oracle;
    ``aggregate_points`` equal to the finite rows of the three summaries;
    the stable-region counts summing to the points; ``reprocess_sweep`` at
    the original window equal to each summary.json, NaN for NaN; 13 rows from
    window 35 and from ``reprocess_exponential``.
    """
    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.analysis.aggregate import aggregate_points
    from quantumsimulations_tpu_torch.analysis.stable_region import stable_region_stats
    from quantumsimulations_tpu_torch.artifacts.writer import json_dump
    from quantumsimulations_tpu_torch.cli.sweep2d import main as sweep2d_main
    from quantumsimulations_tpu_torch.sweep.reprocess import reprocess_sweep
    from quantumsimulations_tpu_torch.sweep.reprocess_exponential import reprocess_exponential

    root, log = os.path.join(tmp, "grid2d"), os.path.join(tmp, "grid2d.log")
    t_start = time.time()
    t0 = time.perf_counter()
    with open(log, "w", encoding="utf-8") as f, contextlib.redirect_stdout(f):
        sweep2d_main(["--no-plots", "--skip-report", "--out-root", root, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    names = sorted(os.listdir(root))
    if len(names) != 3 or not all(n.startswith("sea_detuning_sweep_") for n in names):
        raise AssertionError(f"grid2d root holds {names}, want three sweep directories (one "
                             "per row: rows named to the second merged into one)")
    rows, summaries = {}, []
    for n in names:
        d = os.path.join(root, n)
        with open(os.path.join(d, "summary.json"), encoding="utf-8") as f:
            summaries.append(json.load(f))
        rows[summaries[-1]["global_params"]["f1A_Hz"]] = (d, summaries[-1])
    if sorted(rows) != [10e3, 20e3, 50e3]:
        raise AssertionError(f"grid2d rows at f1A {sorted(rows)}, want 10, 20, 50 kHz")

    # per-row split: build and solve from each row's timings.json, eigh and
    # traces from its "[solve]" log line, the row's wall from the times its
    # timings.json (the last file a row writes) was written
    with open(log, encoding="utf-8") as f:
        solve = [ln.split() for ln in f if "[solve]" in ln]
    if len(solve) != 3:
        raise AssertionError(f"grid2d log has {len(solve)} [solve] lines, want one per row")
    per_row, t_prev = {}, t_start
    for (f1A, (d, _)), w in zip(sorted(rows.items(), key=lambda kv: kv[1][0]), solve):
        with open(os.path.join(d, "timings.json"), encoding="utf-8") as f:
            st = {k: v["seconds"] for k, v in json.load(f).items()}
        t_end = os.path.getmtime(os.path.join(d, "timings.json"))
        st["eigh"] = float(w[w.index("eigh") + 1].rstrip("s"))
        st["traces"] = float(w[w.index("traces") + 1].rstrip("s"))
        st["artifacts_and_rest"] = (t_end - t_prev) - st["build_models"] - st["solve"]
        per_row[f"{f1A / 1e3:g}kHz"] = {"wall_s": t_end - t_prev, "stages_s": st}
        t_prev = t_end

    norm_dev, oracle_err = 0.0, {}
    for f1A, (d, _) in sorted(rows.items()):
        tr = load_traces(d)
        norm_dev = max(norm_dev, max(float(np.abs(t["state_norm"] - 1.0).max())
                                     for t in tr.values()))
        iz0 = [t["Iz_sea"][0] for (_, tag), t in tr.items() if tag == "center_off"]
        if not np.allclose(iz0, -3.0, rtol=0, atol=1e-12):
            raise AssertionError(f"grid2d {f1A:g} Hz: center_off Iz_sea[0] = {iz0}, want -3")
        if f1A == 50e3:
            if tr.keys() != phase7.keys():
                raise AssertionError("grid2d 50 kHz row and phase 7 wrote different trees")
            diff = {key: float(np.abs(tr[key][k] - phase7[key][k]).max())
                    for key in tr for k in tr[key] if not np.array_equal(tr[key][k], phase7[key][k])}
            if diff:
                raise AssertionError(f"grid2d 50 kHz row differs from phase 7's traces: {diff}")
        else:
            oracle_err[f"{f1A / 1e3:g}kHz"] = oracle_check(d, tr)
    if not norm_dev < 1e-12:
        raise AssertionError(f"grid2d: max |state_norm - 1| = {norm_dev:.3e}")
    if not max(oracle_err.values()) <= ORACLE_ATOL:
        raise AssertionError(f"grid2d: Iz_sea vs host oracle {oracle_err} > {ORACLE_ATOL:g}")

    t0 = time.perf_counter()
    pts = aggregate_points(root)
    want = {k: [] for k in pts}
    for summary in summaries:  # in the sorted order aggregate_points walks them
        f1A = summary["global_params"]["f1A_Hz"]
        for r in summary["sweep_results"]:
            vals = (r["DeltaOmega_over_geff"], r["contrast_rare_center"], r["delta_Hz"])
            if all(np.isfinite(vals)):
                ds = abs(r["I_z_slope_on_center"] - r["I_z_slope_off_center"])
                for k, v in zip(("eta", "contrast", "delta_Hz", "f1A_Hz", "abs_delta_slope"),
                                vals + (f1A, ds)):
                    want[k].append(v)
    for k in pts:
        if not np.array_equal(pts[k], np.asarray(want[k], dtype=float), equal_nan=True):
            raise AssertionError(f"grid2d aggregate_points[{k!r}] differs from the summaries' rows")
    stats = stable_region_stats(pts["delta_Hz"] / pts["f1A_Hz"], pts["contrast"],
                                c_min=0.2, p_min=0.8, bin_decimals=3)
    json_dump(os.path.join(root, "stable_region_stats.json"), stats)
    if sum(b["n"] for b in stats["per_bin"]) != len(pts["eta"]):
        raise AssertionError("grid2d stable-region bin counts do not sum to the points")
    t_aggregate = time.perf_counter() - t0

    t0 = time.perf_counter()
    statuses: dict[str, int] = {}
    for f1A, (d, summary) in sorted(rows.items()):
        with open(reprocess_sweep(d, 0), encoding="utf-8") as f:
            again = json.load(f)["sweep_results"]
        if len(again) != len(summary["sweep_results"]):
            raise AssertionError(f"grid2d {f1A:g} Hz: reprocess wrote {len(again)} rows")
        for new, old in zip(again, summary["sweep_results"]):
            bad = [k for k in old if not _same(new[k], old[k])]
            if bad:
                raise AssertionError(f"grid2d {f1A:g} Hz, {old['delta_Hz']} Hz: reprocessing at "
                                     f"the original window changed {bad}")
        with open(reprocess_sweep(d, 35), encoding="utf-8") as f:
            n35 = len(json.load(f)["sweep_results"])
        with open(reprocess_exponential(d, make_plots=False), encoding="utf-8") as f:
            exp_rows = json.load(f)["rows"]
        if n35 != 13 or len(exp_rows) != 13:
            raise AssertionError(f"grid2d {f1A:g} Hz: {n35} rows at window 35, "
                                 f"{len(exp_rows)} exponential rows, want 13")
        for r in exp_rows:
            for side in ("off", "on"):
                statuses[r[f"status_{side}"]] = statuses.get(r[f"status_{side}"], 0) + 1
    t_reprocess = time.perf_counter() - t0
    return {"wall_s": wall, "rows": per_row, "norm_dev": norm_dev, "vs_oracle": oracle_err,
            "n_points": len(pts["eta"]), "best_region": stats["best_region"],
            "aggregate_s": t_aggregate, "reprocess_s": t_reprocess,
            "exponential_statuses": statuses,
            "dirs": {f"{f1A / 1e3:g}kHz": d for f1A, (d, _) in rows.items()}}


# ---------------------------------------------------------------------------
# Phase G: the parallel slice (parallel/, the sharded engines, native/) at
# world size 1 over NCCL
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _traces_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over every trace of two load_traces trees (0.0 when
    they are equal bit for bit)."""
    import numpy as np

    if a.keys() != b.keys():
        raise AssertionError("the two sweeps wrote different trees")
    return max(float(np.abs(a[key][k] - b[key][k]).max()) for key in a for k in a[key])


def g1_sharded_sweeps(tmp: str, mesh, tr64: dict, tr32: dict, grid_dirs: dict) -> dict:
    """G1: the production sweep at the CLI defaults, uncut, through
    ``run_sweep_sea_detuning(mesh=...)`` with "eig" and with "eig32" (the CLI's
    own arguments, the runner called with the mesh), and the 2D grid through
    ``cli/sweep2d.py --mesh-devices 1`` at its defaults; every saved trace
    against phases 7, 8 and F (bit for bit, else within G1_EIG_ATOL /
    G1_EIG32_ATOL with the largest difference printed)."""
    import torch

    import quantumsimulations_tpu_torch.cli.sweep as cli_sweep
    from quantumsimulations_tpu_torch.cli.sweep2d import main as sweep2d_main
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches

    out = {}
    real = cli_sweep.run_sweep_sea_detuning
    cli_sweep.run_sweep_sea_detuning = lambda **kw: real(**kw, mesh=mesh)
    try:
        for solver, ref, atol in (("eig", tr64, G1_EIG_ATOL), ("eig32", tr32, G1_EIG32_ATOL)):
            d = os.path.join(tmp, f"g1_{solver}")
            with counting() as tr:
                run = production_sweep(solver, d)
            run["launches"] = kernel_launches(tr)
            diff = _traces_diff(load_traces(d), ref)
            if not diff <= atol:
                raise AssertionError(f"G1 sharded {solver} vs unsharded: {diff:.3e} > {atol:g}")
            run["vs_unsharded"] = diff
            out[solver] = run
    finally:
        cli_sweep.run_sweep_sea_detuning = real
    if out["eig32"]["launches"]["cmatmul_f32"] <= 0:
        raise AssertionError("G1: the sharded eig32 sweep did not launch cmatmul_f32")

    root = os.path.join(tmp, "g1_grid2d")
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "g1_grid2d.log"), "w", encoding="utf-8") as f, \
            contextlib.redirect_stdout(f):
        sweep2d_main(["--mesh-devices", "1", "--no-plots", "--skip-report", "--out-root", root,
                      "--device", "cuda"])
    torch.cuda.synchronize()
    grid = {"wall_s": time.perf_counter() - t0, "vs_unsharded": {}}
    names = sorted(os.listdir(root))
    if len(names) != 3:
        raise AssertionError(f"G1 grid2d root holds {names}, want three sweep directories")
    for n in names:
        d = os.path.join(root, n)
        with open(os.path.join(d, "summary.json"), encoding="utf-8") as f:
            key = f"{json.load(f)['global_params']['f1A_Hz'] / 1e3:g}kHz"
        diff = _traces_diff(load_traces(d), load_traces(grid_dirs[key]))
        if not diff <= G1_EIG_ATOL:
            raise AssertionError(f"G1 sharded grid row {key} vs phase F: {diff:.3e}")
        grid["vs_unsharded"][key] = diff
    out["grid2d"] = grid
    return out


def g2_state_sharded(mesh, kry_rows) -> dict:
    """G2: the sharded statevector at n12 (dim 8192): ``make_sharded_apply``
    against the matrix-free apply on a seeded state, then
    ``krylov_traces_assembled_sharded`` over G2_STEPS output steps against
    phase 12's rows."""
    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.dynamics.krylov import default_matrix_free_apply
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.parallel.mesh import mesh_device
    from quantumsimulations_tpu_torch.parallel.state_sharded import (
        krylov_traces_assembled_sharded,
        make_sharded_apply,
    )

    dev = mesh_device(mesh)
    model = build_model(n12_params(G2_STEPS))
    H = model.hamiltonian
    rng = np.random.default_rng(12)
    psi = rng.standard_normal(H.dim) + 1j * rng.standard_normal(H.dim)
    psi = torch.as_tensor(psi / np.linalg.norm(psi), device=dev)
    apply_fn, _, rows, _ = make_sharded_apply(H, mesh)
    got = apply_fn(psi[rows])
    want = default_matrix_free_apply(H, device=dev)(psi)
    apply_rel = float((got - want).abs().max() / want.abs().max())
    if not apply_rel <= G2_APPLY_RTOL:
        raise AssertionError(f"G2 sharded apply vs matrix-free: {apply_rel:.3e} > {G2_APPLY_RTOL:g}")
    t = N12_DT * np.arange(G2_STEPS)
    t0 = time.perf_counter()
    out = krylov_traces_assembled_sharded(H, model.psi0, t, model.dims, model.n_sea_effective,
                                          model.idx_rare, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vs = float(np.abs(out[:7] - kry_rows[:, :G2_STEPS]).max())
    norm_dev = float(np.abs(out[6] - 1.0).max())
    if not (vs <= G2_ATOL and norm_dev <= KRYLOV_NORM_ATOL):
        raise AssertionError(f"G2 sharded krylov vs phase 12: {vs:.3e} (bound {G2_ATOL:g}), "
                             f"max|norm-1| {norm_dev:.3e} (bound {KRYLOV_NORM_ATOL:g})")
    return {"apply_rel_err": apply_rel, "krylov_wall_s": wall, "vs_phase12": vs,
            "norm_dev": norm_dev}


def g3_cheb_sharded(mesh, model, lam: float, f64_rows) -> dict:
    """G3: ``chebyshev_step_traces_sharded`` (the ext limb domain with one
    int32 all_reduce per apply, its limb products through the int8 GEMM
    kernel) at n13 (dim 16384, the production dt) over G3_STEPS output
    steps, against phase 9's f64 rows."""
    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches
    from quantumsimulations_tpu_torch.parallel.cheb_sharded import chebyshev_step_traces_sharded

    t0 = time.perf_counter()
    with counting() as tr:
        rows = chebyshev_step_traces_sharded(
            model.hamiltonian, model.psi0, N13_DT * np.arange(G3_STEPS), model.dims,
            model.n_sea_effective, model.idx_rare, mesh=mesh, norm_bound=lam)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(tr)
    if launches["int8_gemm"] <= 0:
        raise AssertionError(f"G3: the ext tier's products did not launch int8_gemm: {launches}")
    vs = float(np.abs(rows[:7] - f64_rows[:7, :G3_STEPS]).max())
    if not vs <= G3_ATOL:
        raise AssertionError(f"G3 sharded cheb (ext) vs phase 9 f64: {vs:.3e} > {G3_ATOL:g}")
    return {"wall_s": wall, "vs_phase9_f64": vs, "launches": launches,
            "energy_diff": float(abs(rows[7, 0] - f64_rows[7, 0])),
            "norm_dev": float(np.abs(rows[6] - 1.0).max())}


def ext_seed_rows(model, T: int, dev) -> tuple[np.ndarray, float]:
    """The single-card ext chain's first T states (its seed block: the
    Horner core, the squarings and the doubling pass of
    ``expm_traces_assembled_ext`` at block T), with the observables taken
    from their float64 values, as the sharded ext engine takes them (the
    route's own observables sum truncated limb pairs, ~1e-11 at dim 8192);
    returns the (7, T) rows and the seconds."""
    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.dynamics.expm_propagator import (
        _ext_host_setup,
        _ext_powers,
        _ext_split_operator,
        _ext_taylor,
    )
    from quantumsimulations_tpu_torch.dynamics.observables import assembled_rows
    from quantumsimulations_tpu_torch.ops.extprec import ext_val

    t0 = time.perf_counter()
    H, dim = model.hamiltonian, model.hamiltonian.dim
    _, n_sq, dt_s, op = _ext_host_setup(H, np.asarray(model.psi0), N12_DT, dim, dev)
    Are, Aim = _ext_split_operator(op, dt_s, dim, dev)
    stage = lambda name: contextlib.nullcontext()  # noqa: E731
    U = list(_ext_taylor(Are, Aim, 512, stage))
    del Are, Aim
    S_re, S_im, _, _ = _ext_powers(U, np.asarray(model.psi0), n_sq, T.bit_length() - 1, 512, stage)
    sea_mask = torch.as_tensor((np.arange(len(model.dims)) < model.n_sea_effective)
                               .astype(np.float64), device=dev)
    rows = assembled_rows(torch.complex(ext_val(S_re), ext_val(S_im)), model.dims, sea_mask,
                          model.idx_rare).cpu().numpy()
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0


def g4_expm_sharded(mesh, ext_rows, ozaki_norm_dev: float) -> dict:
    """G4: ``expm_traces_sharded`` (Ozaki) and ``expm_traces_sharded_ext`` at
    n12 over G4_STEPS output steps of the production spacing: ext against
    the single-card ext chain's states (``ext_seed_rows``) at
    G4_EXT_ATOL, and against phase 11's ext rows at phase 11's own bar
    (N12_ATOL: the route's observables truncate limb pairs); Ozaki against
    phase 11's rows at phase D's bar; the norm of ext within
    G4_EXT_NORM_ATOL, of Ozaki within phase D's own recorded drift over the
    whole horizon (its squaring chain rounds each product at ~5e-16)."""
    import numpy as np
    import torch

    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.parallel.expm_sharded import (
        expm_traces_sharded,
        expm_traces_sharded_ext,
    )
    from quantumsimulations_tpu_torch.parallel.mesh import mesh_device

    model = build_model(n12_params(G4_STEPS))
    args = (model.hamiltonian, model.psi0, N12_DT * np.arange(G4_STEPS), model.dims,
            model.n_sea_effective, model.idx_rare)
    seed_rows, seed_s = ext_seed_rows(model, G4_STEPS, mesh_device(mesh))
    out = {"single_card_ext_s": seed_s}
    for name, fn in (("ext", expm_traces_sharded_ext), ("ozaki", expm_traces_sharded)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rows = fn(*args, mesh=mesh)
        torch.cuda.synchronize()
        out[name] = {"wall_s": time.perf_counter() - t0,
                     "norm_dev": float(np.abs(rows[6] - 1.0).max())}
        out[name]["rows"] = rows
    ext, oz = out["ext"], out["ozaki"]
    rows = ext.pop("rows")
    ext["vs_single_card"] = float(np.abs(rows[:7] - seed_rows).max())
    ext["vs_phase11"] = float(np.abs(rows[:7] - ext_rows[:7, :G4_STEPS]).max())
    oz["vs_phase11_ext"] = float(np.abs(oz.pop("rows")[:6] - ext_rows[:6, :G4_STEPS]).max())
    oz["norm_bar"] = max(G4_EXT_NORM_ATOL, ozaki_norm_dev)
    if not (ext["vs_single_card"] <= G4_EXT_ATOL and ext["vs_phase11"] <= N12_ATOL
            and ext["norm_dev"] <= G4_EXT_NORM_ATOL):
        raise AssertionError(f"G4 sharded ext: vs the single-card chain "
                             f"{ext['vs_single_card']:.3e} (bound {G4_EXT_ATOL:g}), vs phase 11 "
                             f"{ext['vs_phase11']:.3e} (bound {N12_ATOL:g}), max|norm-1| "
                             f"{ext['norm_dev']:.3e}")
    if not (oz["vs_phase11_ext"] <= OZAKI_ATOL and oz["norm_dev"] <= oz["norm_bar"]):
        raise AssertionError(f"G4 sharded Ozaki: vs ext {oz['vs_phase11_ext']:.3e} (bound "
                             f"{OZAKI_ATOL:g}), max|norm-1| {oz['norm_dev']:.3e} (bound "
                             f"{oz['norm_bar']:.3e})")
    return out


def g5_native(tr64: dict) -> dict:
    """G5: the port's native helpers built with g++ on this machine (no
    numpy fallback may hide here), on phase 7's Iz_sea traces, against the
    numpy metrics."""
    import numpy as np

    from quantumsimulations_tpu_torch import native
    from quantumsimulations_tpu_torch.analysis.metrics import coarse_grain, iz_slope_from_coarse

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("G5: the native library did not build (g++) or load")
    build_s = time.perf_counter() - t0
    keys = sorted(tr64)
    t = tr64[keys[0]]["t"]
    Y = np.stack([tr64[k]["Iz_sea"] for k in keys])
    t0 = time.perf_counter()
    coarse = native.coarse_grain_batch(Y, 100)
    tc = coarse_grain(t, Y[0], 100)[0]
    fits = native.iz_slope_batch(tc, coarse)
    native_s = time.perf_counter() - t0
    worst_coarse = worst_slope = worst_scaled = 0.0
    fields: dict = {}  # per field: the largest difference of its own value and of its scale
    for i in range(len(keys)):
        want = coarse_grain(t, Y[i], 100)[1]
        if not np.allclose(coarse[i], want, rtol=G5_COARSE_RTOL, atol=1e-15):
            raise AssertionError(f"G5 coarse_grain_batch differs from numpy on {keys[i]}")
        worst_coarse = max(worst_coarse, float(np.abs(coarse[i] - want).max()))
        py = iz_slope_from_coarse(tc, coarse[i])
        # the fit's fields that are differences of trace values (Iz_sea
        # ~ -2.4 here, the drift ~1e-4) are held relative to the scale of
        # their operands: the two fits round those operands differently,
        # and a near-flat trace cancels all but a few digits
        ymax = float(np.abs(coarse[i]).max())
        span = py["t_end"] - py["t_start"]
        scale = {"I_z_slope": ymax, "I_z_start": ymax, "I_z_end": ymax,
                 "slope": ymax / span, "slope_std": ymax / span,
                 "t_value": ymax / span / abs(py["slope_std"])}
        for k, v in py.items():
            got = fits[i][k]
            if np.isnan(v) and np.isnan(got):
                continue
            err = abs(got - v)
            if not err <= G5_SLOPE_RTOL * max(abs(v), scale.get(k, 0.0)):
                raise AssertionError(f"G5 iz_slope_batch {k} differs from numpy on {keys[i]}: "
                                     f"{got!r} vs {v!r}")
            own = err / abs(v) if v != 0 else 0.0
            scaled = err / max(abs(v), scale.get(k, 0.0))
            worst_slope = max(worst_slope, own)
            worst_scaled = max(worst_scaled, scaled)
            f = fields.setdefault(k, {"own": 0.0, "scaled": 0.0})
            f["own"], f["scaled"] = max(f["own"], own), max(f["scaled"], scaled)
    return {"build_s": build_s, "native_s": native_s, "traces": len(keys),
            "coarse_max_abs_diff": worst_coarse, "slope_max_rel_diff": worst_slope,
            "slope_max_scaled_diff": worst_scaled, "slope_fields": fields}


def phase_g(tmp: str, smi: str, tr64: dict, tr32: dict, grid_dirs: dict, kry_rows, model13,
            lam: float, f64_rows, ext_rows, ozaki_norm_dev: float) -> dict:
    """Phase G at world size 1: one NCCL process group on this card through
    the port's ``initialize_multihost`` (a single-rank rendezvous on
    127.0.0.1), a ('dp', 'sp') = (1, 1) mesh, G1-G5, the group destroyed at
    the end whatever happens."""
    import torch
    import torch.distributed as dist

    from quantumsimulations_tpu_torch.parallel.distributed import initialize_multihost
    from quantumsimulations_tpu_torch.parallel.mesh import make_mesh

    if not initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda"):
        raise AssertionError("G: initialize_multihost did not start a process group")
    out = {"backend": str(dist.get_backend()),
           "nccl_version": ".".join(map(str, torch.cuda.nccl.version()))}
    say(f"[G] process group: backend {out['backend']}, NCCL {out['nccl_version']}, world size "
        f"{dist.get_world_size()} on {smi}")
    try:
        mesh = make_mesh(1, sp=1, device="cuda")
        t0 = time.perf_counter()
        g1 = out["G1"] = g1_sharded_sweeps(tmp, mesh, tr64, tr32, grid_dirs)
        out["G1"]["wall_s"] = time.perf_counter() - t0
        say(f"[G1/5] dp-sharded production sweep, (1, 1) mesh, uncut (39 sims, dim 128, 20000 "
            f"steps): eig {g1['eig']['wall_s']:.2f} s {_split(g1['eig'])}, max|sharded - phase 7| "
            f"{g1['eig']['vs_unsharded']:.1e} (bar: bit for bit, else {G1_EIG_ATOL:g}); eig32 "
            f"{g1['eig32']['wall_s']:.2f} s {_split(g1['eig32'])}, max|sharded - phase 8| "
            f"{g1['eig32']['vs_unsharded']:.1e} (else {G1_EIG32_ATOL:g}), cmatmul_f32 launches "
            f"{g1['eig32']['launches']['cmatmul_f32']}; sweep2d --mesh-devices 1 (3 rows) "
            f"{g1['grid2d']['wall_s']:.2f} s, max|row - phase F| {g1['grid2d']['vs_unsharded']}; "
            f"phase G1 {g1['wall_s']:.2f} s; {smi}")
        t0 = time.perf_counter()
        g2 = out["G2"] = g2_state_sharded(mesh, kry_rows)
        g2["wall_s"] = time.perf_counter() - t0
        say(f"[G2/5] sharded statevector n12 (dim 8192): apply vs matrix-free rel err "
            f"{g2['apply_rel_err']:.2e} (bar {G2_APPLY_RTOL:g}); krylov_traces_assembled_sharded "
            f"over {G2_STEPS} output steps {g2['krylov_wall_s']:.2f} s, vs phase 12 "
            f"{g2['vs_phase12']:.2e} (bar {G2_ATOL:g}), max|norm-1| {g2['norm_dev']:.2e} (bar "
            f"{KRYLOV_NORM_ATOL:g}); phase G2 {g2['wall_s']:.2f} s; {smi}")
        t0 = time.perf_counter()
        g3 = out["G3"] = g3_cheb_sharded(mesh, model13, lam, f64_rows)
        g3["phase_s"] = time.perf_counter() - t0
        say(f"[G3/5] chebyshev_step_traces_sharded n13 (dim 16384, production dt, {G3_STEPS} "
            f"output steps, ext limbs, one int32 all_reduce per apply): {g3['wall_s']:.2f} s; vs "
            f"phase 9 f64 {g3['vs_phase9_f64']:.2e} (bar {G3_ATOL:g}), energy diff "
            f"{g3['energy_diff']:.1e} rad/s, max|norm-1| {g3['norm_dev']:.2e}; launches "
            f"{dict(g3['launches'])}; phase G3 {g3['phase_s']:.2f} s; {smi}")
        t0 = time.perf_counter()
        g4 = out["G4"] = g4_expm_sharded(mesh, ext_rows, ozaki_norm_dev)
        g4["wall_s"] = time.perf_counter() - t0
        say(f"[G4/5] row-sharded expm n12 (dim 8192, {G4_STEPS} output steps, production dt): "
            f"ext {g4['ext']['wall_s']:.2f} s, vs the single-card ext chain's states "
            f"{g4['ext']['vs_single_card']:.2e} (bar {G4_EXT_ATOL:g}; that chain "
            f"{g4['single_card_ext_s']:.2f} s), vs phase 11's rows {g4['ext']['vs_phase11']:.2e} "
            f"(bar {N12_ATOL:g}), max|norm-1| {g4['ext']['norm_dev']:.2e} (bar "
            f"{G4_EXT_NORM_ATOL:g}); Ozaki {g4['ozaki']['wall_s']:.2f} s, vs phase 11 ext "
            f"{g4['ozaki']['vs_phase11_ext']:.2e} (bar {OZAKI_ATOL:g}), max|norm-1| "
            f"{g4['ozaki']['norm_dev']:.2e} (bar: phase D's recorded drift "
            f"{g4['ozaki']['norm_bar']:.2e}); phase G4 {g4['wall_s']:.2f} s; {smi}")
        t0 = time.perf_counter()
        g5 = out["G5"] = g5_native(tr64)
        g5["wall_s"] = time.perf_counter() - t0
        say(f"[G5/5] native helpers (g++ build {g5['build_s']:.2f} s): coarse_grain_batch + "
            f"iz_slope_batch on phase 7's {g5['traces']} Iz_sea traces {g5['native_s']:.4f} s; vs "
            f"numpy: coarse max abs diff {g5['coarse_max_abs_diff']:.1e} (bar rtol "
            f"{G5_COARSE_RTOL:g}), slope fields max diff {g5['slope_max_scaled_diff']:.1e} of "
            f"their operands' scale (bar {G5_SLOPE_RTOL:g}; of their own value "
            f"{g5['slope_max_rel_diff']:.1e}; per field, own / scaled: "
            + ", ".join(f"{k} {f['own']:.1e} / {f['scaled']:.1e}"
                        for k, f in sorted(g5["slope_fields"].items()))
            + f"); phase G5 {g5['wall_s']:.2f} s; {smi}")
    finally:
        dist.destroy_process_group()
    return out


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
    from quantumsimulations_tpu_torch.kernels import launches as kernel_launches
    from quantumsimulations_tpu_torch.kernels._build import build_all
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.ops.split_apply import split_operator

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    say("[1/20] card (nvidia-smi name, power.limit):")
    say(smi)
    peaks = card_peaks(name)
    say(f"      torch {torch.__version__}, CUDA {torch.version.cuda}, peaks from the "
        f"{peaks[0]} data sheet: {peaks[1] / 1e12:g} TFLOP/s f32, {peaks[4] / 1e12:g} TFLOP/s "
        f"TF32 (dense), {peaks[2] / 1e12:g} TOP/s int8 (dense), {peaks[5] / 1e12:g} TFLOP/s f64, "
        f"{peaks[3] / 1e12:g} TB/s")

    t0 = time.perf_counter()
    side = ThreadPoolExecutor(max_workers=1)  # kernel 3's SIMT design, built meanwhile
    simt_build = side.submit(build_ext_obs_simt)
    built = build_all(extra_flags=("-Xptxas", "-v"))
    for kname, (out, sec) in built.items():
        report = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        say(f"[2/20] built {kname} in {sec:.2f} s; ptxas: {' | '.join(report)}")
    say(f"      all {len(built)} builds (in parallel): {time.perf_counter() - t0:.2f} s")

    main_shape = (39, 128, 128, 1680)
    at_main = check_cmatmul(main_shape, peaks, seed=1)
    at_large = check_cmatmul((1, 2048, 2048, 1024), peaks, seed=2)
    for r in (at_main, at_large):
        say(f"[3/20] cmatmul_f32 {tuple(r['shape'])}: rel err {r['max_rel_err']:.3e} "
            f"(bound {KERNEL_REL_TOL:g}), device ms per call: kernel {r['ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, library (complex64 matmul) {r['library_ms']:.4f}; eager call "
            f"{r['call_ms']:.4f} ms; 3xTF32 bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['tf32_gflop']:.1f} GFLOP), float32 CUDA-core bound {r['f32_core_bound_ms']:.4f} ms")

    limb = {}
    for i, lname in enumerate(LIMB_SHAPES):
        r = limb[lname] = check_limb(lname, peaks, seed=10 + i)
        say(f"[4/20] limb_matmul_canon {lname} {r['shape'][0]}@{r['shape'][1]}"
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
    rx, tx = ctx.Pipe(duplex=False)
    lab_proc = ctx.Process(target=labframe_oracle, args=(tx,), daemon=True)
    lab_proc.start()
    tx.close()
    oracles["lab"] = (lab_proc, rx)

    obs = {}
    simt, simt_s = simt_build.result()
    say(f"      built {EXT_OBS_SIMT_SRC} (kernel 3's SIMT design, for phase 5) in {simt_s:.2f} s")
    launches_16384 = 0  # the dim-16384 path's launches in this phase
    for i, shape in enumerate(EXT_OBS_SHAPES):
        with counting() as tr:
            r = obs[shape] = check_ext_obs(shape, peaks, seed=20 + i, simt=simt)
        if shape[1] == 16384:
            launches_16384 += kernel_launches(tr)["ext_obs"]
        say(f"[5/20] ext_obs_diagonals_int8 {shape}: equal to plain bit for bit; device ms per "
            f"call: kernel {r['ms']:.4f}, SIMT design {r['simt_ms']:.4f} (same call, in turns: "
            f"{r['ms_turns']}, {r['simt_ms_turns']}); eager call {r['call_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{r['mbytes']:.0f} MB at HBM {r['bytes_ms']:.4f}, {r['gop']:.1f} G operations at the "
            f"int8 tensor-core rate {r['int8_tensor_core_ms']:.4f}), {r['bound_ms'] / r['ms']:.1%} "
            f"of it; the same operations on the int32 CUDA cores {r['int32_cuda_core_ms']:.4f} ms, "
            f"at the __dp4a rate {r['dp4a_ms']:.4f} ms (the JAX cost estimate counts "
            f"{r['cost_estimate_gop']:.1f} G)")
    at_path, at_16384 = obs[EXT_OBS_PATH], obs[EXT_OBS_PATH_16384]
    side.shutdown()

    zexp = {}
    for i, zshape in enumerate(ZEXP_SHAPES):
        r = zexp[zshape] = check_zexp(zshape, peaks, seed=30 + i)
        say(f"[6/20] z_expectations_f32 {zshape}: rel err {r['max_rel_err']:.3e} (bound "
            f"{KERNEL_REL_TOL:g}; the float32 chain {r['chain_rel_err']:.3e}), "
            f"{r['bit_equal_share']:.4f} of outputs equal to plain bit for bit, two calls "
            f"equal; plan {r['plan']}; device ms per call: kernel {r['ms']:.5f}, plain "
            f"{r['plain_ms']:.5f}, same-function chain {r['yardsticks_ms']['chain']:.5f}, "
            f"matmul on a precomputed |psi|^2 {r['yardsticks_ms']['matmul_on_p2']:.5f}; eager "
            f"call {r['call_ms']:.5f} ms; bound {r['bound_ms']:.5f} ms ({r['bound_by']})")

    gemm = {}
    for i, gshape in enumerate(INT8_GEMM_SHAPES):
        r = gemm[gshape] = check_int8_gemm(gshape, peaks, seed=40 + i)
        say(f"[6b/20] int8_gemm {gshape}: equal to torch._int_mm bit for bit (two calls), plan "
            f"{r['plan']}; device ms per call: kernel {r['ms']:.4f}, torch._int_mm "
            f"{r['library_ms']:.4f}; eager call {r['call_ms']:.4f} ms; bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}), {r['roofline']:.1%} of it (torch._int_mm "
            f"{r['library_roofline']:.1%})")
    gemm_path = gemm[INT8_GEMM_SHAPES[0]]

    carry = {}
    for i, case in enumerate(EXT_CARRY_CASES):
        r = carry[case] = check_ext_carry(case, peaks, seed=50 + i)
        say(f"[6c/20] ext_carry {r['form']} {tuple(r['shape'])} (N_total {r['n_total']}, p0 "
            f"{r['p0']}): equal to plain bit for bit (two calls); device ms per call: kernel "
            f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}; eager call {r['call_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms (bytes, {r['mbytes']:.1f} MB), {r['roofline']:.1%} of it")
        torch.cuda.empty_cache()
    carry_path = carry[EXT_CARRY_CASES[0]]

    tmp = tempfile.mkdtemp(prefix="qst_chip_smoke_")
    try:
        dir64, dir32 = os.path.join(tmp, "eig"), os.path.join(tmp, "eig32")

        with counting() as tr:
            run64 = production_sweep("eig", dir64)
        launches_eig = kernel_launches(tr)
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
        say(f"[7/20] eig sweep (39 sims, dim 128, 20000 steps): {run64['wall_s']:.2f} s wall "
            f"{_split(run64)}; max|norm-1| {norm_dev:.2e}; Iz_sea vs longdouble oracle "
            f"{oracle_err:.2e}; launches {launches_eig}")

        with counting() as tr:
            run32 = production_sweep("eig32", dir32)
        launches_eig32 = kernel_launches(tr)
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
        say(f"[8/20] eig32 sweep: {run32['wall_s']:.2f} s wall {_split(run32)}; "
            f"max |eig32 - eig| {diff:.2e} "
            f"(bound {EIG32_ATOL:g}); launches {launches_eig32}")

        # ---- n13, the default tier through the user entry point ----
        T = N13_STEPS
        params = n13_params(T)
        t0 = time.perf_counter()
        with counting() as tr:
            t_sim, named = simulate_rare(params, device="cuda")
        torch.cuda.synchronize()
        sim_wall = time.perf_counter() - t0
        launches_sim = kernel_launches(tr)
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
        say(f"[9/20] n13 {shape}: simulate_rare (auto -> cheb_step, f64 on cuda) "
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
        say(f"[10/20] n13 extp: {extp['wall_s']:.2f} s {extp['stages_s']}, "
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
        say(f"[11/20] n12 ext (dim 8192, {N12_STEPS} steps, production dt): simulate_rare "
            f"(auto -> ext) {n12['wall_s']:.2f} s wall, stages {st}; n_sq {n12['n_sq']}: "
            f"{n12['products']} (8192)^3 ext products, {n12['s_per_product']:.3f} s each "
            f"(int8 tensor-core bound {n12['product_bound_s']:.3f} s); launches "
            f"{n12['launches']}; max|norm-1| {n12['norm_dev']!r} (bound {N12_NORM_ATOL:g}); Iz_sea[0] {n12['iz0']!r}; "
            f"vs cheb_step f64 over {N12_CHECK_STEPS} steps {n12['vs_cheb_step']:.2e}, vs "
            f"expm_multiply oracle at t=dt {n12['vs_oracle']:.2e} (bound {N12_ATOL:g}; oracle "
            f"{n12['oracle_s']:.1f} s on the host)")

        kry = n12_krylov(n12)
        kry_rows = kry.pop("rows")  # for phase G2
        say(f"[12/20] n12 krylov (dim 8192, {N12_CHECK_STEPS} output steps, production dt): "
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
        say(f"[13/20] n13 chebyshev (dim 16384, {CHEB_STEPS} output steps, t_final "
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
            f"{zp['max_rel_err']:.3e} ({zp['bit_equal_share']:.4f} bit-equal), plan "
            f"{zp['plan']}; device ms per call: kernel {zp['ms']:.5f} (cold L2 "
            f"{zp['cold_ms']:.5f}), plain {zp['plain_ms']:.5f}, same-function chain "
            f"{zp['yardsticks_ms']['chain']:.5f}; eager call {zp['call_ms']:.5f} ms; bound "
            f"{zp['bound_ms']:.5f} ms ({zp['bound_by']})")

        # ---- phases A-E: the solvers ported after the kernels ----
        expm = dense_expm()
        say(f"[14/20] A. dense expm (n_sea 6, dim 128, {len(expm['t'])} steps over 30 s, the "
            f"simulate CLI's production parameters): simulate_rare(expm) {expm['wall_s']:.2f} s "
            f"wall (eig route {expm['eig_wall_s']:.2f} s); vs eig {expm['vs_eig']:.2e} (bound "
            f"{EXPM_ATOL:g}); max|norm-1| {expm['norm_dev']:.2e} (bound {EXPM_NORM_ATOL:g}); "
            f"launches {expm['launches']}")
        dop = dopri_rotating()
        say(f"[15/20] B. dopri, rotating frame (n_sea 6, t_final {DOPRI_T_FINAL:g} s, "
            f"{DOPRI_STEPS} outputs, atol/rtol {DOPRI_TOL}): {dop['wall_s']:.2f} s wall, "
            f"n_accepted {dop['n_accepted']}, n_rejected {dop['n_rejected']}, "
            f"{dop['accepted_per_s']:.1f} accepted steps/s ({dop['attempted_ms']:.4f} ms per "
            f"attempted step); vs eig {dop['vs_eig']:.2e} (bound {DOPRI_ATOL:g}); max|norm-1| "
            f"{dop['norm_dev']:.2e} (bound {DOPRI_NORM_ATOL:g}); launches {dop['launches']}")
        lab = labframe_and_cli(oracles["lab"], expm, tmp)
        say(f"[16/20] C. lab frame (n_sea 6, scaled frequencies, 2e-3 s, 81 outputs): "
            f"simulate_lab_frame {lab['wall_s']:.2f} s wall; Iz_sea vs DOP853 oracle "
            f"{lab['vs_oracle']:.2e} (bound {LAB_ATOL:g}; oracle {lab['oracle_s']:.1f} s on the "
            f"host); max|norm-1| {lab['norm_dev']:.2e}; launches {lab['launches']}; simulate CLI "
            f"{' '.join(SIM_ARGV)}: {lab['cli_wall_s']:.2f} s, trace.npz equal to phase A's bit "
            f"for bit ('{lab['cli_line']}')")
        ext_rows_n12 = n12["rows"][:, :G4_STEPS].copy()  # for phase G4
        oz = ozaki_n12(n12.pop("rows"), peaks)
        say(f"[17/20] D. Ozaki expm (n12, dim 8192, {N12_STEPS} steps, production dt, uncut): "
            f"simulate_rare(expm) {oz['wall_s']:.2f} s wall, stages {oz['stages_s']} (calls "
            f"{oz['stage_calls']}); n_sq {oz['n_sq']}; {oz['s_per_real_product']:.4f} s per real "
            f"(8192)^3 Ozaki product ({oz['limb_pairs']} int8 limb-pair GEMMs; int8 tensor-core "
            f"bound {oz['real_product_bound_s']:.4f} s); peak {oz['peak_gb']:.2f} GB; vs ext "
            f"{oz['vs_ext']:.2e} (bound {OZAKI_ATOL:g}); max|norm-1| {oz['norm_dev']:.3e}; "
            f"launches {oz['launches']}; dense complex128 expm_propagate_traces on the same "
            f"workload {oz['dense_wall_s']:.2f} s, vs ext {oz['dense_vs_ext']:.2e}, max|norm-1| "
            f"{oz['dense_norm_dev']:.3e}")
        lt = limb_tier(model, lam, f64["rows"])
        say(f"[18/20] E. cheb_step limb tier (n13, dim 16384, {LIMB_STEPS} steps, production dt, "
            f"K {lt['K']}): {lt['wall_s']:.2f} s {lt['stages_s']}, {lt['steps_per_s']:.4f} "
            f"steps/s, {lt['applies_per_s']:.1f} applies/s, {lt['kernels_per_apply']} device "
            f"kernels per apply (torch.profiler); vs f64 {lt['vs_f64']:.2e} (bound "
            f"{LIMB_ATOL:g}); launches {lt['launches']}")
        with counting() as tr:
            grid = grid2d(tmp, tr64)
        grid["launches"] = kernel_launches(tr)
        split = "; ".join(f"{k} {r['wall_s']:.2f} s {_split(r)}" for k, r in grid["rows"].items())
        say(f"[19/20] F. 2D grid (sweep2d CLI defaults: 3 rows x 39 sims, dim 128, 20000 steps, "
            f"uncut): {grid['wall_s']:.2f} s wall; rows {split}; 3 row directories; 50 kHz row "
            f"equal to phase 7's traces bit for bit; Iz_sea vs longdouble oracle "
            f"{grid['vs_oracle']} (bound {ORACLE_ATOL:g}); max|norm-1| {grid['norm_dev']:.2e}; "
            f"aggregate + stable region {grid['aggregate_s']:.3f} s ({grid['n_points']} points, "
            f"best region {grid['best_region']}); reprocess (windows 0 and 35) + exponential "
            f"{grid['reprocess_s']:.3f} s, window 0 equal to each summary.json, exponential "
            f"statuses {grid['exponential_statuses']}; launches {grid['launches']}")
        expm.pop("named")
        expm.pop("t")
        say(json.dumps({"solvers": {"expm": expm, "dopri": dop, "labframe": lab,
                                    "ozaki_n12": oz, "limb_n13": lt, "grid2d": grid}}))

        # ---- phase G: the parallel slice at world size 1 over NCCL ----
        g = phase_g(tmp, smi, tr64, tr32, grid.pop("dirs"), kry_rows, model, lam, f64["rows"],
                    ext_rows_n12, oz["norm_dev"])
        launches_g1 = g["G1"]["eig32"]["launches"]["cmatmul_f32"]
        say(json.dumps({"parallel": g}))
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
            "launches": launches_eig32["cmatmul_f32"] + launches_g1,
            "launches_by_path": {"eig32 sweep (phase 8)": launches_eig32["cmatmul_f32"],
                                 "dp-sharded eig32 sweep (phase G1)": launches_g1},
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
            "launches": n12["launches"]["ext_obs"],
            "max_abs_err": max(r["max_abs_err"] for k, r in obs.items() if k[1] <= 8192),
            "ms": at_path["ms"],
            "kernel_ms": at_path["ms"],
            "plain_ms": at_path["plain_ms"],
            "bound_ms": at_path["bound_ms"],
            "bound_by": at_path["bound_by"],
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes the per-site limb-pair sums",
            "timing": "ms, simt_ms: device time per call (CUDA-graph replay, the better of two "
                      "turns); call_ms: one eager call under CUDA events (host work included); "
                      "plain_ms: eager",
            "call_ms": at_path["call_ms"],
            "simt_ms": at_path["simt_ms"],
            "simt_source": EXT_OBS_SIMT_SRC,
            "bounds_ms": {"bytes_at_hbm": at_path["bytes_ms"],
                          "int8_tensor_cores": at_path["int8_tensor_core_ms"],
                          "int32_cuda_cores": at_path["int32_cuda_core_ms"],
                          "dp4a": at_path["dp4a_ms"]},
            "shapes": {str(k): v for k, v in obs.items() if k[1] <= 8192},
            "n12": n12,
        },
        {
            "name": "ext_obs_diagonals_int8 (dim 16384)",
            "route": "cuda",
            "source": "quantumsimulations_tpu_torch/csrc/ext_obs_diagonals.cu",
            "replaces": "quantumsimulations_tpu/ops/pallas_kernels.py:200",
            "launches": launches_16384,
            "unit": "the launches of phase 5 at dim 16384 (the smoke runs no n13 ext evolution; "
                    "the route launches the path once per n13 evolution)",
            "max_abs_err": max(r["max_abs_err"] for k, r in obs.items() if k[1] == 16384),
            "ms": at_16384["ms"],
            "kernel_ms": at_16384["ms"],
            "plain_ms": at_16384["plain_ms"],
            "bound_ms": at_16384["bound_ms"],
            "bound_by": at_16384["bound_by"],
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes the per-site limb-pair sums",
            "timing": "as the row above",
            "call_ms": at_16384["call_ms"],
            "simt_ms": at_16384["simt_ms"],
            "bounds_ms": {"bytes_at_hbm": at_16384["bytes_ms"],
                          "int8_tensor_cores": at_16384["int8_tensor_core_ms"],
                          "int32_cuda_cores": at_16384["int32_cuda_core_ms"],
                          "dp4a": at_16384["dp4a_ms"]},
            "shapes": {str(k): v for k, v in obs.items() if k[1] == 16384},
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
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes the square sum and the "
                            "signed reduction",
            "timing": "ms, plain_ms, yardsticks: device time per call (CUDA-graph replay, "
                      "warm L2); cold_ms: one call after a 512 MB read; call_ms: one eager "
                      "call under CUDA events (host work included)",
            "call_ms": zp["call_ms"],
            "cold_ms": zp["cold_ms"],
            "yardsticks_ms": {"chain": zp["yardsticks_ms"]["chain"],
                              "matmul_on_p2": zp["yardsticks_ms"]["matmul_on_p2"],
                              "note": "chain: torch.matmul(signs32, (re*re + im*im).to(float32)), "
                                      "the same function summed in float32; matmul_on_p2: the "
                                      "same matmul on a |psi|^2 computed beforehand, which "
                                      "leaves out the square sum"},
            "shapes": {str(k): v for k, v in zexp.items()},
            "n13_chebyshev": {k: v for k, v in cheb.items() if k != "zexp"},
            "n12_krylov": kry,
        },
    ]
    kernels.append({
        "name": "int8_gemm",
        "route": "cuda",
        "source": "quantumsimulations_tpu_torch/csrc/int8_gemm.cu",
        "replaces": "none: the JAX package's limb products are XLA dots (s8 x s8 -> s32)",
        "launches": n12["launches"]["int8_gemm"],
        "max_abs_err": 0,
        "ms": gemm_path["ms"],
        "kernel_ms": gemm_path["ms"],
        "plain_ms": None,
        "bound_ms": gemm_path["bound_ms"],
        "bound_by": gemm_path["bound_by"],
        "library_ms": gemm_path["library_ms"],
        "library_call": "torch._int_mm on K-contiguous operands (cuBLASLt); the port never "
                        "calls it on the card",
        "timing": "ms, library_ms: device time per call (CUDA-graph replay); call_ms: one eager "
                  "call under CUDA events (host work included)",
        "call_ms": gemm_path["call_ms"],
        "shapes": {str(k): v for k, v in gemm.items()},
    })
    kernels.append({
        "name": "ext_carry",
        "route": "cuda",
        "source": "quantumsimulations_tpu_torch/csrc/ext_carry.cu",
        "replaces": "none: the JAX package carries the ext digits with XLA element-wise programs",
        "launches": n12["launches"]["ext_carry"],
        "max_abs_err": 0,
        "ms": carry_path["ms"],
        "kernel_ms": carry_path["ms"],
        "plain_ms": carry_path["plain_ms"],
        "bound_ms": carry_path["bound_ms"],
        "bound_by": carry_path["bound_by"],
        "library_ms": None,
        "library_call": "none: no single PyTorch call forms the Karatsuba digits and carries them",
        "timing": "ms: device time per call (CUDA-graph replay); plain_ms, call_ms: one eager "
                  "call under CUDA events (host work included)",
        "call_ms": carry_path["call_ms"],
        "shapes": {str(k): v for k, v in carry.items()},
    })
    say(f"[20/20] total {time.perf_counter() - t_start:.1f} s; kernels:")
    say(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
