"""Chebyshev STEPPING propagator on the split-matmul apply — the engine
beyond dense reach (n_sea >= 13, Hilbert dim >= 16384).

Port of ``quantumsimulations_tpu/dynamics/cheb_step.py``.  Per output
interval dt the new state is one truncated Chebyshev expansion

    psi(t + dt) = sum_{k<K} c_k(lambda dt) T_k(H / lambda) psi(t),
    c_k(x) = (2 - delta_k0) (-i)^k J_k(x)

evaluated by the three-term recurrence with the accumulator folded in, so a
trace is T restarted sweeps of K ~ lambda*dt terms each; the working set is
a few (DL, DR) planes whatever T is.

Where the JAX package runs a jitted ``scan`` over steps and a ``fori_loop``
over terms, the port runs Python loops of eager PyTorch operations on the
chosen device; the statevector travels as one (2, DL, DR) float64 tensor
holding both planes.  Arithmetic tiers (``arithmetic=``):

  * ``"f64"`` — the float64 split apply (ops/split_apply.py, cuBLAS DGEMM on
    the card); the default on ``cuda`` and ``cpu``, as the JAX package's
    default is ``"f64"`` on its ``gpu`` and ``cpu`` backends;
  * ``"ext"`` — the recurrence kept in the fixed-grid limb domain, each
    product digit one exact int8 GEMM (ops/split_apply_ext.py,
    ``ops/extprec.py::diagonal_mm``: the int8 GEMM kernel on the card);
  * ``"extp"`` — the same limb domain with every product through the
    hand-written CUDA kernel ``limb_matmul_canon`` (ops/limb_kernels.py);
  * ``"limb"`` — the float64 recurrence with every apply product an exact
    int8 limb product of the Ozaki tier (ops/split_apply_limb.py, 9 limbs
    of 6 bits, ``ops/extprec.py::int_mm``: the int8 GEMM kernel on the
    card).

Each dispatch (``steps_per_dispatch`` output steps: the host loop's chunk
between row fetches and checkpoints) stacks its pre-advance states and turns
them into assembled rows in one batched observable pass.  With ``ckpt_dir``
the exact (psi, rows) are snapshotted at dispatch boundaries (the JAX
package's NPZ scheme, dynamics/checkpoint.py), so a rerun with the same
arguments resumes bit-identically; a stop file (``CooperativeStop``) makes a
long run checkpoint and yield.

Replaces qt.sesolve (reference: dipolar_ensemble_with_rare.py:653-666) at
bath sizes beyond dense reach.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..ops.embed import OperatorSum
from ..ops.split_apply import make_split_apply
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer
from .chebyshev import chebyshev_coefficients
from .observables import assembled_rows

class CooperativeStop(RuntimeError):
    """Raised when a stop file asked a long trace to yield the device.

    The state/rows checkpoint for the current progress is already on disk
    when this is raised (given ``ckpt_dir``), so a rerun with the same
    arguments resumes losslessly.
    """


def _stop_file() -> str:
    """Path of the cooperative stop flag (env QST_STOP_FILE overrides).

    The default lives at the repository root next to the packages, the
    same file the JAX package watches."""
    env = os.environ.get("QST_STOP_FILE")
    if env:
        return env
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(pkg_root, ".qst_stop")


def _lambda_bound(H: OperatorSum, dim: int) -> float:
    """Spectral bound for the Chebyshev scaling: min(triangle bound, inflated
    host power iteration).  The triangle bound is guaranteed but loose; the
    power iteration converges from below, so it is inflated 5% and the
    propagator's norm-drift row is the runtime guard.  Host numpy/scipy, the
    same operations as the JAX package, so the same lambda."""
    from .krylov import spectral_norm_bound

    bound = spectral_norm_bound(H)
    if dim >= 512:
        import scipy.sparse as sparse

        from .expm_propagator import _spectral_norm_host

        r, c, v = H.to_coo()
        Hs = sparse.csr_matrix((v, (r, c)), shape=(dim, dim))
        est = _spectral_norm_host(Hs, iters=60)  # includes the 5% inflation
        return float(min(bound, est))
    return float(bound)


def _rot(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """c * (i x) on stacked planes, c = (-ci, ci) as a (2, 1, 1) tensor:
    (-ci*x_im, ci*x_re), the same products as the JAX package's terms."""
    return x.flip(0) * c


def _step_coefficients(c_re: np.ndarray, c_im: np.ndarray, dev) -> tuple[list[float], torch.Tensor]:
    """One step's Chebyshev coefficients in the runs' form: the real parts
    as Python floats and the imaginary parts as a (K, 2, 1, 1) tensor
    (-c_im, c_im) for :func:`_rot`."""
    K = len(c_re)
    ci = torch.as_tensor(np.stack([-c_im, c_im], axis=1).reshape(K, 2, 1, 1),
                         dtype=torch.float64, device=dev)
    return [float(x) for x in c_re], ci


def _make_step_run(apply_stacked):
    """``run(P, n_steps, cr, ci) -> (P, states)``: advance n_steps output
    steps of the float64 tier, stacking each pre-advance state (n_steps, 2,
    DL, DR).  ``apply_stacked`` computes (H / lambda) @ psi on stacked
    planes; the coefficients (:func:`_step_coefficients`) come with every
    call, as the JAX package passes them to its cached run."""

    def run(P: torch.Tensor, n_steps: int, cr: list[float], ci: torch.Tensor):
        K = len(cr)
        states = torch.empty((n_steps,) + tuple(P.shape), dtype=P.dtype, device=P.device)
        for step in range(n_steps):
            states[step] = P
            # seed: T_0 = psi, T_1 = Ht psi
            h = apply_stacked(P)
            acc = P * cr[0] + _rot(P, ci[0])
            acc += h * cr[1]
            acc += _rot(h, ci[1])
            prev, cur = P, h
            for k in range(2, K):
                hh = apply_stacked(cur)
                nxt = hh * 2.0 - prev
                acc += nxt * cr[k]
                acc += _rot(nxt, ci[k])
                prev, cur = cur, nxt
            P = acc
        return P, states

    return run


def _make_step_run_ext(apply_stacked, grid_ops):
    """Limb-domain variant of :func:`_make_step_run`: the recurrence state
    circulates as canonical int8 limb stacks (L, 2, DL, DR), so the per-term
    elementwise work is int32 carries; only the accumulator lives in float64,
    fed by one grouped limb evaluation per term.  Same (float64 planes in,
    float64 planes out) contract as the f64 run — checkpoints and rows are
    tier-agnostic."""
    split, carry, val = grid_ops.split, grid_ops.carry, grid_ops.val

    def run(P: torch.Tensor, n_steps: int, cr: list[float], ci: torch.Tensor):
        K = len(cr)
        states = torch.empty((n_steps,) + tuple(P.shape), dtype=P.dtype, device=P.device)
        for step in range(n_steps):
            states[step] = P
            t0 = split(P)
            h = apply_stacked(t0)  # T_1, canonical limbs
            v1 = val(h)
            acc = P * cr[0] + _rot(P, ci[0])
            acc += v1 * cr[1]
            acc += _rot(v1, ci[1])
            prev, cur = t0, h
            for k in range(2, K):
                hh = apply_stacked(cur)
                # T_{k+1} = 2 * hh - T_{k-1}: exact digit arithmetic, one
                # carry (|values| <= 3 stays on the fixed grid)
                d = hh.to(torch.int32)
                d.mul_(2).sub_(prev)
                nxt = carry(d)
                v = val(nxt)
                acc += v * cr[k]
                acc += _rot(v, ci[k])
                prev, cur = cur, nxt
            P = acc
        return P, states

    return run


def _rows_of_stack(states: torch.Tensor, sea_mask: torch.Tensor, e0: float,
                   dims: tuple[int, ...], idx_rare: int) -> torch.Tensor:
    """(n_steps, 2, DL, DR) state stacks -> flat assembled rows (n_steps*8,)
    in chronological column order (TRACE_ROWS layout per step)."""
    ns = states.shape[0]
    flat = states.reshape(ns, 2, -1)
    S = torch.complex(flat[:, 0], flat[:, 1]).T  # (dim, n_steps)
    rows = assembled_rows(S, dims, sea_mask, idx_rare)
    rows = torch.cat([rows, torch.full_like(rows[:1], e0)])  # (8, n_steps)
    return rows.T.reshape(-1)


def _default_arith(device_type: str) -> str:
    """Default apply tier per device type: ``"f64"`` on ``cuda`` and
    ``cpu``, as the JAX package's ``_default_arith`` picks ``"f64"`` on its
    ``gpu`` and ``cpu`` backends (the limb tiers exist because its TPU
    emulates float64; the card has native float64).  QST_CHEB_ARITH and
    ``arithmetic=`` override."""
    if device_type in ("cuda", "cpu"):
        return "f64"
    raise ValueError(f"no default arithmetic tier for device type {device_type!r}")


_ENGINE_CACHE: dict = {}
_ENGINE_CACHE_MAX = 8


def clear_engine_cache() -> int:
    """Release every cached engine (operator device buffers, apply closures,
    step runs, and the strong H references that pin them).  Returns the
    number of entries released."""
    n = len(_ENGINE_CACHE)
    _ENGINE_CACHE.clear()
    return n


def _engine_for(H: OperatorSum, lam: float, arith: str, split: int | None, dev: torch.device):
    """Build (or reuse) the apply for one (H, lambda, tier, device) engine.

    Repeated calls on the same operator (warm-up then measure; multi-segment
    resumes) would otherwise redo the host split, the limb split of the
    operator planes and their upload.  Keyed by the H object's identity
    (entries hold a strong reference, so ids cannot be recycled while
    cached); bounded FIFO.
    """
    key = (id(H), float(lam), arith, split, str(dev))
    hit = _ENGINE_CACHE.get(key)
    if hit is not None and hit["H"] is H:
        return hit
    entry: dict = {"H": H}
    if arith in ("ext", "extp"):
        from ..ops import split_apply_ext as spx

        make = spx.make_ext_apply_pallas if arith == "extp" else spx.make_ext_apply
        apply_ext, so, grid_ops = make(H, split=split, scale=1.0 / lam, device=dev)

        def apply_ht(P: torch.Tensor) -> torch.Tensor:  # f64 facade (e0 only)
            return grid_ops.val(apply_ext.stacked(grid_ops.split(P)))

        entry.update(apply_ht=apply_ht, so=so,
                     run=_make_step_run_ext(apply_ext.stacked, grid_ops))
    elif arith == "limb":
        from ..ops.split_apply_limb import make_split_apply_limb

        apply_ht, so = make_split_apply_limb(H, split=split, scale=1.0 / lam, device=dev)
        entry.update(apply_ht=apply_ht.stacked, so=so, run=_make_step_run(apply_ht.stacked))
    elif arith == "f64":
        apply_ht, so = make_split_apply(H, split=split, scale=1.0 / lam, device=dev)
        entry.update(apply_ht=apply_ht.stacked, so=so, run=_make_step_run(apply_ht.stacked))
    else:
        raise ValueError(f"unknown arithmetic {arith!r} (use 'f64', 'limb', 'ext', or 'extp')")
    while len(_ENGINE_CACHE) >= _ENGINE_CACHE_MAX:
        _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
    _ENGINE_CACHE[key] = entry
    return entry


def _default_steps_per_dispatch(dim: int) -> int:
    """Steps per dispatch by Hilbert dim, the JAX package's table.

    There the table bounds each device program under the TPU worker's
    ~60 s crash limit (its docs/ROUND4.md fault record).  On the card a
    dispatch is only the host loop's chunk between row fetches and
    checkpoints, and no such watchdog exists; the table is kept so that the
    row-fetch cadence and the checkpoint fingerprints (which record it)
    match the JAX package's.  ``steps_per_dispatch`` or
    QST_CHEB_STEPS_PER_DISPATCH override it."""
    if dim <= 8192:
        return 64
    if dim <= 16384:
        return 8
    return 1


def chebyshev_step_traces(
    H: OperatorSum,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    n_sea_effective: int,
    idx_rare: int,
    split: int | None = None,
    norm_bound: float | None = None,
    steps_per_dispatch: int | None = None,
    ckpt_dir: str | None = None,
    progress: bool = False,
    arithmetic: str | None = None,
    device: str | torch.device = "cuda",
    timer: StageTimer | None = None,
) -> np.ndarray:
    """Assembled rows (8, T), TRACE_ROWS layout — same contract as
    eig_traces_assembled_batched.

    ``steps_per_dispatch`` sets how many output steps run between row
    fetches (default: :func:`_default_steps_per_dispatch`; env override
    QST_CHEB_STEPS_PER_DISPATCH); with ``ckpt_dir`` set, the exact state and
    the computed rows are snapshotted every QST_CHEB_CKPT_EVERY_DISPATCHES
    dispatches and a rerun with the same arguments resumes bit-identically.
    QST_CHEB_ABORT_AFTER_DISPATCHES aborts after that many (tests).

    ``arithmetic`` selects the apply's tier (env override QST_CHEB_ARITH;
    default :func:`_default_arith`): "f64", "limb", "ext" or "extp" (module
    docstring).  All tiers agree to float64 roundoff.

    Port-only parameters: ``device`` (default "cuda"; raises without CUDA)
    and ``timer``, a :class:`StageTimer` that, when given, receives the
    stages "lambda", "engine" (host split, limb split, upload), "e0",
    "stepping" and "rows" (each ending in a device synchronise).
    """
    dev = resolve_device(device)
    stage = timer.stage if timer is not None else (lambda name: contextlib.nullcontext())
    times = np.asarray(times)
    T = len(times)
    if T > 1:
        dts = np.diff(times)
        if not np.allclose(dts, dts[0], rtol=1e-9, atol=0.0):
            raise ValueError("chebyshev stepper requires a uniform time grid")
        dt = float(dts[0])
    else:
        dt = 0.0
    dim = int(np.prod(dims))

    with stage("lambda"):
        lam = float(norm_bound) if norm_bound is not None else _lambda_bound(H, dim)
    # coefficient row for ONE step; K ~ lam*dt + Bessel tail margin
    C = chebyshev_coefficients(lam, np.asarray([dt]))[0] if dt > 0.0 else np.ones(1)
    K = max(2, len(C))
    c_re = np.zeros(K)
    c_im = np.zeros(K)
    c_re[: len(C)] = np.real(C)
    c_im[: len(C)] = np.imag(C)

    arith = arithmetic or os.environ.get("QST_CHEB_ARITH") or _default_arith(dev.type)
    with stage("engine"):
        engine = _engine_for(H, lam, arith, split, dev)
    so = engine["so"]
    DL, DR = so.DL, so.DR

    spd = steps_per_dispatch or int(
        os.environ.get("QST_CHEB_STEPS_PER_DISPATCH", "0")
    ) or _default_steps_per_dispatch(dim)
    spd = max(1, min(spd, T))

    sea_mask = torch.as_tensor((np.arange(len(dims)) < n_sea_effective).astype(np.float64),
                               device=dev)
    psi0 = np.asarray(psi0)
    P0 = torch.as_tensor(
        np.stack([np.real(psi0), np.imag(psi0)]).reshape(2, DL, DR), dtype=torch.float64,
        device=dev,
    )
    with stage("e0"):
        h0 = engine["apply_ht"](P0)
        # <H> at t=0, conserved under the (unitary) propagation
        e0 = float(lam * float((P0 * h0).sum()))

    run = engine["run"]
    cr, ci = _step_coefficients(c_re, c_im, dev)

    done = 0
    flats: list[np.ndarray] = []
    P = P0

    ckpt_fp = None
    if ckpt_dir:
        from .checkpoint import clear_ext_advance, load_ext_advance, save_ext_advance

        ckpt_fp = {
            "engine": "cheb-step", "dim": dim, "T": T, "dt": dt,
            "K": K, "lam": lam, "spd": spd, "e0": e0,
            # tiers agree only to f64 roundoff; resume must not mix them
            # ("f64" omitted, as the JAX package omits it)
            **({"arith": arith} if arith != "f64" else {}),
        }
        res = load_ext_advance(ckpt_dir, ckpt_fp)
        if res is not None:
            done, flats, s_re_h, s_im_h = res
            P = torch.as_tensor(
                np.stack([np.asarray(s_re_h), np.asarray(s_im_h)]).reshape(2, DL, DR),
                dtype=torch.float64, device=dev,
            )
            if progress:
                print(f"[cheb-step] resume at step {done}/{T}", flush=True)

    abort_after = int(os.environ.get("QST_CHEB_ABORT_AFTER_DISPATCHES", "0"))
    # checkpoint cadence in dispatches: bounds the crash-loss window at N
    # dispatches while keeping the save cost small
    ckpt_every = max(1, int(os.environ.get("QST_CHEB_CKPT_EVERY_DISPATCHES", "1")))
    dispatches = 0
    saved_done = done

    def _save() -> None:
        nonlocal saved_done
        host = P.cpu().numpy()
        save_ext_advance(ckpt_dir, ckpt_fp, done, flats, host[0].reshape(-1), host[1].reshape(-1))
        saved_done = done

    t_start = time.perf_counter()
    while done < T:
        n = min(spd, T - done)
        with stage("stepping"):
            P, states = run(P, n, cr, ci)
        with stage("rows"):
            flat = _rows_of_stack(states, sea_mask, e0, dims, idx_rare)
            flats.append(flat.cpu().numpy())  # value fetch = sync point
        del states
        done += n
        dispatches += 1
        if ckpt_dir and done < T and dispatches % ckpt_every == 0:
            _save()
            if abort_after and dispatches >= abort_after:
                raise RuntimeError(
                    f"aborted after {dispatches} dispatches (QST_CHEB_ABORT_AFTER_DISPATCHES)"
                )
        if done < T and os.path.exists(_stop_file()):
            if ckpt_dir and saved_done < done:
                _save()  # cadence may have skipped this dispatch
            raise CooperativeStop(
                f"stop file {_stop_file()} present at step {done}/{T}"
                + ("" if ckpt_dir else " (no ckpt_dir: progress NOT saved)")
            )
        if progress:
            el = time.perf_counter() - t_start
            rate = done / el if el > 0 else 0.0
            print(f"[cheb-step] {done}/{T} steps ({K} terms/step), {el:.1f}s, "
                  f"{rate:.2f} steps/s", flush=True)
    if ckpt_dir:
        clear_ext_advance(ckpt_dir)
    rows = np.concatenate(flats).reshape(T, 8).T  # (8, T)
    return np.ascontiguousarray(rows)
