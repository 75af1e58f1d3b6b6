"""Adaptive Dormand–Prince (DoPri5) Schrödinger integrator.

Port of ``quantumsimulations_tpu/dynamics/dopri.py``: the general path for
time-dependent Hamiltonians — the lab-frame cosine-drive form

    H(t) = H0 + sum_k f_k(t) * V_k

that QuTiP would express as ``sesolve([H0, [V, 'cos(w t)']])`` — and an
in-framework cross-check of the exact steppers at the reference's
tolerances (atol=1e-10 / rtol=1e-9, sweep_sea_detuning.py:1247-1250).

The embedded 5(4) pair, the initial-step heuristic, the PI step-size
controller, the NaN-as-reject rule, the floor on h and the 20,000,000-step
budget, and Hairer's 4th-order dense output are the JAX package's.  Where
the JAX package runs one ``lax.while_loop`` on the device, the port runs a
Python loop: each attempted step is eager PyTorch on the chosen device (six
right-hand sides of H psi, the stage sums and the error norm), and the
error norm comes to the host once per step, where the controller runs in
Python floats in the JAX package's order.  The state is a complex128
tensor; the right-hand side is -i H(t) psi with H psi from
``krylov.default_matrix_free_apply`` (the qubit flip apply where the
operator allows it, else ``OperatorSum.apply``), so it agrees with the JAX
package's term-by-term apply to float64 rounding and the step sequences
coincide except where an error norm falls within rounding of a decision.

The coefficient functions ``f_k`` are plain Python callables of a float t
(``math.cos``), evaluated on the host once per stage.

Output states are recorded by dense output as steps pass the output grid,
collected on the device and reduced to observables in batches.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.embed import OperatorSum
from ..utils.device import resolve_device
from .krylov import default_matrix_free_apply
from .observables import site_xyz_expectations, state_norms

# Dormand–Prince 5(4) tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = _A[6, :7].copy()  # 5th-order solution (FSAL)
_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40])
# Hairer's contd5 dense-output coefficients
_D = np.array([
    -12715105075.0 / 11282082432.0,
    0.0,
    87487479700.0 / 32700410799.0,
    -10690763975.0 / 1880347072.0,
    701980252875.0 / 199316789632.0,
    -1453857185.0 / 822651844.0,
    69997945.0 / 29380423.0,
])
_MAX_STEPS = 20_000_000
#: output states reduced to observables per batch
_RECORD_BATCH = 512


class TimeDependentHamiltonian:
    """H(t) = H0 + sum_k f_k(t) V_k with OperatorSum pieces.

    ``pieces`` are (V_k, f_k) pairs; ``f_k`` is a Python callable of a
    float t returning a float (e.g. ``lambda t: math.cos(w * t)``); the
    QuTiP-style [H0, [V, cos]] list maps directly."""

    def __init__(self, H0: OperatorSum, pieces: Sequence[tuple[OperatorSum, Callable]] = ()):
        self.H0 = H0
        self.pieces = tuple(pieces)
        self._applies: dict = {}

    def _ops(self, device: torch.device):
        ops = self._applies.get(device)
        if ops is None:
            ops = self._applies[device] = (
                default_matrix_free_apply(self.H0, device=device),
                [(default_matrix_free_apply(V, device=device), fn) for V, fn in self.pieces],
            )
        return ops

    def apply(self, psi: torch.Tensor, t: float) -> torch.Tensor:
        """H(t) @ psi for a complex128 (dim,) tensor."""
        h0, pieces = self._ops(psi.device)
        out = h0(psi)
        for v, fn in pieces:
            out = out + v(psi) * float(fn(t))
        return out


def _rhs_factory(H, device) -> Callable:
    """psi' = -i H(t) psi."""
    if isinstance(H, OperatorSum):
        apply_h0 = default_matrix_free_apply(H, device=device)

        def apply_h(psi, t):
            return apply_h0(psi)
    else:
        apply_h = H.apply

    def rhs(psi: torch.Tensor, t: float) -> torch.Tensor:
        # -i * (re + i im) = im - i re: the product's terms with the zero
        # real part of -i are exact zeros, so this is an exact swap and sign
        return apply_h(psi, t) * -1j

    return rhs


def _sum_abs2(x: torch.Tensor) -> torch.Tensor:
    return (x.real * x.real + x.imag * x.imag).sum()


def _dopri_integrate(psi0: torch.Tensor, t_out: np.ndarray, atol: float, rtol: float,
                     max_step: float, rhs, dims, n_out: int):
    """(site_xyz (n_out, n, 3), norm (n_out,), n_accepted, n_rejected)."""
    dev = psi0.device
    dim = psi0.shape[0]
    t0 = float(t_out[0])
    t_end = float(t_out[-1])

    k0 = rhs(psi0, t0)
    # initial step heuristic
    d0 = math.sqrt(float(_sum_abs2(psi0)) / dim)
    d1 = math.sqrt(float(_sum_abs2(k0)) / dim)
    h0 = 0.01 * d0 / max(d1, 1e-300) if d1 > 1e-12 else 1e-6
    h0 = min(min(h0, max_step), t_end - t0)

    def coeffs(row):
        return torch.as_tensor(row, dtype=torch.complex128, device=dev)

    A = [coeffs(row[:i]) for i, row in enumerate(_A)]
    B5, B4, D = coeffs(_B5), coeffs(_B4), coeffs(_D)
    C = [float(c) for c in _C]

    def attempt_step(psi, t, h, k_first):
        ks = torch.empty((7, dim), dtype=psi.dtype, device=dev)
        ks[0] = k_first
        for i in range(1, 7):
            yi = psi + h * (A[i] @ ks[:i])
            ks[i] = rhs(yi, t + C[i] * h)
        y5 = psi + h * (B5 @ ks)
        y4 = psi + h * (B4 @ ks)
        err_v = y5 - y4
        sc = atol + rtol * torch.sqrt(torch.maximum(psi.real ** 2 + psi.imag ** 2,
                                                    y5.real ** 2 + y5.imag ** 2))
        err = math.sqrt(float(((err_v.real ** 2 + err_v.imag ** 2) / sc ** 2).mean()))
        # a NaN error (diverging state, overflowing coefficient function)
        # must act as a hard reject, not poison the controller
        if not math.isfinite(err):
            err = math.inf
        return y5, err, ks  # FSAL: ks[6] = f(t+h, y5)

    out_xyz = np.zeros((n_out, len(dims), 3))
    out_norm = np.zeros(n_out)
    pending: list[tuple[int, torch.Tensor]] = []

    def flush():
        if pending:
            idx = [i for i, _ in pending]
            S = torch.stack([p for _, p in pending], dim=1)  # (dim, n)
            out_xyz[idx] = site_xyz_expectations(S, dims).permute(2, 0, 1).cpu().numpy()
            out_norm[idx] = state_norms(S).cpu().numpy()
            pending.clear()

    def record(idx, psi):
        pending.append((idx, psi))
        if len(pending) >= _RECORD_BATCH:
            flush()

    record(0, psi0)
    h_floor = max((t_end - t0) * 1e-15, 1e-300)
    t, psi, h, k = t0, psi0, h0, k0
    out_idx, n_acc, n_rej = 1, 0, 0
    # guards against step-size collapse (incompatible frequencies, NaN
    # divergence): once h shrinks to the floor or the step budget runs out,
    # the loop exits; the unfilled tail of the trace stays at zero with
    # n_accepted/n_rejected exposing the stall
    while out_idx < n_out and t < t_end and h > h_floor and n_acc + n_rej < _MAX_STEPS:
        h = min(h, t_end - t)
        y_new, err, ks = attempt_step(psi, t, h, k)
        accept = err <= 1.0
        # PI controller
        fac = min(max(0.9 * max(err, 1e-16) ** -0.2, 0.2), 5.0)
        h_next = min(h * fac, max_step)
        if accept:
            # DOPRI5 4th-order dense output (Hairer's contd5): matches the
            # solution order between accepted steps, so output sampling
            # never degrades the tolerance
            r1 = psi
            r2 = y_new - psi
            r3 = h * ks[0] - r2
            r4 = r2 - h * ks[6] - r3
            r5 = h * (D @ ks)
            while out_idx < n_out and t_out[out_idx] <= t + h + 1e-300:
                th = (float(t_out[out_idx]) - t) / h
                th1 = 1.0 - th
                record(out_idx, r1 + th * (r2 + th1 * (r3 + th * (r4 + th1 * r5))))
                out_idx += 1
            t = t + h
            psi = y_new
            k = ks[6].clone()
            n_acc += 1
        else:
            n_rej += 1
        h = h_next
    flush()
    return out_xyz, out_norm, n_acc, n_rej


def dopri_propagate_traces(
    H,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    atol: float = 1e-10,
    rtol: float = 1e-9,
    max_step: float | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Adaptive-step traces; H may be an OperatorSum or a
    TimeDependentHamiltonian.  Returns site_xyz (n, 3, T), norm (T,),
    n_accepted, n_rejected, and energy (T,) for a time-independent H only.

    Port-only parameter: ``device`` (default "cuda"; raises without CUDA)."""
    dev = resolve_device(device)
    times = np.asarray(times, dtype=np.float64)
    rhs = _rhs_factory(H, dev)
    if max_step is None:
        max_step = float(times[-1] - times[0])
    p0 = torch.as_tensor(np.asarray(psi0), dtype=torch.complex128, device=dev)
    out_xyz, out_norm, n_acc, n_rej = _dopri_integrate(
        p0, times, float(atol), float(rtol), float(max_step), rhs, dims, len(times))
    result = {
        "site_xyz": np.moveaxis(out_xyz, 0, -1),  # (n, 3, T)
        "norm": out_norm,
        "n_accepted": int(n_acc),
        "n_rejected": int(n_rej),
    }
    # energy trace only defined for time-independent H
    if isinstance(H, OperatorSum):
        e0 = float(torch.vdot(p0, H.apply(p0)).real)
        result["energy"] = np.full(len(times), e0)
    return result
