"""Top-level evolution API: reference-compatible `simulate_rare`.

Returns ``(t, traces)`` with the exact key set the reference's solver wrapper
produces (dipolar_ensemble_with_rare.py:611-680): Ix/Iy/Iz_sea, Iz/Ix/Iy_R
(real expectation traces) and state_norm.

Solver dispatch (params.solver_method) in this port:
  * "eig"   — dense eigendecomposition propagator (exact), complex128.
  * "eig32" — the same with the product in the float32 fused complex-matmul
              kernel (~1e-5 accuracy).
  * "ext"   — the dense exact-limb step-operator chain
              (expm_propagator.expm_traces_assembled_ext).
  * "cheb_step" — the split-matmul Chebyshev stepper (cheb_step.py), at its
              default arithmetic tier ("f64" on cuda and cpu).
  * "krylov" — matrix-free Lanczos stepping (krylov.py).
  * "chebyshev" — one matrix-free global Chebyshev basis sweep for all
              output times (chebyshev.py).
  * "expm"  — the dense step operator by Taylor + scaling and squaring:
              complex128 matmuls (expm_propagator.expm_propagate_traces),
              or, at dim >= 2048 on cuda, the same chain on float64-accurate
              int8 limb products (expm_traces_assembled_ozaki), as the JAX
              package routes it off its CPU backend.
  * "dopri" — adaptive Dormand–Prince (dopri.py), honoring
              solver_atol / solver_rtol (defaults 1e-10 / 1e-9).
  * "auto"  — as in the JAX package: "eig" up to dim 2048, "ext" up to dim
              8192, "cheb_step" above.

Every solver of the JAX package's ``simulate_rare`` runs here.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..models.dipolar import build_model
from ..models.params import DipolarRareParams
from ..utils.device import resolve_device
from ..utils.profiling import tracing
from .eig_propagator import (
    eig_traces_assembled_batched,
    eig_traces_assembled_batched32,
    eigh_host,
    traces_dict,
)
from .observables import assemble_traces

_EIG_MAX_DIM = 2048  # host eigh is cheap up to here (seconds on one core)
_EXT_MAX_DIM = 8192  # the JAX package's dense ext limb chain reaches this far

#: the solvers this port runs: every solver of the JAX package
PORTED = ("eig", "eig32", "ext", "cheb_step", "krylov", "chebyshev", "expm", "dopri")


def _auto_method(dim: int) -> str:
    if dim <= _EIG_MAX_DIM:
        return "eig"
    if dim <= _EXT_MAX_DIM:
        return "ext"
    return "cheb_step"


def check_method(method: str) -> None:
    """Raise for a solver this port does not know; "auto" resolves to a
    ported solver at every dim."""
    if method not in PORTED and method != "auto":
        raise ValueError(f"unknown solver_method: {method!r}")


def simulate_rare(
    params: DipolarRareParams, device: str | torch.device = "cuda", timer=None
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Run one time evolution; reference-compatible signature and outputs.

    Port-only parameters: ``device`` (default "cuda"; raises without CUDA)
    and ``timer``, a :class:`..utils.profiling.StageTimer` handed to the
    stepping routes ("ext", "cheb_step", the Ozaki "expm") for their stage
    split.  With a timer the model build is its stage "build_model", and the
    timer is the active tracer of the whole evolution (the int8 GEMMs' launch
    spans and counters, ``ops/extprec.py::int_mm``)."""
    if params.steps < 2 or params.t_final <= 0.0:
        raise ValueError("Bad time grid: steps >= 2 and t_final > 0.")

    with tracing(timer):
        with timer.stage("build_model") if timer is not None else contextlib.nullcontext():
            model = build_model(params)
        return _solve(params, model, device, timer)


def _solve(params: DipolarRareParams, model, device, timer):
    """:func:`simulate_rare` on a built model: the solver dispatch."""
    t = np.linspace(0.0, params.t_final, params.steps)
    dims = model.dims
    dim = int(np.prod(dims))

    method = params.solver_method
    if method == "auto":
        method = _auto_method(dim)
    check_method(method)

    if method == "cheb_step":
        from .cheb_step import chebyshev_step_traces

        rows = chebyshev_step_traces(
            model.hamiltonian, model.psi0, t, dims,
            model.n_sea_effective, model.idx_rare, device=device, timer=timer,
        )
        named = traces_dict(rows)
        named.pop("energy", None)
        return t, named
    if method == "krylov":
        from .krylov import krylov_traces_assembled

        rows = krylov_traces_assembled(
            model.hamiltonian, model.psi0, t, dims,
            model.n_sea_effective, model.idx_rare, device=device,
        )
        named = traces_dict(rows)
        named.pop("energy", None)
        return t, named
    if method == "chebyshev":
        from .chebyshev import chebyshev_traces_assembled

        rows = chebyshev_traces_assembled(
            model.hamiltonian, model.psi0, t, dims,
            model.n_sea_effective, model.idx_rare, device=device,
        )
        named = traces_dict(rows)
        named.pop("energy", None)
        return t, named
    if method == "expm":
        from .expm_propagator import expm_propagate_traces, expm_traces_assembled_ozaki

        if dim >= 2048 and resolve_device(device).type != "cpu":
            # the JAX package's route off its CPU backend: a limb-product
            # step operator
            rows = expm_traces_assembled_ozaki(
                model.hamiltonian, model.psi0, t, dims,
                model.n_sea_effective, model.idx_rare, device=device, timer=timer,
            )
            named = traces_dict(rows)
            named.pop("energy", None)
            return t, named
        out = expm_propagate_traces(model.hamiltonian, model.psi0, t, dims, device=device)
        return t, assemble_traces(out["site_xyz"], out["norm"], model.n_sea_effective,
                                  model.idx_rare)
    if method == "dopri":
        from .dopri import dopri_propagate_traces

        out = dopri_propagate_traces(
            model.hamiltonian, model.psi0, t, dims,
            atol=params.solver_atol or 1e-10, rtol=params.solver_rtol or 1e-9, device=device,
        )
        return t, assemble_traces(out["site_xyz"], out["norm"], model.n_sea_effective,
                                  model.idx_rare)
    if method == "ext":
        # parity-grade dense step operator: a Taylor + squaring chain of
        # exact integer limb products; only the 75-bit truncation is
        # amplified across the squarings
        from .expm_propagator import expm_traces_assembled_ext

        rows = expm_traces_assembled_ext(
            model.hamiltonian, model.psi0, t, dims,
            model.n_sea_effective, model.idx_rare, device=device, timer=timer,
        )
        named = traces_dict(rows)
        named.pop("energy", None)
        return t, named

    w, V = eigh_host(model.hamiltonian.to_dense())
    fn = eig_traces_assembled_batched32 if method == "eig32" else eig_traces_assembled_batched
    rows = fn(
        w[None], V[None], model.psi0[None], t, dims,
        np.asarray([model.n_sea_effective]), model.idx_rare, device=device,
    )
    named = traces_dict(rows[0])
    named.pop("energy", None)
    return t, named
