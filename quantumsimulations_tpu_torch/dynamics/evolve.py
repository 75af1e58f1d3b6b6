"""Top-level evolution API: reference-compatible `simulate_rare`.

Returns ``(t, traces)`` with the exact key set the reference's solver wrapper
produces (dipolar_ensemble_with_rare.py:611-680): Ix/Iy/Iz_sea, Iz/Ix/Iy_R
(real expectation traces) and state_norm.

Solver dispatch (params.solver_method) in this port:
  * "eig"   — dense eigendecomposition propagator (exact), complex128.
  * "eig32" — the same with the product in the float32 fused complex-matmul
              kernel (~1e-5 accuracy).
  * "auto"  — "eig" up to dim 2048, as in the JAX package.

The JAX package's other solvers are not ported yet; asking for one (or for
"auto" above dim 2048, where the JAX package picks "ext" or "cheb_step")
raises NotImplementedError naming the ROADMAP.md item that will port it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.dipolar import build_model
from ..models.params import DipolarRareParams
from .eig_propagator import (
    eig_traces_assembled_batched,
    eig_traces_assembled_batched32,
    eigh_host,
    traces_dict,
)

_EIG_MAX_DIM = 2048  # host eigh is cheap up to here (seconds on one core)
_EXT_MAX_DIM = 8192  # the JAX package's dense ext limb chain reaches this far

#: where each solver of the JAX package is scheduled to be ported
_NOT_PORTED = {
    "cheb_step": "ROADMAP.md queue 1 item 5 (beyond-dense stepping)",
    "ext": "ROADMAP.md queue 1 item 6 (dense exact-limb chain)",
    "expm": "ROADMAP.md queue 1 item 7 (other solvers)",
    "krylov": "ROADMAP.md queue 1 item 7 (other solvers)",
    "chebyshev": "ROADMAP.md queue 1 item 7 (other solvers)",
    "dopri": "ROADMAP.md queue 1 item 7 (other solvers)",
}


def _auto_method(dim: int) -> str:
    if dim <= _EIG_MAX_DIM:
        return "eig"
    if dim <= _EXT_MAX_DIM:
        return "ext"
    return "cheb_step"


def check_method(method: str) -> None:
    """Raise for a solver this port does not run yet (or does not know)."""
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"solver_method {method!r} is not ported to PyTorch yet: {_NOT_PORTED[method]}"
        )
    if method not in ("eig", "eig32"):
        raise ValueError(f"unknown solver_method: {method!r}")


def simulate_rare(
    params: DipolarRareParams, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Run one time evolution; reference-compatible signature and outputs."""
    if params.steps < 2 or params.t_final <= 0.0:
        raise ValueError("Bad time grid: steps >= 2 and t_final > 0.")

    model = build_model(params)
    t = np.linspace(0.0, params.t_final, params.steps)
    dims = model.dims
    dim = int(np.prod(dims))

    method = params.solver_method
    if method == "auto":
        method = _auto_method(dim)
    check_method(method)

    w, V = eigh_host(model.hamiltonian.to_dense())
    fn = eig_traces_assembled_batched32 if method == "eig32" else eig_traces_assembled_batched
    rows = fn(
        w[None], V[None], model.psi0[None], t, dims,
        np.asarray([model.n_sea_effective]), model.idx_rare, device=device,
    )
    named = traces_dict(rows[0])
    named.pop("energy", None)
    return t, named
