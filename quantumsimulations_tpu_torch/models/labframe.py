"""Lab-frame cosine-drive Hamiltonian (time-dependent path).

Port of ``quantumsimulations_tpu/models/labframe.py``.  The production
rotating-frame model (models/dipolar.py) is the RWA of this lab-frame form:

    H(t) = sum_j omega_z^(j) Iz_j                    (full Zeeman, not detuning)
         + 2*omega1_A cos(omega_rf_A t + phi_A) * sum_sea Ix_j
         + 2*omega1_R cos(omega_rf_R t + phi_R) * Ix_R
         + H_dipolar (secular, as in the rotating frame)

It maps onto :class:`~quantumsimulations_tpu_torch.dynamics.dopri.
TimeDependentHamiltonian` pieces and integrates with the adaptive DoPri
stepper.  The factor 2 on omega1 makes the co-rotating RWA component match
the rotating-frame drive amplitude (standard linear-drive convention).  The
drive coefficients are ``math.cos`` of a float t, evaluated on the host.

Lab-frame integration must resolve the Larmor frequency (~MHz-GHz), so it is
reserved for RWA-validity studies and short horizons; production sweeps use
the exact rotating-frame propagators.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..dynamics.dopri import TimeDependentHamiltonian
from ..ops.embed import OperatorSum, ProductTerm
from .dipolar import build_hamiltonian_terms
from .params import DipolarRareParams, get_derived_frequencies


def build_lab_frame_model(params: DipolarRareParams):
    """(TimeDependentHamiltonian, freqs) for the lab-frame cosine-drive form."""
    n_sea = params.n_sea
    idx_rare = n_sea
    dims = params.hilbert_dims()
    n_sea_eff = n_sea + 1 if not params.is_center_rare else n_sea

    freqs = get_derived_frequencies(params)

    # static part: full Zeeman + the same secular dipolar network the
    # rotating-frame builder produces (drives/detunings excluded)
    static_params = dataclasses.replace(params, drive_sea=False, drive_rare=False)
    H_dip, _meta = build_hamiltonian_terms(static_params)

    zeeman_terms = [ProductTerm(freqs["omega_Az"], ((j, "z"),)) for j in range(n_sea_eff)]
    if params.is_center_rare:
        zeeman_terms.append(ProductTerm(freqs["omega_Rz"], ((idx_rare, "z"),)))
    else:
        zeeman_terms.append(ProductTerm(freqs["omega_Az"], ((idx_rare, "z"),)))
    H0 = OperatorSum(dims, tuple(zeeman_terms) + H_dip.terms)

    pieces = []
    if params.drive_sea and freqs["omega1_sea"] != 0.0:
        V_sea = OperatorSum(
            dims,
            tuple(ProductTerm(2.0 * freqs["omega1_sea"], ((j, "x"),)) for j in range(n_sea_eff)),
        )
        w_rf, phi = freqs["omega_rf_sea"], params.phi_sea
        pieces.append((V_sea, lambda t, w=w_rf, p=phi: math.cos(w * t + p)))
    if params.is_center_rare and params.drive_rare and freqs["omega1_rare"] != 0.0:
        V_rare = OperatorSum(dims, (ProductTerm(2.0 * freqs["omega1_rare"], ((idx_rare, "x"),)),))
        w_rf, phi = freqs["omega_rf_rare"], params.phi_rare
        pieces.append((V_rare, lambda t, w=w_rf, p=phi: math.cos(w * t + p)))

    return TimeDependentHamiltonian(H0, pieces), freqs


def simulate_lab_frame(
    params: DipolarRareParams,
    atol: float | None = None,
    rtol: float | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Lab-frame evolution with the adaptive stepper; reference-named traces.

    Port-only parameter: ``device`` (default "cuda"; raises without CUDA)."""
    from ..dynamics.dopri import dopri_propagate_traces
    from ..dynamics.observables import assemble_traces
    from .dipolar import build_model

    model = build_model(params)  # reuses geometry/initial state/metadata
    Ht, _freqs = build_lab_frame_model(params)
    t = np.linspace(0.0, params.t_final, params.steps)
    out = dopri_propagate_traces(
        Ht,
        model.psi0,
        t,
        model.dims,
        atol=atol or params.solver_atol or 1e-10,
        rtol=rtol or params.solver_rtol or 1e-9,
        device=device,
    )
    traces = assemble_traces(out["site_xyz"], out["norm"], model.n_sea_effective, model.idx_rare)
    return t, traces
