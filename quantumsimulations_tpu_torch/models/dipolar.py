"""Rotating-frame Hamiltonian of the dipolar sea + rare-spin ensemble.

Builds the term-IR Hamiltonian matching the reference construction
(dipolar_ensemble_with_rare.py:453-588) exactly:

  * Zeeman detunings, gated on drive flags and nonzero detuning (:504-512);
  * static RF drive terms  omega1 * (cos(phi) Sx + sin(phi) Sy)  (:515-528);
  * sea-sea homonuclear secular dipolar with the reference's nonstandard
    double-quantum transverse part  b_ij [IzIz - 1/4 (IxIx - IyIy)]  (:559-561);
  * sea-rare heteronuclear Ising  b_iR Iz_i Jz_R  (:563-568);
  * the ``is_center_rare=False`` control geometry where every site (including
    the center one) is a sea spin with full homonuclear couplings (:488-489,
    :533-545) — geometry unchanged, center site's gamma set to gamma_sea.

Unlike the reference, the spin-3/2 rare path is self-consistent here: the
rare site's local dimension follows ``is_spin_three_half`` whenever
``is_center_rare`` (see SURVEY.md §2.1 on the reference's latent dims
mismatch; the production mode — all spin-1/2 — is bit-identical in structure).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
import math

import numpy as np

from ..ops.embed import OperatorSum, ProductTerm
from ..ops.spin import eigenstate
from .geometry import dipolar_couplings_from_positions, shell_positions_with_rare_center
from .params import DipolarRareParams, get_derived_frequencies


@dataclass(frozen=True)
class ModelArrays:
    """Host-side model description for one simulation variant."""

    hamiltonian: OperatorSum
    dims: tuple[int, ...]
    n_sea_effective: int  # number of sites summed into the "sea" observables
    idx_rare: int
    positions: np.ndarray
    couplings: np.ndarray
    psi0: np.ndarray  # complex128 flat statevector


def build_hamiltonian_terms(params: DipolarRareParams) -> tuple[OperatorSum, dict]:
    """Construct the Hamiltonian IR and metadata (no dense assembly)."""
    n_sea = params.n_sea
    n_total = n_sea + 1
    idx_rare = n_sea
    dims = params.hilbert_dims()

    # Control geometry: every site (incl. the center) is a sea spin.
    n_sea_eff = n_total if not params.is_center_rare else n_sea

    freqs = get_derived_frequencies(params)
    omega1_sea = freqs["omega1_sea"]
    omega1_rare = freqs["omega1_rare"]
    delta_sea = freqs["delta_sea"]
    delta_rare = freqs["delta_rare"]

    terms: list[ProductTerm] = []

    # ---- Zeeman detunings (rotating frame) ----
    if params.drive_sea and delta_sea != 0.0:
        terms += [ProductTerm(delta_sea, ((j, "z"),)) for j in range(n_sea_eff)]
    if params.is_center_rare and params.drive_rare and delta_rare != 0.0:
        terms.append(ProductTerm(delta_rare, ((idx_rare, "z"),)))

    # ---- RF drives (static in this rotating frame) ----
    if params.drive_sea and omega1_sea != 0.0:
        cx = omega1_sea * math.cos(params.phi_sea)
        cy = omega1_sea * math.sin(params.phi_sea)
        terms += [ProductTerm(cx, ((j, "x"),)) for j in range(n_sea_eff)]
        terms += [ProductTerm(cy, ((j, "y"),)) for j in range(n_sea_eff)]
    if params.is_center_rare and params.drive_rare and omega1_rare != 0.0:
        terms.append(ProductTerm(omega1_rare * math.cos(params.phi_rare), ((idx_rare, "x"),)))
        terms.append(ProductTerm(omega1_rare * math.sin(params.phi_rare), ((idx_rare, "y"),)))

    # ---- Dipolar couplings from the (shell + center) geometry ----
    # The geometry is identical in both control modes: n_sea spins on the
    # shell plus the center site (reference :533-536 passes n_sea - 1 after
    # the n_sea -> n_total reassignment, i.e. the original n_sea).
    positions = shell_positions_with_rare_center(n_sea=n_sea, radius=params.shell_scale)
    if positions.shape != (n_total, 3):
        raise RuntimeError("Shell geometry returned unexpected number of sites.")
    b = dipolar_couplings_from_positions(
        positions,
        params.dipolar_scale,
        params.gamma_sea,
        params.gamma_rare if params.is_center_rare else params.gamma_sea,
    )

    for i, j in combinations(range(n_total), 2):
        bij = float(b[i, j])
        if i < n_sea_eff and j < n_sea_eff:
            # homonuclear secular dipolar; note the reference's minus between
            # the xx and yy parts (double-quantum), NOT the standard flip-flop.
            terms.append(ProductTerm(bij, ((i, "z"), (j, "z"))))
            terms.append(ProductTerm(-0.25 * bij, ((i, "x"), (j, "x"))))
            terms.append(ProductTerm(+0.25 * bij, ((i, "y"), (j, "y"))))
        elif i == idx_rare or j == idx_rare:
            sea_idx = i if j == idx_rare else j
            terms.append(ProductTerm(bij, tuple(sorted(((sea_idx, "z"), (idx_rare, "z"))))))

    H = OperatorSum(dims, tuple(terms))
    meta = {
        "freqs": freqs,
        "positions": positions,
        "couplings": b,
        "dims": dims,
        "n_sea_effective": n_sea_eff,
        "idx_rare": idx_rare,
    }
    return H, meta


def initial_state(params: DipolarRareParams) -> np.ndarray:
    """Product initial state (reference :591-606).

    Sea spins: z-axis eigenstate with sign ``init_x_sign``.
    Rare spin (when center is rare): z-axis eigenstate with the opposite sign,
    of the appropriate spin (|m=+3/2> style extremal state for spin-3/2).
    """
    sea_ket = eigenstate(0.5, "z", params.init_x_sign)
    kets = [sea_ket] * params.n_sea
    if params.is_center_rare:
        s_rare = 1.5 if params.is_spin_three_half else 0.5
        kets.append(eigenstate(s_rare, "z", -params.init_x_sign))
    else:
        kets.append(sea_ket)
    psi = kets[0]
    for k in kets[1:]:
        psi = np.kron(psi, k)
    return psi.astype(np.complex128)


def build_model(params: DipolarRareParams) -> ModelArrays:
    H, meta = build_hamiltonian_terms(params)
    return ModelArrays(
        hamiltonian=H,
        dims=meta["dims"],
        n_sea_effective=meta["n_sea_effective"],
        idx_rare=meta["idx_rare"],
        positions=meta["positions"],
        couplings=meta["couplings"],
        psi0=initial_state(params),
    )

