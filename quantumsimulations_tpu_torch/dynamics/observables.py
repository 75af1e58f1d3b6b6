"""Expectation-value traces from blocks of statevectors.

Instead of materializing dense observable matrices and computing
<psi|O|psi> per output time (the reference lets ``qt.sesolve`` do this with
six dense e_ops, dipolar_ensemble_with_rare.py:653-666), each per-site
expectation is a handful of elementwise slice-products reduced over the
environment axes.  Collective sea observables are sums of per-site
expectations (linearity).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.spin import spin_matrix


def site_xyz_expectations(states: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """Per-site <Sx>, <Sy>, <Sz> for blocks of states.

    Spin operators only couple ADJACENT local levels (Jx/Jy are tridiagonal,
    Jz diagonal), so with ``p = conj(psi_a) psi_{a+1}``:

        <Jx> = sum_a Jx[a,a+1] * 2 Re(p)
        <Jy> = sum_a c_a      * 2 Im(p),   Jy[a,a+1] = -i c_a
        <Jz> = sum_a Jz[a,a] * |psi_a|^2

    Parameters
    ----------
    states : complex tensor of shape (..., dim, T)
        Columns are statevectors at successive output times; leading axes
        (a batch of simulations) are carried through.
    dims : per-site local dimensions (spin-3/2 sites included).

    Returns
    -------
    Real tensor of shape (..., n_sites, 3, T), in the real dtype that
    matches ``states`` (float64 for complex128, float32 for complex64).
    """
    n_sites = len(dims)
    lead = states.shape[:-2]
    T = states.shape[-1]
    outs = []
    for site in range(n_sites):
        dl = int(np.prod(dims[:site], dtype=np.int64)) if site > 0 else 1
        d = dims[site]
        dr = int(np.prod(dims[site + 1 :], dtype=np.int64)) if site + 1 < n_sites else 1
        ps = states.reshape(*lead, dl, d, dr, T)
        s = (d - 1) / 2.0
        jx = np.real(spin_matrix(s, "x"))  # real symmetric, superdiag c_a
        jy = np.imag(spin_matrix(s, "y"))  # Jy[a,a+1] = -i c_a -> imag part -c_a
        jz = np.real(np.diag(spin_matrix(s, "z")))
        ex = ey = ez = 0.0
        for a in range(d):
            pa = ps[..., :, a, :, :]  # (..., dl, dr, T)
            ez = ez + float(jz[a]) * (pa.real * pa.real + pa.imag * pa.imag).sum(dim=(-3, -2))
            if a + 1 < d:
                pb = ps[..., :, a + 1, :, :]
                p = (pa.conj() * pb).sum(dim=(-3, -2))
                ex = ex + (2.0 * float(jx[a, a + 1])) * p.real
                ey = ey + (2.0 * float(-jy[a, a + 1])) * p.imag
        outs.append(torch.stack([ex, ey, ez], dim=-2))  # (..., 3, T)
    return torch.stack(outs, dim=-3)  # (..., n_sites, 3, T)


def state_norms(states: torch.Tensor) -> torch.Tensor:
    """||psi(t)|| per column (..., T) — the reference's integrator diagnostic.

    ``torch.linalg.vector_norm`` rather than ``.sqrt()`` of a sum: on the CPU
    ``torch.sqrt`` of float64 goes through MKL's vector math library, whose
    first call in a process was seen to return values off by ~1e-11 for one
    thread's share of the elements; the norm reduction takes its square
    roots elsewhere.
    """
    return torch.linalg.vector_norm(states, dim=-2)


def assemble_traces(
    site_xyz: np.ndarray,
    norms: np.ndarray,
    n_sea_effective: int,
    idx_rare: int,
) -> dict[str, np.ndarray]:
    """Build the reference's named observable dict from per-site expectations.

    Keys match dipolar_ensemble_with_rare.py:671-679: collective sea sums
    over sites [0, n_sea_effective) and the rare site's x/y/z, plus
    state_norm.  For the sea-as-center control variant, n_sea_effective
    includes the center site (reference :488-489).
    """
    sea = site_xyz[:n_sea_effective]  # (n_sea_eff, 3, T)
    rare = site_xyz[idx_rare]  # (3, T)
    return {
        "Ix_sea": np.asarray(sea[:, 0, :].sum(axis=0)),
        "Iy_sea": np.asarray(sea[:, 1, :].sum(axis=0)),
        "Iz_sea": np.asarray(sea[:, 2, :].sum(axis=0)),
        "Iz_R": np.asarray(rare[2]),
        "Ix_R": np.asarray(rare[0]),
        "Iy_R": np.asarray(rare[1]),
        "state_norm": np.asarray(norms),
    }
