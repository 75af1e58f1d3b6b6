"""Spin operator matrices for arbitrary spin quantum number.

Generic construction from the angular-momentum ladder algebra:

    J+ |s, m> = sqrt(s(s+1) - m(m+1)) |s, m+1>
    Jz |s, m> = m |s, m>
    Jx = (J+ + J-)/2,   Jy = (J+ - J-)/(2i)

For s = 1/2 this reproduces the Pauli-halves (0.5*sigma_{x,y,z}) and for
s = 3/2 the 4x4 matrices the reference obtains from ``qt.jmat(1.5, ...)``
(reference: dipolar_ensemble_with_rare.py:16-25).

Basis ordering follows the QuTiP convention: descending m, i.e. the first
basis vector is |s, m=+s>.  All matrices are host-side numpy complex128;
device code reads the coefficients it needs from them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _jmats(two_s: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Jx, Jy, Jz) for spin s = two_s / 2, basis ordered m = +s ... -s."""
    s = two_s / 2.0
    d = two_s + 1
    m = s - np.arange(d)  # descending: +s, s-1, ..., -s
    jz = np.diag(m).astype(np.complex128)
    # J+ couples |m> -> |m+1>; with descending ordering, |m+1> is the *previous*
    # row, so J+ has entries on the superdiagonal.
    ladder = np.sqrt(s * (s + 1.0) - m[1:] * (m[1:] + 1.0))
    jp = np.zeros((d, d), dtype=np.complex128)
    jp[np.arange(d - 1), np.arange(1, d)] = ladder
    jm = jp.conj().T
    jx = 0.5 * (jp + jm)
    jy = (jp - jm) / 2j
    return jx, jy, jz


def spin_matrix(s: float, which: str) -> np.ndarray:
    """Return the spin-s operator: 'x' | 'y' | 'z' | 'p' (J+) | 'm' (J-) | 'i' (identity)."""
    two_s = int(round(2 * s))
    if abs(2 * s - two_s) > 1e-12 or two_s < 1:
        raise ValueError(f"invalid spin quantum number: {s}")
    d = two_s + 1
    if which == "i":
        return np.eye(d, dtype=np.complex128)
    jx, jy, jz = _jmats(two_s)
    if which == "x":
        return jx.copy()
    if which == "y":
        return jy.copy()
    if which == "z":
        return jz.copy()
    if which == "p":
        return (jx + 1j * jy).copy()
    if which == "m":
        return (jx - 1j * jy).copy()
    raise ValueError(f"unknown operator label: {which!r}")


def spin_dim(s: float) -> int:
    return int(round(2 * s)) + 1


def eigenstate(s: float, axis: str, sign: int) -> np.ndarray:
    """Extremal eigenvector of the spin-s operator along ``axis``.

    ``sign >= 0`` selects the largest-eigenvalue eigenstate, ``sign < 0`` the
    smallest.  Matches the reference's ``basis_sea`` / ``basis_rare`` semantics
    (dipolar_ensemble_with_rare.py:54-100): for the z axis these are the
    |m=+s> / |m=-s> basis kets; for x they are the extremal Jx eigenstates.
    """
    axis = axis.lower()
    if axis not in ("x", "y", "z"):
        raise ValueError("axis must be 'x', 'y' or 'z'")
    if axis == "z":
        d = spin_dim(s)
        ket = np.zeros(d, dtype=np.complex128)
        # basis ordering is descending m: index 0 is m=+s, index d-1 is m=-s
        ket[0 if sign >= 0 else d - 1] = 1.0
        return ket
    op = spin_matrix(s, axis)
    evals, evecs = np.linalg.eigh(op)
    idx = int(np.argmax(evals) if sign >= 0 else np.argmin(evals))
    ket = evecs[:, idx].astype(np.complex128)
    # Fix the global phase so the largest-|amplitude| component is real-positive
    # (QuTiP's eigenstates have an arbitrary phase; observables are invariant,
    # but a deterministic convention keeps golden tests stable).
    k = int(np.argmax(np.abs(ket)))
    phase = ket[k] / abs(ket[k])
    return ket / phase
