"""Shell geometry and secular dipolar couplings.

Behavioral parity targets (reference file:line):
  * Platonic vertex sets for n in {4, 6, 8, 12, 20}
    (dipolar_ensemble_with_rare.py:107-202),
  * Fibonacci-sphere fallback for other n (:234-247),
  * rare nucleus at the origin as the LAST row (:249-251),
  * coupling law b_ij = g_i g_j * scale * (1 - 3 cos^2 theta_ij) / r_ij^3
    with theta measured against the z axis and heteronuclear gamma selection
    for the last site (:255-299).

Geometry is cheap one-time host setup; everything here is vectorized numpy
(the reference loops over pairs in Python).
"""

from __future__ import annotations

import numpy as np

_PHI = (1.0 + np.sqrt(5.0)) / 2.0


def _unit_rows(pts: np.ndarray) -> np.ndarray:
    return pts / np.linalg.norm(pts, axis=1, keepdims=True)


def platonic_vertices(n_sea: int) -> np.ndarray:
    """Unit-sphere vertices of the Platonic solid with ``n_sea`` vertices."""
    phi, inv_phi = _PHI, 1.0 / _PHI
    if n_sea == 4:
        pts = np.array(
            [[1, 1, 1], [-1, -1, 1], [-1, 1, -1], [1, -1, -1]], dtype=float
        )
    elif n_sea == 6:
        pts = np.array(
            [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
            dtype=float,
        )
    elif n_sea == 8:
        # cube corners, x-major ordering (matches reference :137-148)
        pts = np.array(
            [
                [1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1],
                [-1, 1, 1], [-1, 1, -1], [-1, -1, 1], [-1, -1, -1],
            ],
            dtype=float,
        )
    elif n_sea == 12:
        # icosahedron: cyclic permutations of (0, ±1, ±phi) (reference :150-167)
        pts = np.array(
            [
                [0, 1, phi], [0, -1, phi], [0, 1, -phi], [0, -1, -phi],
                [1, phi, 0], [-1, phi, 0], [1, -phi, 0], [-1, -phi, 0],
                [phi, 0, 1], [phi, 0, -1], [-phi, 0, 1], [-phi, 0, -1],
            ],
            dtype=float,
        )
    elif n_sea == 20:
        # dodecahedron: cube corners + rectangle triples (reference :169-194)
        cube = [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0) for z in (-1.0, 1.0)]
        yz = [[0.0, y, z] for y in (-inv_phi, inv_phi) for z in (-phi, phi)]
        xy = [[x, y, 0.0] for x in (-inv_phi, inv_phi) for y in (-phi, phi)]
        xz = [[x, 0.0, z] for x in (-phi, phi) for z in (-inv_phi, inv_phi)]
        pts = np.array(cube + yz + xy + xz, dtype=float)
    else:
        raise ValueError(f"No Platonic solid with {n_sea} vertices.")
    return _unit_rows(pts)


def fibonacci_sphere(n: int) -> np.ndarray:
    """Quasi-uniform unit-sphere points (golden-angle spiral).

    Identical point set to the reference fallback
    (dipolar_ensemble_with_rare.py:234-247): latitude from the midpoint rule
    on y in [-1, 1], longitude 2*pi*i/phi.
    """
    i = np.arange(n, dtype=float)
    y = 1.0 - 2.0 * (i + 0.5) / n
    r_xy = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    ang = 2.0 * np.pi * i / _PHI
    return np.stack([r_xy * np.cos(ang), y, r_xy * np.sin(ang)], axis=1)


def shell_positions_with_rare_center(n_sea: int, radius: float = 0.282393) -> np.ndarray:
    """n_sea sea nuclei on a shell of ``radius``; rare nucleus at origin (last row).

    Returns an (n_sea + 1, 3) array.  Platonic placement when available,
    Fibonacci-sphere otherwise (reference :205-251).
    """
    if n_sea < 1:
        raise ValueError("n_sea must be at least 1.")
    try:
        sea = radius * platonic_vertices(n_sea)
    except ValueError:
        sea = radius * fibonacci_sphere(n_sea)
    return np.vstack([sea, np.zeros((1, 3))])


def dipolar_couplings_from_positions(
    positions: np.ndarray,
    scale: float,
    gamma_sea: float,
    gamma_rare: float,
) -> np.ndarray:
    """Secular dipolar coupling matrix (symmetric, zero diagonal).

        b_ij = g_i g_j * scale * (1 - 3 cos^2 theta_ij) / r_ij^3

    theta_ij is the angle of r_i - r_j to the z axis (the B0 direction); the
    LAST site carries gamma_rare, all others gamma_sea (reference :255-299).
    Raises on coincident sites, like the reference.
    """
    positions = np.asarray(positions, dtype=float)
    n = positions.shape[0]
    diff = positions[:, None, :] - positions[None, :, :]  # (n, n, 3)
    r = np.linalg.norm(diff, axis=-1)
    off = ~np.eye(n, dtype=bool)
    if np.any(r[off] == 0.0):
        raise ValueError("Two sites have identical positions.")
    with np.errstate(divide="ignore", invalid="ignore"):
        cos_th = np.where(off, diff[..., 2] / np.where(r == 0, 1.0, r), 0.0)
        geom = np.where(off, (1.0 - 3.0 * cos_th**2) / np.where(r == 0, 1.0, r) ** 3, 0.0)
    gammas = np.full(n, gamma_sea, dtype=float)
    gammas[n - 1] = gamma_rare
    b = np.outer(gammas, gammas) * scale * geom
    np.fill_diagonal(b, 0.0)
    return b


def coupling_statistics(b: np.ndarray, n_sea: int) -> dict[str, float]:
    """Sea-rare / sea-sea |b| statistics in Hz (reference sweep driver
    sweep_sea_detuning.py:451-480); b entries are angular frequencies."""
    idx_rare = b.shape[0] - 1
    sea_rare = b[:n_sea, idx_rare]
    iu = np.triu_indices(n_sea, k=1)
    sea_sea = b[:n_sea, :n_sea][iu]
    two_pi = 2.0 * np.pi
    ar = np.abs(sea_rare) / two_pi
    aa = np.abs(sea_sea) / two_pi
    return {
        "avg_b_AR_Hz": float(ar.mean()),
        "rms_b_AR_Hz": float(np.sqrt(np.mean(np.abs(sea_rare) ** 2)) / two_pi),
        "min_b_AR_Hz": float(ar.min()),
        "max_b_AR_Hz": float(ar.max()),
        "avg_b_AA_Hz": float(aa.mean()),
        "rms_b_AA_Hz": float(np.sqrt(np.mean(np.abs(sea_sea) ** 2)) / two_pi),
        "min_b_AA_Hz": float(aa.min()),
        "max_b_AA_Hz": float(aa.max()),
    }
