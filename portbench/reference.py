"""Plain reference of one bath evolution, and the comparison that decides
``correct``.

Independent of the program: it imports nothing of the port and takes only
the parameter record the harness hands both sides (the reference code's
``DipolarRareParams`` fields, see ``traffic.params_record``).  From those it
builds, in plain PyTorch:

  * the geometry: n_sea sites on a shell of radius ``shell_scale`` (the
    Platonic solid with n_sea vertices where one exists, else the Fibonacci
    sphere) and the rare site at the origin, last;
  * the couplings b_ij = g_i g_j scale (1 - 3 cos^2 theta_ij) / r_ij^3,
    theta against the z axis, the last site carrying gamma_rare;
  * the rotating-frame Hamiltonian as a dense matrix: detunings
    (gamma B0 - omega_rf) Sz on each driven species, drives
    omega1 (cos phi Sx + sin phi Sy), sea-sea b [SzSz - (SxSx - SySy)/4],
    sea-rare b Sz Jz;
  * the initial state: every sea spin in its Sz eigenstate of sign
    ``init_x_sign``, the rare spin in its extremal Jz state of the other sign;
  * the evolution psi(t) = V exp(-i w t) V^H psi(0) from the eigenpairs
    (w, V) of H by ``torch.linalg.eigh``;
  * per output time the seven rows Ix/Iy/Iz_sea, Iz/Ix/Iy_R and the norm
    from each site's reduced density matrix.

``dtype`` complex128 is the reference; complex64 (TF32 off) is the control,
the same computation one precision below the configuration's float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: the seven rows the program returns and the reference computes, in order
ROWS = ("Ix_sea", "Iy_sea", "Iz_sea", "Iz_R", "Ix_R", "Iy_R", "state_norm")

_GOLDEN = (1.0 + math.sqrt(5.0)) / 2.0


def _shell_directions(n: int) -> np.ndarray:
    """(n, 3) unit vectors: a Platonic solid's vertices for n in {4, 6, 8,
    12, 20}, else the golden-angle (Fibonacci) sphere."""
    p, q = _GOLDEN, 1.0 / _GOLDEN
    signs = [(a, b) for a in (-1.0, 1.0) for b in (-1.0, 1.0)]
    if n == 4:
        pts = [(1, 1, 1), (-1, -1, 1), (-1, 1, -1), (1, -1, -1)]
    elif n == 6:
        pts = [(s, 0, 0) for s in (1, -1)] + [(0, s, 0) for s in (1, -1)] + [(0, 0, s) for s in (1, -1)]
    elif n == 8:
        pts = [(x, y, z) for x in (1, -1) for y in (1, -1) for z in (1, -1)]
    elif n == 12:
        pts = [(0, a, b * p) for a, b in signs] + [(a, b * p, 0) for a, b in signs] \
            + [(b * p, 0, a) for a, b in signs]
    elif n == 20:
        pts = [(x, y, z) for x in (1, -1) for y in (1, -1) for z in (1, -1)] \
            + [(0, a * q, b * p) for a, b in signs] + [(a * q, b * p, 0) for a, b in signs] \
            + [(b * p, 0, a * q) for a, b in signs]
    else:
        i = np.arange(n) + 0.5
        y = 1.0 - 2.0 * i / n
        r = np.sqrt(np.clip(1.0 - y * y, 0.0, None))
        phi = 2.0 * np.pi * (i - 0.5) / _GOLDEN
        return np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=1)
    pts = np.asarray(pts, dtype=np.float64)
    return pts / np.linalg.norm(pts, axis=1, keepdims=True)


def couplings(p: dict) -> np.ndarray:
    """(n_sea + 1, n_sea + 1) secular dipolar couplings, rare site last."""
    n = p["n_sea"]
    pos = np.vstack([p["shell_scale"] * _shell_directions(n), np.zeros((1, 3))])
    gam = np.full(n + 1, p["gamma_sea"])
    gam[n] = p["gamma_rare"] if p["is_center_rare"] else p["gamma_sea"]
    b = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        for j in range(i + 1, n + 1):
            d = pos[i] - pos[j]
            r = float(np.linalg.norm(d))
            cos2 = (d[2] / r) ** 2
            b[i, j] = b[j, i] = gam[i] * gam[j] * p["dipolar_scale"] * (1.0 - 3.0 * cos2) / r**3
    return b


def spin_ops(s: float) -> dict[str, np.ndarray]:
    """Sx, Sy, Sz of spin s, basis m = +s, ..., -s."""
    m = s - np.arange(int(round(2 * s)) + 1)
    up = np.diag(np.sqrt(s * (s + 1) - m[1:] * (m[1:] + 1)), 1).astype(np.complex128)
    return {"x": (up + up.T) / 2, "y": (up - up.T) / 2j, "z": np.diag(m).astype(np.complex128)}


def dims_of(p: dict) -> list[int]:
    rare = 4 if (p["is_spin_three_half"] and p["is_center_rare"]) else 2
    return [2] * p["n_sea"] + [rare]


def _embed(factors: dict[int, np.ndarray], dims: list[int], dtype, device) -> torch.Tensor:
    """The dense operator with ``factors[k]`` on site k and identities
    elsewhere (runs of identities as one identity)."""
    out = None
    run = 1
    for k, d in enumerate(dims + [None]):
        if d is not None and k not in factors:
            run *= d
            continue
        pieces = []
        if run > 1:
            pieces.append(torch.eye(run, dtype=dtype, device=device))
        if d is not None:
            pieces.append(torch.as_tensor(factors[k], dtype=dtype, device=device))
        for x in pieces:
            out = x if out is None else torch.kron(out, x)
        run = 1
    return out


def hamiltonian(p: dict, dtype=torch.complex128, device="cpu") -> torch.Tensor:
    """Dense rotating-frame H (rad/s) of the record ``p``."""
    dims = dims_of(p)
    n = p["n_sea"]
    rare = n
    n_sea_eff = n if p["is_center_rare"] else n + 1
    sea, rop = spin_ops(0.5), spin_ops((dims[rare] - 1) / 2)
    d_sea = p["gamma_sea"] * p["B0_sea"] - p["omega_rf_sea"] if p["drive_sea"] else 0.0
    d_rare = p["gamma_rare"] * p["B0_rare"] - p["omega_rf_rare"] if p["drive_rare"] else 0.0
    w1_sea, w1_rare = p["gamma_sea"] * p["B1_sea"], p["gamma_rare"] * p["B1_rare"]
    terms: list[tuple[float, dict]] = []
    for j in range(n_sea_eff):
        if d_sea != 0.0:
            terms.append((d_sea, {j: sea["z"]}))
        if p["drive_sea"] and w1_sea != 0.0:
            terms.append((w1_sea * math.cos(p["phi_sea"]), {j: sea["x"]}))
            terms.append((w1_sea * math.sin(p["phi_sea"]), {j: sea["y"]}))
    if p["is_center_rare"] and p["drive_rare"]:
        if d_rare != 0.0:
            terms.append((d_rare, {rare: rop["z"]}))
        if w1_rare != 0.0:
            terms.append((w1_rare * math.cos(p["phi_rare"]), {rare: rop["x"]}))
            terms.append((w1_rare * math.sin(p["phi_rare"]), {rare: rop["y"]}))
    b = couplings(p)
    for i in range(n + 1):
        for j in range(i + 1, n + 1):
            if j < n_sea_eff:
                terms.append((b[i, j], {i: sea["z"], j: sea["z"]}))
                terms.append((-0.25 * b[i, j], {i: sea["x"], j: sea["x"]}))
                terms.append((0.25 * b[i, j], {i: sea["y"], j: sea["y"]}))
            elif j == rare:
                terms.append((b[i, j], {i: sea["z"], j: rop["z"]}))
    dim = int(np.prod(dims))
    H = torch.zeros((dim, dim), dtype=dtype, device=device)
    for c, factors in terms:
        if c != 0.0:
            H.add_(_embed(factors, dims, dtype, device), alpha=c)
    return H


def initial_state(p: dict, dtype=torch.complex128, device="cpu") -> torch.Tensor:
    dims = dims_of(p)
    psi = torch.ones(1, dtype=dtype, device=device)
    for k, d in enumerate(dims):
        ket = torch.zeros(d, dtype=dtype, device=device)
        sign = p["init_x_sign"] if (k < p["n_sea"] or not p["is_center_rare"]) else -p["init_x_sign"]
        ket[0 if sign >= 0 else d - 1] = 1.0  # m = +s first
        psi = torch.kron(psi, ket)
    return psi


def _observables(S: torch.Tensor, dims: list[int], n_sea_eff: int, rare: int,
                 ops: list[dict]) -> torch.Tensor:
    """(dim, B) states -> (7, B) float64 rows."""
    B = S.shape[1]
    xyz = []
    for k, d in enumerate(dims):
        dl, dr = int(np.prod(dims[:k])), int(np.prod(dims[k + 1:]))
        X = S.reshape(dl, d, dr, B)
        # M[a, b, t] = sum over the other sites of conj(psi_a) psi_b, so that
        # <O>(t) = sum_ab M[a, b, t] O[a, b]
        M = torch.einsum("lart,lbrt->abt", X.conj(), X)
        row = []
        for w in "xyz":
            O = torch.as_tensor(ops[k][w], dtype=S.dtype, device=S.device)
            row.append(torch.einsum("abt,ab->t", M, O).real)
        xyz.append(torch.stack(row))
    xyz = torch.stack(xyz).to(torch.float64)  # (n_sites, 3, B)
    sea = xyz[:n_sea_eff].sum(dim=0)
    r = xyz[rare]
    norm = torch.linalg.vector_norm(S, dim=0).to(torch.float64)
    return torch.stack([sea[0], sea[1], sea[2], r[2], r[0], r[1], norm])


def reference_rows(p: dict, dtype=torch.complex128, device="cpu", block: int = 512) -> np.ndarray:
    """(7, steps) rows of ``ROWS`` for the record ``p`` on the grid
    linspace(0, t_final, steps): H = V diag(w) V^H by ``torch.linalg.eigh``,
    psi(t) = V (exp(-i w t) * (V^H psi(0))), a block of output times at a
    time.  Every phase has modulus one, so a lower precision stays bounded
    and reads as wrong phases."""
    was_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _reference_rows(p, dtype, device, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was_tf32


def _reference_rows(p, dtype, device, block):
    dims = dims_of(p)
    n_sea_eff = p["n_sea"] if p["is_center_rare"] else p["n_sea"] + 1
    T = p["steps"]
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    ops = [spin_ops((d - 1) / 2) for d in dims]
    w, V = torch.linalg.eigh(hamiltonian(p, dtype, device))
    c = V.conj().T @ initial_state(p, dtype, device)
    times = torch.linspace(0.0, p["t_final"], T, dtype=torch.float64, device=device).to(real)
    one = torch.ones((), dtype=real, device=device)
    rows = torch.empty((7, T), dtype=torch.float64, device=device)
    for b0 in range(0, T, block):
        t = times[b0:b0 + block]
        phase = torch.polar(one.expand(len(w), len(t)), -w[:, None] * t[None, :])
        rows[:, b0:b0 + block] = _observables(V @ (c[:, None] * phase), dims, n_sea_eff,
                                              len(dims) - 1, ops)
    return rows.cpu().numpy()


def trace_gap(program: dict, reference: np.ndarray) -> float:
    """Largest |program - reference| over the seven rows and every output
    time; +inf where the program's rows are missing, misshapen or not
    finite."""
    try:
        got = np.stack([np.asarray(program[k], dtype=np.float64) for k in ROWS])
    except (KeyError, ValueError):
        return math.inf
    if got.shape != reference.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.abs(got - reference).max())
