"""Exact propagation via dense eigendecomposition — the small/medium-N fast path.

The rotating-frame Hamiltonian is time-independent (the reference's drives are
static in the rotating frame, dipolar_ensemble_with_rare.py:515-528), so the
entire trace is available in closed form:

    psi(t_k) = V exp(-i L t_k) V^dag psi0

One host eigendecomposition per Hamiltonian; then, for each block of output
times, the device builds the amplitudes c * exp(-i w t) (phase.py), forms
``states = V @ amp`` and reduces the states to the named observable rows
(collective sea sums + rare site + norm + energy = 8 rows per simulation).

Two precisions:

  * ``eig_traces_assembled_batched`` — complex128 throughout; ``V @ amp`` is
    a plain ``torch.matmul`` on complex128, as the JAX package leaves it to
    XLA (``ops/cplx.matmul``) outside any Pallas kernel.
  * ``eig_traces_assembled_batched32`` — the f32 speed mode: the amplitudes
    are built in float64, cast to float32 planes, and the product goes
    through the hand-written ``ops/cmatmul.cmatmul_f32`` kernel; observables
    are reduced in float32 (~1e-5 accuracy; tested at 2e-4 against f64).

Parameters kept for call-site compatibility with the JAX package:

  * ``t_chunk`` — columns of output times per block.  The default
    (:func:`default_time_chunk`, the JAX package's table, QST_TCHUNK
    overriding it) bounds the per-block state tensor at 64 MiB of complex128
    or complex64 (twice the columns in the f32 mode, as the JAX package).
  * ``pack`` — a no-op.  It selected the JAX package's byte-packed trace
    download, which exists only for its TPU link; the port always returns
    plain float64 rows.
  * ``interpret`` (f32 mode) — a no-op.  It selected Pallas interpret mode;
    here the tensors' device alone picks the kernel (CUDA) or the plain
    PyTorch version (CPU).

The per-site API (:func:`eig_propagate_traces` and its batched form) returns
each site's <Sx, Sy, Sz> instead of the assembled rows, for tests and custom
observables.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.cmatmul import cmatmul_f32
from ..utils.device import resolve_device
from .observables import site_xyz_expectations, state_norms
from .phase import grid_expi_neg, reduce_wdt_host, uniform_grid_decomposition

#: row order of assembled trace blocks (matches the reference's observable
#: dict plus the two diagnostics)
TRACE_ROWS = ("Ix_sea", "Iy_sea", "Iz_sea", "Iz_R", "Ix_R", "Iy_R", "state_norm", "energy")



def eigh_host(H: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition on the host CPU (numpy LAPACK)."""
    w, V = np.linalg.eigh(H)
    return w, V


def dense_matrix_host(op) -> np.ndarray:
    """Dense complex128 matrix of an OperatorSum (its index-arithmetic
    ``to_dense``); the JAX package's named hook for the host build."""
    return op.to_dense()


def default_time_chunk(dim: int, T: int, batch: int = 1) -> int:
    """Output times per block: 2^22 / (dim * batch) columns (64 MiB of
    complex128 states), at least 64 and at most T; env QST_TCHUNK
    overrides, as in the JAX package."""
    env = os.environ.get("QST_TCHUNK")
    if env:
        return max(1, min(T, int(env)))
    return max(64, min(T, (1 << 22) // max(1, dim * batch)))


def _coeffs(V: torch.Tensor, psi0: torch.Tensor) -> torch.Tensor:
    """c = V^dag psi0 for a batch: (B, dim, dim), (B, dim) -> (B, dim)."""
    return (V.mH @ psi0.unsqueeze(-1)).squeeze(-1)


def _assemble_rows(xyz, norms, energy, sea_mask, idx_rare) -> torch.Tensor:
    """(B, n, 3, Tc), (B, Tc), (B, Tc) -> named rows (B, 8, Tc) in TRACE_ROWS order."""
    sea = torch.einsum("bj,bjot->bot", sea_mask, xyz)  # Ix/Iy/Iz_sea
    rare = xyz[:, idx_rare]  # x, y, z
    return torch.stack(
        [sea[:, 0], sea[:, 1], sea[:, 2], rare[:, 2], rare[:, 0], rare[:, 1], norms, energy],
        dim=1,
    )


def _setup(w, V, psi0, times, dims, n_sea_effective, t_chunk, itemsize, device):
    dev = resolve_device(device)
    w = np.asarray(w, dtype=np.float64)
    B, dim = w.shape
    T = len(times)
    if t_chunk is None:
        # float32 states: half the bytes, twice the columns
        t_chunk = default_time_chunk(dim, T, batch=B) * (16 // itemsize)
    dt, eps = uniform_grid_decomposition(times)
    r = np.stack([reduce_wdt_host(wb, dt) for wb in w])
    sea_mask = (
        np.arange(len(dims))[None, :] < np.asarray(n_sea_effective)[:, None]
    ).astype(np.float64)
    f64 = dict(dtype=torch.float64, device=dev)
    return dict(
        dev=dev, T=T, t_chunk=int(t_chunk),
        w=torch.as_tensor(w, **f64),
        r=torch.as_tensor(r, **f64),
        k=torch.arange(T, **f64),
        eps=torch.as_tensor(eps, **f64),
        sea_mask=torch.as_tensor(sea_mask, **f64),
        V=torch.as_tensor(np.asarray(V), dtype=torch.complex128, device=dev),
        psi0=torch.as_tensor(np.asarray(psi0), dtype=torch.complex128, device=dev),
    )


def eig_traces_assembled_batched(
    w: np.ndarray,  # (B, dim)
    V: np.ndarray,  # (B, dim, dim) complex
    psi0: np.ndarray,  # (B, dim) complex
    times: np.ndarray,
    dims: tuple[int, ...],
    n_sea_effective: np.ndarray,  # (B,) number of sites in the sea sums
    idx_rare: int,
    t_chunk: int | None = None,
    pack: bool | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Named-observable traces for a batch: returns (B, 8, T) float64.

    Row order is TRACE_ROWS.  ``pack`` is accepted and ignored (module
    docstring).
    """
    return _eig_rows(w, V, psi0, times, dims, n_sea_effective, idx_rare, t_chunk,
                     device).cpu().numpy()


def _eig_rows(w, V, psi0, times, dims, n_sea_effective, idx_rare, t_chunk, device) -> torch.Tensor:
    """:func:`eig_traces_assembled_batched`'s rows as a (B, 8, T) float64
    tensor on the device (the sharded sweep gathers them there)."""
    s = _setup(w, V, psi0, times, dims, n_sea_effective, t_chunk, 16, device)
    V, w, r = s["V"], s["w"], s["r"]
    c = _coeffs(V, s["psi0"])
    T, tc = s["T"], s["t_chunk"]
    rows = torch.empty((w.shape[0], len(TRACE_ROWS), T), dtype=torch.float64, device=s["dev"])
    for t0 in range(0, T, tc):
        kb, eb = s["k"][t0 : t0 + tc], s["eps"][t0 : t0 + tc]
        amp = c.unsqueeze(-1) * grid_expi_neg(r, kb, w, eb)  # (B, dim, Tc)
        states = V @ amp
        xyz = site_xyz_expectations(states, dims)
        norms = state_norms(states)
        energy = (w.unsqueeze(-1) * (amp.real * amp.real + amp.imag * amp.imag)).sum(dim=-2)
        rows[:, :, t0 : t0 + tc] = _assemble_rows(xyz, norms, energy, s["sea_mask"], idx_rare)
    return rows


def eig_traces_assembled_batched32(
    w: np.ndarray,
    V: np.ndarray,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    n_sea_effective: np.ndarray,
    idx_rare: int,
    t_chunk: int | None = None,
    interpret: bool | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """f32 speed mode of the assembled traces (fused complex-f32 matmul kernel).

    Casts exactly where the JAX package's ``_assembled_chunk32`` does: the
    phases and amplitudes are float64, the amplitude planes and V are cast
    to float32 for the product, and the observables are reduced in float32
    before the rows are widened back to float64.  ``interpret`` is accepted
    and ignored (module docstring).
    """
    return _eig32_rows(w, V, psi0, times, dims, n_sea_effective, idx_rare, t_chunk,
                       device).cpu().numpy()


def _eig32_rows(w, V, psi0, times, dims, n_sea_effective, idx_rare, t_chunk,
                device) -> torch.Tensor:
    """:func:`eig_traces_assembled_batched32`'s rows as a (B, 8, T) float64
    tensor on the device."""
    s = _setup(w, V, psi0, times, dims, n_sea_effective, t_chunk, 8, device)
    V, w, r = s["V"], s["w"], s["r"]
    c = _coeffs(V, s["psi0"])
    v_re = V.real.to(torch.float32).contiguous()
    v_im = V.imag.to(torch.float32).contiguous()
    w32 = w.to(torch.float32).unsqueeze(-1)
    mask32 = s["sea_mask"].to(torch.float32)
    T, tc = s["T"], s["t_chunk"]
    rows = torch.empty((w.shape[0], len(TRACE_ROWS), T), dtype=torch.float64, device=s["dev"])
    for t0 in range(0, T, tc):
        kb, eb = s["k"][t0 : t0 + tc], s["eps"][t0 : t0 + tc]
        amp = c.unsqueeze(-1) * grid_expi_neg(r, kb, w, eb)  # complex128 (B, dim, Tc)
        amp_re = amp.real.to(torch.float32).contiguous()
        amp_im = amp.imag.to(torch.float32).contiguous()
        s_re, s_im = cmatmul_f32(v_re, v_im, amp_re, amp_im)
        states = torch.complex(s_re, s_im)
        xyz = site_xyz_expectations(states, dims)
        norms = state_norms(states)
        energy = (w32 * (amp_re * amp_re + amp_im * amp_im)).sum(dim=-2)
        rows[:, :, t0 : t0 + tc] = _assemble_rows(xyz, norms, energy, mask32, idx_rare)
    return rows


def traces_dict(row_block: np.ndarray) -> dict[str, np.ndarray]:
    """(8, T) assembled rows -> the reference's named trace dict (+energy)."""
    return {name: row_block[i] for i, name in enumerate(TRACE_ROWS)}


def eig_propagate_traces_batched(
    w: np.ndarray,
    V: np.ndarray,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    t_chunk: int | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Batched per-site traces: site_xyz (B, n, 3, T), norm (B, T), energy (B, T)."""
    s = _setup(w, V, psi0, times, dims, np.zeros(np.asarray(w).shape[0]), t_chunk, 16, device)
    V, w, r = s["V"], s["w"], s["r"]
    c = _coeffs(V, s["psi0"])
    xyzs, norms, energies = [], [], []
    for t0 in range(0, s["T"], s["t_chunk"]):
        kb, eb = s["k"][t0 : t0 + s["t_chunk"]], s["eps"][t0 : t0 + s["t_chunk"]]
        amp = c.unsqueeze(-1) * grid_expi_neg(r, kb, w, eb)  # (B, dim, Tc)
        states = V @ amp
        xyzs.append(site_xyz_expectations(states, dims))
        norms.append(state_norms(states))
        energies.append((w.unsqueeze(-1) * (amp.real * amp.real + amp.imag * amp.imag)).sum(dim=-2))
    return {
        "site_xyz": torch.cat(xyzs, dim=-1).cpu().numpy(),
        "norm": torch.cat(norms, dim=-1).cpu().numpy(),
        "energy": torch.cat(energies, dim=-1).cpu().numpy(),
    }


def eig_propagate_traces(
    w: np.ndarray,
    V: np.ndarray,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    t_chunk: int | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Per-site traces for one simulation: site_xyz (n, 3, T), norm, energy."""
    out = eig_propagate_traces_batched(
        w[None, :], V[None, :, :], psi0[None, :], times, dims, t_chunk=t_chunk, device=device
    )
    return {k: v[0] for k, v in out.items()}
