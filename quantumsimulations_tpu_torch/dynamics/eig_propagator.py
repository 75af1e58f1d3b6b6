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

  * ``t_chunk`` — columns of output times per block.  The default bounds the
    per-block state tensor at 64 MiB (``_CHUNK_STATE_BYTES``).
  * ``pack`` — a no-op.  It selected the JAX package's byte-packed trace
    download, which exists only for its TPU link; the port always returns
    plain float64 rows.
  * ``interpret`` (f32 mode) — a no-op.  It selected Pallas interpret mode;
    here the tensors' device alone picks the kernel (CUDA) or the plain
    PyTorch version (CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cmatmul import cmatmul_f32
from ..utils.device import resolve_device
from .observables import site_xyz_expectations, state_norms
from .phase import grid_expi_neg, reduce_wdt_host, uniform_grid_decomposition

#: row order of assembled trace blocks (matches the reference's observable
#: dict plus the two diagnostics)
TRACE_ROWS = ("Ix_sea", "Iy_sea", "Iz_sea", "Iz_R", "Ix_R", "Iy_R", "state_norm", "energy")

#: bound on the per-block state tensor B*dim*t_chunk*itemsize
_CHUNK_STATE_BYTES = 64 << 20


def eigh_host(H: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition on the host CPU (numpy LAPACK)."""
    w, V = np.linalg.eigh(H)
    return w, V


def _coeffs(V: torch.Tensor, psi0: torch.Tensor) -> torch.Tensor:
    """c = V^dag psi0 for a batch: (B, dim, dim), (B, dim) -> (B, dim)."""
    return (V.mH @ psi0.unsqueeze(-1)).squeeze(-1)


def _default_time_chunk(dim: int, T: int, batch: int, itemsize: int) -> int:
    return max(64, min(T, _CHUNK_STATE_BYTES // max(1, dim * batch * itemsize)))


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
        t_chunk = _default_time_chunk(dim, T, B, itemsize)
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
    return rows.cpu().numpy()


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
    return rows.cpu().numpy()


def traces_dict(row_block: np.ndarray) -> dict[str, np.ndarray]:
    """(8, T) assembled rows -> the reference's named trace dict (+energy)."""
    return {name: row_block[i] for i, name in enumerate(TRACE_ROWS)}
