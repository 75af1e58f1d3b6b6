"""Sharded-statevector Hamiltonian apply: the beyond-single-device engine.

Port of ``quantumsimulations_tpu/parallel/state_sharded.py``.  The
statevector is sharded over the mesh axis 'sp' by its leading k qubit axes
(2^k = n_shards, contiguous blocks: the rank's index in the 'sp' group is
the first k bits of the global index), and H psi is evaluated with one
pairwise exchange per XOR mask:

  * All z/zz terms are DIAGONAL in the product basis -> one elementwise
    multiply with the rank's slice of the diagonal (no communication).
  * A term with x/y factors on sharded qubits flips those bits: amplitudes
    move between the ranks whose indices differ by the XOR mask of the
    flipped bits -> one ``dist.batch_isend_irecv`` pair exchange.  Terms are
    GROUPED BY MASK, so the sea-sea xx+yy network costs one exchange per
    qubit pair, not per term, and each rank applies the local factors and a
    per-rank +-1/2, +-i/2 phase (from the z/y eigenstructure of its own
    index bits) to the received block.

Where the JAX package contracts each term's local factors one by one
inside ``shard_map``, the port folds every term of a mask group, with its
per-rank phase, into one gather table over the rank's block (as the
single-device ``ops/embed.py::make_qubit_flip_apply`` does): out[d] +=
sum_c coef[c, d] * src[idx[c, d]], where each component c is one pattern of
local index shifts (a flip on a qubit axis, a shift on a spin-3/2 axis).
One gather, one multiply and one sum per mask group, whatever the number of
terms; the sums run in another order than the JAX package's, so the two
agree to float64 rounding, not bit for bit.

The Krylov stepper (dynamics/krylov.py) runs on top of this apply with
``all_reduce``-reduced inner products (:func:`krylov_traces_assembled_sharded`).
Every rank calls the entry points with the same arguments and returns the
whole result.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.embed import OperatorSum, local_op
from .mesh import all_gather_cat, all_reduce, axis_size, exchange, mesh_device


@dataclass(frozen=True)
class _MaskGroupTerm:
    coeff: float
    local_factors: tuple[tuple[int, str], ...]  # (axis within local dims, op)
    sharded_factors: tuple[tuple[int, str], ...]  # (bit position from MSB, op in xyz)


class ShardedHamiltonian:
    """Preprocessed term IR for a statevector sharded on its first k qubits."""

    def __init__(self, H: OperatorSum, n_shards: int):
        k = int(np.log2(n_shards))
        if 2**k != n_shards:
            raise ValueError("n_shards must be a power of two")
        if any(d != 2 for d in H.dims[:k]):
            raise ValueError("sharded sites must be qubits (dim 2)")
        self.H = H
        self.k = k
        self.n_shards = n_shards
        self.dims = H.dims
        self.local_dims = tuple(H.dims[k:])
        self.local_dim = int(np.prod(self.local_dims)) if self.local_dims else 1
        self.diag = H.diagonal_part()  # (global dim,) host f64

        groups: dict[int, list[_MaskGroupTerm]] = {}
        for term in H.offdiagonal_terms():
            mask = 0
            local_factors: list[tuple[int, str]] = []
            sharded_factors: list[tuple[int, str]] = []
            for site, which in term.factors:
                if site < k:
                    bitpos = k - 1 - site  # site 0 = MSB of the rank index
                    sharded_factors.append((bitpos, which))
                    if which in ("x", "y"):
                        mask |= 1 << bitpos
                else:
                    local_factors.append((site - k, which))
            groups.setdefault(mask, []).append(
                _MaskGroupTerm(term.coeff, tuple(local_factors), tuple(sharded_factors))
            )
        self.mask_groups = groups

    @staticmethod
    def rank_phase(t: _MaskGroupTerm, my_idx: int) -> complex:
        """coeff times the per-rank scalar of the term's sharded-site factors."""
        ph = complex(t.coeff)
        for bitpos, which in t.sharded_factors:
            b = (my_idx >> bitpos) & 1
            if which == "x":
                ph *= 0.5
            elif which == "z":
                ph *= 0.5 * (1.0 - 2.0 * b)  # Iz eigenvalue: +1/2 for bit 0
            elif which == "y":
                # (sigma_y psi)_b = i (2b - 1) psi_{1-b}; Iy = sigma_y / 2
                ph *= 0.5j * (2.0 * b - 1.0)
            else:
                raise ValueError(which)
        return ph

    def _group_tables(self, terms, my_idx: int) -> tuple[np.ndarray, np.ndarray]:
        """(idx, coef), each (n_components, local_dim): the mask group's
        terms, with their per-rank phases, as gather components over the
        rank's block.  A component collects the local factors' nonzero
        entries that share one index shift per axis (a flip on a qubit axis,
        b - a on any other): rows outside its entries keep coefficient 0."""
        dims = self.local_dims
        n = len(dims)
        ld = self.local_dim
        strides = np.ones(n, dtype=np.int64)
        for a in range(n - 2, -1, -1):
            strides[a] = strides[a + 1] * dims[a + 1]
        rows = np.arange(ld, dtype=np.int64)
        digits = [(rows // strides[a]) % dims[a] for a in range(n)]
        comps: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}
        for t in terms:
            ph = self.rank_phase(t, my_idx)
            entries = []
            for axis, which in t.local_factors:
                M = local_op(dims[axis], which)
                entries.append([(int(a), int(b), M[a, b]) for a, b in zip(*np.nonzero(M))])
            for combo in product(*entries):
                value = ph
                mask = np.ones(ld, dtype=bool)
                src = rows.copy()
                key = []
                for (axis, _), (a, b, v) in zip(t.local_factors, combo):
                    value = value * v
                    mask &= digits[axis] == a
                    src += (b - a) * strides[axis]
                    if a != b:
                        key.append((axis, "flip" if dims[axis] == 2 else b - a))
                idx, coef = comps.setdefault(
                    tuple(key), (rows.copy(), np.zeros(ld, dtype=np.complex128)))
                idx[mask] = src[mask]
                coef[mask] += value
        return (np.stack([c[0] for c in comps.values()]),
                np.stack([c[1] for c in comps.values()]))

    def local_apply_fn(self, group, my_idx: int, device: torch.device):
        """``apply(psi_local) -> (H psi)_local`` for the rank ``my_idx`` of
        the 'sp' process ``group``: its block of the diagonal, one gather
        table per mask group (built here, on ``device``), and one pairwise
        exchange per nonzero mask."""
        ld = self.local_dim
        diag = torch.as_tensor(self.diag[my_idx * ld:(my_idx + 1) * ld], dtype=torch.float64,
                               device=device)
        tables = []
        for mask, terms in self.mask_groups.items():
            idx, coef = self._group_tables(terms, my_idx)
            tables.append((mask, torch.as_tensor(idx.reshape(-1), device=device),
                           torch.as_tensor(coef, device=device)))

        def apply(psi_local: torch.Tensor) -> torch.Tensor:
            out = psi_local * diag
            for mask, idx, coef in tables:
                src = psi_local if mask == 0 else exchange(psi_local, my_idx ^ mask, group)
                out += torch.index_select(src, 0, idx).view(coef.shape).mul_(coef).sum(dim=0)
            return out

        return apply


def _sp(mesh: DeviceMesh, axis: str):
    """(group, n_shards, my_idx, device) of the mesh axis on this rank."""
    return (mesh.get_group(axis), axis_size(mesh, axis), mesh.get_local_rank(axis),
            mesh_device(mesh))


def make_sharded_apply(H: OperatorSum, mesh: DeviceMesh, axis: str = "sp"):
    """Build ``(apply_fn, diag_local, rows, sh)`` for the sharded H psi.

    ``apply_fn(psi_local) -> (H psi)_local`` maps this rank's complex128
    block of the statevector, the global indices ``rows`` (a slice), to the
    same block of the product; every rank of the axis calls it together.
    ``diag_local`` is the rank's block of H's diagonal."""
    group, n_shards, my_idx, dev = _sp(mesh, axis)
    sh = ShardedHamiltonian(H, n_shards)
    rows = slice(my_idx * sh.local_dim, (my_idx + 1) * sh.local_dim)
    diag_local = torch.as_tensor(sh.diag[rows], dtype=torch.float64, device=dev)
    return sh.local_apply_fn(group, my_idx, dev), diag_local, rows, sh


def krylov_traces_assembled_sharded(
    H: OperatorSum,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    n_sea_effective: int,
    idx_rare: int,
    mesh: DeviceMesh,
    axis: str = "sp",
    m: int | None = None,
    theta: float | None = None,
) -> np.ndarray:
    """Full assembled trace (8, T) on a statevector sharded over ``axis``.

    Lanczos substeps with all_reduce-reduced inner products, the sharded H
    apply, and the per-step observables: each named observable (collective
    sea Ix/Iy/Iz, rare x/y/z) is its own term IR, so <psi|O|psi> is the sum
    over ranks of <psi_local | (O psi)_local>, with at most one exchange per
    sharded-site x/y factor.  The step after the last output row, whose
    result the JAX package discards, is not taken."""
    from ..dynamics.krylov import (
        KRYLOV_M,
        KRYLOV_THETA,
        _uniform_dt,
        make_krylov_step,
        spectral_norm_bound,
        spectral_norm_estimate,
    )

    m = KRYLOV_M if m is None else m
    theta = KRYLOV_THETA if theta is None else theta
    times = np.asarray(times)
    T = len(times)
    dt = _uniform_dt(times)
    group, n_shards, my_idx, dev = _sp(mesh, axis)

    sh = ShardedHamiltonian(H, n_shards)
    apply_h = sh.local_apply_fn(group, my_idx, dev)
    norm_bound = min(spectral_norm_bound(H), spectral_norm_estimate(H, device=dev))
    step, n_sub = make_krylov_step(H, dt, m=m, theta=theta, apply_h=apply_h,
                                   norm_bound=norm_bound, axis_name=group, device=dev)

    # observable term IRs: Ix/Iy/Iz_sea (collective sums), rare x/y/z
    sea_sites = list(range(n_sea_effective))
    obs_ops = [OperatorSum.sum_over_sites(dims, sea_sites, w) for w in ("x", "y", "z")] + [
        OperatorSum.single_site(dims, idx_rare, w) for w in ("x", "y", "z")]
    obs_apply = [ShardedHamiltonian(o, n_shards).local_apply_fn(group, my_idx, dev)
                 for o in obs_ops]

    ld = sh.local_dim
    psi = torch.as_tensor(np.asarray(psi0)[my_idx * ld:(my_idx + 1) * ld],
                          dtype=torch.complex128, device=dev)
    e0 = all_reduce(torch.vdot(psi, apply_h(psi)).real.clone(), group)

    rows = []
    for t in range(T):
        vals = all_reduce(torch.stack([torch.vdot(psi, a(psi)).real for a in obs_apply]), group)
        nrm = torch.linalg.vector_norm(
            all_gather_cat(torch.linalg.vector_norm(psi).reshape(1), group))
        # sea x, y, z, rare z, x, y, norm (TRACE_ROWS)
        rows.append(torch.stack([vals[0], vals[1], vals[2], vals[5], vals[3], vals[4], nrm]))
        if t + 1 < T:
            psi = step(psi)
    out = np.empty((8, T))
    out[:7] = torch.stack(rows, dim=1).cpu().numpy()
    out[7] = float(e0)
    return out
