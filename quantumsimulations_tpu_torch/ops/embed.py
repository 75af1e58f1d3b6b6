"""Operator IR: sums of tensor-product terms over a mixed-dimension spin chain.

Operators are kept as a light IR — a sum of :class:`ProductTerm`s, each a
scalar coefficient times single-site operator factors.  Everything here runs
on the host in numpy:

  * ``to_dense()``        — the dense complex128 matrix, which the dense
                            eigendecomposition propagator consumes;
  * ``to_coo()``          — the aggregated sparse triplet, for the spectral
                            bound of the Chebyshev stepper;
  * ``diagonal_part()`` / ``offdiagonal_terms()`` — the decomposition the
                            split-matmul apply (ops/split_apply.py) is built
                            from.

Sites are indexed 0..n-1 with per-site local dimension ``dims[k]`` (the rare
spin, when present, is the last index, matching the reference convention at
dipolar_ensemble_with_rare.py:28-34).

Not yet ported from ``quantumsimulations_tpu/ops/embed.py``: the matrix-free
``apply`` and ``to_dense_device``, which only the Krylov and global
Chebyshev solvers use (ROADMAP.md queue 1 item 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product

import numpy as np

from .spin import spin_matrix


def local_op(dim: int, which: str) -> np.ndarray:
    """Single-site spin operator for a site of local dimension ``dim``."""
    s = (dim - 1) / 2.0
    return spin_matrix(s, which)


@dataclass(frozen=True)
class ProductTerm:
    """coeff * prod_k op_k acting on the listed sites (identity elsewhere)."""

    coeff: float
    factors: tuple[tuple[int, str], ...]  # ((site, opname), ...) sorted by site

    def __post_init__(self):
        sites = [s for s, _ in self.factors]
        if sorted(sites) != list(sites) or len(set(sites)) != len(sites):
            raise ValueError("factors must be sorted by site and unique")


@dataclass(frozen=True)
class OperatorSum:
    """A Hermitian-by-construction sum of product terms on a spin chain."""

    dims: tuple[int, ...]
    terms: tuple[ProductTerm, ...]

    @property
    def dim(self) -> int:
        return int(np.prod(self.dims))

    def _strides_and_digits(self):
        dims = self.dims
        n = len(dims)
        strides = np.ones(n, dtype=np.int64)
        for k in range(n - 2, -1, -1):
            strides[k] = strides[k + 1] * dims[k + 1]
        rows = np.arange(self.dim, dtype=np.int64)
        digits = [(rows // strides[k]) % dims[k] for k in range(n)]
        return strides, rows, digits

    def _combos(self, term: ProductTerm, strides, digits):
        """(value, row mask, column shift) for each combination of the
        factors' local nonzero entries, in the reference's order."""
        factor_entries = []
        for site, which in term.factors:
            M = local_op(self.dims[site], which)
            nz = np.nonzero(M)
            factor_entries.append(
                (site, [(int(a), int(b), M[a, b]) for a, b in zip(*nz)])
            )
        for combo in product(*[ents for _, ents in factor_entries]):
            value = term.coeff
            mask = np.ones(self.dim, dtype=bool)
            col_shift = np.int64(0)
            for (site, _), (a, b, v) in zip(factor_entries, combo):
                value = value * v
                mask &= digits[site] == a
                col_shift += (b - a) * strides[site]
            yield value, mask, col_shift

    def to_dense(self) -> np.ndarray:
        """Assemble the full matrix on the host as numpy complex128.

        Index-arithmetic assembly: the matrix of a product term is sparse
        (one entry per combination of the factors' local nonzeros), so each
        term contributes O(dim) scattered entries instead of an O(dim^2)
        kron chain.  Terms and entries are accumulated in the same order as
        the reference assembly, so the result matches it bit for bit.
        """
        dim = self.dim
        strides, rows, digits = self._strides_and_digits()
        H = np.zeros((dim, dim), dtype=np.complex128)
        for term in self.terms:
            for value, mask, col_shift in self._combos(term, strides, digits):
                r = rows[mask]
                H[r, r + col_shift] += value
        return H

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Aggregated sparse (rows, cols, values) triplet of the operator.

        Same index-arithmetic walk as :meth:`to_dense`, accumulated into one
        vector per column shift, so the dense dim^2 buffer never exists.
        Entries at the same (row, col) are summed in the same order as
        to_dense, so values match it bit for bit; exact zeros are dropped
        and duplicates are fully aggregated.
        """
        dim = self.dim
        strides, _, digits = self._strides_and_digits()
        acc: dict[int, np.ndarray] = {}
        for term in self.terms:
            for value, mask, col_shift in self._combos(term, strides, digits):
                vec = acc.get(int(col_shift))
                if vec is None:
                    vec = acc[int(col_shift)] = np.zeros(dim, dtype=np.complex128)
                vec[mask] += value
        out_r, out_c, out_v = [], [], []
        for shift in sorted(acc):
            vec = acc[shift]
            nzr = np.nonzero(vec)[0]
            out_r.append(nzr)
            out_c.append(nzr + shift)
            out_v.append(vec[nzr])
        if not out_r:
            z = np.zeros(0)
            return z.astype(np.int64), z.astype(np.int64), z.astype(np.complex128)
        return np.concatenate(out_r), np.concatenate(out_c), np.concatenate(out_v)

    def diagonal_part(self) -> np.ndarray:
        """Sum of all purely diagonal terms as a length-dim real vector.

        Terms made only of 'z' (and 'i') factors are diagonal in the product
        basis; aggregating them into one vector turns the dominant part of
        the dipolar Hamiltonian into a single elementwise multiply.
        """
        diag = np.zeros(self.dim, dtype=np.float64)
        for term in self.terms:
            if not self._is_diagonal(term):
                continue
            v = np.ones(1, dtype=np.float64)
            fac = dict(term.factors)
            for k, d in enumerate(self.dims):
                loc = np.real(np.diag(local_op(d, fac[k]))) if k in fac else np.ones(d)
                v = np.kron(v, loc)
            diag += term.coeff * v
        return diag

    @staticmethod
    def _is_diagonal(term: ProductTerm) -> bool:
        return all(op in ("z", "i") for _, op in term.factors)

    def offdiagonal_terms(self) -> tuple[ProductTerm, ...]:
        return tuple(t for t in self.terms if not self._is_diagonal(t))
