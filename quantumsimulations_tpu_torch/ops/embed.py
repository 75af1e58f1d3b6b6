"""Operator IR: sums of tensor-product terms over a mixed-dimension spin chain.

Operators are kept as a light IR — a sum of :class:`ProductTerm`s, each a
scalar coefficient times single-site operator factors — and assembled into a
dense numpy complex128 matrix on the host (``to_dense``), which is what the
dense eigendecomposition propagator consumes.

Sites are indexed 0..n-1 with per-site local dimension ``dims[k]`` (the rare
spin, when present, is the last index, matching the reference convention at
dipolar_ensemble_with_rare.py:28-34).

Not yet ported from ``quantumsimulations_tpu/ops/embed.py``: the matrix-free
``apply``, ``to_coo`` and the expectation helpers, which only the stepping
solvers use (ROADMAP.md queue 1 items 2 and 5).
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

    def to_dense(self) -> np.ndarray:
        """Assemble the full matrix on the host as numpy complex128.

        Index-arithmetic assembly: the matrix of a product term is sparse
        (one entry per combination of the factors' local nonzeros), so each
        term contributes O(dim) scattered entries instead of an O(dim^2)
        kron chain.  Terms and entries are accumulated in the same order as
        the reference assembly, so the result matches it bit for bit.
        """
        dims = self.dims
        dim = self.dim
        n = len(dims)
        strides = np.ones(n, dtype=np.int64)
        for k in range(n - 2, -1, -1):
            strides[k] = strides[k + 1] * dims[k + 1]
        rows = np.arange(dim, dtype=np.int64)
        digits = [(rows // strides[k]) % dims[k] for k in range(n)]

        H = np.zeros((dim, dim), dtype=np.complex128)
        for term in self.terms:
            # local nonzero entries per factor: (row_digit, col_digit, value)
            factor_entries = []
            for site, which in term.factors:
                M = local_op(dims[site], which)
                nz = np.nonzero(M)
                factor_entries.append(
                    (site, [(int(a), int(b), M[a, b]) for a, b in zip(*nz)])
                )
            for combo in product(*[ents for _, ents in factor_entries]):
                value = term.coeff
                mask = np.ones(dim, dtype=bool)
                col_shift = np.int64(0)
                for (site, _), (a, b, v) in zip(factor_entries, combo):
                    value = value * v
                    mask &= digits[site] == a
                    col_shift += (b - a) * strides[site]
                r = rows[mask]
                H[r, r + col_shift] += value
        return H
