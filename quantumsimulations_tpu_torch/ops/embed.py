"""Operator IR: sums of tensor-product terms over a mixed-dimension spin chain.

Operators are kept as a light IR — a sum of :class:`ProductTerm`s, each a
scalar coefficient times single-site operator factors.  The IR supports:

  * ``to_dense()``        — the dense complex128 matrix (host numpy), which
                            the dense eigendecomposition propagator consumes
                            (``to_dense_kron`` is the slow kron-chain oracle,
                            ``to_dense_cplx`` / ``to_dense_device`` the same
                            matrix as a complex torch tensor);
  * ``to_coo()``          — the aggregated sparse triplet (host numpy), for
                            the spectral bound of the Chebyshev stepper;
  * ``diagonal_part()`` / ``offdiagonal_terms()`` — the decomposition the
                            split-matmul apply (ops/split_apply.py) is built
                            from;
  * ``site_reduced_density`` / ``expect_site`` — single-site expectations
                            through the reduced density matrix;
  * ``apply(psi)``        — the matrix-free H @ psi on a complex torch
                            statevector, term by term (any local dims), and
                            :func:`make_qubit_flip_apply`, the same product
                            for all-spin-1/2 chains in a fixed number of
                            launches (the Krylov and global Chebyshev
                            solvers' apply).

Sites are indexed 0..n-1 with per-site local dimension ``dims[k]`` (the rare
spin, when present, is the last index, matching the reference convention at
dipolar_ensemble_with_rare.py:28-34).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from itertools import product
from typing import Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
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

    # -- constructors --------------------------------------------------------
    @staticmethod
    def single_site(dims: Sequence[int], site: int, which: str, coeff: float = 1.0) -> "OperatorSum":
        return OperatorSum(tuple(dims), (ProductTerm(coeff, ((site, which),)),))

    @staticmethod
    def sum_over_sites(dims: Sequence[int], sites: Sequence[int], which: str,
                       coeff: float = 1.0) -> "OperatorSum":
        return OperatorSum(tuple(dims), tuple(ProductTerm(coeff, ((s, which),)) for s in sites))

    def __add__(self, other: "OperatorSum") -> "OperatorSum":
        if other == 0:
            return self
        if self.dims != other.dims:
            raise ValueError("dims mismatch")
        return OperatorSum(self.dims, self.terms + other.terms)

    __radd__ = __add__

    def __mul__(self, c: float) -> "OperatorSum":
        return OperatorSum(self.dims, tuple(ProductTerm(t.coeff * c, t.factors) for t in self.terms))

    __rmul__ = __mul__

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

    def to_dense_kron(self) -> np.ndarray:
        """Reference kron-chain assembly (slow; kept for validation)."""
        H = np.zeros((self.dim, self.dim), dtype=np.complex128)
        for term in self.terms:
            fac = dict(term.factors)
            mats = [local_op(d, fac[k]) if k in fac else np.eye(d, dtype=np.complex128)
                    for k, d in enumerate(self.dims)]
            H += term.coeff * reduce(np.kron, mats)
        return H

    def to_dense_cplx(self, dtype=torch.float64, device: str | torch.device = "cuda") -> torch.Tensor:
        """:meth:`to_dense` as a complex tensor on ``device`` whose real and
        imaginary parts have ``dtype`` (the JAX package's (re, im) planes)."""
        cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
        return torch.as_tensor(self.to_dense(), device=resolve_device(device)).to(cdtype)

    def to_dense_device(self, col_block: int = 256, device: str | torch.device = "cuda") -> torch.Tensor:
        """The dense matrix assembled on ``device`` as complex128, by applying
        the matrix-free terms to blocks of ``col_block`` identity columns
        (out[:, j] = H @ e_j), as the JAX package's ``to_dense_device``."""
        dev = resolve_device(device)
        dim = self.dim
        cb = min(col_block, dim)
        diag = torch.as_tensor(self.diagonal_part(), dtype=torch.complex128, device=dev)
        out = torch.empty((dim, dim), dtype=torch.complex128, device=dev)
        for start in range(0, dim, cb):
            width = min(cb, dim - start)
            eye = torch.zeros((dim, width), dtype=torch.complex128, device=dev)
            eye[start:start + width].diagonal().fill_(1.0)
            blk = eye * diag[:, None]
            eye_t = eye.reshape(self.dims + (width,))
            for term in self.offdiagonal_terms():
                blk = blk + _apply_product_term(eye_t, self.dims, term).reshape(dim, width)
            out[:, start:start + width] = blk
        return out

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

    # -- matrix-free apply ------------------------------------------------------
    def apply(self, psi: torch.Tensor, diag: torch.Tensor | None = None) -> torch.Tensor:
        """H @ psi for a flat complex statevector (dim,), without
        materializing H.

        ``diag`` may be passed in as a precomputed real tensor on psi's
        device (from :meth:`diagonal_part`); otherwise it is computed on the
        host here.  The off-diagonal terms are applied one by one as per-site
        tensor contractions, in the JAX package's order."""
        if diag is None:
            diag = torch.as_tensor(self.diagonal_part(), device=psi.device)
        out = psi * diag
        psi_t = psi.reshape(self.dims)
        for term in self.offdiagonal_terms():
            out = out + _apply_product_term(psi_t, self.dims, term).reshape(psi.shape)
        return out


def _apply_product_term(psi_t: torch.Tensor, dims: tuple[int, ...], term: ProductTerm) -> torch.Tensor:
    """Apply coeff * prod(op_site) to a tensor-shaped statevector (trailing
    axes after the sites are carried through): each factor contracts its
    site's axis, out'[.., a, ..] = sum_b op[a, b] out[.., b, ..]."""
    out = psi_t
    for site, which in term.factors:
        op = torch.as_tensor(local_op(dims[site], which), dtype=psi_t.dtype, device=psi_t.device)
        out = torch.movedim(torch.tensordot(op, out, dims=([1], [site])), 0, site)
    return out * term.coeff


def site_reduced_density(psi: torch.Tensor, dims: Sequence[int], site: int) -> torch.Tensor:
    """Single-site reduced density matrix rho_site (d, d) of a flat complex
    statevector: rho[a, b] = sum_{l, r} psi[l, a, r] * conj(psi[l, b, r])."""
    dims = tuple(dims)
    dl = int(np.prod(dims[:site], dtype=np.int64)) if site > 0 else 1
    dr = int(np.prod(dims[site + 1:], dtype=np.int64)) if site + 1 < len(dims) else 1
    p = psi.reshape(dl, dims[site], dr)
    return torch.einsum("lar,lbr->ab", p, p.conj())


def expect_site(psi: torch.Tensor, dims: Sequence[int], site: int, which: str) -> torch.Tensor:
    """Real part of <psi| op_site |psi> via the reduced density matrix:
    tr(rho @ op) = sum_ab rho[a, b] op[b, a]."""
    rho = site_reduced_density(psi, dims, site)
    op = torch.as_tensor(local_op(tuple(dims)[site], which), dtype=rho.dtype, device=rho.device)
    return (rho * op.T).sum().real


# ---------------------------------------------------------------------------
# Matrix-free apply for all-spin-1/2 chains in a fixed number of launches.
#
# For qubit chains every off-diagonal product term of the dipolar model
# family is a bit-flip permutation with a per-level coefficient:
#
#   * c_x X_j + c_y Y_j      ->  flip bit j, coefficient (c_x -+ i c_y) by level
#   * c_xx X_jX_k + c_yy Y_jY_k -> flip bits j,k, REAL coefficient
#         c_xx + c_yy * (-1 if a_j == a_k else +1) by level pair
#
# so (H psi)[d] = diag[d] psi[d] + sum_t coef_t[d] psi[d XOR mask_t].  The
# JAX package applies the terms one by one (reshape, reverse, multiply, add),
# which XLA fuses into one program; eagerly that would be ~6 launches per
# term (92 terms, ~550 launches per apply at n_sea = 13).  Here an index
# table idx[t, d] = d XOR mask_t and a coefficient table coef[t, d] (both
# (n_terms, dim), built once on the device) turn the apply into one gather,
# one multiply, one column sum and one multiply-add, whatever the number of
# terms.  The terms are summed in another order than the JAX package's, so
# the two agree to float64 rounding, not bit for bit.
# ---------------------------------------------------------------------------


def make_qubit_flip_apply(H: OperatorSum, device: str | torch.device = "cuda"):
    """Build ``apply(psi, diag) -> H @ psi`` for an all-spin-1/2 OperatorSum
    whose off-diagonal terms are single-site x/y or two-site xx/yy products
    (the dipolar model family), with its tables on ``device``.  ``psi`` is a
    complex128 (dim,) tensor, ``diag`` the real diagonal (dim,).  Returns
    None if the operator has terms outside that family (callers fall back
    to :meth:`OperatorSum.apply`)."""
    dims = H.dims
    if any(d != 2 for d in dims):
        return None
    n = len(dims)
    singles: dict[int, list[float]] = {}
    pairs: dict[tuple[int, int], list[float]] = {}
    for term in H.offdiagonal_terms():
        sites = [s for s, _ in term.factors]
        ops = [w for _, w in term.factors]
        if len(sites) == 1 and ops[0] in ("x", "y"):
            acc = singles.setdefault(sites[0], [0.0, 0.0])
            acc[0 if ops[0] == "x" else 1] += term.coeff
        elif len(sites) == 2 and ops in (["x", "x"], ["y", "y"]):
            acc = pairs.setdefault((sites[0], sites[1]), [0.0, 0.0])
            acc[0 if ops[0] == "x" else 1] += term.coeff
        else:
            return None

    dev = resolve_device(device)
    dim = 1 << n
    index = np.arange(dim, dtype=np.int64)

    def level(site: int) -> np.ndarray:  # site 0 is the most significant bit
        return (index >> (n - 1 - site)) & 1

    masks, coefs = [], []
    # Spin operators carry the 1/2: I_{x,y} = sigma_{x,y}/2, so singles
    # scale by 1/2 and pairs by 1/4.  Coefficients are indexed by the
    # OUTPUT index's levels, as the JAX package's broadcast constants are.
    for site, (cx2, cy2) in singles.items():
        cx, cy = 0.5 * cx2, 0.5 * cy2
        sgn = 1.0 - 2.0 * level(site)  # +1 on level 0, -1 on level 1
        masks.append(1 << (n - 1 - site))
        coefs.append(cx - 1j * (cy * sgn))
    for (j, k), (cxx, cyy) in pairs.items():
        C = 0.25 * np.asarray([[cxx - cyy, cxx + cyy], [cxx + cyy, cxx - cyy]], dtype=np.float64)
        if not np.any(C):
            continue
        masks.append((1 << (n - 1 - j)) | (1 << (n - 1 - k)))
        coefs.append(C[level(j), level(k)].astype(np.complex128))
    if not masks:
        return lambda psi, diag: psi * diag
    idx = torch.as_tensor(
        (index[None, :] ^ np.asarray(masks, dtype=np.int64)[:, None]).reshape(-1), device=dev
    )
    coef = torch.as_tensor(np.stack(coefs), dtype=torch.complex128, device=dev)

    def apply(psi: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
        flipped = torch.index_select(psi, 0, idx).view(coef.shape)
        return torch.addcmul(flipped.mul_(coef).sum(dim=0), psi, diag)

    return apply
