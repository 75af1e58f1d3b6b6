"""Hamiltonian apply as small dense matmuls via a left/right Hilbert-space split.

Port of ``quantumsimulations_tpu/ops/split_apply.py`` (the ``f64`` tier of
the Chebyshev stepper).  Factor the n-site chain into a LEFT group (sites <
split) and a RIGHT group (sites >= split) and view the statevector as a
(DL, DR) matrix Psi.  Every product term falls into one of four buckets:

  * purely diagonal terms        ->  one (DL, DR) table D:  out += D * Psi
  * terms entirely on the left   ->  H_L (DL x DL):         out += H_L @ Psi
  * terms entirely on the right  ->  H_R (DR x DR):         out += Psi @ H_R^T
  * cross terms L (x) R          ->  out += L_a @ Psi @ R_a^T

The cross bucket factors by left operator, and the i's of y factors are
folded so that every stacked plane is REAL (``_subchain_real``).  The host
decomposition (:func:`split_operator`) is numpy and matches the JAX
package's bit for bit.

The dense products are ``torch.matmul`` on float64 (cuBLAS DGEMM on the
card), as the JAX package leaves them to XLA.  The statevector travels as
two float64 planes (re, im), the same contract as the JAX package's
``Cplx``, so that checkpoints and the limb tiers share it.  The fused form
multiplies both planes in one matmul per bucket (``Lcat @ [re | im]``);
the values agree with the JAX package to float64 roundoff.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device
from .embed import OperatorSum, local_op


def _subchain_real(dims: tuple[int, ...], factors) -> tuple[np.ndarray, int]:
    """Real matrix + i-phase exponent of prod(op) over the sub-chain dims.

    factors: iterable of (local_site_index, opname) with indices relative to
    the sub-chain.  Equals i^phase * (returned real matrix).
    """
    mats = []
    n_y = 0
    fac = dict(factors)
    for k, d in enumerate(dims):
        if k in fac:
            op = local_op(d, fac[k])
            if fac[k] == "y":
                n_y += 1
                op = np.real(op / 1j)  # y / i is real
            else:
                op = np.real(op)  # x, z, i are real
        else:
            op = np.eye(d)
        mats.append(op)
    M = mats[0]
    for m in mats[1:]:
        M = np.kron(M, m)
    return M, n_y


@dataclass(frozen=True)
class SplitOperator:
    """Host-side split decomposition of an OperatorSum (all planes real)."""

    dims: tuple[int, ...]
    split: int
    DL: int
    DR: int
    diag: np.ndarray  # (DL, DR) real
    HL_re: np.ndarray  # (DL, DL)
    HL_im: np.ndarray
    HR_re: np.ndarray  # (DR, DR)
    HR_im: np.ndarray
    # cross stacks; term = phase * L (x) R with L/R REAL and phase in {1, i}
    # (the -1/-i signs are folded into R).  Shapes (A, DL, DL) / (A, DR, DR).
    cross_re_L: np.ndarray
    cross_re_R: np.ndarray
    cross_im_L: np.ndarray
    cross_im_R: np.ndarray

    def to_dense(self) -> np.ndarray:
        """Reassemble the full dense matrix (tests)."""
        dim = self.DL * self.DR
        H = np.zeros((dim, dim), dtype=np.complex128)
        H[np.arange(dim), np.arange(dim)] = self.diag.reshape(-1)
        H += np.kron(self.HL_re + 1j * self.HL_im, np.eye(self.DR))
        H += np.kron(np.eye(self.DL), self.HR_re + 1j * self.HR_im)
        for a in range(self.cross_re_L.shape[0]):
            H += np.kron(self.cross_re_L[a], self.cross_re_R[a])
        for a in range(self.cross_im_L.shape[0]):
            H += 1j * np.kron(self.cross_im_L[a], self.cross_im_R[a])
        return H

    def live(self) -> dict:
        """Which buckets hold anything (zero planes are skipped)."""
        return {
            "diag": bool(np.any(self.diag)),
            "HLre": bool(np.any(self.HL_re)),
            "HLim": bool(np.any(self.HL_im)),
            "HRre": bool(np.any(self.HR_re)),
            "HRim": bool(np.any(self.HR_im)),
            "A_re": self.cross_re_L.shape[0],
            "A_im": self.cross_im_L.shape[0],
        }


def default_split(dims: tuple[int, ...]) -> int:
    """Split point balancing DL ~ DR (matmul cost ~ A*DL*DR*(DL+DR))."""
    n = len(dims)
    best, best_cost = 1, float("inf")
    for s in range(1, n):
        DL = int(np.prod(dims[:s], dtype=np.int64))
        DR = int(np.prod(dims[s:], dtype=np.int64))
        cost = DL * DR * (DL + DR)
        if cost < best_cost:
            best, best_cost = s, cost
    return best


def split_operator(H: OperatorSum, split: int | None = None) -> SplitOperator:
    """Decompose ``H`` about ``split`` (sites < split are the left group)."""
    dims = H.dims
    n = len(dims)
    if split is None:
        split = default_split(dims)
    if not (1 <= split <= n - 1):
        raise ValueError(f"split must be in [1, {n - 1}], got {split}")
    ldims = dims[:split]
    rdims = dims[split:]
    DL = int(np.prod(ldims, dtype=np.int64))
    DR = int(np.prod(rdims, dtype=np.int64))

    diag = H.diagonal_part().reshape(DL, DR)
    HL = np.zeros((DL, DL), dtype=np.complex128)
    HR = np.zeros((DR, DR), dtype=np.complex128)
    # cross accumulation keyed by (left factor signature, total i-phase mod 2)
    # -> [L real matrix (unit coeff), accumulated R real matrix]; the sign
    # (-1)^(phase // 2) folds into R so only phase mod 2 (real vs i) remains.
    cross: dict[tuple, list[np.ndarray]] = {}
    for term in H.offdiagonal_terms():
        lf = tuple((s, op) for s, op in term.factors if s < split)
        rf = tuple((s - split, op) for s, op in term.factors if s >= split)
        if not rf:
            M, n_y = _subchain_real(ldims, lf)
            HL += term.coeff * (1j**n_y) * M
        elif not lf:
            M, n_y = _subchain_real(rdims, rf)
            HR += term.coeff * (1j**n_y) * M
        else:
            L, py = _subchain_real(ldims, lf)
            R, qy = _subchain_real(rdims, rf)
            phase = (py + qy) % 4
            sign = -1.0 if phase >= 2 else 1.0
            key = (lf, phase % 2)
            acc = cross.get(key)
            if acc is None:
                cross[key] = [L, sign * term.coeff * R]
            else:
                acc[1] = acc[1] + sign * term.coeff * R
    re_L, re_R, im_L, im_R = [], [], [], []
    for (lf, par), (L, R) in sorted(cross.items()):
        if not np.any(R):
            continue
        (re_L if par == 0 else im_L).append(L)
        (re_R if par == 0 else im_R).append(R)

    def _stack(mats, d):
        return np.stack(mats) if mats else np.zeros((0, d, d))

    return SplitOperator(
        dims=dims, split=split, DL=DL, DR=DR, diag=diag,
        HL_re=np.real(HL), HL_im=np.imag(HL),
        HR_re=np.real(HR), HR_im=np.imag(HR),
        cross_re_L=_stack(re_L, DL), cross_re_R=_stack(re_R, DR),
        cross_im_L=_stack(im_L, DL), cross_im_R=_stack(im_R, DR),
    )


def left_blocks(so: SplitOperator, scale: float) -> tuple[list[np.ndarray], dict[str, int]]:
    """Row blocks of the one left operand [HL_re; HL_im; cross_re_L; cross_im_L]
    (live blocks only) and each block's row offset; ``scale`` folds into the
    H_L planes only (the cross scale lives in the R stacks)."""
    live = so.live()
    blocks: list[np.ndarray] = []
    off: dict[str, int] = {}
    pos = 0
    for name, mat, on in (
        ("HLre", so.HL_re * scale, live["HLre"]),
        ("HLim", so.HL_im * scale, live["HLim"]),
        ("cre", so.cross_re_L, live["A_re"]),
        ("cim", so.cross_im_L, live["A_im"]),
    ):
        if on:
            off[name] = pos
            blocks.append(mat.reshape(-1, so.DL))
            pos += blocks[-1].shape[0]
    return blocks, off


def right_blocks(so: SplitOperator, scale: float) -> tuple[list[np.ndarray], dict[str, int]]:
    """Column blocks of the one right operand [HR_re^T | HR_im^T] (live
    blocks only) and each block's column offset."""
    live = so.live()
    blocks: list[np.ndarray] = []
    off: dict[str, int] = {}
    for name, mat, on in (("HRre", so.HR_re.T * scale, live["HRre"]),
                          ("HRim", so.HR_im.T * scale, live["HRim"])):
        if on:
            off[name] = len(blocks) * so.DR
            blocks.append(mat)
    return blocks, off


def cross_r_flat(R: np.ndarray, scale: float) -> np.ndarray:
    """(A, DR, DR) cross R stack -> (A*DR, DR) with row a*DR + k, column l
    holding scale * R[a, l, k]: the operand that contracts (a, k) at once."""
    A, DR, _ = R.shape
    return np.transpose(R * scale, (0, 2, 1)).reshape(A * DR, DR)


class PlaneApply:
    """``scale * H @ psi`` on float64 planes: ``apply(pr, pi) -> (re, im)``
    on (DL, DR) planes, as the JAX package's apply on a ``Cplx``, and
    ``apply.stacked(P)`` on one (2, DL, DR) tensor holding both planes (the
    form the Chebyshev stepper uses)."""

    def __init__(self, stacked):
        self.stacked = stacked

    def __call__(self, pr: torch.Tensor, pi: torch.Tensor):
        out = self.stacked(torch.stack([pr, pi]))
        return out[0], out[1]


def make_split_apply(
    H: OperatorSum,
    split: int | None = None,
    scale: float = 1.0,
    fused: bool = True,
    device: str | torch.device = "cuda",
):
    """:class:`PlaneApply` computing ``scale * H @ psi`` on (DL, DR) float64
    planes, entirely in dense matmuls.

    ``scale`` (e.g. 1/lambda for Chebyshev) is folded into the precomputed
    matrices.  Returns ``(apply, so)`` with the :class:`SplitOperator`.
    Zero planes are skipped when the apply is built.  ``fused=True`` (the
    default) concatenates every left-acting matrix into one operand and
    both H_R planes into another, and multiplies both statevector planes at
    once; ``fused=False`` issues one product per bucket and plane, as the
    JAX package's unfused form does.  Same values to float64 roundoff.
    """
    dev = resolve_device(device)
    so = split_operator(H, split)
    if fused:
        return _make_split_apply_fused(so, scale, dev), so
    live = so.live()

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=dev)

    diag = t(so.diag * scale)
    HLre, HLim = t(so.HL_re * scale), t(so.HL_im * scale)
    HRreT, HRimT = t(so.HR_re.T * scale), t(so.HR_im.T * scale)
    CreL, CreR = t(so.cross_re_L), t(so.cross_re_R * scale)
    CimL, CimR = t(so.cross_im_L), t(so.cross_im_R * scale)

    def _cross(Lst, Rst, plane):
        # sum_a L_a @ plane @ R_a^T as two batched matmuls
        Z = torch.einsum("aij,jk->aik", Lst, plane)
        return torch.einsum("aik,alk->il", Z, Rst)

    def apply(P: torch.Tensor) -> torch.Tensor:
        pr, pi = P[0], P[1]
        out_re = diag * pr if live["diag"] else torch.zeros_like(pr)
        out_im = diag * pi if live["diag"] else torch.zeros_like(pi)
        if live["HLre"]:
            out_re = out_re + HLre @ pr
            out_im = out_im + HLre @ pi
        if live["HLim"]:
            out_re = out_re - HLim @ pi
            out_im = out_im + HLim @ pr
        if live["HRre"]:
            out_re = out_re + pr @ HRreT
            out_im = out_im + pi @ HRreT
        if live["HRim"]:
            out_re = out_re - pi @ HRimT
            out_im = out_im + pr @ HRimT
        if live["A_re"]:  # real cross stack: planes independent
            out_re = out_re + _cross(CreL, CreR, pr)
            out_im = out_im + _cross(CreL, CreR, pi)
        if live["A_im"]:  # i * (L (x) R): rotates the planes
            out_re = out_re - _cross(CimL, CimR, pi)
            out_im = out_im + _cross(CimL, CimR, pr)
        return torch.stack([out_re, out_im])

    return PlaneApply(apply), so


def _make_split_apply_fused(so: SplitOperator, scale: float, dev: torch.device):
    """Fused form of :func:`make_split_apply` on stacked planes (2, DL, DR).

    One ``Lcat @ [pr | pi]`` matmul yields every left product of both
    planes; each cross bucket's second stage is one matmul of the relaid
    (2*DL, A*DR) products against the flattened R stack; the right bucket
    is one ``[pr; pi] @ [HR_re^T | HR_im^T]`` matmul.
    """
    DL, DR = so.DL, so.DR
    live = so.live()

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=dev)

    lblocks, off = left_blocks(so, scale)
    rblocks, roff = right_blocks(so, scale)
    Lcat = t(np.concatenate(lblocks, axis=0)) if lblocks else None
    Rcat = t(np.concatenate(rblocks, axis=1)) if rblocks else None
    diag = t(so.diag * scale)
    CreRt = t(cross_r_flat(so.cross_re_R, scale)) if live["A_re"] else None
    CimRt = t(cross_r_flat(so.cross_im_R, scale)) if live["A_im"] else None

    def _cross(Z, name, A_n, Rt):
        """sum_a (L_a @ plane) @ R_a^T for both planes: (2, DL, DR)."""
        Zc = Z[off[name]: off[name] + A_n * DL].reshape(A_n, DL, 2, DR)
        Zt = Zc.permute(2, 1, 0, 3).reshape(2 * DL, A_n * DR)
        return (Zt @ Rt).reshape(2, DL, DR)

    def _rows(Z, name):
        """Rows of one H_L block for both planes: (2, DL, DR)."""
        o = off[name]
        return Z[o:o + DL].reshape(DL, 2, DR).permute(1, 0, 2)

    def apply(P: torch.Tensor) -> torch.Tensor:
        out = diag * P if live["diag"] else torch.zeros_like(P)
        if Lcat is not None:
            Z = Lcat @ P.permute(1, 0, 2).reshape(DL, 2 * DR)  # (R, 2*DR): [re | im]
            if live["HLre"]:
                out += _rows(Z, "HLre")
            if live["HLim"]:  # (i * HL_im) rotates the planes
                zz = _rows(Z, "HLim")
                out[0] -= zz[1]
                out[1] += zz[0]
            if live["A_re"]:
                out += _cross(Z, "cre", live["A_re"], CreRt)
            if live["A_im"]:
                c = _cross(Z, "cim", live["A_im"], CimRt)
                out[0] -= c[1]
                out[1] += c[0]
        if Rcat is not None:
            W = (P.reshape(2 * DL, DR) @ Rcat).reshape(2, DL, -1)  # [re; im] @ Rcat
            if live["HRre"]:
                o = roff["HRre"]
                out += W[:, :, o:o + DR]
            if live["HRim"]:
                o = roff["HRim"]
                out[0] -= W[1, :, o:o + DR]
                out[1] += W[0, :, o:o + DR]
        return out

    return PlaneApply(apply)
