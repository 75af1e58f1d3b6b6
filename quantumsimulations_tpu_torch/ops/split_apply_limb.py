"""Split-matmul Hamiltonian apply with int8-LIMB products: the "limb" tier.

Port of ``quantumsimulations_tpu/ops/split_apply_limb.py``.  The same
decomposition as :mod:`.split_apply` (left/right Hilbert split, fused left
concat, factored cross bucket), but every matmul is an exact int8 limb
product of the Ozaki tier (ops/extprec.py: ``_limb_split`` and
``_accumulate_products``) with 9 limbs of 6 bits (54 bits >= float64's 53):
each product is exact in int32 up to the float64 sum over the significance
diagonals, so the apply agrees with the float64 one to float64 rounding.

The static operator planes are limb-split once, when the apply is built;
the statevector planes (and the cross bucket's first-stage products) are
split per apply, each plane with its own scale, as in the JAX package.
Where the JAX package multiplies the two planes one at a time, the port
lays both planes of one operand side by side in one GEMM (along N for the
left bucket, along M for the cross and right buckets) and applies each
plane's scale to its half of the int32 result: the integer digits of a
column never mix with another column's, so the values are those of two
separate products.

int32 budget: every product needs K * 2^(2*limb_bits) * n_limbs < 2^31 (K
the contraction dim), at 6 bits K < ~58k; checked when the apply is built.

The arithmetic tier under dynamics/cheb_step.py (``arithmetic="limb"``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .embed import OperatorSum
from .extprec import _accumulate_products, _check_i32, _limb_split
from .split_apply import PlaneApply, cross_r_flat, left_blocks, right_blocks, split_operator

N_LIMBS = 9
LIMB_BITS = 6  # 9 * 6 = 54 bits >= float64's 53-bit significand


def make_split_apply_limb(
    H: OperatorSum,
    split: int | None = None,
    scale: float = 1.0,
    n_limbs: int = N_LIMBS,
    limb_bits: int = LIMB_BITS,
    device: str | torch.device = "cuda",
):
    """:class:`~.split_apply.PlaneApply` computing ``scale * H @ psi`` on
    (DL, DR) float64 planes with every matmul an exact int8 limb product.

    Returns ``(apply, so)`` like :func:`.split_apply.make_split_apply`.
    Values match the float64 apply to float64 rounding (~1e-15 relative)."""
    dev = resolve_device(device)
    so = split_operator(H, split)
    DL, DR = so.DL, so.DR
    live = so.live()
    A_re, A_im = live["A_re"], live["A_im"]
    for K in (DL, DR, A_re * DR, A_im * DR):
        if K:
            _check_i32(K, n_limbs, limb_bits)

    def prelimb(mat: np.ndarray):
        t = torch.as_tensor(np.ascontiguousarray(mat), dtype=torch.float64, device=dev)
        return _limb_split(t, n_limbs, limb_bits)

    # left concat (live block rows): ONE (R, DL) @ (DL, 2*DR) limb product
    lblocks, off = left_blocks(so, scale)
    Lcat = prelimb(np.concatenate(lblocks, axis=0)) if lblocks else None
    # cross second stage as ONE (2*DL, A*DR) @ (A*DR, DR) limb product
    CreRt = prelimb(cross_r_flat(so.cross_re_R, scale)) if A_re else None
    CimRt = prelimb(cross_r_flat(so.cross_im_R, scale)) if A_im else None
    # right concat: ONE (2*DL, DR) @ (DR, rpos) limb product
    rblocks, roff = right_blocks(so, scale)
    Rcat = prelimb(np.concatenate(rblocks, axis=1)) if rblocks else None
    diag = torch.as_tensor(so.diag * scale, dtype=torch.float64, device=dev)

    def mm(A, B, shape):
        return _accumulate_products(A, B, shape, n_limbs, limb_bits)

    def split_planes(x: torch.Tensor, dim: int):
        """Both planes of x (2, M, N) split, each with its own scale, their
        limb stacks laid side by side along the plane's ``dim`` (0: M,
        1: N)."""
        (l0, s0), (l1, s1) = (_limb_split(x[0], n_limbs, limb_bits),
                              _limb_split(x[1], n_limbs, limb_bits))
        return torch.cat([l0, l1], dim=dim + 1), (s0, s1)

    def scaled_halves(out: torch.Tensor, dim: int, s_op: float, s_planes) -> torch.Tensor:
        """(2, ...) from a product whose halves along ``dim`` are the two
        planes: each half times s_op * its plane's scale."""
        a, b = out.chunk(2, dim=dim)
        return torch.stack([a * (s_op * s_planes[0]), b * (s_op * s_planes[1])])

    def cross(Z: torch.Tensor, name: str, A_n: int, Rt) -> torch.Tensor:
        """sum_a (L_a @ plane) @ R_a^T for both planes from the left
        products Z (2, R, DR): (2, DL, DR)."""
        Zt = Z[:, off[name]: off[name] + A_n * DL].reshape(2, A_n, DL, DR)
        Zt = Zt.permute(0, 2, 1, 3).reshape(2, DL, A_n * DR)
        zl, zs = split_planes(Zt, 0)
        return scaled_halves(mm(zl, Rt[0], (2 * DL, DR)), 0, Rt[1], zs)

    def apply(P: torch.Tensor) -> torch.Tensor:
        out = diag * P if live["diag"] else torch.zeros_like(P)
        if Lcat is not None:
            pl, ps = split_planes(P, 1)  # (n, DL, 2*DR)
            R = Lcat[0].shape[1]
            Z = scaled_halves(mm(Lcat[0], pl, (R, 2 * DR)), 1, Lcat[1], ps)  # (2, R, DR)
            if live["HLre"]:
                out += Z[:, off["HLre"]: off["HLre"] + DL]
            if live["HLim"]:  # (i * HL_im) rotates the planes
                zz = Z[:, off["HLim"]: off["HLim"] + DL]
                out[0] -= zz[1]
                out[1] += zz[0]
            if A_re:
                out += cross(Z, "cre", A_re, CreRt)
            if A_im:
                c = cross(Z, "cim", A_im, CimRt)
                out[0] -= c[1]
                out[1] += c[0]
        if Rcat is not None:
            pl, ps = split_planes(P, 0)  # (n, 2*DL, DR)
            W = scaled_halves(mm(pl, Rcat[0], (2 * DL, Rcat[0].shape[2])), 0, Rcat[1], ps)
            if live["HRre"]:
                o = roff["HRre"]
                out += W[:, :, o:o + DR]
            if live["HRim"]:
                o = roff["HRim"]
                out[0] -= W[1, :, o:o + DR]
                out[1] += W[0, :, o:o + DR]
        return out

    return PlaneApply(apply), so
