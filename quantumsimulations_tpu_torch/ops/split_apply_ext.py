"""Split-matmul apply in a FIXED-GRID limb domain (the ``ext`` and ``extp`` tiers).

Port of ``quantumsimulations_tpu/ops/split_apply_ext.py``.  The Chebyshev
recurrence state never leaves the limb domain, so the per-term elementwise
work is int32 carry cascades:

  * static operator planes are split once at build time (host numpy);
  * the apply takes canonical limbs and returns canonical limbs — limb-pair
    products into int32 digit stacks, summed across the four buckets
    (diag / left / cross / right) on the shared digit grid, one carry
    cascade at the end;
  * Chebyshev T_k entries are bounded, so the fixed grid (|x| < 2^GRID_BITS)
    always holds mid-recurrence (2*P - T_prev <= 3);
  * only the trace accumulator lives in float64, fed by one grouped limb
    evaluation per term.

Grid: limb j (int8) carries weight 2^(-GRID_BITS * j), so the product of
limbs (j, i) lands exactly on digit j + i; 6-bit limbs x 10 = 60 bits
(resolution 2^-54).

Two tiers, the same numbers bit for bit as the JAX package's:

  * ``make_ext_apply`` (tier ``ext``): each product digit is one exact
    int8 GEMM over its diagonal's limb pairs
    (:func:`..extprec.diagonal_mm`, kernel ``csrc/int8_gemm.cu`` on the
    card), and the digits are carried once after the bucket sum, as the
    JAX package's XLA tier does.
  * ``make_ext_apply_pallas`` (tier ``extp``; the JAX name is kept): every
    product bucket goes through :func:`..limb_kernels.limb_matmul_canon`,
    the hand-written CUDA kernel on the card, with the cross relayout folded
    into its ``transpose_out`` layout.  Per-bucket truncation to L limbs
    differs from ``ext`` below the grid resolution.

Both return an :class:`ExtApply`: ``apply(t_re, t_im) -> (p_re, p_im)`` on
(L, DL, DR) int8 limb stacks as in the JAX package, and
``apply.stacked(T)`` on one (L, 2, DL, DR) stack holding both planes, the
form the stepper uses so that the carries, splits and evaluations run once
for both planes.  The elementwise diagonal bucket and the digit sums are one
batched gather-multiply-``index_add_`` over the 72 limb pairs; int32 sums are
exact in any order, so the bits are those of the JAX package's 72 separate
products.

``make_ext_apply_sharded`` is the same apply on a statevector plane whose DR
columns are sharded over a process group (parallel/cheb_sharded.py): the
buckets that contract over DR are summed across the ranks as one exact
int32 ``all_reduce`` of canonical digits per apply, so its digits equal the
single-rank apply's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .embed import OperatorSum
from .extprec import _cat_k, _right_rev, diagonal_mm
from .limb_kernels import GRID_GUARD, carry_digits, limb_matmul_canon
from .split_apply import SplitOperator, cross_r_flat, left_blocks, right_blocks, split_operator

GRID_BITS = 6
GRID_LIMBS = 10  # 10 * 6 = 60 captured bits; resolution 2^-54 for |x| <= 1


@dataclass(frozen=True)
class GridOps:
    """Limb-domain primitives bound to one (bits, limbs) grid; the limb axis
    is axis 0 throughout."""

    bits: int
    limbs: int
    split: Callable  # float64 -> canonical int8 limbs (L, ...)
    carry: Callable  # int32 digit stack (n, ...) -> canonical int8 limbs (n, ...)
    val: Callable  # canonical limbs (L, ...) -> float64 (grouped Horner)


def _split_host(x: np.ndarray, b: int, L: int) -> np.ndarray:
    """Host split: f64 -> (L, ...) int8 canonical limbs on the 2^b grid."""
    maxabs = float(np.abs(x).max()) if x.size else 0.0
    assert maxabs < 2.0**b, f"grid domain violated: max|x| = {maxabs} >= 2^{b}"
    limbs = np.empty((L,) + x.shape, np.int8)
    r = np.array(x, np.float64)
    l = np.empty_like(r)
    for j in range(L):
        np.rint(r, out=l)
        limbs[j] = l
        r -= l
        r *= float(2**b)
    return limbs


def _make_grid_ops(b: int, L: int) -> GridOps:
    # group size of the Horner evaluation: partial sums stay exact in int32
    # (|l| <= 2^b canonical incl. the fold into limb 0)
    g = max(1, (31 - (b + 1)) // b)

    def split(x: torch.Tensor) -> torch.Tensor:
        limbs = torch.empty((L,) + tuple(x.shape), dtype=torch.int8, device=x.device)
        r = x
        for j in range(L):
            l = torch.round(r)  # half to even, as jnp.rint
            limbs[j] = l
            r = (r - l) * float(2**b)
        return limbs

    def carry(d: torch.Tensor) -> torch.Tensor:
        """Exact carry cascade on int32 digits -> canonical int8 limbs
        (nearest, ties toward +inf)."""
        return carry_digits(d, b, d.shape[0])

    def val(limbs: torch.Tensor) -> torch.Tensor:
        """Canonical limbs -> float64, group by group as the JAX package's
        int32 Horner: group q's integer sum_p l[q*g + p] * 2^(b*(g-1-p)) is
        exact (in float64 too, every partial sum being an integer < 2^31),
        is scaled by the exact power 2^(-b*(q*g + g-1)), and the groups are
        added in order.  A short last group is padded with zero limbs, which
        scales its integer and its weight by inverse powers of two and
        leaves the term's value exactly as it was."""
        n = limbs.shape[0]
        n_groups = -(-n // g)
        x = limbs.to(torch.float64)
        pad = n_groups * g - n
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        x = x.reshape((n_groups, g) + tuple(x.shape[1:]))
        w = torch.tensor([2.0 ** (b * (g - 1 - p)) for p in range(g)],
                         dtype=torch.float64, device=x.device)
        ints = (x * w.reshape((1, g) + (1,) * (x.dim() - 2))).sum(dim=1)
        out = None
        for q in range(n_groups):
            term = ints[q] * (2.0 ** (-float(b * (q * g + g - 1))))
            out = term if out is None else out + term
        return out

    return GridOps(bits=b, limbs=L, split=split, carry=carry, val=val)


def _pairs(L: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(j, i, s = j + i) of the live limb pairs, s < L + GRID_GUARD."""
    jj, ii = [], []
    for s in range(L + GRID_GUARD):
        for j in range(max(0, s - L + 1), min(s + 1, L)):
            jj.append(j)
            ii.append(s - j)
    jj_t = torch.tensor(jj, dtype=torch.long, device=device)
    ii_t = torch.tensor(ii, dtype=torch.long, device=device)
    return jj_t, ii_t, jj_t + ii_t


def _product_digits(a: torch.Tensor, b_st: torch.Tensor, L: int, K: int, bits: int) -> torch.Tensor:
    """Digit stacks of (limb a) @ (limb b): (L+GUARD, M, N) int32, no carry;
    each digit one :func:`..extprec.diagonal_mm`."""
    assert K * (2 ** (2 * bits)) * L < 2**31, "i32 would overflow"
    left, right = _cat_k(a), _right_rev(b_st)
    digits = torch.empty((L + GRID_GUARD, a.shape[1], b_st.shape[2]), dtype=torch.int32,
                         device=a.device)
    for s in range(L + GRID_GUARD):
        diagonal_mm(left, right, L, s, out=digits[s])
    return digits


class ExtApply:
    """``scale * H @ t`` on canonical limb stacks; see the module docstring."""

    def __init__(self, stacked: Callable):
        self.stacked = stacked

    def __call__(self, t_re: torch.Tensor, t_im: torch.Tensor):
        out = self.stacked(torch.stack([t_re, t_im], dim=1))
        return out[:, 0], out[:, 1]


class _ExtOperands:
    """Host split of the static planes that both tiers' applies share."""

    def __init__(self, H: OperatorSum, split, scale, b, L, dev):
        self.so: SplitOperator = split_operator(H, split)
        self.live = self.so.live()
        self.b, self.L, self.dev = b, L, dev
        self.ops = _make_grid_ops(b, L)
        self.jj, self.ii, self.ss = _pairs(L, dev)
        self.diag = self.pre(self.so.diag * scale) if self.live["diag"] else None
        # the diag limbs of every pair, gathered once: (72, 1, DL, DR) int32
        self.diag_pairs = (self.diag.index_select(0, self.jj).to(torch.int32).unsqueeze(1)
                           if self.diag is not None else None)
        rblocks, self.roff = right_blocks(self.so, scale)
        self.Rcat = self.pre(np.concatenate(rblocks, axis=1)) if rblocks else None
        self.rpos = len(rblocks) * self.so.DR

    def pre(self, mat: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(_split_host(np.ascontiguousarray(mat), self.b, self.L),
                               device=self.dev)

    def diag_digits(self, dig: torch.Tensor, T: torch.Tensor) -> None:
        """dig (S, 2, DL, DR) += digits of (limb diag) * (limb T), elementwise."""
        prod = self.diag_pairs * T.index_select(0, self.ii)
        dig.index_add_(0, self.ss, prod)

    def add_right(self, dig, w4, L):
        """Right bucket from w4 (rows, 2, DL, rpos) = [re; im] @ Rcat."""
        DR = self.so.DR
        if self.live["HRre"]:
            o = self.roff["HRre"]
            dig[:L] += w4[..., o:o + DR]
        if self.live["HRim"]:  # (i * HR_im) rotates the planes
            o = self.roff["HRim"]
            dig[:L, 0] -= w4[:L, 1, :, o:o + DR]
            dig[:L, 1] += w4[:L, 0, :, o:o + DR]


def make_ext_apply(
    H: OperatorSum,
    split: int | None = None,
    scale: float = 1.0,
    grid_bits: int = GRID_BITS,
    grid_limbs: int = GRID_LIMBS,
    device: str | torch.device = "cuda",
):
    """Limb-domain apply, tier ``ext``: returns ``(apply, so, ops)``.

    Inputs/outputs are (grid_limbs, DL, DR) int8 canonical limb stacks of
    the statevector planes; the result is ``scale * H @ t`` exact to the
    grid truncation.  ``ops`` is the :class:`GridOps` of the same grid.
    """
    dev = resolve_device(device)
    X = _ExtOperands(H, split, scale, grid_bits, grid_limbs, dev)
    so, live, b, L = X.so, X.live, grid_bits, grid_limbs
    DL, DR = so.DL, so.DR
    S = L + GRID_GUARD
    lblocks, off = left_blocks(so, scale)
    Lcat = X.pre(np.concatenate(lblocks, axis=0)) if lblocks else None
    CreRt = X.pre(cross_r_flat(so.cross_re_R, scale)) if live["A_re"] else None
    CimRt = X.pre(cross_r_flat(so.cross_im_R, scale)) if live["A_im"] else None

    def _cross_digits(z, name, A_n, Rt):
        """Second stage of one cross bucket for both planes: carry the Zc
        slice of the left digits to canonical, relayout to (L, 2*DL, A*DR),
        multiply by the flattened R stack -> (S, 2, DL, DR) digits."""
        Zc = carry_digits(z[:, off[name]: off[name] + A_n * DL], b, L)  # (L, A*DL, 2*DR)
        Zt = Zc.reshape(L, A_n, DL, 2, DR).permute(0, 3, 2, 1, 4).reshape(L, 2 * DL, A_n * DR)
        return _product_digits(Zt, Rt, L, A_n * DR, b).reshape(S, 2, DL, DR)

    def stacked(T: torch.Tensor) -> torch.Tensor:
        dig = torch.zeros((S, 2, DL, DR), dtype=torch.int32, device=T.device)
        if live["diag"]:
            X.diag_digits(dig, T)
        if Lcat is not None:
            bcat = T.permute(0, 2, 1, 3).reshape(L, DL, 2 * DR)  # [re | im]
            z = _product_digits(Lcat, bcat, L, DL, b)  # (S, R, 2*DR)

            def rows(name):
                o = off[name]
                return z[:, o:o + DL].reshape(S, DL, 2, DR).permute(0, 2, 1, 3)

            if live["HLre"]:
                dig += rows("HLre")
            if live["HLim"]:  # (i * HL_im) rotates the planes
                zz = rows("HLim")
                dig[:, 0] -= zz[:, 1]
                dig[:, 1] += zz[:, 0]
            if live["A_re"]:
                dig += _cross_digits(z, "cre", live["A_re"], CreRt)
            if live["A_im"]:
                cc = _cross_digits(z, "cim", live["A_im"], CimRt)
                dig[:, 0] -= cc[:, 1]
                dig[:, 1] += cc[:, 0]
        if X.Rcat is not None:
            w = _product_digits(T.reshape(L, 2 * DL, DR), X.Rcat, L, DR, b)  # (S, 2*DL, rpos)
            X.add_right(dig, w.reshape(S, 2, DL, X.rpos), S)
        return carry_digits(dig, b, L)

    return ExtApply(stacked), so, X.ops


def make_ext_apply_pallas(
    H: OperatorSum,
    split: int | None = None,
    scale: float = 1.0,
    grid_bits: int = GRID_BITS,
    grid_limbs: int = GRID_LIMBS,
    interpret: bool | None = None,
    device: str | torch.device = "cuda",
):
    """Limb-domain apply through the fused limb kernel (tier ``extp``).

    The JAX name is kept; on the card every product bucket runs through the
    hand-written CUDA kernel :func:`..limb_kernels.limb_matmul_canon` (six
    launches per apply for the dipolar model: H_L, two cross stages per
    plane, H_R).  Same contract as :func:`make_ext_apply`; ``interpret`` is
    an accepted no-op (the device picks kernel or plain version).
    """
    dev = resolve_device(device)
    X = _ExtOperands(H, split, scale, grid_bits, grid_limbs, dev)
    so, live, b, L = X.so, X.live, grid_bits, grid_limbs
    DL, DR = so.DL, so.DR
    S = L + GRID_GUARD

    # HL bucket: both planes stacked on the M axis -> one kernel call
    hl_blocks, hl_off = [], {}
    for name, mat in (("HLre", so.HL_re), ("HLim", so.HL_im)):
        if live[name]:
            hl_off[name] = len(hl_blocks) * DL
            hl_blocks.append(mat * scale)
    HLcat = X.pre(np.concatenate(hl_blocks, axis=0)) if hl_blocks else None
    # cross buckets: L operand stacked (A*DL, DL); R stacks flattened and
    # transposed (A*DR, DR), scale folded into R
    A_re, A_im = live["A_re"], live["A_im"]
    CreL = X.pre(so.cross_re_L.reshape(A_re * DL, DL)) if A_re else None
    CreRt = X.pre(cross_r_flat(so.cross_re_R, scale)) if A_re else None
    CimL = X.pre(so.cross_im_L.reshape(A_im * DL, DL)) if A_im else None
    CimRt = X.pre(cross_r_flat(so.cross_im_R, scale)) if A_im else None

    def kmm(x, y, **kw):
        return limb_matmul_canon(x, y, bits=b, **kw)

    def _cross_one(Lst, Rt, t_plane):
        """One cross bucket for one input plane -> canonical (L, DL, DR).
        transpose_out puts M-tile a's (DL, DR) product at columns
        [a*DR, (a+1)*DR): the (L, DL, A*DR) second-stage layout directly."""
        Z = kmm(Lst, t_plane, tm=DL, transpose_out=True)
        return kmm(Z, Rt)

    def stacked(T: torch.Tensor) -> torch.Tensor:
        dig = torch.zeros((S, 2, DL, DR), dtype=torch.int32, device=T.device)
        if live["diag"]:
            X.diag_digits(dig, T)
        if HLcat is not None:
            bcat = T.permute(0, 2, 1, 3).reshape(L, DL, 2 * DR)  # [re | im]
            z = kmm(HLcat, bcat)  # (L, n_hl*DL, 2*DR)

            def rows(name):
                o = hl_off[name]
                return z[:, o:o + DL].reshape(L, DL, 2, DR).permute(0, 2, 1, 3)

            if live["HLre"]:
                dig[:L] += rows("HLre")
            if live["HLim"]:  # (i * HL_im) rotates the planes
                zz = rows("HLim")
                dig[:L, 0] -= zz[:, 1]
                dig[:L, 1] += zz[:, 0]
        if A_re or A_im:
            t_re, t_im = T[:, 0].contiguous(), T[:, 1].contiguous()
        if A_re:
            dig[:L, 0] += _cross_one(CreL, CreRt, t_re)
            dig[:L, 1] += _cross_one(CreL, CreRt, t_im)
        if A_im:
            dig[:L, 0] -= _cross_one(CimL, CimRt, t_im)
            dig[:L, 1] += _cross_one(CimL, CimRt, t_re)
        if X.Rcat is not None:
            w = kmm(T.reshape(L, 2 * DL, DR), X.Rcat)  # (L, 2*DL, rpos): [re; im]
            X.add_right(dig, w.reshape(L, 2, DL, X.rpos), L)
        return carry_digits(dig, b, L)

    return ExtApply(stacked), so, X.ops


def make_ext_apply_sharded(
    H: OperatorSum,
    axis,
    n_shards: int,
    split: int | None = None,
    scale: float = 1.0,
    grid_bits: int = GRID_BITS,
    grid_limbs: int = GRID_LIMBS,
    device: str | torch.device = "cuda",
):
    """DR-column-sharded limb-domain apply (tier ``ext``).

    ``axis`` is the process group of the mesh axis (the JAX package's mesh
    axis name): the statevector plane (DL, DR) is sharded on its DR axis
    over its ``n_shards`` ranks, the rank r of the group holding columns
    [r * DR/n_shards, (r+1) * DR/n_shards).  Communication per apply:

      * diag and left products: local (their contraction dim DL is whole);
      * cross second stage and right bucket contract over the GLOBAL DR
        axis: each rank computes its k-local digit partials for ALL output
        columns, carries them to canonical (bounding each limb at ~2^bits so
        the sum over ranks cannot overflow int32), and ONE int32
        ``all_reduce`` of them sums the ranks exactly, after which each rank
        keeps its own output columns.

    Returns ``(apply, so, ops)``: ``apply(t_re, t_im)`` and
    ``apply.stacked(T)`` map (L, [2,] DL, DR/n_shards) canonical limbs to
    the same, equal to the single-rank :func:`make_ext_apply`'s columns bit
    for bit (the same digit sums, carried once more).  Every rank of the
    group calls each apply together."""
    dev = resolve_device(device)
    X = _ExtOperands(H, split, scale, grid_bits, grid_limbs, dev)
    so, live, b, L = X.so, X.live, grid_bits, grid_limbs
    DL, DR = so.DL, so.DR
    assert DR % n_shards == 0, (DR, n_shards)
    S = L + GRID_GUARD
    DRl = DR // n_shards
    k0 = dist.get_rank(axis) * DRl
    cols = slice(k0, k0 + DRl)
    lblocks, off = left_blocks(so, scale)
    Lcat = X.pre(np.concatenate(lblocks, axis=0)) if lblocks else None
    # cross R stacks (L, A, DRk, DRout) sliced to this rank's k range, then
    # flattened to the (A * DRl, DR) operand that contracts (a, k) at once
    R4 = {name: X.pre(cross_r_flat(R, scale)).reshape(L, A_n, DR, DR)[:, :, cols]
          .reshape(L, A_n * DRl, DR).contiguous()
          for name, R, A_n in (("cre", so.cross_re_R, live["A_re"]),
                               ("cim", so.cross_im_R, live["A_im"])) if A_n}
    diag_pairs = X.diag_pairs[..., cols].contiguous() if X.diag_pairs is not None else None
    Rk = X.Rcat[:, cols].contiguous() if X.Rcat is not None else None

    def _cross_digits(z, name, A_n):
        """k-local second stage of one cross bucket for both planes and ALL
        output columns -> (S, 2, DL, DR) digits."""
        Zc = carry_digits(z[:, off[name]: off[name] + A_n * DL], b, L)  # (L, A*DL, 2*DRl)
        Zt = Zc.reshape(L, A_n, DL, 2, DRl).permute(0, 3, 2, 1, 4).reshape(L, 2 * DL, A_n * DRl)
        return _product_digits(Zt, R4[name], L, A_n * DRl, b).reshape(S, 2, DL, DR)

    def stacked(T: torch.Tensor) -> torch.Tensor:
        dig = torch.zeros((S, 2, DL, DRl), dtype=torch.int32, device=T.device)
        if diag_pairs is not None:
            dig.index_add_(0, X.ss, diag_pairs * T.index_select(0, X.ii))
        glob = []  # digit partials of the buckets that contract over global DR
        if Lcat is not None:
            bcat = T.permute(0, 2, 1, 3).reshape(L, DL, 2 * DRl)  # [re | im]
            z = _product_digits(Lcat, bcat, L, DL, b)  # (S, R, 2*DRl)

            def rows(name):
                o = off[name]
                return z[:, o:o + DL].reshape(S, DL, 2, DRl).permute(0, 2, 1, 3)

            if live["HLre"]:
                dig += rows("HLre")
            if live["HLim"]:  # (i * HL_im) rotates the planes
                zz = rows("HLim")
                dig[:, 0] -= zz[:, 1]
                dig[:, 1] += zz[:, 0]
            if live["A_re"] or live["A_im"]:
                cross = torch.zeros((S, 2, DL, DR), dtype=torch.int32, device=T.device)
                if live["A_re"]:
                    cross += _cross_digits(z, "cre", live["A_re"])
                if live["A_im"]:
                    cc = _cross_digits(z, "cim", live["A_im"])
                    cross[:, 0] -= cc[:, 1]
                    cross[:, 1] += cc[:, 0]
                glob.append(cross)
        if Rk is not None:
            w = _product_digits(T.reshape(L, 2 * DL, DRl), Rk, L, DRl, b)  # (S, 2*DL, rpos)
            glob.append(w.reshape(S, 2, DL, X.rpos))
        if glob:
            # one exact collective: canonical digits summed as int32
            g = carry_digits(torch.cat(glob, dim=-1), b).to(torch.int32)
            dist.all_reduce(g, group=axis)
            col = 0
            if Lcat is not None and (live["A_re"] or live["A_im"]):
                dig += g[..., k0:k0 + DRl]
                col = DR
            if Rk is not None:
                gw = g[..., col:]
                if live["HRre"]:
                    o = X.roff["HRre"] + k0
                    dig += gw[..., o:o + DRl]
                if live["HRim"]:  # (i * HR_im) rotates the planes
                    o = X.roff["HRim"] + k0
                    dig[:, 0] -= gw[:, 1, :, o:o + DRl]
                    dig[:, 1] += gw[:, 0, :, o:o + DRl]
        return carry_digits(dig, b, L)

    return ExtApply(stacked), so, X.ops
