"""Fixed-grid extended precision ("ext"): ~75-bit values as canonical 5-bit
limb stacks on a FIXED power-of-two grid.

Port of the ext part of ``quantumsimulations_tpu/ops/extprec.py``:

    value = sum_j l_j * 2^(EXT_E - 5*(j+1)),   l_j integer, |l_j| <= 16

(limb 0 takes the top carry and reaches |l_0| <= 33).  Every chain value of
the dense step-operator chain (dynamics/expm_propagator.py) is bounded, so
the grid never moves: products land exactly ON grid positions, digit sums
are exact integers, and renormalisation is an exact carry cascade.  The only
error is the truncation below limb L.

Limb products.  The JAX package runs each limb-pair product as an XLA dot
``s8 x s8 -> s32``; here it is :func:`int_mm`: on the card the hand-written
Hopper int8 GEMM ``csrc/int8_gemm.cu`` (``ops/int8_gemm.py``), on the CPU
``torch._int_mm``.  The limb pairs of one significance diagonal are laid
side by side along K, so each diagonal is one GEMM per Karatsuba term: the
left operand is the limb stack concatenated along K (:class:`ExtLeft`), the
right operand the limb stack in reversed limb order, so that the pairs
(j, s - j) of diagonal s are one contiguous K range of both
(:func:`diagonal_mm`, which every exact limb product of the port uses: the
ext chain, the Ozaki products, the ``limb`` and ``ext`` tiers of
``cheb_step``).  Each limb
takes a whole number of 16-byte rows of K (zeros after a ragged K, which
change no sum), so every GEMM operand starts and strides on 16 bytes, as
the kernel reads them.  Int32 sums are exact in any order (headroom
asserted as in the JAX package), so the digits, and every carried limb,
equal the JAX package's bit for bit.

The two limb splits of the Hamiltonian decide the bits of the whole chain
(they may canonicalise ties differently, both exact), so both are ported as
plain functions: the float32 triple split with native-f32 extraction
(:func:`ext_split_upload`) and the host canonical split of COO values plus a
scatter (:func:`ext_split_upload_coo_pair_host`).  What the JAX package adds
around them for its TPU tunnel (flat 1-D uploads, the packed scatter
program, the paired f32 upload) is left out: a tensor goes to the card with
one ``.to(device)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import count, launch_span
from .ext_carry import EXT_GUARD, EXT_LIMBS, ext_axpy_traced, ext_carry_panel
from .int8_gemm import int8_gemm
from .limb_kernels import carry_digits

# Fixed grid top exponent; a multiple of 5 so that products of two
# grid-aligned limbs land exactly on grid positions (s = j + i).
EXT_E = 5


def _ext_w(j: int) -> float:
    """Weight of limb j (exact power of two)."""
    return float(2.0 ** (EXT_E - 5 * (j + 1)))


def ext_split(x: torch.Tensor, L: int = EXT_LIMBS) -> torch.Tensor:
    """float64 -> (L, ...) int8 canonical limbs on the fixed grid (exact
    multiply / round-half-even / subtract steps, as ``jnp.rint``)."""
    limbs = torch.empty((L,) + tuple(x.shape), dtype=torch.int8, device=x.device)
    r = x.to(torch.float64) * (2.0 ** (5 - EXT_E))
    for j in range(L):
        lj = torch.round(r)
        limbs[j] = lj.to(torch.int8)
        r = (r - lj) * 32.0
    return limbs


def ext_split_host(x: np.ndarray, L: int = EXT_LIMBS) -> np.ndarray:
    """Host (numpy) ext_split: float64 -> (L, ...) int8 canonical limbs."""
    maxabs = float(np.abs(x).max()) if x.size else 0.0
    assert maxabs < 2.0**EXT_E, (
        f"ext_split_host domain violated: max|x| = {maxabs} >= 2^{EXT_E} "
        "(out-of-grid input would silently corrupt the int8 limbs)"
    )
    limbs = np.empty((L,) + x.shape, np.int8)
    r = np.array(x * (2.0 ** (5 - EXT_E)))
    lj = np.empty_like(r)
    for j in range(L):
        np.rint(r, out=lj)
        limbs[j] = lj
        r -= lj
        r *= 32.0
    return limbs


def ext_val(limbs: torch.Tensor) -> torch.Tensor:
    """(L, ...) limbs -> float64 value, smallest significance first."""
    out = torch.zeros(limbs.shape[1:], dtype=torch.float64, device=limbs.device)
    for j in range(limbs.shape[0] - 1, -1, -1):
        out = out + limbs[j].to(torch.float64) * _ext_w(j)
    return out


def _ext_carry(d: torch.Tensor) -> torch.Tensor:
    """Exact carry cascade on float64 integer digits (L, ...) -> canonical
    int8 limbs; carries round half to even (``jnp.rint``)."""
    L = d.shape[0]
    limbs = torch.empty(d.shape, dtype=torch.int8, device=d.device)
    carry = torch.zeros_like(d[0])
    for j in range(L - 1, 0, -1):
        t = d[j] + carry
        carry = torch.round(t * (1.0 / 32.0))
        limbs[j] = (t - carry * 32.0).to(torch.int8)
    limbs[0] = (d[0] + carry).to(torch.int8)
    return limbs


def _ext_carry_i32(d: torch.Tensor) -> torch.Tensor:
    """Exact carry cascade on int32 digits -> canonical int8 limbs; carries
    round half up (arithmetic shift), as the JAX package's ``_ext_carry_i32``.
    Both cascades are exact; they differ on ties only."""
    return carry_digits(d, 5)


def ext_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact sum of two canonical ext stacks (same fixed grid)."""
    return _ext_carry_i32(a.to(torch.int32) + b.to(torch.int32))


def ext_neg(a: torch.Tensor) -> torch.Tensor:
    return (-a.to(torch.int32)).to(torch.int8)


def ext_scalar_limbs(c, L: int = EXT_LIMBS) -> tuple[float, ...]:
    """Static 5-bit signed limb expansion of a host scalar on grid e = 0:

        c = sum_i s_i * 2^(-5*(i+1)),  |s_i| <= 16  (exact to 5L bits)

    Requires |c| < 1.  Pass a Fraction for exact rationals."""
    assert abs(c) < 1.0
    r = Fraction(c)
    out = []
    for _ in range(L):
        r *= 32
        s = int(round(r))
        out.append(float(s))
        r -= s
    return tuple(out)


def ext_scalar_mul(a: torch.Tensor, c_limbs) -> torch.Tensor:
    """Exact ext * static-scalar product (scalar on grid e = 0, |c| < 1),
    digits in float64 and the rint carry, as the JAX package's
    ``ext_scalar_mul``.  Limb j times scalar limb i lands on position
    j + i + 1; positions >= L are truncated."""
    L = a.shape[0]
    af = a.to(torch.float64)
    d = torch.zeros((L + EXT_GUARD,) + tuple(a.shape[1:]), dtype=torch.float64, device=a.device)
    for m in range(L + EXT_GUARD):
        for i, ci in enumerate(c_limbs):
            j = m - 1 - i
            if 0 <= j < L and ci != 0.0:
                d[m] = d[m] + af[j] * float(ci)
    return _ext_carry(d)[:L]


def _ext_pairs(L: int) -> tuple[np.ndarray, np.ndarray]:
    """(j, i) limb-pair indices of every kept product diagonal (j + i =
    s < L + EXT_GUARD, both < L), ordered by (s, j)."""
    pairs = [
        (j, s - j)
        for s in range(L + EXT_GUARD)
        for j in range(max(0, s - L + 1), min(s + 1, L))
    ]
    jj = np.asarray([p[0] for p in pairs], np.int32)
    ii = np.asarray([p[1] for p in pairs], np.int32)
    return jj, ii


# ---------------------------------------------------------------------------
# Limb products through int8 GEMMs
# ---------------------------------------------------------------------------


def int_mm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact
    (:func:`~.int8_gemm.int8_gemm`): on a CUDA tensor the hand-written
    Hopper GEMM, which takes A with unit stride along K and B K-contiguous
    (the transpose of an (N, K) row-major copy), 16-byte aligned; on the
    CPU ``torch._int_mm`` on zero-padded operands.  With ``out`` (a
    contiguous (M, N) int32 view) the result is written there.

    Under an active tracer (``utils/profiling.py``) the GEMM is a launch
    span ``int8_gemm``, and the innermost open stage counts
    ``int8_gemm.calls`` and ``int8_gemm.ops``: 2 M K N of the operands as
    ``torch._int_mm`` takes them (M at least 17, K and N rounded up to 8)
    on every device, so the counts compare across devices and commits.  On
    the card the wrapper adds ``int8_gemm.wide`` or ``int8_gemm.narrow``,
    the kernel variant launched."""
    M, K = a.shape
    N = b.shape[1]
    with launch_span("int8_gemm"):
        out = int8_gemm(a, b, out=out)
    count("int8_gemm.calls", 1)
    count("int8_gemm.ops", 2 * max(M, 17) * -(-K // 8) * 8 * -(-N // 8) * 8)
    return out


def _whole_rows(K: int) -> int:
    """K rounded up to whole 16-byte rows: a limb's column stride in the
    concatenated GEMM operands."""
    return -(-K // 16) * 16


@dataclass
class ExtLeft:
    """Left operand of :func:`ext_cmatmul`, prepared once for many products:
    the real, imaginary and Karatsuba-sum limb stacks (L, M, K) laid out as
    (M, L * Kw) int8, limb j at columns [j*Kw, j*Kw + K) and zeros up to
    (j+1)*Kw, Kw = K in whole 16-byte rows (:func:`_cat_k`)."""

    re: torch.Tensor
    im: torch.Tensor
    sum: torch.Tensor
    L: int
    K: int


def _cat_k(a: torch.Tensor) -> torch.Tensor:
    """(L, M, K) limb stack -> (M, L * Kw) int8, limb j at columns
    [j*Kw, j*Kw + K), zeros after it (Kw = :func:`_whole_rows` (K))."""
    L, M, K = a.shape
    kw = _whole_rows(K)
    if kw != K:
        a = torch.nn.functional.pad(a, (0, kw - K))
    return a.permute(1, 0, 2).contiguous().view(M, L * kw)


def ext_left(are: torch.Tensor, aim: torch.Tensor) -> ExtLeft:
    L, _, K = are.shape
    # Karatsuba limb sums: canonical limbs are <= 16, limb 0 <= 33, so the
    # sums are <= 66 and exact in int8
    return ExtLeft(_cat_k(are), _cat_k(aim), _cat_k(are + aim), L, K)


def _right_rev(b: torch.Tensor) -> torch.Tensor:
    """(L, K, N) limb stack -> (N, L * Kw) int8, limbs in REVERSED order:
    limb i at columns [(L-1-i)*Kw, (L-1-i)*Kw + K), zeros after it (Kw =
    :func:`_whole_rows` (K)), so that a diagonal's limb pairs with a
    :func:`_cat_k` operand are one K range of both (:func:`diagonal_mm`).

    The copy must be K-contiguous: a view of the permuted stack (which
    ``reshape`` would return, the limb and K axes merging) is
    N-contiguous, a layout the card's int8 GEMM refuses."""
    L, K, N = b.shape
    kw = _whole_rows(K)
    if kw != K:
        b = torch.nn.functional.pad(b, (0, 0, 0, kw - K))
    return b.flip(0).permute(2, 0, 1).contiguous().view(N, L * kw)


def diagonal_mm(left: torch.Tensor, right_rev: torch.Tensor, L: int, s: int,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Digit s of the product of two L-limb stacks, before any carry: the
    sum over the limb pairs (j, s - j), j0 <= j < j1, as ONE :func:`int_mm`
    over their K range.  ``left`` is a :func:`_cat_k` operand (M, L * Kw),
    ``right_rev`` a :func:`_right_rev` operand (N, L * Kw): limb j of the
    left and limb s - j of the right both sit at K block j - j0 of the
    range.  Int32 sums are exact in any order; the callers assert their
    headroom.  ``out`` as for :func:`int_mm`."""
    kw = left.shape[1] // L
    j0, j1 = max(0, s - L + 1), min(s + 1, L)
    r0 = L - 1 - s  # right_rev's block of limb s - j is r0 + j
    return int_mm(left[:, j0 * kw: j1 * kw],
                  right_rev[:, (r0 + j0) * kw: (r0 + j1) * kw].t(), out=out)


def _ext_workspace(left: ExtLeft, N: int, device) -> torch.Tensor:
    """Flat int32 room for the (3, L + EXT_GUARD, M, N) Karatsuba GEMM
    outputs of one column panel of up to N columns."""
    return torch.empty(3 * (left.L + EXT_GUARD) * left.re.shape[0] * N, dtype=torch.int32,
                       device=device)


def _ext_cpanel_into(left: ExtLeft, b_re, b_im, ws: torch.Tensor, c_re, c_im, p0: int) -> None:
    """Exact diagonals + carry for (full ext A) @ (ext B panel), the limbs
    written into columns [p0, p0 + N) of the (L, M, N_total) stacks c_re,
    c_im; ``ws`` is :func:`_ext_workspace` room for at least N columns.

    Karatsuba complex product, 3 int8 GEMMs per diagonal:

        m1 = a_re @ b_re,  m2 = a_im @ b_im,  m3 = (a_re+a_im) @ (b_re+b_im)
        re = m1 - m2,      im = m3 - m1 - m2

    Each GEMM sums the diagonal's limb pairs along its K into its slot of
    the workspace; EXT_GUARD extra diagonals below the last kept limb feed
    carries upward and are then dropped, as in the JAX package.  One
    :func:`~.ext_carry.ext_carry_panel` forms re and im and carries both."""
    L = left.L
    N = b_re.shape[2]
    M = left.re.shape[0]
    S = L + EXT_GUARD
    d = ws[:3 * S * M * N].view(3, S, M, N)
    r_re, r_im, r_sum = _right_rev(b_re), _right_rev(b_im), _right_rev(b_re + b_im)
    for s in range(S):
        diagonal_mm(left.re, r_re, L, s, out=d[0, s])
        diagonal_mm(left.im, r_im, L, s, out=d[1, s])
        diagonal_mm(left.sum, r_sum, L, s, out=d[2, s])
    ext_carry_panel(d, c_re, c_im, p0)


def _ext_cpanel_product(left: ExtLeft, b_re: torch.Tensor, b_im: torch.Tensor):
    """(full ext A) @ (ext B panel) as two new (L, M, N) limb stacks
    (:func:`_ext_cpanel_into`)."""
    L, M, N = left.L, left.re.shape[0], b_re.shape[2]
    c_re = torch.empty((L, M, N), dtype=torch.int8, device=b_re.device)
    c_im = torch.empty_like(c_re)
    _ext_cpanel_into(left, b_re, b_im, _ext_workspace(left, N, b_re.device), c_re, c_im, 0)
    return c_re, c_im


def ext_cmatmul(
    are: torch.Tensor | ExtLeft,
    aim: torch.Tensor | None,
    bre: torch.Tensor,
    bim: torch.Tensor,
    panel: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-to-truncation complex matmul of canonical ext stacks.

    (L, M, K) @ (L, K, N) int8 canonical limbs -> (L, M, N).  ``are`` may be
    an :class:`ExtLeft` (``aim`` then None) prepared once for several
    products with the same left operand.  ``panel`` bounds the int32 digit
    workspace to (3, L + EXT_GUARD, M, panel), allocated once and reused
    by every panel; the values do not depend on it."""
    assert EXT_E == 5, "product grid alignment requires EXT_E == 5"
    left = are if isinstance(are, ExtLeft) else ext_left(are, aim)
    L, K = left.L, left.K
    # i32 headroom (Karatsuba): per limb pair |m3| <= K*66*66, |m1|,|m2| <=
    # K*33*33, so |im digit| <= K*6534; a diagonal sums up to L pairs
    assert K * 6534 * L < 2**31, "i32 would overflow in ext_cmatmul"
    assert bre.shape[0] == L and bre.shape[1] == K, (bre.shape, L, K)
    N = bre.shape[2]
    M = left.re.shape[0]
    panel = max(1, min(panel, N))
    c_re = torch.empty((L, M, N), dtype=torch.int8, device=bre.device)
    c_im = torch.empty_like(c_re)
    ws = _ext_workspace(left, panel, bre.device)
    for p0 in range(0, N, panel):
        p1 = min(p0 + panel, N)
        _ext_cpanel_into(left, bre[:, :, p0:p1], bim[:, :, p0:p1], ws, c_re, c_im, p0)
    return c_re, c_im


def ext_taylor_horner(
    are: torch.Tensor,
    aim: torch.Tensor,
    coeff_limbs: np.ndarray,  # (degree+1, Lc): limbs of 1/k at row k
    degree: int,
    panel: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """D = Horner(exp(A) - I) in the exact limb domain:
    D <- A + (A @ D) * (1/k) for k = degree .. 2, starting from D = A.

    The JAX package runs the recursion per column panel (columns of D are
    independent through it) to bound TPU memory; the values are the same
    whole-matrix or panel by panel."""
    left = ext_left(are, aim)
    d_re, d_im = are, aim
    for k in range(degree, 1, -1):
        d_re, d_im = ext_horner_step(left, are, aim, d_re, d_im, coeff_limbs[k], panel)
    return d_re, d_im


def ext_horner_step(left: ExtLeft, are, aim, d_re, d_im, cl, panel: int = 512):
    """One Horner step D <- A + (A @ D) * c, the scalar c given by its limbs
    ``cl`` and A both as limb stacks and as its prepared left operand.  The
    real plane's product is freed before the imaginary one is scaled."""
    p_re, p_im = ext_cmatmul(left, None, d_re, d_im, panel=panel)
    n_re = ext_axpy_traced(are, p_re, cl)
    del p_re
    return n_re, ext_axpy_traced(aim, p_im, cl)


def taylor_coeff_limbs(degree: int, Lc: int = EXT_LIMBS) -> np.ndarray:
    """(degree+1, Lc) exact limb expansions of 1/k (row k; rows 0, 1 unused)."""
    out = np.zeros((degree + 1, Lc))
    for k in range(2, degree + 1):
        out[k] = np.asarray(ext_scalar_limbs(Fraction(1, k), Lc))
    return out


def ext_add_identity(a: torch.Tensor) -> torch.Tensor:
    """a + I in the limb domain (1.0 sits exactly on limb 0: w(0) = 1)."""
    out = a.clone()
    out[0].diagonal().add_(1)
    return out


# ---------------------------------------------------------------------------
# The two limb splits of a host matrix
# ---------------------------------------------------------------------------


def f32_triple_split_host(x: np.ndarray):
    """Exact x = a1 + a2 + a3 with a_k float32 (lossless for |x| < 2^127)."""
    a1 = x.astype(np.float32)
    r = x - a1
    a2 = r.astype(np.float32)
    r -= a2
    a3 = r.astype(np.float32)
    return a1, a2, a3


def _ext_carry_i8_digits(d8: torch.Tensor) -> torch.Tensor:
    """Carry cascade over small int8 digits (|d| <= 48, sums of <= 3 exact
    limb extractions) -> canonical int8 limbs: the int32 cascade, one limb
    widened at a time."""
    L = d8.shape[0]
    limbs = torch.empty_like(d8)
    carry = torch.zeros(d8.shape[1:], dtype=torch.int32, device=d8.device)
    for j in range(L - 1, 0, -1):
        t = d8[j].to(torch.int32) + carry
        carry = (t + 16) >> 5
        limbs[j] = torch.sub(t, carry, alpha=32)
    limbs[0] = d8[0].to(torch.int32) + carry
    return limbs


def _ext_limbs_from_f32_planes(planes, L: int) -> torch.Tensor:
    """(L, *shape) int8 canonical limbs from the three float32 planes of
    :func:`f32_triple_split_host` (on the device).  Each plane's limbs are
    extracted in native float32 (round / subtract / scale by 32 are exact on
    5-bit steps of a 24-bit significand), summed as int8 digits, then
    carried."""
    shape = tuple(planes[0].shape)
    digits = torch.zeros((L,) + shape, dtype=torch.int8, device=planes[0].device)
    for plane in planes:
        r = plane * float(2.0 ** (5 - EXT_E))
        for j in range(L):
            lj = torch.round(r)
            digits[j] += lj.to(torch.int8)
            r = (r - lj) * 32.0
    return _ext_carry_i8_digits(digits)


def ext_split_upload(x: np.ndarray, L: int = EXT_LIMBS, device="cuda") -> torch.Tensor:
    """Host float64 array -> (L, ...) int8 canonical ext limbs on ``device``
    (default "cuda", raising without CUDA; pass "cpu" for the host), through
    the float32 triple split (:func:`_ext_limbs_from_f32_planes`).  The JAX
    package's split below its chunk dim, and always for psi0."""
    device = resolve_device(device)
    maxabs = float(np.abs(x).max()) if x.size else 0.0
    assert maxabs < 2.0**EXT_E, (
        f"ext_split_upload domain violated: max|x| = {maxabs} >= 2^{EXT_E}"
    )
    planes = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in f32_triple_split_host(np.ascontiguousarray(x))]
    return _ext_limbs_from_f32_planes(planes, L)


def ext_split_upload_coo_pair_host(
    rows: np.ndarray,
    cols: np.ndarray,
    v_a: np.ndarray,
    v_b: np.ndarray,
    dim: int,
    L: int = EXT_LIMBS,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """COO pair -> two dense (L, dim, dim) limb stacks: the host canonical
    split of the value vectors (:func:`ext_split_host`) scattered into
    zeros on ``device`` (default "cuda", raising without CUDA).  The JAX
    package's split at and above its chunk dim.  Indices must be
    duplicate-free (``OperatorSum.to_coo`` aggregates)."""
    device = resolve_device(device)
    assert rows.shape == cols.shape == v_a.shape == v_b.shape
    assert dim * dim < 2**31
    lr = torch.from_numpy(ext_split_host(np.ascontiguousarray(v_a), L)).to(device)
    li = torch.from_numpy(ext_split_host(np.ascontiguousarray(v_b), L)).to(device)
    idx = torch.from_numpy(rows.astype(np.int64) * dim + cols.astype(np.int64)).to(device)
    out = []
    for limbs in (lr, li):
        dense = torch.zeros((L, dim * dim), dtype=torch.int8, device=device)
        dense[:, idx] = limbs
        out.append(dense.reshape(L, dim, dim))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# The Ozaki tier: float64-accurate products from exact int8 limb products
# ---------------------------------------------------------------------------
#
# Port of the first part of ``quantumsimulations_tpu/ops/extprec.py``.  Each
# float64 matrix is split into N_LIMBS integer limbs of LIMB_BITS bits on a
# grid set by its own largest entry,
#
#     x = scale * sum_k l_k * 2^(-LIMB_BITS * k),  l_k integer, |l_k| <= 2^LIMB_BITS,
#
# each limb-pair product is an exact int8 GEMM, the pairs of one significance
# diagonal are summed in int32 (exact), and only the weighted sum across the
# diagonals runs in float64, smallest diagonal first.
#
# Bit-for-bit with the JAX package.  Its exponent, scale and diagonal
# weights come from XLA's ``log2`` and ``exp2``, which are not exact: XLA
# computes log2(x) as log(x) * (1 / ln 2) and exp2(e) as exp(e * ln 2), so a
# "power of two" scale is off by a few ulp and the exponent of a maximum
# just below (or at) a power of two can round either way.  :func:`_xla_floor_log2`
# and :func:`_xla_exp2` repeat those operations on the host with the C
# library's ``log`` and ``exp`` (which XLA's CPU backend matches on every
# exponent a matrix can have), so the limbs, the scale and every product
# equal the JAX package's on its CPU backend.  The digit sums are exact in
# any order, so each diagonal's limb pairs run as one :func:`diagonal_mm`,
# as in the ext chain.
#
# TPU workarounds that are no-ops here: the JAX package's ``_SYNC_ELEMS``
# and the ``fetch_sync`` between the four real products of
# :func:`cmatmul_f64` (they kept queued programs from reserving their limb
# transients at once on a 16 GB TPU; torch runs the products in stream
# order and its caching allocator reuses the freed blocks), and the jitted
# ``_sub`` / ``_add`` helpers (one eager operation each here).

import math  # noqa: E402

LIMB_BITS = 5
N_LIMBS = 11  # 11 * 5 = 55 bits >= float64's 53-bit significand
_LN2 = 0.6931471805599453  # XLA's ln 2 constant
_INV_LN2 = 1.4426950408889634  # XLA's folded 1 / ln 2


def _xla_floor_log2(x: float) -> float:
    """floor(log2(x)) as XLA computes it: floor(log(x) * (1 / ln 2))."""
    return float(math.floor(math.log(x) * _INV_LN2))


def _xla_exp2(e: float) -> float:
    """exp2(e) as XLA computes it: exp(e * ln 2) (not exact at integers)."""
    return math.exp(e * _LN2)


def _limb_split(x: torch.Tensor, n_limbs: int = N_LIMBS, limb_bits: int = LIMB_BITS):
    """(limbs int8 (n_limbs, ...), scale) with x ~= sum_k limbs[k] * scale * 2^{-limb_bits*k}.

    ``scale`` (a host float, the one host sync of a split) is XLA's
    exp2(floor(log2 max|x|) + 1 - limb_bits), so max|x| / scale lies in
    about [2^(limb_bits-1), 2^limb_bits).  A 2-D input's stack is a view of
    an (M, n_limbs, K) buffer, the layout :func:`_cat_k` turns into the
    concatenated-K GEMM operand without a copy."""
    maxabs = float(x.abs().max()) if x.numel() else 0.0
    scale, inv_scale = _limb_scales(maxabs, limb_bits)
    return _split_scaled(x, inv_scale, n_limbs, limb_bits), scale


def _limb_scales(maxabs: float, limb_bits: int = LIMB_BITS) -> tuple[float, float]:
    """(scale, 1 / scale) of a split whose largest magnitude is ``maxabs``:
    exp2(+-e), e = floor(log2 max|x|) + 1 - limb_bits, in XLA's arithmetic."""
    safe = maxabs if maxabs > 0 else 1.0
    e = _xla_floor_log2(safe) + 1.0 - limb_bits
    return _xla_exp2(e), _xla_exp2(-e)


def _split_scaled(x: torch.Tensor, inv_scale: float, n_limbs: int = N_LIMBS,
                  limb_bits: int = LIMB_BITS) -> torch.Tensor:
    """The limbs of :func:`_limb_split` on a given grid ``inv_scale``."""
    if x.dim() == 2:
        buf = torch.empty((x.shape[0], n_limbs, x.shape[1]), dtype=torch.int8, device=x.device)
        limbs = buf.permute(1, 0, 2)
    else:
        limbs = torch.empty((n_limbs,) + tuple(x.shape), dtype=torch.int8, device=x.device)
    r = x.to(torch.float64) * inv_scale  # |r| < 2^limb_bits
    for k in range(n_limbs):
        lk = torch.round(r)  # half to even, as jnp.rint
        limbs[k] = lk.to(torch.int8)
        r = (r - lk) * float(2**limb_bits)
    return limbs


def _check_i32(K: int, n_limbs: int, limb_bits: int) -> None:
    """int32 accumulation: K-sums and diagonal sums must stay below 2^31."""
    if K * (2 ** (2 * limb_bits)) * n_limbs >= 2**31:
        raise ValueError(f"contraction dim {K} overflows int32 at {n_limbs} limbs of "
                         f"{limb_bits} bits")


def _accumulate_products(A, B, out_shape, n_limbs: int, limb_bits: int):
    """sum_s 2^(-limb_bits*s) * (sum_k A[k] @ B[s-k]) for limb stacks A
    (n_limbs, M, K) and B (n_limbs, K, N), before the scales: the float64
    sum over the diagonals smallest first (the rounding the JAX package's
    ``_accumulate_products`` has: a few ulp of the result).  The callers
    multiply by the scales as the JAX package's compiled programs do
    (:func:`_scale_product`)."""
    left, right = _cat_k(A), _right_rev(B)
    out = torch.zeros(out_shape, dtype=torch.float64, device=A.device)
    for s in range(n_limbs - 1, -1, -1):
        acc = diagonal_mm(left, right, n_limbs, s)
        out = out + acc.to(torch.float64) * _xla_exp2(float(-limb_bits * s))
    return out


def _exponent(scale: float) -> float:
    """The integer e of a split's scale exp(e * ln 2)."""
    return float(round(math.log2(scale)))


def _scale_product(sa: float, sb: float) -> float:
    """sa * sb where both scales were computed in the same XLA program as
    the product (``matmul_f64``): XLA's simplifier turns exp(x) * exp(y)
    into exp(x + y), and its CPU code contracts the exponent sum
    ea * ln 2 + eb * ln 2 into one fused multiply-add."""
    ea, eb = _exponent(sa), _exponent(sb)
    return math.exp(float(Fraction(ea) * Fraction(_LN2) + Fraction(eb * _LN2)))


def matmul_f64(a: torch.Tensor, b: torch.Tensor, n_limbs: int = N_LIMBS,
               limb_bits: int = LIMB_BITS) -> torch.Tensor:
    """float64-precision a @ b via error-free int8 limb products."""
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError(f"matmul_f64 takes float64 operands, got {a.dtype} and {b.dtype}")
    _check_i32(a.shape[-1], n_limbs, limb_bits)
    A, sa = _limb_split(a, n_limbs, limb_bits)
    B, sb = _limb_split(b, n_limbs, limb_bits)
    out = _accumulate_products(A, B, (a.shape[0], b.shape[1]), n_limbs, limb_bits)
    return out * _scale_product(sa, sb)


def limbs_of(a: torch.Tensor, n_limbs: int = N_LIMBS, limb_bits: int = LIMB_BITS):
    """Split a reused left operand once (a step operator applied to many
    state blocks): ``(limbs, scale)`` for :func:`matmul_f64_prelimbed`."""
    _check_i32(a.shape[-1], n_limbs, limb_bits)
    return _limb_split(a, n_limbs, limb_bits)


def matmul_f64_prelimbed(A, sa: float, b: torch.Tensor, n_limbs: int = N_LIMBS,
                         limb_bits: int = LIMB_BITS) -> torch.Tensor:
    """(pre-limbed A) @ b."""
    B, sb = _limb_split(b, n_limbs, limb_bits)
    return _accumulate_products(A, B, (A.shape[1], b.shape[1]), n_limbs, limb_bits) * (sa * sb)


def cmatmul_f64(a_re, a_im, b_re, b_im, n_limbs: int = N_LIMBS, limb_bits: int = LIMB_BITS):
    """float64-precision complex product on (re, im) planes: four real
    limb products, re = rr - ii and im = ri + ir, as the JAX package.  Each
    plane is split once and its limbs reused by both products it enters
    (a split is deterministic, so the values are the JAX package's)."""
    for x in (a_re, a_im, b_re, b_im):
        if x.dtype != torch.float64:
            raise TypeError(f"cmatmul_f64 takes float64 planes, got {x.dtype}")
    _check_i32(a_re.shape[-1], n_limbs, limb_bits)
    shape = (a_re.shape[0], b_re.shape[1])
    Ar, sar = _limb_split(a_re, n_limbs, limb_bits)
    Ai, sai = _limb_split(a_im, n_limbs, limb_bits)
    Br, sbr = _limb_split(b_re, n_limbs, limb_bits)
    Bi, sbi = _limb_split(b_im, n_limbs, limb_bits)
    return _cmatmul_split((Ar, sar), (Ai, sai), (Br, sbr), (Bi, sbi), shape, n_limbs, limb_bits)


def _cmatmul_split(Ar, Ai, Br, Bi, shape, n_limbs: int = N_LIMBS, limb_bits: int = LIMB_BITS):
    """:func:`cmatmul_f64` on planes already split: each argument a
    ``(limbs, scale)`` pair."""
    def mm(x, y):
        out = _accumulate_products(x[0], y[0], shape, n_limbs, limb_bits)
        return out * _scale_product(x[1], y[1])

    c_re = mm(Ar, Br) - mm(Ai, Bi)
    return c_re, mm(Ar, Bi) + mm(Ai, Br)


def cmatmul_f64_cplx(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`cmatmul_f64` on complex128 tensors (the JAX package's
    ``Cplx`` pairs are complex tensors in this port)."""
    re, im = cmatmul_f64(a.real.contiguous(), a.imag.contiguous(),
                         b.real.contiguous(), b.imag.contiguous(), **kw)
    return torch.complex(re, im)
