"""Row-sharded dense step-operator propagation: dims beyond one device's memory.

Port of ``quantumsimulations_tpu/parallel/expm_sharded.py``.  Every dense
operator is sharded BY ROWS over the mesh axis, and the limb-product panels
are fed by ``all_gather`` collectives:

  * ``expm_traces_sharded`` (Ozaki tier): U is carried as row-sharded
    (rows/P, dim) float64 planes; each product re-splits its operands into
    Ozaki limbs with a GLOBAL scale negotiated by an ``all_reduce`` (MAX)
    of the ranks' largest magnitudes (per-rank scales would put the gathered
    panels on different grids and break the error-free product).
  * ``expm_traces_sharded_ext`` (exact limbs): every chain operand is a
    canonical fixed-grid int8 limb stack (ops/extprec.py), so products land
    on the grid, carries are exact integer operations and no scale needs
    negotiating; the only error is the final truncation, as in the
    single-device ``ext`` chain.
  * C = A @ B: a loop over column panels; each gathers B's (L, dim, panel)
    limbs from all ranks (one ``all_gather`` per panel and plane), and the
    rank computes its rows of the panel.
  * States stay REPLICATED (dim x block is small); applying the row-sharded
    step operator gives each rank its rows, re-replicated with one
    ``all_gather`` per block advance.  Every rank computes the same rows of
    observables from the replicated states and returns them (the JAX
    package's closing ``pmax`` only retypes those identical rows for its
    type system; no collective is needed here).

The operator's rows are built from its COO triplet at and above
``dynamics/expm_propagator._EXT_CHUNK_DIM`` (the same values as the dense
matrix, without a dim^2 host buffer; e0 and the norm estimate from the
sparse matrix), and from the dense matrix below it, as the JAX package
builds them.  The limb products are the port's int8 GEMMs
(ops/extprec.py::int_mm: the hand-written Hopper kernel
``csrc/int8_gemm.cu`` on the card, ``torch._int_mm`` on the CPU); the JAX
package runs them in plain ``jnp``, outside any Pallas kernel.

Replaces the reference's single-process ``qt.sesolve``
(dipolar_ensemble_with_rare.py:653) for bath sizes no single device holds.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..dynamics.expm_propagator import (
    _EXT_CHUNK_DIM,
    _TAYLOR_DEGREE,
    _n_squarings,
    _uniform_dt,
)
from ..dynamics.observables import assembled_rows
from ..ops.embed import OperatorSum
from ..ops.extprec import _accumulate_products, _limb_scales, _split_scaled
from .mesh import all_gather_cat, all_reduce, axis_size, mesh_device


def auto_limb_cfg(dim: int) -> tuple[int, int]:
    """(n_limbs, limb_bits) so the int32 accumulator never overflows.

    Constraint: dim * 2^(2*limb_bits) * n_limbs < 2^31 (int8 products,
    exact int32 diagonal sums); keep >= 55 bits of significand.  5-bit
    limbs (11 of them) hold to dim ~190k."""
    for bits in (5, 4, 3):
        n = int(np.ceil(55 / bits))
        if dim * (2 ** (2 * bits)) * n < 2**31:
            return (n, bits)
    raise ValueError(f"dim {dim} too large for exact i32 limb accumulation")


def _layout(times, dims, mesh, axis, block):
    """(T, dt, dim, group, rows, device, block, log2_block, n_blocks)."""
    times = np.asarray(times)
    T = len(times)
    dt = _uniform_dt(times)
    dim = int(np.prod(dims))
    n_dev = axis_size(mesh, axis)
    if dim % n_dev:
        raise ValueError(f"dim {dim} not divisible by {n_dev} devices")
    rows_local = dim // n_dev
    my = mesh.get_local_rank(axis)
    block = min(block, T)
    block = 1 << (block.bit_length() - 1)
    return (T, dt, dim, mesh.get_group(axis), slice(my * rows_local, (my + 1) * rows_local),
            mesh_device(mesh), block, block.bit_length() - 1, int(np.ceil(T / block)))


def _host_operator(H: OperatorSum, psi0: np.ndarray, rows: slice, big: bool):
    """(e0, local rows (r, c, v) of H as COO, host matrix for the norm):
    from the COO triplet when ``big``, else from the dense matrix."""
    dim = H.dim
    if big:
        import scipy.sparse as sparse

        r, c, v = H.to_coo()
        Hh = sparse.csr_matrix((v, (r, c)), shape=(dim, dim))
        sel = (r >= rows.start) & (r < rows.stop)
        local = (r[sel] - rows.start, c[sel], v[sel])
    else:
        Hh = H.to_dense()
        rr, cc = np.nonzero(Hh[rows])
        local = (rr, cc, Hh[rows][rr, cc])
    e0 = float(np.real(np.vdot(psi0, Hh @ psi0)))
    return e0, local, Hh


def _scatter_rows(local, n_rows: int, dim: int, values: np.ndarray, dev,
                  dtype=torch.float64) -> torch.Tensor:
    """(..., n_rows, dim) zeros with ``values`` (..., nnz) at the local COO
    positions."""
    r, c, _ = local
    idx = torch.as_tensor(r.astype(np.int64) * dim + c.astype(np.int64), device=dev)
    vals = torch.as_tensor(np.ascontiguousarray(values), device=dev)
    out = torch.zeros(vals.shape[:-1] + (n_rows * dim,), dtype=dtype, device=dev)
    out[..., idx] = vals.to(dtype)
    return out.reshape(vals.shape[:-1] + (n_rows, dim))


def _rows_block(S: torch.Tensor, dims, sea_mask, idx_rare, e0: float) -> torch.Tensor:
    """(8, block) TRACE_ROWS of a replicated complex (dim, block) state block."""
    rows = assembled_rows(S, dims, sea_mask, idx_rare)
    return torch.cat([rows, torch.full_like(rows[:1], e0)])


def _finish(blocks: list[torch.Tensor], T: int) -> np.ndarray:
    return np.ascontiguousarray(torch.cat(blocks, dim=1).cpu().numpy()[:, :T])


# ---------------------------------------------------------------------------
# Ozaki tier
# ---------------------------------------------------------------------------


def _global_split(x_local: torch.Tensor, group, n_limbs: int, limb_bits: int):
    """(limbs, scale) with the scale negotiated across the group (MAX)."""
    maxabs = all_reduce(x_local.abs().max().clone(), group, dist.ReduceOp.MAX)
    scale, inv = _limb_scales(float(maxabs), limb_bits)
    return _split_scaled(x_local, inv, n_limbs, limb_bits), scale


def _sharded_cmatmul_prelimbed(Ar, sar, Ai, sai, Br, sbr, Bi, sbi, group, panel: int,
                               n_limbs: int, limb_bits: int, dim: int):
    """Row-sharded complex product C = A @ B_global from pre-split limbs
    (L, rows_local, dim): one tiled all_gather of B's panel limbs per column
    panel; the rank's rows of C, float64."""
    rows_local = Ar.shape[1]
    c_re = torch.empty((rows_local, dim), dtype=torch.float64, device=Ar.device)
    c_im = torch.empty_like(c_re)
    for p0 in range(0, dim, panel):
        p1 = min(p0 + panel, dim)
        br = all_gather_cat(Br[:, :, p0:p1], group, dim=1)  # (L, dim, panel)
        bi = all_gather_cat(Bi[:, :, p0:p1], group, dim=1)
        shape = (rows_local, p1 - p0)

        def mm(A, sa, B, sb):
            return _accumulate_products(A, B, shape, n_limbs, limb_bits) * (sa * sb)

        c_re[:, p0:p1] = mm(Ar, sar, br, sbr) - mm(Ai, sai, bi, sbi)
        c_im[:, p0:p1] = mm(Ar, sar, bi, sbi) + mm(Ai, sai, br, sbr)
    return c_re, c_im


def _apply_replicated(Ar, sar, Ai, sai, S: torch.Tensor, group, n_limbs: int, limb_bits: int):
    """Row-sharded (pre-limbed) U applied to a REPLICATED complex (dim, B)
    block; the re-replicated product by one tiled all_gather.  Every rank
    splits the same replicated block, so its local largest magnitude is the
    global one: no scale negotiation."""
    s_re, s_im = S.real.contiguous(), S.imag.contiguous()
    sb, inv = _limb_scales(float(torch.maximum(s_re.abs().max(), s_im.abs().max())), limb_bits)
    Br = _split_scaled(s_re, inv, n_limbs, limb_bits)
    Bi = _split_scaled(s_im, inv, n_limbs, limb_bits)
    shape = (Ar.shape[1], S.shape[1])

    def mm(A, sa, B):
        return _accumulate_products(A, B, shape, n_limbs, limb_bits) * (sa * sb)

    out = torch.complex(mm(Ar, sar, Br) - mm(Ai, sai, Bi), mm(Ar, sar, Bi) + mm(Ai, sai, Br))
    return all_gather_cat(out, group, dim=0)


def expm_traces_sharded(
    H: OperatorSum,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    n_sea_effective: int,
    idx_rare: int,
    mesh: DeviceMesh,
    axis: str = "sp",
    block: int = 128,
    panel: int = 512,
) -> np.ndarray:
    """Assembled observable rows (8, T) via a row-sharded dense step operator
    in the Ozaki tier: the Taylor-Horner core, the scaling squarings, the
    doubling pass that seeds a block of states, and the block advance with
    the observables.  The advance after the last block, whose states the
    JAX package discards, is not taken."""
    from ..dynamics.krylov import spectral_norm_bound

    T, dt, dim, group, rows, dev, block, log2_block, n_blocks = _layout(
        times, dims, mesh, axis, block)
    n_limbs, limb_bits = auto_limb_cfg(dim)
    panel = min(panel, dim)
    n_sq = _n_squarings(spectral_norm_bound(H), dt)
    dt_s = dt / (2**n_sq)
    psi0 = np.asarray(psi0)
    e0, local, _ = _host_operator(H, psi0, rows, dim >= _EXT_CHUNK_DIM)
    rows_local = rows.stop - rows.start
    # A = -i H dt_s, this rank's rows
    a_re, a_im = _scatter_rows(local, rows_local, dim,
                               np.stack([local[2].imag * dt_s, -local[2].real * dt_s]), dev)

    def split(x):
        return _global_split(x, group, n_limbs, limb_bits)

    def product(A, B):
        return _sharded_cmatmul_prelimbed(*A[0], *A[1], *B[0], *B[1], group, panel,
                                          n_limbs, limb_bits, dim)

    # limbs of A once; Horner D <- A + (A @ D) / k, k = degree .. 2
    A = (split(a_re), split(a_im))
    u_re, u_im = a_re, a_im
    for i in range(_TAYLOR_DEGREE - 1):
        t_re, t_im = product(A, (split(u_re), split(u_im)))
        invk = 1.0 / (_TAYLOR_DEGREE - i)
        u_re, u_im = a_re + t_re * invk, a_im + t_im * invk
    del A
    u_re.diagonal(offset=rows.start).add_(1.0)  # U = I + D on this rank's rows
    for _ in range(n_sq):
        C = (split(u_re), split(u_im))
        u_re, u_im = product(C, C)

    # doubling pass: a replicated block of seed states + U -> U^block
    S = torch.zeros((dim, block), dtype=torch.complex128, device=dev)
    S[:, 0] = torch.as_tensor(psi0, dtype=torch.complex128, device=dev)
    for k in range(log2_block):
        w = 1 << k
        C = (split(u_re), split(u_im))
        S[:, w:2 * w] = _apply_replicated(*C[0], *C[1], S[:, :w], group, n_limbs, limb_bits)
        u_re, u_im = product(C, C)

    sea_mask = torch.as_tensor((np.arange(len(dims)) < n_sea_effective).astype(np.float64),
                               device=dev)
    B = (split(u_re), split(u_im))
    del u_re, u_im
    out = []
    for b in range(n_blocks):
        out.append(_rows_block(S, dims, sea_mask, idx_rare, e0))
        if b + 1 < n_blocks:
            S = _apply_replicated(*B[0], *B[1], S, group, n_limbs, limb_bits)
    return _finish(out, T)


# ---------------------------------------------------------------------------
# Exact-limb ("ext") tier: the parity-grade chain
# ---------------------------------------------------------------------------


def _ext_sharded_cmatmul(left, b_re, b_im, group, panel: int, dim: int):
    """Row-sharded exact complex limb product C = A @ B: ``left`` the
    prepared left operand of A's rows (ops/extprec.ext_left), b_re/b_im the
    (L, rows_local, dim) canonical limbs of B's rows; one tiled all_gather
    of B's column-panel limbs per panel and plane, each panel carried into
    C's columns through one digit workspace."""
    from ..ops.extprec import _ext_cpanel_into, _ext_workspace

    L, rows_local = b_re.shape[0], left.re.shape[0]
    c_re = torch.empty((L, rows_local, dim), dtype=torch.int8, device=b_re.device)
    c_im = torch.empty_like(c_re)
    ws = _ext_workspace(left, min(panel, dim), b_re.device)
    for p0 in range(0, dim, panel):
        p1 = min(p0 + panel, dim)
        _ext_cpanel_into(left, all_gather_cat(b_re[:, :, p0:p1], group, dim=1),
                         all_gather_cat(b_im[:, :, p0:p1], group, dim=1), ws, c_re, c_im, p0)
    return c_re, c_im


def _ext_sharded_apply(left, s_re, s_im, group):
    """Row-sharded ext operator (``left``) applied to a REPLICATED
    (L, dim, w) limb block; the re-replicated product limb stacks by one
    tiled all_gather each (int8: a quarter of the Ozaki tier's bytes)."""
    from ..ops.extprec import _ext_cpanel_product

    o_re, o_im = _ext_cpanel_product(left, s_re, s_im)
    return all_gather_cat(o_re, group, dim=1), all_gather_cat(o_im, group, dim=1)


def expm_traces_sharded_ext(
    H: OperatorSum,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    n_sea_effective: int,
    idx_rare: int,
    mesh: DeviceMesh,
    axis: str = "sp",
    block: int = 128,
    panel: int = 512,
) -> np.ndarray:
    """Assembled observable rows (8, T) via the row-sharded EXACT-LIMB chain:
    the contract of :func:`expm_traces_sharded`, parity-grade (truncation
    ~2^-65 per product, no float64 rounding in the chain), as the
    single-device ``ext`` route."""
    from ..dynamics.expm_propagator import _EXT_DEGREE, _EXT_THETA, _spectral_norm_host
    from ..dynamics.krylov import spectral_norm_bound
    from ..ops.extprec import (
        EXT_LIMBS,
        ext_axpy_traced,
        ext_left,
        ext_split_host,
        ext_val,
        taylor_coeff_limbs,
    )

    T, dt, dim, group, rows, dev, block, log2_block, n_blocks = _layout(
        times, dims, mesh, axis, block)
    L = EXT_LIMBS
    # exact int32 diagonal sums (see ops/extprec.ext_cmatmul)
    if dim * 33 * 33 * 2 * L >= 2**31:
        raise ValueError(f"dim {dim}: int32 would overflow in the ext product pyramid")
    panel = min(panel, dim)
    psi0 = np.asarray(psi0)
    e0, local, Hh = _host_operator(H, psi0, rows, dim >= _EXT_CHUNK_DIM)
    norm = min(spectral_norm_bound(H), _spectral_norm_host(Hh))
    del Hh
    x = norm * abs(dt)
    n_sq = max(0, int(np.ceil(np.log2(max(x, 1e-30) / _EXT_THETA))))
    dt_s = dt / (2**n_sq)

    # the host split of this rank's rows of A = -i H dt_s into canonical limbs
    rows_local = rows.stop - rows.start
    v = local[2]
    a = _scatter_rows(local, rows_local, dim,
                      np.stack([ext_split_host(v.imag * dt_s, L),
                                ext_split_host(-v.real * dt_s, L)]), dev, dtype=torch.int8)
    a_re, a_im = a[0], a[1]
    coeffs = taylor_coeff_limbs(_EXT_DEGREE)

    # Horner: D <- A + (A @ D) / k, k = degree .. 2 (exact limb operations)
    left_a = ext_left(a_re, a_im)
    u_re, u_im = a_re, a_im
    for k in range(_EXT_DEGREE, 1, -1):
        t_re, t_im = _ext_sharded_cmatmul(left_a, u_re, u_im, group, panel, dim)
        u_re = ext_axpy_traced(a_re, t_re, coeffs[k])
        u_im = ext_axpy_traced(a_im, t_im, coeffs[k])
    del left_a, a
    # U = I + D: 1.0 sits exactly on limb 0 at this rank's row offset
    u_re[0].diagonal(offset=rows.start).add_(1)
    for _ in range(n_sq):
        u_re, u_im = _ext_sharded_cmatmul(ext_left(u_re, u_im), u_re, u_im, group, panel, dim)

    # doubling pass on the replicated seed limb block
    S_re = torch.zeros((L, dim, block), dtype=torch.int8, device=dev)
    S_im = torch.zeros_like(S_re)
    S_re[:, :, 0] = torch.as_tensor(ext_split_host(np.ascontiguousarray(psi0.real), L), device=dev)
    S_im[:, :, 0] = torch.as_tensor(ext_split_host(np.ascontiguousarray(psi0.imag), L), device=dev)
    for k in range(log2_block):
        w = 1 << k
        left = ext_left(u_re, u_im)
        S_re[:, :, w:2 * w], S_im[:, :, w:2 * w] = _ext_sharded_apply(
            left, S_re[:, :, :w].contiguous(), S_im[:, :, :w].contiguous(), group)
        u_re, u_im = _ext_sharded_cmatmul(left, u_re, u_im, group, panel, dim)

    # advance: observables from the limb states, then S <- B @ S
    sea_mask = torch.as_tensor((np.arange(len(dims)) < n_sea_effective).astype(np.float64),
                               device=dev)
    left = ext_left(u_re, u_im)
    del u_re, u_im
    out = []
    for b in range(n_blocks):
        out.append(_rows_block(torch.complex(ext_val(S_re), ext_val(S_im)), dims, sea_mask,
                               idx_rare, e0))
        if b + 1 < n_blocks:
            S_re, S_im = _ext_sharded_apply(left, S_re, S_im, group)
    return _finish(out, T)
