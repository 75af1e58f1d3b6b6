"""Fused int8 limb-pair observable sums: per-site x/y/z and norm^2 diagonal
sums straight from ext limb state stacks, for all-spin-1/2 Hilbert spaces.

Port of ``quantumsimulations_tpu/ops/pallas_kernels.py::ext_obs_diagonals_int8``
(the Pallas kernel ``_ext_obs_kernel``).  For every limb pair p = (j, i) of
the pair tables and column t, with prod = Rj*Ri + Ij*Ii elementwise over the
rows of the (L, dim, T) limb planes R = S_re, I = S_im:

  * row 3*n_sites: sum over all rows of prod (norm^2);
  * per site k (stride dr = 2^(n_sites-1-k); a runs over the level-0 rows,
    b = a + dr is its level-1 partner):
      z_k = sum_a prod[a] - sum_b prod[b],
      x_k = sum_a (Rj[a]*Ri[b] + Ij[a]*Ii[b]),
      y_k = sum_a (Rj[a]*Ii[b] - Ij[a]*Ri[b]);

each added into significance diagonal s = j + i of an (n_diag, R, T) int32
result, R = 3*n_sites + 1 rounded up to 8 (the padding rows are zero).  The
float64 combine with weights 2^(-5 s) runs outside
(dynamics/expm_propagator.py::_ext_site_obs_fused).  Int32 sums are exact
in any order under the headroom assert, so the kernel, the plain version and
the Pallas kernel agree bit for bit.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/ext_obs_diagonals.cu`` (int8 tensor-core Grams, one column per block
up to dim 8192, one column per two blocks of a cluster at dim 16384; its
header gives the design and the bound); on a CPU tensor it runs
:func:`ext_obs_diagonals_plain`.  A CUDA tensor never takes the plain
version: the kernel launches or the wrapper raises.  The CUDA kernel is
compiled for the full triangle of pairs (every (j, s - j) with s < n_diag,
the tables ``_ext_obs_pairs`` builds), in any order, with n_diag <= 11,
L >= n_diag and dim <= 16384 (a column's limbs in the shared memory of one
block, or of two: the ext route's dims); the wrapper raises for other
tables and larger dims.

Under an active tracer (``utils/profiling.py``) each call is a launch span
``ext_obs`` and the innermost open stage counts ``ext_obs.columns`` (T) and
``ext_obs.bytes``, the least HBM bytes of the call: the n_diag limb planes
of both stacks read once, the (n_diag, R, T) int32 sums written once.

Parameters kept for call-site compatibility with the JAX package:
``t_tile`` (a no-op: the CUDA kernel masks a ragged T, so T need not be a
multiple of it) and ``interpret`` (a no-op: the tensors' device picks the
kernel or the plain version).
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import launch_counts
from ..utils.profiling import count, launch_span

#: largest n_diag the CUDA kernel is compiled for (the JAX package's _EXT_OBS_Q)
KERNEL_MAX_DIAG = 11
#: largest n_sites of the CUDA kernel: a block holds 23 planes of up to 8192
#: rows + 16 bytes (189 KB) of a column, so a dim-16384 column takes two
#: blocks of a cluster, and no dim above fits
KERNEL_MAX_SITES = 14
#: columns per chunk of the plain version
_PLAIN_COLS = 2048


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check(S_re, S_im, jj, ii, n_diag: int) -> tuple[int, int, int, int, int]:
    if S_re.dtype != torch.int8 or S_im.dtype != torch.int8:
        raise TypeError(f"ext_obs_diagonals_int8 takes int8 limb planes, got {S_re.dtype}, {S_im.dtype}")
    if S_re.dim() != 3 or S_re.shape != S_im.shape:
        raise ValueError(f"ext_obs_diagonals_int8 takes two (L, dim, T) stacks, got "
                         f"{tuple(S_re.shape)}, {tuple(S_im.shape)}")
    if S_re.device != S_im.device:
        raise ValueError("ext_obs_diagonals_int8 operands must lie on one device")
    L, dim, T = S_re.shape
    n_sites = dim.bit_length() - 1
    assert 1 << n_sites == dim, "fused obs kernel requires a power-of-two dim"
    # i32 headroom: <= q pairs per diagonal, |limb| <= 33, dim rows
    assert dim * 33 * 33 * int(n_diag) < 2**31, "i32 would overflow"
    if len(jj) != len(ii):
        raise ValueError("jj and ii must have one entry per pair")
    return L, dim, T, n_sites, _round_up(3 * n_sites + 1, 8)


def ext_obs_diagonals_plain(S_re, S_im, jj, ii, n_diag: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ext_obs_diagonals_int8`: the same
    sums, vectorised over the pairs of one diagonal at a time, in int64 and
    cast to int32 at the end (columns in chunks of _PLAIN_COLS, which bounds
    the int32 transients)."""
    L, dim, T, n_sites, R = _check(S_re, S_im, jj, ii, n_diag)
    jj = [int(x) for x in jj]
    ii = [int(x) for x in ii]
    out = torch.zeros((n_diag, R, T), dtype=torch.int64, device=S_re.device)
    for s in range(n_diag):
        ps = [p for p in range(len(jj)) if jj[p] + ii[p] == s]
        if not ps:
            continue
        js = torch.as_tensor([jj[p] for p in ps], device=S_re.device)
        is_ = torch.as_tensor([ii[p] for p in ps], device=S_re.device)
        for t0 in range(0, T, _PLAIN_COLS):
            cols = slice(t0, min(t0 + _PLAIN_COLS, T))
            out[s, :, cols] = _diagonal_sums(S_re[:, :, cols], S_im[:, :, cols], js, is_,
                                             n_sites, R)
    return out.to(torch.int32)


def _diagonal_sums(S_re, S_im, js, is_, n_sites: int, R: int) -> torch.Tensor:
    """(R, T) int64 sums over the pairs (js[p], is_[p]) of one diagonal."""
    _, dim, T = S_re.shape
    n = len(js)
    Rj, Ij = S_re[js].to(torch.int32), S_im[js].to(torch.int32)  # (n, dim, T)
    Ri, Ii = S_re[is_].to(torch.int32), S_im[is_].to(torch.int32)
    prod = Rj * Ri + Ij * Ii
    out = torch.zeros((R, T), dtype=torch.int64, device=S_re.device)
    out[3 * n_sites] = prod.sum(dim=(0, 1))
    for k in range(n_sites):
        dr = 1 << (n_sites - 1 - k)
        dl = dim // (2 * dr)

        def lev(u, a):
            return u.reshape(n, dl, 2, dr, T)[:, :, a]

        pv = prod.reshape(n, dl, 2, dr, T)
        out[3 * k + 2] = pv[:, :, 0].sum(dim=(0, 1, 2)) - pv[:, :, 1].sum(dim=(0, 1, 2))
        Rja, Ija, Rib, Iib = lev(Rj, 0), lev(Ij, 0), lev(Ri, 1), lev(Ii, 1)
        out[3 * k] = (Rja * Rib + Ija * Iib).sum(dim=(0, 1, 2))
        out[3 * k + 1] = (Rja * Iib - Ija * Rib).sum(dim=(0, 1, 2))
    return out


def _is_triangle(jj, ii, n_diag: int) -> bool:
    pairs = sorted(zip((int(x) for x in jj), (int(x) for x in ii)))
    return pairs == sorted((j, s - j) for s in range(n_diag) for j in range(s + 1))


def _lib_fn():
    from ..kernels._build import load_library

    fn = load_library("ext_obs_diagonals").qst_ext_obs_diagonals
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(S_re, S_im, n_diag: int, L: int, dim: int, T: int, n_sites: int, R: int) -> torch.Tensor:
    if not (S_re.is_contiguous() and S_im.is_contiguous()):
        raise ValueError("ext_obs_diagonals_int8 takes contiguous limb stacks on cuda")
    if L * dim * T >= 2**62:
        raise ValueError(f"ext_obs_diagonals_int8 shape out of range: {tuple(S_re.shape)}")
    out = torch.empty((n_diag, R, T), dtype=torch.int32, device=S_re.device)
    if T == 0:
        return out
    with torch.cuda.device(S_re.device):
        stream = torch.cuda.current_stream(S_re.device).cuda_stream
        rc = _lib_fn()(S_re.data_ptr(), S_im.data_ptr(), out.data_ptr(),
                       L, dim, T, n_sites, R, n_diag, stream)
    if rc != 0:
        raise RuntimeError(f"ext_obs_diagonals kernel launch failed with CUDA error {rc}")
    launch_counts["ext_obs_diagonals_int8"] += 1
    return out


def ext_obs_diagonals_int8(
    S_re: torch.Tensor,  # (L, dim, T) int8 canonical ext limbs
    S_im: torch.Tensor,
    jj,  # (P,) left-limb index per pair
    ii,  # (P,) right-limb index per pair
    n_diag: int,
    t_tile: int = 128,
    interpret: bool | None = None,
) -> torch.Tensor:
    """(n_diag, R, T) int32 raw observable sums per significance diagonal.

    R = 3 * n_sites + 1 rows padded to a multiple of 8; all local dims must
    be 2 (n_sites = log2(dim)).  Combine outside with weights 2^(-5 s).
    ``t_tile`` and ``interpret`` are accepted no-ops (module docstring)."""
    L, dim, T, n_sites, R = _check(S_re, S_im, jj, ii, n_diag)
    with launch_span("ext_obs"):
        out = _dispatch(S_re, S_im, jj, ii, n_diag, L, dim, T, n_sites, R)
    count("ext_obs.columns", T)
    count("ext_obs.bytes", 2 * n_diag * dim * T + 4 * n_diag * R * T)
    return out


def _dispatch(S_re, S_im, jj, ii, n_diag: int, L: int, dim: int, T: int, n_sites: int,
              R: int) -> torch.Tensor:
    if S_re.device.type == "cpu":
        return ext_obs_diagonals_plain(S_re, S_im, jj, ii, n_diag)
    if S_re.device.type != "cuda":
        raise ValueError(f"ext_obs_diagonals_int8 runs on cuda or cpu, not {S_re.device}")
    if not (1 <= n_diag <= min(KERNEL_MAX_DIAG, L)) or not _is_triangle(jj, ii, n_diag):
        raise ValueError(
            f"the CUDA obs kernel takes the full pair triangle of n_diag <= "
            f"{KERNEL_MAX_DIAG} diagonals with L >= n_diag (got n_diag={n_diag}, L={L})"
        )
    if n_sites > KERNEL_MAX_SITES:
        raise ValueError(
            f"the CUDA obs kernel holds one column's limbs in the shared memory of one block "
            f"or of two: dim <= {1 << KERNEL_MAX_SITES} (got dim={dim})"
        )
    return _launch(S_re, S_im, n_diag, L, dim, T, n_sites, R)
