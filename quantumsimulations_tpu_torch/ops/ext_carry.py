"""The exact-limb chain's digit epilogue: int32 digits -> canonical int8 limbs.

Two functions of the ``ext`` chain (``ops/extprec.py``), each one launch of
the hand-written Hopper kernel ``csrc/ext_carry.cu`` on a CUDA tensor (its
header gives the bound and the design), and the plain PyTorch version of the
same integer arithmetic on a CPU tensor.  A CUDA tensor never takes the plain
version: the kernel launches or the wrapper raises.  Both are bit for bit the
composition the JAX package runs (``_ext_cpanel_product``'s Karatsuba
differences and ``_ext_carry_i32``; ``ext_add`` of ``_ext_scalar_mul_traced``):

  * :func:`ext_carry_panel`, after a column panel's int8 GEMMs: the
    Karatsuba outputs m1, m2, m3 of every significance diagonal (one (3, S,
    M, N) int32 workspace) -> re = m1 - m2 and im = m3 - m1 - m2, each
    carried to its first L limbs, written into the product's (L, M,
    N_total) limb stacks at the panel's column offset;
  * :func:`ext_axpy_traced`, the Horner step's a + p * c, the scalar c given
    by its limbs: the digits of p * c, carried, added to a and carried again.

The ext format's sizes live here (``ops/extprec.py`` imports them): L =
EXT_LIMBS = 15 limbs and S = L + EXT_GUARD = 17 digits, which the CUDA kernel
is compiled for.  It takes contiguous stacks; the wrapper raises for anything
else.

Under an active tracer (``utils/profiling.py``) each call is a launch span
``ext_carry`` and the innermost open stage counts ``ext_carry.calls`` and
``ext_carry.bytes``, the least HBM bytes of the call: the panel form reads 3 S
int32 digits and writes 2 L int8 limbs per element, the Horner form reads
p's and a's L limbs and writes L per column.  On the card it also counts
``ext_carry.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.profiling import count, launch_span
from .limb_kernels import carry_digits

EXT_LIMBS = 15  # 15 * 5 = 75 bits below the grid top
EXT_GUARD = 2  # extra product diagonals computed below the last kept limb
#: columns of the flattened stack per float64 product in
#: :func:`_scalar_digits` (1 GB of float64 transient at L = 15)
_SCALAR_CHUNK = 1 << 23
#: columns of the flattened stack per int32 digit block of
#: :func:`ext_axpy_plain`: one (dim, dim) plane at dim 8192, so a dim-16384
#: stack carries in four blocks (~6 GB of transients, not ~25).  Every
#: column carries on its own, so the blocks change no bit.
_CARRY_CHUNK = 1 << 26


def _check_panel(ws, c_re, c_im, p0: int) -> tuple[int, int, int, int]:
    if ws.dtype != torch.int32 or c_re.dtype != torch.int8 or c_im.dtype != torch.int8:
        raise TypeError(f"ext_carry_panel takes int32 digits and int8 limbs, got {ws.dtype}, "
                        f"{c_re.dtype}, {c_im.dtype}")
    if ws.dim() != 4 or ws.shape[0] != 3 or c_re.dim() != 3 or c_re.shape != c_im.shape:
        raise ValueError(f"ext_carry_panel takes (3, S, M, N) digits and two (L, M, N_total) "
                         f"stacks, got {tuple(ws.shape)}, {tuple(c_re.shape)}, {tuple(c_im.shape)}")
    _, S, M, N = ws.shape
    L = c_re.shape[0]
    if c_re.shape[1] != M or not 0 <= p0 <= c_re.shape[2] - N or not 1 <= L <= S:
        raise ValueError(f"ext_carry_panel: digits {tuple(ws.shape)} do not fit columns "
                         f"[{p0}, {p0 + N}) of limbs {tuple(c_re.shape)}")
    if not (ws.device == c_re.device == c_im.device):
        raise ValueError("ext_carry_panel operands must lie on one device")
    return S, M, N, L


def ext_carry_panel_plain(ws, c_re, c_im, p0: int) -> None:
    """Plain PyTorch version of :func:`ext_carry_panel`: the Karatsuba
    differences as int32 planes, :func:`~.limb_kernels.carry_digits` of each,
    and the limbs copied into the panel's columns."""
    S, M, N, L = _check_panel(ws, c_re, c_im, p0)
    m1, m2, m3 = ws
    d_re = torch.sub(m1, m2)
    d_im = m3.sub(m1).sub_(m2)
    c_re[:, :, p0:p0 + N] = carry_digits(d_re, 5, L)
    c_im[:, :, p0:p0 + N] = carry_digits(d_im, 5, L)


def ext_carry_panel(ws: torch.Tensor, c_re: torch.Tensor, c_im: torch.Tensor, p0: int) -> None:
    """Carry one column panel of an ext complex product in place: ``ws`` the
    (3, S, M, N) int32 Karatsuba outputs m1, m2, m3 of the S significance
    diagonals, ``c_re`` and ``c_im`` the (L, M, N_total) int8 limb stacks
    whose columns [p0, p0 + N) receive the canonical limbs of re = m1 - m2
    and im = m3 - m1 - m2 (module docstring)."""
    S, M, N, L = _check_panel(ws, c_re, c_im, p0)
    with launch_span("ext_carry"):
        if ws.device.type == "cpu":
            ext_carry_panel_plain(ws, c_re, c_im, p0)
        elif ws.device.type == "cuda":
            _launch_panel(ws, c_re, c_im, p0, S, M, N, L)
        else:
            raise ValueError(f"ext_carry_panel runs on cuda or cpu, not {ws.device}")
    count("ext_carry.calls", 1)
    count("ext_carry.bytes", (3 * S * 4 + 2 * L) * M * N)


def _scalar_band(cl, L: int, device) -> torch.Tensor:
    """The banded (L + G, L) float64 matrix of the scalar's limbs ``cl``:
    digit m of ext * scalar is sum_i a[m - 1 - i] * cl[i], a short
    convolution along the limb axis, so one matmul with this band."""
    cl = np.asarray(cl, dtype=np.float64)
    band = np.zeros((L + EXT_GUARD, L))
    for m in range(L + EXT_GUARD):
        for i in range(min(len(cl), m)):
            j = m - 1 - i
            if 0 <= j < L:
                band[m, j] = cl[i]
    return torch.as_tensor(band, device=device)


def _scalar_digits(C: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """(L + G, n) int32 digits C @ flat of an (L, n) limb block, one float64
    product per :data:`_SCALAR_CHUNK` columns (bounds the float64 transient).
    Every partial sum is an integer below 2^14, so the float64 product is
    exact and equals the JAX package's int32 sum."""
    d = torch.empty((C.shape[0], flat.shape[1]), dtype=torch.int32, device=flat.device)
    for c0 in range(0, flat.shape[1], _SCALAR_CHUNK):
        c1 = c0 + _SCALAR_CHUNK
        d[:, c0:c1] = C @ flat[:, c0:c1].to(torch.float64)
    return d


def ext_axpy_plain(a: torch.Tensor, p: torch.Tensor, cl) -> torch.Tensor:
    """Plain PyTorch version of :func:`ext_axpy_traced`, in blocks of
    :data:`_CARRY_CHUNK` columns: each block's digits (one float64 matmul
    with :func:`_scalar_band`), shift carry, sum and second carry before the
    next block, so neither the scaled stack nor a whole stack of int32
    digits is ever held."""
    L = a.shape[0]
    C = _scalar_band(cl, L, p.device)
    fa, fp = a.reshape(L, -1), p.reshape(L, -1)
    out = torch.empty(fa.shape, dtype=torch.int8, device=a.device)
    for c0 in range(0, fa.shape[1], _CARRY_CHUNK):
        c1 = c0 + _CARRY_CHUNK
        scaled = carry_digits(_scalar_digits(C, fp[:, c0:c1]), 5, L)
        out[:, c0:c1] = carry_digits(fa[:, c0:c1].to(torch.int32).add_(scaled), 5)
    return out.reshape(a.shape)


def ext_axpy_traced(a: torch.Tensor, p: torch.Tensor, cl) -> torch.Tensor:
    """The Horner step's a + p * c, the scalar c given by its limbs ``cl`` as
    data (the Taylor 1/k): the JAX package's
    ``ext_add(a, _ext_scalar_mul_traced(p, cl))`` bit for bit, on (L, ...)
    int8 limb stacks of one shape (module docstring)."""
    if a.dtype != torch.int8 or p.dtype != torch.int8:
        raise TypeError(f"ext_axpy_traced takes int8 limb stacks, got {a.dtype}, {p.dtype}")
    if a.shape != p.shape or a.dim() < 1:
        raise ValueError(f"ext_axpy_traced takes two limb stacks of one shape, got "
                         f"{tuple(a.shape)}, {tuple(p.shape)}")
    if a.device != p.device:
        raise ValueError("ext_axpy_traced operands must lie on one device")
    L = a.shape[0]
    with launch_span("ext_carry"):
        if a.device.type == "cpu":
            out = ext_axpy_plain(a, p, cl)
        elif a.device.type == "cuda":
            out = _launch_axpy(a, p, cl)
        else:
            raise ValueError(f"ext_axpy_traced runs on cuda or cpu, not {a.device}")
    count("ext_carry.calls", 1)
    count("ext_carry.bytes", 3 * a.numel())
    return out


def _lib():
    from ..kernels._build import load_library

    lib = load_library("ext_carry")
    if lib.qst_ext_carry_panel.argtypes is None:
        lib.qst_ext_carry_panel.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        lib.qst_ext_carry_panel.restype = ctypes.c_int
        lib.qst_ext_axpy.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                                              ctypes.c_int, ctypes.c_void_p])
        lib.qst_ext_axpy.restype = ctypes.c_int
    return lib


def _check_kernel_limbs(name: str, L: int, S: int) -> None:
    if L != EXT_LIMBS or S != EXT_LIMBS + EXT_GUARD:
        raise ValueError(f"the CUDA {name} is compiled for {EXT_LIMBS} limbs and "
                         f"{EXT_LIMBS + EXT_GUARD} digits (got {L} and {S})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_panel(ws, c_re, c_im, p0: int, S: int, M: int, N: int, L: int) -> None:
    _check_kernel_limbs("ext_carry_panel", L, S)
    if not (ws.is_contiguous() and c_re.is_contiguous() and c_im.is_contiguous()):
        raise ValueError("ext_carry_panel takes contiguous digits and limb stacks on cuda")
    with torch.cuda.device(ws.device):
        rc = _lib().qst_ext_carry_panel(ws.data_ptr(), c_re.data_ptr(), c_im.data_ptr(), M, N,
                                        c_re.shape[2], p0, _stream(ws.device))
    if rc != 0:
        raise RuntimeError(f"ext_carry_panel kernel launch failed with CUDA error {rc}")
    count("ext_carry.launches", 1)


def _launch_axpy(a, p, cl) -> torch.Tensor:
    L = a.shape[0]
    _check_kernel_limbs("ext_axpy_traced", L, L + EXT_GUARD)
    if not (a.is_contiguous() and p.is_contiguous()):
        raise ValueError("ext_axpy_traced takes contiguous limb stacks on cuda")
    limbs = np.asarray(cl, dtype=np.float64)
    ints = np.rint(limbs)
    if limbs.ndim != 1 or not np.array_equal(ints, limbs) or np.abs(ints).max(initial=0) > 16:
        raise ValueError("ext_axpy_traced takes the scalar's limbs as integers in [-16, 16]")
    c = np.ascontiguousarray(ints, dtype=np.int32)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        rc = _lib().qst_ext_axpy(a.data_ptr(), p.data_ptr(), out.data_ptr(), a.numel() // L,
                                 c.ctypes.data, len(c), _stream(a.device))
    if rc != 0:
        raise RuntimeError(f"ext_axpy kernel launch failed with CUDA error {rc}")
    count("ext_carry.launches", 1)
    return out
