"""Fused limb-domain matmul: int8 limb-pair products -> canonical int8 limbs.

Port of ``quantumsimulations_tpu/ops/limb_kernels.py::limb_matmul_canon``
(the Pallas kernel ``_limb_kernel``).  A value on the 2^bits grid is an
(L, ...) stack of int8 limbs, limb j weighing 2^(-bits*j).  The product of
limb stacks a (L, M, K) and b (L, K, N) accumulates every limb pair (j, i)
with j + i = s < S = L + 2 into an int32 digit s, then an exact carry
cascade (nearest, ties toward +inf) emits canonical int8 limbs (L, M, N).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/limb_matmul_canon.cu`` (see its header for the bound and design); on a
CPU tensor it runs :func:`limb_matmul_canon_plain`, the plain PyTorch
version.  A CUDA tensor never takes the plain version: the kernel launches
or the wrapper raises.

Parameters kept for call-site compatibility with the JAX package:

  * ``tm`` — with ``transpose_out`` it is a LAYOUT parameter (the callers
    pass tm = DL): M-tile i's (tm, N) product lands at columns
    [i*N, (i+1)*N) of an (L, tm, (M // tm) * N) result.  It is clamped to
    ``min(tm, round_up(M, 32))`` as the JAX package clamps it.  Without
    ``transpose_out`` it is a no-op.
  * ``tn``, ``tk`` — no-ops: they sized the TPU kernel's VMEM tiles; the
    CUDA kernel's tiles and K split come from :func:`limb_launch_plan`, and
    it masks ragged edges itself.
  * ``interpret`` — a no-op: it selected Pallas interpret mode; here the
    tensors' device alone picks the kernel (CUDA) or the plain version (CPU).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..utils.profiling import count

GRID_GUARD = 2  # product digits feeding carries up the cascade (matches ext)
#: limb count the CUDA kernel is compiled for (split_apply_ext.GRID_LIMBS)
KERNEL_LIMBS = 10


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def live_pairs(L: int) -> int:
    """Number of limb pairs (j, i), j, i < L, with j + i < L + GRID_GUARD."""
    S = L + GRID_GUARD
    return sum(min(s + 1, L) - max(0, s - L + 1) for s in range(S))


def carry_digits(d: torch.Tensor, bits: int, L: int | None = None) -> torch.Tensor:
    """Exact carry cascade on an int32 digit stack (n, ...) -> canonical int8
    limbs: nearest, ties toward +inf.  Returns the first ``L`` limbs (all n
    by default); the limbs above L are never formed.  ``>>`` on int32
    tensors is an arithmetic shift, as the JAX package's is; ``c * 2^bits``
    stands for its ``c << bits`` (the same bits in two's complement)."""
    half = 1 << (bits - 1)
    n = d.shape[0]
    L = n if L is None else L
    out = torch.empty((L,) + tuple(d.shape[1:]), dtype=torch.int8, device=d.device)
    c = torch.zeros_like(d[0])
    for s in range(n - 1, 0, -1):
        t = d[s] + c
        c = (t + half) >> bits
        if s < L:
            out[s] = torch.sub(t, c, alpha=1 << bits)
    out[0] = d[0] + c
    return out


def product_digits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Digit stack (L + GRID_GUARD, M, N) int32 of (limb a) @ (limb b), no carry.

    The plain version of the limb kernel's digits, which
    :func:`limb_matmul_canon_plain` and the tests hold the kernel against:
    digit s is sum_j a[j] @ b[s - j], ONE float64 matmul of the pairs'
    limbs laid side by side along K.  Every partial sum is an integer below
    2^31, far under 2^53, so the float64 product is exact in any order.
    The port's own limb products form their digits through
    ``ops/extprec.py::diagonal_mm`` (int8 GEMMs), which equals this bit for
    bit.
    """
    L, M, K = a.shape
    N = b.shape[2]
    af, bf = a.to(torch.float64), b.to(torch.float64)
    digits = torch.zeros((L + GRID_GUARD, M, N), dtype=torch.int32, device=a.device)
    for s in range(L + GRID_GUARD):
        j0, j1 = max(0, s - L + 1), min(s + 1, L)  # pairs (j, s - j), j0 <= j < j1
        A_s = af[j0:j1].permute(1, 0, 2).reshape(M, (j1 - j0) * K)
        B_s = bf[s - j1 + 1: s - j0 + 1].flip(0).reshape((j1 - j0) * K, N)
        digits[s] = (A_s @ B_s).to(torch.int32)
    return digits


def limb_transpose_layout(out: torch.Tensor, tm: int) -> torch.Tensor:
    """(L, M, N) -> (L, tm, (M // tm) * N), M-tile i at columns [i*N, (i+1)*N)."""
    L, M, N = out.shape
    return out.reshape(L, M // tm, tm, N).permute(0, 2, 1, 3).reshape(L, tm, (M // tm) * N)


def limb_matmul_canon_plain(
    a: torch.Tensor, b: torch.Tensor, bits: int, tm: int = 128, transpose_out: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of :func:`limb_matmul_canon`: the digits of
    :func:`product_digits` (exact float64 matmuls), the carry cascade, the
    first L limbs and the ``transpose_out`` layout."""
    out = carry_digits(product_digits(a, b), bits, a.shape[0])
    return limb_transpose_layout(out, tm) if transpose_out else out


def _check(a, b, bits: int) -> tuple[int, int, int, int]:
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("limb_matmul_canon takes two torch tensors")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"limb_matmul_canon takes int8 limb stacks, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("limb_matmul_canon operands must lie on one device")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"limb_matmul_canon takes (L,M,K)@(L,K,N), got {tuple(a.shape)}@{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("limb_matmul_canon takes contiguous limb stacks")
    if not 1 <= bits <= 7:
        raise ValueError(f"bits must be in [1, 7], got {bits}")
    L, M, K = a.shape
    N = b.shape[2]
    # i32 digit headroom: canonical limbs are <= 2^(bits-1) (limb 0 <= ~2^bits
    # after carry folds), a digit sums <= L pair-dots of K MACs each
    assert K * (2 ** (2 * bits)) * L < 2**31, "i32 would overflow"
    return L, M, K, N


#: the CUDA kernel's output tile and K step (csrc/limb_matmul_canon.cu)
TILE_M, TILE_N, K_STEP = 32, 32, 32
#: int32 digit registers a kernel thread holds (12 digits x 4) and threads
#: per block: one K slice's share of the split-K workspace per output tile
#: (the kernel refuses a workspace smaller than its own count)
_DIGIT_REGS, _THREADS = 48, 256
#: streaming multiprocessors of an H100 (the plan's default)
H100_SMS = 132


@dataclass(frozen=True)
class LimbPlan:
    """Launch plan of one limb product: a grid of (grid_m, grid_n) output
    tiles of (tile_m, tile_n), each summed over ``ksplit`` K slices of
    ``kslice`` (a multiple of ``k_step``); slice z is
    [z * kslice, min(K, (z + 1) * kslice))."""

    tile_m: int
    tile_n: int
    k_step: int
    grid_m: int
    grid_n: int
    ksplit: int
    kslice: int

    @property
    def tiles(self) -> int:
        return self.grid_m * self.grid_n

    @property
    def blocks(self) -> int:
        return self.tiles * self.ksplit

    @property
    def workspace_ints(self) -> int:
        """int32 of the split-K workspace (0 without a split)."""
        return self.blocks * _DIGIT_REGS * _THREADS if self.ksplit > 1 else 0

    def k_slices(self, K: int) -> list[tuple[int, int]]:
        return [(z * self.kslice, min(K, (z + 1) * self.kslice)) for z in range(self.ksplit)]


@functools.lru_cache(maxsize=256)
def limb_launch_plan(M: int, K: int, N: int, sms: int = H100_SMS) -> LimbPlan:
    """Tiles and K split of one (L, M, K) @ (L, K, N) launch.

    Output tiles of TILE_M x TILE_N.  A product with at least one tile per
    SM runs unsplit; a smaller output splits K into slices of whole K steps,
    aiming at two blocks per SM (the kernel's occupancy), with no empty
    slice.  Every slice's int32 sums stay within the wrapper's headroom
    assertion, which covers the full K.
    """
    grid_m, grid_n = -(-M // TILE_M), -(-N // TILE_N)
    tiles = max(1, grid_m * grid_n)
    steps = max(1, -(-K // K_STEP))
    ksplit = 1 if tiles >= sms else min(steps, -(-2 * sms // tiles))
    kslice = -(-steps // ksplit) * K_STEP
    ksplit = max(1, -(-K // kslice))
    return LimbPlan(TILE_M, TILE_N, K_STEP, grid_m, grid_n, ksplit, kslice)


def _lib_fn():
    from ..kernels._build import load_library

    fn = load_library("limb_matmul_canon").qst_limb_matmul_canon
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


#: split-K tile counters per (device, stream): zeroed once, and the kernel's
#: last-arriving block resets each one to 0, so launches in stream order
#: share them without a memset
_counters: dict[tuple[int, int], torch.Tensor] = {}
_sms: dict[int, int] = {}


def _tile_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return c


def _launch(a, b, bits: int, tm: int, transpose_out: bool) -> torch.Tensor:
    L, M, K = a.shape
    N = b.shape[2]
    if L != KERNEL_LIMBS:
        raise ValueError(f"the CUDA limb kernel is built for L={KERNEL_LIMBS} limbs, got L={L}")
    if max(M, N, K) >= 2**31 or L * M * N >= 2**31:
        raise ValueError(f"limb_matmul_canon shape out of range: {tuple(a.shape)}@{tuple(b.shape)}")
    if transpose_out:
        out = torch.empty((L, tm, (M // tm) * N), dtype=torch.int8, device=a.device)
        row_tile, ldo = tm, (M // tm) * N
    else:
        out = torch.empty((L, M, N), dtype=torch.int8, device=a.device)
        row_tile, ldo = M, N
    if M * N == 0:
        return out
    dev = a.device
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = limb_launch_plan(M, K, N, _sms[dev.index])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = counters = None
        if plan.ksplit > 1:
            ws = torch.empty(plan.workspace_ints, dtype=torch.int32, device=dev)
            counters = _tile_counters(dev, stream, plan.tiles)
        rc = _lib_fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                       L, M, K, N, bits, row_tile, ldo,
                       plan.tile_m, plan.tile_n, plan.k_step, plan.ksplit, plan.kslice,
                       None if ws is None else ws.data_ptr(), plan.workspace_ints,
                       None if counters is None else counters.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"limb_matmul_canon kernel launch failed with CUDA error {rc}")
    count("limb_matmul_canon.launches", 1)
    return out


def limb_matmul_canon(
    a: torch.Tensor,  # (L, M, K) int8 canonical limbs
    b: torch.Tensor,  # (L, K, N) int8 canonical limbs
    bits: int,
    tm: int = 128,
    tn: int = 128,
    tk: int = 512,
    transpose_out: bool = False,
    interpret: bool | None = None,
) -> torch.Tensor:
    """Canonical int8 limbs of (limb a) @ (limb b) on the 2^bits grid.

    Returns (L, M, N), or with ``transpose_out`` (L, tm, (M // tm) * N):
    M-tile ``i``'s (tm, N) product lands at columns ``[i*N, (i+1)*N)``.
    ``tn``, ``tk`` and ``interpret`` are accepted no-ops (module docstring).
    """
    L, M, K, N = _check(a, b, bits)
    tm = min(tm, _round_up(M, 32))
    if transpose_out and M % tm != 0:
        raise ValueError(f"transpose_out needs M % tm == 0, got M={M}, tm={tm}")
    if a.device.type == "cpu":
        return limb_matmul_canon_plain(a, b, bits, tm=tm, transpose_out=transpose_out)
    if a.device.type != "cuda":
        raise ValueError(f"limb_matmul_canon runs on cuda or cpu, not {a.device}")
    return _launch(a, b, bits, tm, transpose_out)
