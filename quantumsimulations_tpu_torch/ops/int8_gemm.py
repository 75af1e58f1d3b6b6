"""Exact int8 GEMM: (M, K) int8 @ (K, N) int8 -> (M, N) int32.

Every limb-pair product of the port's limb tiers runs through it
(``ops/extprec.py::int_mm``: the ext chain and advance, the Ozaki products,
the ``limb`` tier of ``cheb_step``, the sharded engines).  On a CUDA tensor
the wrapper launches the hand-written Hopper kernel ``csrc/int8_gemm.cu``
(``wgmma`` on the int8 tensor cores, TMA staging, warp-specialised; its
header gives the bound and the design); on a CPU tensor it runs
:func:`int8_gemm_plain`, ``torch._int_mm`` on operands padded to the shapes
it takes.  A CUDA tensor never takes the plain version or any library GEMM:
the kernel launches or the wrapper raises.  Int32 sums are exact in any
order under the callers' headroom asserts, so both equal each other, and the
JAX package's XLA dot, bit for bit.

The kernel reads both operands K-major through the Tensor Memory
Accelerator, as every caller lays them out: A with unit stride along K, B
the transpose of a K-contiguous (N, K) operand, both with 16-byte aligned
starts and row strides (:func:`int8_gemm_layout` checks and raises on
anything else).  Ragged M, N and K need no padding on the card.  The tile
width and the split of K come from the shapes alone
(:func:`int8_gemm_plan`).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count

#: rows of a block tile and bytes of K per pipeline stage (csrc/int8_gemm.cu BM, BK)
TILE_M = 128
TILE_K = 128
#: the widest N the narrow variant takes (one tile holds every column)
NARROW_N = 64
#: block tiles an SM holds at once: the wide variant's ring fills its shared
#: memory, the narrow one's half of it
BLOCKS_PER_SM = {"wide": 1, "narrow": 2}
_GRID_Z_MAX = 65535
_INT_MAX = 2**31 - 1

_sm_counts: dict[int, int] = {}


def int8_gemm_plan(M: int, N: int, K: int, sms: int) -> tuple[str, int, int]:
    """(variant, bn, splits) of one GEMM on a card of ``sms`` SMs.

    ``wide`` for N > 64: 128 x 256 block tiles (128 x 128 for N <= 128);
    ``narrow`` for N <= 64: the smallest of 8, 16, 32, 64 columns that holds
    N, so one tile row reads A once.  Where the tiles would leave SMs idle,
    K is split into ``splits`` runs across the grid, as many as fill one
    wave (never more than K's 128-byte slices)."""
    if N <= NARROW_N:
        variant, bn = "narrow", max(8, 1 << (N - 1).bit_length())
    else:
        variant, bn = "wide", 128 if N <= 128 else 256
    tiles = -(-M // TILE_M) * -(-N // bn)
    k_tiles = -(-K // TILE_K)
    splits = max(1, min(k_tiles, BLOCKS_PER_SM[variant] * sms // tiles, _GRID_Z_MAX))
    return variant, bn, splits


def int8_gemm_layout(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(lda, ldb): the byte strides between A's rows and between B's
    columns, after checking the layout the kernel reads (module docstring).
    Raises TypeError or ValueError on anything else."""
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("int8_gemm takes two torch tensors")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_gemm takes int8 operands, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError("int8_gemm operands must lie on one device")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_gemm takes (M, K) @ (K, N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if min(M, N, K) < 1 or max(M, N, K) > _INT_MAX:
        raise ValueError(f"int8_gemm shape out of range: M={M} K={K} N={N}")
    if K > 1 and a.stride(1) != 1:
        raise ValueError("int8_gemm takes A with unit stride along K")
    if K > 1 and b.stride(0) != 1:
        raise ValueError("int8_gemm takes B K-contiguous: the transpose of an (N, K) row-major "
                         "operand, not an N-contiguous one")
    # a stride along an axis of length 1 is never used
    whole = -(-K // 16) * 16
    lda = a.stride(0) if M > 1 else whole
    ldb = b.stride(1) if N > 1 else whole
    for name, x, ld in (("A", a, lda), ("B", b, ldb)):
        if ld < K or ld % 16 or x.data_ptr() % 16:
            raise ValueError(f"int8_gemm takes {name} with a 16-byte aligned start and rows "
                             f"16-byte multiples apart (stride {ld}, K {K})")
    return lda, ldb


def int8_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` on operands zero-padded to M > 16 and K, N
    multiples of 8 (the shapes it takes; zeros change no sum)."""
    M, K = a.shape
    N = b.shape[1]
    pm, pk, pn = max(17 - M, 0), (-K) % 8, (-N) % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a, b)
    return out[:M, :N] if (pm or pn) else out


def _lib_fn():
    from ..kernels._build import load_library

    fn = load_library("int8_gemm").qst_int8_gemm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def _out(out: torch.Tensor | None, M: int, N: int, device) -> torch.Tensor:
    """The (M, N) int32 result: ``out`` after checking that the kernel can
    write it (contiguous, on the operands' device, 8-byte aligned where N
    is even: the epilogue stores int32 pairs), else a new tensor."""
    if out is None:
        return torch.empty((M, N), dtype=torch.int32, device=device)
    if (out.dtype != torch.int32 or out.shape != (M, N) or not out.is_contiguous()
            or out.device != device):
        raise ValueError(f"int8_gemm writes a contiguous ({M}, {N}) int32 tensor on {device}, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    if out.data_ptr() % (8 if N % 2 == 0 else 4):
        raise ValueError("int8_gemm writes int32 pairs: out must start 8-byte aligned")
    return out


def _launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    lda, ldb = int8_gemm_layout(a, b)
    M, K = a.shape
    N = b.shape[1]
    variant, bn, splits = int8_gemm_plan(M, N, K, _sm_count(a.device))
    out = _out(out, M, N, a.device)
    if splits > 1:  # split blocks add into C
        out.zero_()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib_fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, lda, ldb, bn, splits,
                       stream)
    if rc != 0:
        raise RuntimeError(f"int8_gemm kernel launch failed with CUDA error {rc}")
    count(f"int8_gemm.{variant}", 1)  # wide plus narrow: the launches
    return out


def int8_gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact: the kernel on a
    CUDA tensor, :func:`int8_gemm_plain` on a CPU one.  With ``out``, a
    contiguous (M, N) int32 tensor (a view of a larger workspace), the
    result is written there and returned."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        res = int8_gemm_plain(a, b)
        return res if out is None else _out(out, *res.shape, a.device).copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cuda or cpu, not {a.device}")
    return _launch(a, b, out)
