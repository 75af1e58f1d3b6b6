"""Fused per-site z expectations: <Sz_j>(t) for every site of a block of
states at once, out[j, t] = sum_d signs[j, d] * |psi[d, t]|^2.

Port of ``quantumsimulations_tpu/ops/pallas_kernels.py::z_expectations_f32``
(the Pallas kernel ``_zexp_kernel``) and ``z_sign_table``.  The contract is
the JAX function's: |psi|^2 = re*re + im*im is formed in the planes' own
dtype (float32 or float64) and rounded to float32, the signs are taken as
float32, and the products are summed; the result is an (n_sites, T) float32
tensor.  The JAX kernel sums in float32 on the TPU's matrix unit; the port
sums the same float32 products in float64 (exact products, one rounding at
the end), in the CUDA kernel and in the plain version alike.  The JAX
wrapper pads T to 128 and n to 8 for the TPU's layout; the port does not
pad.

On a CUDA tensor :func:`z_expectations_f32` launches the hand-written Hopper
kernel ``csrc/z_expectations_f32.cu`` once (its header gives the design and
the bound), on the grid of :func:`zexp_launch_plan`, and counts the launch
(``z_expectations_f32.launches``, :mod:`..kernels`); on a CPU tensor it runs
:func:`z_expectations_f32_plain`.  A CUDA tensor never takes the plain
version: the kernel launches or the wrapper raises.  ``interpret`` is
accepted for call-site compatibility and ignored (the tensors' device picks
the kernel or the plain version).

As in the JAX package, no solver route calls this kernel: the routes compute
their observables with ``dynamics/observables.py`` in float64.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import count
from .embed import local_op

#: most sites the CUDA kernel keeps in registers
KERNEL_MAX_SITES = 16
#: threads per block of the CUDA kernel, at most (csrc/z_expectations_f32.cu)
_THREADS = 128
#: most columns of a block's tile (csrc/z_expectations_f32.cu MAX_TILE_COLS)
_MAX_TILE_COLS = 128
#: column groups of a block where the columns take more than one tile
_WIDE_GROUPS = 32
#: blocks of the CUDA kernel resident on one SM (128 threads, <= 128
#: registers a thread, 48 KB of shared memory a block)
_BLOCKS_PER_SM = 4
#: plane bytes a block streams, at least, where the plan fills all of them
_FULL_BLOCK_BYTES = 64 << 10
#: plane bytes a row slice streams, at least, where there are few
_MIN_SLICE_BYTES = 16 << 10
#: most blocks of a cluster (16 is beyond the portable 8; Hopper allows it)
_MAX_CLUSTER = 16
#: streaming multiprocessors of an H100 SXM (the plan's default)
H100_SMS = 132


def z_sign_table(dims: tuple[int, ...]) -> np.ndarray:
    """signs[j, d] = <d| S_z^{(j)} |d> for every site j and basis index d
    (float64 numpy, (n_sites, dim))."""
    n = len(dims)
    dim = int(np.prod(dims))
    out = np.zeros((n, dim))
    for j, d in enumerate(dims):
        z = np.real(np.diag(local_op(d, "z")))
        left = int(np.prod(dims[:j], dtype=np.int64)) if j else 1
        right = int(np.prod(dims[j + 1 :], dtype=np.int64)) if j + 1 < n else 1
        out[j] = np.tile(np.repeat(z, right), left)
    return out


def _check(psi_re, psi_im, signs) -> None:
    if psi_re.dtype != psi_im.dtype or psi_re.dtype not in (torch.float32, torch.float64):
        raise TypeError("z_expectations_f32 takes two float32 or two float64 planes, got "
                        f"{psi_re.dtype}, {psi_im.dtype}")
    if psi_re.dim() != 2 or psi_re.shape != psi_im.shape:
        raise ValueError(f"z_expectations_f32 takes two (dim, T) planes, got "
                         f"{tuple(psi_re.shape)}, {tuple(psi_im.shape)}")
    if not signs.is_floating_point() or signs.dim() != 2 or signs.shape[1] != psi_re.shape[0]:
        raise ValueError(f"signs must be a float (n_sites, dim) table, got {signs.dtype} "
                         f"{tuple(signs.shape)} for dim {psi_re.shape[0]}")
    if psi_im.device != psi_re.device or signs.device != psi_re.device:
        raise ValueError("z_expectations_f32 operands must lie on one device")


def z_expectations_f32_plain(psi_re: torch.Tensor, psi_im: torch.Tensor,
                             signs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`z_expectations_f32`: the square sum
    in the planes' dtype, rounded to float32, and the float32 signs; their
    products (exact in float64) are summed in float64 and the sum rounded
    once to float32, as the CUDA kernel sums them, in another order.  A
    plain float32 matmul of the same operands is ~1e-5 of the largest output
    away from it at dim 16384 on random planes (a site's sum cancels two
    large halves), so it would be no reference for the kernel's."""
    _check(psi_re, psi_im, signs)
    p2 = (psi_re * psi_re + psi_im * psi_im).to(torch.float32)
    return (signs.to(torch.float32).double() @ p2.double()).to(torch.float32)


@dataclass(frozen=True)
class ZexpPlan:
    """Launch plan of one (n, dim, T) call of the CUDA kernel.

    A grid of ``col_tiles`` x ``row_slices`` blocks of ``groups`` x
    ``row_lanes`` threads, in clusters of ``cluster`` consecutive slices.  A
    thread owns ``cols`` adjacent columns of its block's tile of ``groups *
    cols`` columns; row slice s covers rows [s * slice_rows, (s + 1) *
    slice_rows) cut at dim (the last slices may be empty).  The blocks of a
    cluster add their partial sums in slice order; with more than one
    cluster per column tile (``partials``), each cluster writes its float64
    sums to a workspace and the last to finish adds them in order."""

    n: int
    dim: int
    T: int
    cols: int
    groups: int
    row_lanes: int
    col_tiles: int
    row_slices: int
    slice_rows: int
    cluster: int

    @property
    def threads(self) -> int:
        return self.groups * self.row_lanes

    @property
    def tile_cols(self) -> int:
        return self.groups * self.cols

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.row_slices

    @property
    def partials(self) -> int:
        """Partial sums per column tile that the workspace merges."""
        return self.row_slices // self.cluster

    @property
    def tile_stride(self) -> int:
        """float64 of one partial tile in the workspace: n sites x the
        tile's columns, rounded up to even (16-byte aligned tiles)."""
        return -(-self.n * self.tile_cols // 2) * 2

    @property
    def workspace_doubles(self) -> int:
        """float64 of the workspace: every cluster's partial tiles (0 where
        one cluster spans a tile's slices)."""
        return self.tile_stride * self.col_tiles * self.partials if self.partials > 1 else 0

    @property
    def counters(self) -> int:
        """int32 arrival counters, one per column tile (0 without a merge)."""
        return self.col_tiles if self.partials > 1 else 0


@functools.lru_cache(maxsize=256)
def zexp_launch_plan(n: int, dim: int, T: int, itemsize: int, align: int = 16,
                     sms: int = H100_SMS) -> ZexpPlan:
    """Grid of the CUDA kernel for n sites, (dim, T) planes of ``itemsize``
    bytes whose base addresses are multiples of ``align`` bytes.

    Two columns a thread (one 16-byte float64 or 8-byte float32 load per row)
    where T is even and the planes are aligned for it, else one.  Where T <=
    128, one tile spans every column and the block's remaining threads are
    row lanes, so a block reads whole rows, contiguous in the row-major
    planes; a wider T takes tiles of 32 column groups and 4 row lanes.  The
    rows are cut into slices: as many blocks as the card holds at once (four
    per SM) where each then streams at least 64 KB of the planes, else two
    per SM, at least, where the planes hold 16 KB a slice (fewer, larger
    blocks where the bytes are few: their time is latency).  In the second case consecutive slices go in clusters
    of up to 16 blocks, which add their sums through distributed shared
    memory before the workspace merge (in the first, clusters would cost
    occupancy).
    """
    if not (1 <= n <= KERNEL_MAX_SITES and dim >= 1 and T >= 1 and itemsize in (4, 8)):
        raise ValueError(f"no z kernel plan for n={n}, dim={dim}, T={T}, itemsize={itemsize}")
    cols = 2 if T % 2 == 0 and align % (2 * itemsize) == 0 else 1
    width = -(-T // cols)
    if T <= _MAX_TILE_COLS:
        groups, col_tiles = width, 1
    else:
        groups, col_tiles = _WIDE_GROUPS, -(-width // _WIDE_GROUPS)
    row_lanes = _THREADS // groups
    full = _BLOCKS_PER_SM * sms
    plane_bytes = 2 * dim * T * itemsize
    one_wave = plane_bytes >= full * _FULL_BLOCK_BYTES
    if one_wave:
        slices = max(1, full // col_tiles)
    else:
        slices = min(-(-2 * sms // col_tiles), plane_bytes // _MIN_SLICE_BYTES)
    slices = max(1, min(slices, -(-dim // row_lanes)))
    cluster = 1 if one_wave else 1 << (min(slices, _MAX_CLUSTER).bit_length() - 1)
    slices = -(-slices // cluster) * cluster
    slice_rows = -(-dim // slices)
    return ZexpPlan(n, dim, T, cols, groups, row_lanes, col_tiles, slices, slice_rows, cluster)


def _lib_fn():
    from ..kernels._build import load_library

    fn = load_library("z_expectations_f32").qst_z_expectations_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


#: workspace (float64) and arrival counters (int32) per (device, stream):
#: the counters are zeroed once, and the kernel's last-arriving blocks reset
#: each one to 0, so calls in stream order share them without a memset, and a
#: CUDA graph can capture a call (the buffers exist before the capture)
_buffers: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
_sms: dict[int, int] = {}


def _merge_buffers(device: torch.device, stream: int,
                   plan: ZexpPlan) -> tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    ws, counters = _buffers.get(key, (None, None))
    if ws is None or ws.numel() < plan.workspace_doubles or counters.numel() < plan.counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("z_expectations_f32: call once on this stream before a CUDA graph "
                               "captures it, so its workspace exists (none is allocated during "
                               "capture)")
        ws = torch.empty(max(plan.workspace_doubles, 1 << 16), dtype=torch.float64, device=device)
        counters = torch.zeros(max(plan.counters, 1024), dtype=torch.int32, device=device)
        _buffers[key] = ws, counters
    return ws, counters


def _alignment(t: torch.Tensor) -> int:
    ptr = t.data_ptr()
    return ptr & -ptr if ptr else 1 << 16


def _launch(psi_re: torch.Tensor, psi_im: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    dim, T = psi_re.shape
    n = signs.shape[0]
    if not 1 <= n <= KERNEL_MAX_SITES:
        raise ValueError(f"the CUDA z kernel takes 1..{KERNEL_MAX_SITES} sites, got {n}")
    if not (psi_re.is_contiguous() and psi_im.is_contiguous()):
        raise ValueError("z_expectations_f32 takes contiguous planes on cuda")
    if dim * T >= 2**62 or n * T >= 2**31 or T > 2**31 - 1024 or dim >= 2**31:
        raise ValueError(f"z_expectations_f32 shape out of range: ({n}, {dim}, {T})")
    if T == 0 or dim == 0:
        return torch.zeros((n, T), dtype=torch.float32, device=psi_re.device)
    out = torch.empty((n, T), dtype=torch.float32, device=psi_re.device)
    if signs.dtype not in (torch.float32, torch.float64):
        signs = signs.to(torch.float32)  # exact for the narrower float types
    signs = signs.contiguous()
    dev = psi_re.device
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    align = min(_alignment(psi_re), _alignment(psi_im))
    plan = zexp_launch_plan(n, dim, T, psi_re.element_size(), align, _sms[dev.index])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = counters = None
        if plan.partials > 1:
            ws, counters = _merge_buffers(dev, stream, plan)
        rc = _lib_fn()(psi_re.data_ptr(), psi_im.data_ptr(), signs.data_ptr(), out.data_ptr(),
                       None if ws is None else ws.data_ptr(),
                       0 if ws is None else ws.numel(),
                       None if counters is None else counters.data_ptr(),
                       0 if counters is None else counters.numel(),
                       n, dim, T, plan.cols, plan.groups, plan.row_lanes, plan.col_tiles,
                       plan.row_slices, plan.slice_rows, plan.cluster,
                       psi_re.element_size(), signs.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"z_expectations_f32 kernel launch failed with CUDA error {rc}")
    count("z_expectations_f32.launches", 1)
    return out


def z_expectations_f32(
    psi_re: torch.Tensor,  # (dim, T)
    psi_im: torch.Tensor,
    signs: torch.Tensor,  # (n_sites, dim): z eigenvalue of site j at basis index d
    interpret: bool | None = None,
) -> torch.Tensor:
    """All per-site <Sz>(t) traces, (n_sites, T) float32, fused as |psi|^2 ->
    one reduction of the float32 products, summed in float64 and rounded
    once.  ``interpret`` is an accepted no-op (module docstring)."""
    _check(psi_re, psi_im, signs)
    if psi_re.device.type == "cpu":
        return z_expectations_f32_plain(psi_re, psi_im, signs)
    if psi_re.device.type != "cuda":
        raise ValueError(f"z_expectations_f32 runs on cuda or cpu, not {psi_re.device}")
    return _launch(psi_re, psi_im, signs)
