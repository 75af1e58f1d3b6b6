"""Fused per-site z expectations: <Sz_j>(t) for every site of a block of
states at once, out[j, t] = sum_d signs[j, d] * |psi[d, t]|^2.

Port of ``quantumsimulations_tpu/ops/pallas_kernels.py::z_expectations_f32``
(the Pallas kernel ``_zexp_kernel``) and ``z_sign_table``.  The contract is
the JAX function's: |psi|^2 = re*re + im*im is formed in the planes' own
dtype (float32 or float64) and rounded to float32, the signs are taken as
float32, and the sum over d runs in float32 (no TF32; the CUDA kernel
compensates its float32 sums, so its result is the exact sum rounded to
float32 to within a rounding or two).  The result is an (n_sites, T)
float32 tensor.  The JAX wrapper pads T to 128 and n to 8 for
the TPU's layout; the port does not pad.

On a CUDA tensor :func:`z_expectations_f32` launches the hand-written Hopper
kernel ``csrc/z_expectations_f32.cu`` (its header gives the design and the
bound) and counts the launch in ``kernels.launch_counts``; on a CPU tensor it
runs :func:`z_expectations_f32_plain`.  A CUDA tensor never takes the plain
version: the kernel launches or the wrapper raises.  ``interpret`` is
accepted for call-site compatibility and ignored (the tensors' device picks
the kernel or the plain version).

As in the JAX package, no solver route calls this kernel: the routes compute
their observables with ``dynamics/observables.py`` in float64.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import launch_counts
from .embed import local_op

#: most sites the CUDA kernel keeps in registers
KERNEL_MAX_SITES = 16
#: blocks the CUDA kernel aims for (two per SM of an H100)
_TARGET_BLOCKS = 264
#: fewest rows per block when the rows are split over blocks
_MIN_ROWS_PER_BLOCK = 128
_COLS_PER_BLOCK = 32


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
    once to float32.  That is the value every float32 summation of the
    contract approximates; a plain float32 matmul of the same operands is
    itself ~1e-5 of the largest output away from it at dim 16384 on random
    planes (a site's sum cancels two large halves), so it would be no
    reference for the kernel's."""
    _check(psi_re, psi_im, signs)
    p2 = (psi_re * psi_re + psi_im * psi_im).to(torch.float32)
    return (signs.to(torch.float32).double() @ p2.double()).to(torch.float32)


def _row_blocks(dim: int, T: int) -> int:
    """Row slices per column tile: enough blocks to fill the card when T is
    small, at least _MIN_ROWS_PER_BLOCK rows each."""
    col_tiles = -(-T // _COLS_PER_BLOCK)
    return max(1, min(-(-_TARGET_BLOCKS // col_tiles), dim // _MIN_ROWS_PER_BLOCK))


def _lib_fn():
    from ..kernels._build import load_library

    fn = load_library("z_expectations_f32").qst_z_expectations_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(psi_re: torch.Tensor, psi_im: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    dim, T = psi_re.shape
    n = signs.shape[0]
    if not 1 <= n <= KERNEL_MAX_SITES:
        raise ValueError(f"the CUDA z kernel takes 1..{KERNEL_MAX_SITES} sites, got {n}")
    if not (psi_re.is_contiguous() and psi_im.is_contiguous()):
        raise ValueError("z_expectations_f32 takes contiguous planes on cuda")
    if dim * T >= 2**62 or n * T >= 2**31 or dim >= 2**31:
        raise ValueError(f"z_expectations_f32 shape out of range: ({n}, {dim}, {T})")
    out = torch.empty((n, T), dtype=torch.float32, device=psi_re.device)
    if T == 0:
        return out
    signs32 = signs.to(torch.float32).contiguous()
    rb = _row_blocks(dim, T)
    scratch = (torch.empty((rb, 2, n, T), dtype=torch.float32, device=psi_re.device)
               if rb > 1 else None)
    with torch.cuda.device(psi_re.device):
        stream = torch.cuda.current_stream(psi_re.device).cuda_stream
        rc = _lib_fn()(psi_re.data_ptr(), psi_im.data_ptr(), signs32.data_ptr(), out.data_ptr(),
                       scratch.data_ptr() if scratch is not None else None,
                       n, dim, T, rb, int(psi_re.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"z_expectations_f32 kernel launch failed with CUDA error {rc}")
    launch_counts["z_expectations_f32"] += 1
    return out


def z_expectations_f32(
    psi_re: torch.Tensor,  # (dim, T)
    psi_im: torch.Tensor,
    signs: torch.Tensor,  # (n_sites, dim): z eigenvalue of site j at basis index d
    interpret: bool | None = None,
) -> torch.Tensor:
    """All per-site <Sz>(t) traces, (n_sites, T) float32, fused as |psi|^2 ->
    one float32 reduction.  ``interpret`` is an accepted no-op (module
    docstring)."""
    _check(psi_re, psi_im, signs)
    if psi_re.device.type == "cpu":
        return z_expectations_f32_plain(psi_re, psi_im, signs)
    if psi_re.device.type != "cuda":
        raise ValueError(f"z_expectations_f32 runs on cuda or cpu, not {psi_re.device}")
    return _launch(psi_re, psi_im, signs)
