"""Fused complex matmul on float32 (re, im) planes.

Port of ``quantumsimulations_tpu/ops/pallas_kernels.py::cmatmul_f32`` (the
Pallas kernel ``_cmatmul_kernel``).  On a CUDA tensor the wrapper launches the
hand-written Hopper kernel ``csrc/cmatmul_f32.cu`` (see its header for the
bound and design); on a CPU tensor it runs :func:`cmatmul_f32_plain`, the
plain PyTorch version of the same function.  A CUDA tensor never falls back
to the plain version: the kernel launches or the wrapper raises.

The planes stay separate (rather than one complex64 tensor) because that is
the kernel's contract: the four input planes are staged side by side in
shared memory and both output planes are accumulated in registers in one
pass.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import launch_counts

_INT_MAX = 2**31 - 1
_GRID_Z_MAX = 65535


def cmatmul_f32_plain(ar, ai, br, bi) -> tuple[torch.Tensor, torch.Tensor]:
    """(cr, ci) of (ar + i ai) @ (br + i bi) with four real matmuls."""
    cr = ar @ br - ai @ bi
    ci = ar @ bi + ai @ br
    return cr, ci


def _check(ar, ai, br, bi) -> None:
    planes = (ar, ai, br, bi)
    if any(not isinstance(x, torch.Tensor) for x in planes):
        raise TypeError("cmatmul_f32 takes four torch tensors")
    if any(x.dtype != torch.float32 for x in planes):
        raise TypeError(f"cmatmul_f32 takes float32 planes, got {[x.dtype for x in planes]}")
    if any(x.device != ar.device for x in planes):
        raise ValueError("cmatmul_f32 planes must lie on one device")
    if ar.shape != ai.shape or br.shape != bi.shape:
        raise ValueError(f"re/im plane shapes differ: {ar.shape}/{ai.shape}, {br.shape}/{bi.shape}")
    if ar.dim() not in (2, 3) or br.dim() != ar.dim():
        raise ValueError(f"cmatmul_f32 takes (M,K)@(K,N) or (B,M,K)@(B,K,N), got {ar.shape}@{br.shape}")
    if ar.shape[-1] != br.shape[-2]:
        raise ValueError(f"contraction mismatch: {ar.shape}@{br.shape}")
    if ar.dim() == 3 and ar.shape[0] != br.shape[0]:
        raise ValueError(f"batch mismatch: {ar.shape}@{br.shape}")
    if any(not x.is_contiguous() for x in planes):
        raise ValueError("cmatmul_f32 takes contiguous planes")


def _lib_fn():
    from ..kernels._build import load_library

    lib = load_library("cmatmul_f32")
    fn = lib.qst_cmatmul_f32
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 6
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _launch(ar, ai, br, bi) -> tuple[torch.Tensor, torch.Tensor]:
    batched = ar.dim() == 3
    if not batched:
        ar, ai, br, bi = (x.unsqueeze(0) for x in (ar, ai, br, bi))
    B, M, K = ar.shape
    N = br.shape[-1]
    if max(M, K, N) > _INT_MAX or B > _GRID_Z_MAX:
        raise ValueError(f"cmatmul_f32 shape out of range: B={B} M={M} K={K} N={N}")
    cr = torch.empty((B, M, N), dtype=torch.float32, device=ar.device)
    ci = torch.empty_like(cr)
    if B * M * N > 0:
        fn = _lib_fn()
        with torch.cuda.device(ar.device):
            stream = torch.cuda.current_stream(ar.device).cuda_stream
            rc = fn(
                ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(),
                cr.data_ptr(), ci.data_ptr(),
                B, M, K, N,
                M * K, K, K * N, N, M * N, N,
                stream,
            )
        if rc != 0:
            raise RuntimeError(f"cmatmul_f32 kernel launch failed with CUDA error {rc}")
        launch_counts["cmatmul_f32"] += 1
    if not batched:
        cr, ci = cr[0], ci[0]
    return cr, ci


def cmatmul_f32(ar, ai, br, bi) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused complex matmul on float32 planes: returns (cr, ci).

    Takes contiguous (M, K) @ (K, N) planes, or a batch (B, M, K) @ (B, K, N),
    all on one device.  CUDA tensors go through the hand-written kernel,
    CPU tensors through :func:`cmatmul_f32_plain`.
    """
    _check(ar, ai, br, bi)
    if ar.device.type == "cpu":
        return cmatmul_f32_plain(ar, ai, br, bi)
    if ar.device.type != "cuda":
        raise ValueError(f"cmatmul_f32 runs on cuda or cpu, not {ar.device}")
    return _launch(ar, ai, br, bi)
