"""Data-parallel sweep sharding: the Hamiltonian batch over the 'dp' axis.

Port of ``quantumsimulations_tpu/parallel/sweep_shard.py``.  The detuning
grid is embarrassingly parallel (the reference serialises it in Python at
sweep_sea_detuning.py:611): the batch is padded to a multiple of the 'dp'
size, each rank solves its contiguous share of whole simulations through the
port's batched eig propagator (the f32 mode through the hand-written
``cmatmul_f32`` kernel on the card), and the (B, 8, T) rows are gathered over
'dp' on the device, so that every rank returns all of them.  Ranks that
differ only in 'sp' solve the same share (the JAX package replicates the
batch over 'sp' the same way).

The chunk sizes are the JAX package's: ``default_time_chunk`` for the
local share (``batch = Bp // dp``), twice it in the f32 mode.  At dp = 1
these are the unsharded defaults, so the rows equal the unsharded rows bit
for bit.
"""

from __future__ import annotations

import numpy as np
from torch.distributed.device_mesh import DeviceMesh

from ..dynamics.eig_propagator import _eig32_rows, _eig_rows, default_time_chunk
from .mesh import all_gather_cat, axis_size, mesh_device


def pad_batch(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading axis up to a multiple (replicating the last element)."""
    B = x.shape[0]
    rem = (-B) % multiple
    if rem == 0:
        return x, B
    pad = np.repeat(x[-1:], rem, axis=0)
    return np.concatenate([x, pad], axis=0), B


def _sharded(rows_fn, f32: bool, w, V, psi0, times, dims, n_sea_effective, idx_rare,
             mesh: DeviceMesh, t_chunk) -> np.ndarray:
    dp = axis_size(mesh, "dp")
    w_p, B = pad_batch(np.asarray(w), dp)
    V_p, _ = pad_batch(np.asarray(V), dp)
    psi_p, _ = pad_batch(np.asarray(psi0), dp)
    nse_p, _ = pad_batch(np.asarray(n_sea_effective), dp)
    Bp, dim = w_p.shape
    local = Bp // dp
    if t_chunk is None:
        t_chunk = default_time_chunk(dim, len(times), batch=max(1, local)) * (2 if f32 else 1)
    share = slice(mesh.get_local_rank("dp") * local, (mesh.get_local_rank("dp") + 1) * local)
    rows = rows_fn(w_p[share], V_p[share], psi_p[share], times, dims, nse_p[share], idx_rare,
                   t_chunk, mesh_device(mesh))
    return all_gather_cat(rows, mesh.get_group("dp")).cpu().numpy()[:B]


def eig_traces_assembled_sharded(
    w: np.ndarray,  # (B, dim)
    V: np.ndarray,  # (B, dim, dim) complex
    psi0: np.ndarray,  # (B, dim) complex
    times: np.ndarray,
    dims: tuple[int, ...],
    n_sea_effective: np.ndarray,
    idx_rare: int,
    mesh: DeviceMesh,
    t_chunk: int | None = None,
) -> np.ndarray:
    """dp-sharded assembled traces (B, 8, T); batch padded to the dp size."""
    return _sharded(_eig_rows, False, w, V, psi0, times, dims, n_sea_effective, idx_rare,
                    mesh, t_chunk)


def eig_traces_assembled_sharded32(
    w: np.ndarray,  # (B, dim)
    V: np.ndarray,  # (B, dim, dim) complex
    psi0: np.ndarray,  # (B, dim) complex
    times: np.ndarray,
    dims: tuple[int, ...],
    n_sea_effective: np.ndarray,
    idx_rare: int,
    mesh: DeviceMesh,
    t_chunk: int | None = None,
    interpret: bool | None = None,
) -> np.ndarray:
    """dp-sharded f32 speed mode: each rank runs the f32 trace path, whose
    product is the ``cmatmul_f32`` kernel on the card, on its local share of
    whole simulations.  ``interpret`` is accepted and ignored (the device
    picks the kernel or its plain version)."""
    return _sharded(_eig32_rows, True, w, V, psi0, times, dims, n_sea_effective, idx_rare,
                    mesh, t_chunk)
