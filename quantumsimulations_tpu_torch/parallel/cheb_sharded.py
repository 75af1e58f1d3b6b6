"""Multi-device beyond-dense Chebyshev stepping: the DR-sharded limb-domain apply.

Port of ``quantumsimulations_tpu/parallel/cheb_sharded.py``: the sharded
form of ``dynamics/cheb_step.py`` with ``arithmetic="ext"``.  The
statevector plane (DL, DR) is column-sharded over the mesh axis, every rank
advances its DR/P slice through the limb-domain recurrence (the splits,
carries and evaluations are elementwise, hence local), and the two buckets
that contract over the global DR axis exchange ONE exact int32
``all_reduce`` of canonical limb stacks per apply
(ops/split_apply_ext.py::make_ext_apply_sharded): value-identical to the
single-device engine, with no float64 rounding on the wire.

Each dispatch gathers the rank's stacked pre-advance states over the axis
(``all_gather``, float64) and every rank assembles the rows from the whole
states, as the JAX package assembles them from its global arrays.  The
step after the last output row, whose result the JAX package discards, is
not taken.

Replaces qt.sesolve (reference: dipolar_ensemble_with_rare.py:653-666) at
bath sizes beyond one device's patience.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..dynamics.cheb_step import (
    _lambda_bound,
    _make_step_run_ext,
    _rows_of_stack,
    _step_coefficients,
)
from ..dynamics.chebyshev import chebyshev_coefficients
from ..ops.embed import OperatorSum
from ..ops.split_apply_ext import make_ext_apply_sharded
from .mesh import all_gather_cat, all_reduce, axis_size, mesh_device


def chebyshev_step_traces_sharded(
    H: OperatorSum,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    n_sea_effective: int,
    idx_rare: int,
    mesh: DeviceMesh,
    axis: str = "sp",
    split: int | None = None,
    norm_bound: float | None = None,
    steps_per_dispatch: int | None = None,
) -> np.ndarray:
    """Assembled rows (8, T), TRACE_ROWS layout: the same contract and (to
    float64 roundoff) the same values as the single-device
    ``chebyshev_step_traces(..., arithmetic="ext")``.  ``steps_per_dispatch``
    (default QST_CHEB_STEPS_PER_DISPATCH, else 64, as in the JAX package)
    sets the output steps between state gathers."""
    times = np.asarray(times)
    T = len(times)
    if T > 1:
        dts = np.diff(times)
        if not np.allclose(dts, dts[0], rtol=1e-9, atol=0.0):
            raise ValueError("chebyshev stepper requires a uniform time grid")
        dt = float(dts[0])
    else:
        dt = 0.0
    dim = int(np.prod(dims))
    group, n_shards, dev = mesh.get_group(axis), axis_size(mesh, axis), mesh_device(mesh)

    lam = float(norm_bound) if norm_bound is not None else _lambda_bound(H, dim)
    C = chebyshev_coefficients(lam, np.asarray([dt]))[0] if dt > 0.0 else np.ones(1)
    K = max(2, len(C))
    c_re = np.zeros(K)
    c_im = np.zeros(K)
    c_re[: len(C)] = np.real(C)
    c_im[: len(C)] = np.imag(C)

    apply_local, so, ops = make_ext_apply_sharded(H, group, n_shards, split=split,
                                                  scale=1.0 / lam, device=dev)
    DL, DR = so.DL, so.DR
    DRl = DR // n_shards
    cols = slice(mesh.get_local_rank(axis) * DRl, (mesh.get_local_rank(axis) + 1) * DRl)
    psi0 = np.asarray(psi0)
    P = torch.as_tensor(
        np.stack([np.real(psi0), np.imag(psi0)]).reshape(2, DL, DR)[:, :, cols],
        dtype=torch.float64, device=dev,
    )

    # conserved <H> at t=0 for the energy row, from one sharded apply
    v = ops.val(apply_local.stacked(ops.split(P)))
    e0 = float(lam * all_reduce((P * v).sum(), group))

    sea_mask = torch.as_tensor((np.arange(len(dims)) < n_sea_effective).astype(np.float64),
                               device=dev)
    spd = steps_per_dispatch or int(os.environ.get("QST_CHEB_STEPS_PER_DISPATCH", "64"))
    spd = max(1, min(spd, T))
    run = _make_step_run_ext(apply_local.stacked, ops)
    cr, ci = _step_coefficients(c_re, c_im, dev)

    done = 0
    flats: list[np.ndarray] = []
    while done < T:
        n = min(spd, T - done)
        if done + n < T:
            P, states = run(P, n, cr, ci)
        else:  # the step after the last output row is not taken
            P, states = run(P, n - 1, cr, ci)
            states = torch.cat([states, P[None]])
        states = all_gather_cat(states, group, dim=-1)  # (n, 2, DL, DR)
        flats.append(_rows_of_stack(states, sea_mask, e0, dims, idx_rare).cpu().numpy())
        done += n
    rows = np.concatenate(flats).reshape(T, 8).T
    return np.ascontiguousarray(rows)
