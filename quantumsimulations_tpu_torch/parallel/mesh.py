"""Device-mesh helpers for sweep (DP) and statevector (SP) sharding.

Port of ``quantumsimulations_tpu/parallel/mesh.py``.  The 2D sweep grid
(f1A x detuning) maps to a data-parallel mesh axis 'dp' (each device
propagates a slice of the Hamiltonian batch) and large baths map their
Hilbert dimension to a state-parallel axis 'sp' (sharded statevector,
state_sharded.py).  A 2D ('dp', 'sp') mesh composes both.

The JAX package is single-controller: one process holds a ``Mesh`` and
``shard_map`` runs each device's block.  The port is SPMD, one process per
device: every rank calls the same entry point with the same arguments, the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dim names
("dp", "sp") over an initialised process group, and each rank returns the
whole result, as the JAX function returns it to its controller.  The
collectives map as

    lax.psum                 -> dist.all_reduce (SUM)
    lax.pmax                 -> dist.all_reduce (MAX)
    all_gather(tiled=True)   -> all_gather_single / all_gather_into_tensor
    ppermute (j <-> j^mask)  -> dist.batch_isend_irecv with the peer's
                                global rank from dist.get_global_rank
    axis_index               -> mesh.get_local_rank(axis)

(the helpers at the end of this module).  The backend is NCCL for a mesh on
``cuda`` and gloo on ``cpu``; a mesh whose device the group's backend cannot
serve is an error, never a silent switch.  Complex tensors travel as their
``torch.view_as_real`` float64 views.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import resolve_device

AXES = ("dp", "sp")
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _check_backend(device_type: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.distributed.initialize_multihost (or "
            "torch.distributed.init_process_group) on every rank first"
        )
    want = _BACKEND[device_type]
    have = str(dist.get_backend())
    # a multi-backend group reads "cpu:gloo,cuda:nccl"
    if have != want and f"{device_type}:{want}" not in have.split(","):
        raise RuntimeError(
            f"a mesh on {device_type!r} needs the {want!r} backend; the process group "
            f"runs {have!r}"
        )


def make_mesh(n_devices: int | None = None, sp: int = 1,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """('dp', 'sp') mesh over the first n_devices ranks of the process group.

    ``sp`` ranks shard the statevector axis; the rest form the batch axis.
    Every rank of the group must call it.  Ranks past ``n_devices`` are not
    in the mesh; the entry points refuse a mesh that does not hold the
    calling rank."""
    dev = resolve_device(device)
    _check_backend(dev.type)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    if n_devices % sp != 0:
        raise ValueError("n_devices must be divisible by sp")
    ranks = torch.arange(n_devices).reshape(n_devices // sp, sp)
    mesh = DeviceMesh(dev.type, ranks, mesh_dim_names=AXES)
    host_group(mesh)  # made here, where every rank of the group takes part
    return mesh


def pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


# ---------------------------------------------------------------------------
# Collectives on the mesh's groups
# ---------------------------------------------------------------------------


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def mesh_device(mesh: DeviceMesh, device: str | torch.device | None = None) -> torch.device:
    """The calling rank's device of the mesh (its current CUDA device on a
    ``cuda`` mesh).  Raises where the rank is not in the mesh, or where
    ``device`` (an entry point's own argument) is of another type than the
    mesh's: the mesh never overrides an explicit device."""
    if device is not None and resolve_device(device).type != mesh.device_type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the call asked for {device!r}")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_mesh_root(mesh: DeviceMesh) -> bool:
    """True on the mesh's first rank (coordinate (0, 0)), the one that
    writes artifacts."""
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def _as_real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all_reduce of a contiguous tensor (complex as its real view);
    returns ``x``."""
    dist.all_reduce(_as_real(x), op=op, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The tiled all_gather: every rank's ``x`` concatenated along ``dim``
    in the group's rank order (``lax.all_gather(..., axis=dim, tiled=True)``).
    The collective stacks along a new leading axis, which is moved to
    ``dim`` and merged with it."""
    n = dist.get_world_size(group)
    src = _as_real(x.contiguous()).unsqueeze(0)
    out = torch.empty((n,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out.view(-1), src.view(-1), group=group)
    if x.is_complex():
        out = torch.view_as_complex(out)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    return torch.movedim(out, 0, dim).reshape(shape)


def exchange(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``x`` to the group's rank ``peer`` and receive its block in
    return: one pairwise step of ``ppermute`` with pairs j <-> j ^ mask."""
    buf = torch.empty_like(x)
    g_peer = dist.get_global_rank(group, peer)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, _as_real(x.contiguous()), g_peer, group),
        dist.P2POp(dist.irecv, _as_real(buf), g_peer, group),
    ])
    for r in reqs:
        r.wait()
    return buf


#: how long the other ranks wait in :func:`broadcast_from_root` for the
#: root's host work of its own (a sweep's artifact tree and plots, written
#: while they wait for the next row's directory); that work is not bounded
#: by the collectives' timeout of parallel/distributed.py
HOST_WAIT_S = 3600.0

_HOST_GROUPS: dict = {}


def host_group(mesh: DeviceMesh):
    """A gloo group over the mesh's ranks with the timeout ``HOST_WAIT_S``,
    for host objects that may wait on the root's own work.  One per set of
    ranks and process group, made by :func:`make_mesh` (or on first use,
    where every rank of the process group must call this)."""
    ranks = tuple(int(r) for r in mesh.mesh.flatten().tolist())
    key = (dist.group.WORLD, ranks)
    if key not in _HOST_GROUPS:
        _HOST_GROUPS[key] = dist.new_group(
            list(ranks), timeout=datetime.timedelta(seconds=HOST_WAIT_S), backend="gloo")
    return _HOST_GROUPS[key]


def broadcast_from_root(obj, mesh: DeviceMesh):
    """``obj`` of the mesh's root rank on every rank of the mesh, sent over
    a host (gloo) group whose timeout allows for the root's own host work
    before it (``HOST_WAIT_S``)."""
    box = [obj]
    dist.broadcast_object_list(box, src=int(mesh.mesh.flatten()[0]), group=host_group(mesh))
    return box[0]
