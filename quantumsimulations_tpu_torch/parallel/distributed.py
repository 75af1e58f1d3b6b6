"""Multi-process initialisation and mesh construction.

Port of ``quantumsimulations_tpu/parallel/distributed.py``.  The JAX
package wires ``jax.distributed`` from its JAX_* variables; the port starts
a ``torch.distributed`` process group from torchrun's variables
(MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), one process per
device, and lays the ('dp', 'sp') mesh over all of its ranks:

    torchrun --nproc_per_node 4 -m quantumsimulations_tpu_torch.cli.sweep2d \\
        --mesh-devices 4 --device cpu ...

The backend is NCCL on ``cuda`` (each rank on ``cuda:LOCAL_RANK``) and gloo
on ``cpu``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import resolve_device
from .mesh import _BACKEND, make_mesh

#: the longest a collective may wait for a peer before it fails (a rank that
#: raised leaves its peers waiting in their next collective)
TIMEOUT_S = 120.0


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Start the process group from the arguments or torchrun's variables.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` / ``file://``
    init method).  Returns True when a process group is running (started
    here or before); False for a plain single-process run, where nothing is
    configured (missing configuration is not an error, as in the JAX
    package).  On ``cuda`` the rank's device becomes ``cuda:LOCAL_RANK``
    (LOCAL_RANK, else the process id modulo the devices)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if not coordinator_address or num_processes is None or process_id is None:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    method = coordinator_address
    if "://" not in method:
        method = f"tcp://{method}"
    dist.init_process_group(
        backend=_BACKEND[dev.type], init_method=method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return True


def global_mesh(sp: int = 1, device: str | torch.device = "cuda") -> DeviceMesh:
    """('dp', 'sp') mesh over ALL ranks of the process group; ``sp``
    consecutive ranks form the sharded-state axis, the rest the batch axis."""
    n = dist.get_world_size()
    if n % sp != 0:
        raise ValueError(f"{n} devices not divisible by sp={sp}")
    return make_mesh(n, sp=sp, device=device)
