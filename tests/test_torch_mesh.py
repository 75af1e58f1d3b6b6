"""The port's mesh and process-group helpers (parallel/mesh.py,
parallel/distributed.py) against the JAX package's.

The multi-rank half runs once on 2 gloo ranks (tests/_torch_mp.py, case
"mesh"), started from torchrun's variables (WORLD_SIZE, RANK) through
``initialize_multihost``; its mesh shapes, dim names and refusals are held
against the JAX package's ``make_mesh`` / ``global_mesh`` on the virtual CPU
mesh of the same shape, and its tiled ``all_gather`` along axis 1 against
``lax.all_gather(..., axis=1, tiled=True)`` under ``shard_map``, equal bit
for bit.
"""

import json

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from quantumsimulations_tpu.parallel import distributed as jdist
from quantumsimulations_tpu.parallel import mesh as jmesh
from quantumsimulations_tpu_torch.parallel import mesh as pmesh
from quantumsimulations_tpu_torch.parallel.distributed import initialize_multihost

from _torch_mp import rank_run_fixture
from _torch_mp_worker import gather_block

ranks = pytest.fixture(scope="module")(rank_run_fixture(2, "mesh", timeout=180))


def _every(ranks) -> list[dict]:
    return json.loads(str(ranks.result()["ranks"]))


def test_initialize_multihost_returns_false_without_configuration(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for key in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    assert jdist.initialize_multihost() is False
    assert initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 1000, 1024, 1025])
def test_pow2_floor(n):
    assert pmesh.pow2_floor(n) == jmesh.pow2_floor(n)


@pytest.mark.parametrize(
    "name,want",
    [("make_2_sp2", lambda: jmesh.make_mesh(2, sp=2)),
     ("make_2_sp1", lambda: jmesh.make_mesh(2, sp=1)),
     ("make_all", lambda: jmesh.make_mesh(2)),
     ("global_sp2", lambda: jmesh.make_mesh(2, sp=2)),
     ("global_sp1", lambda: jmesh.make_mesh(2, sp=1))],
)
def test_mesh_shape_and_dim_names(ranks, name, want):
    """Over 2 ranks the port's meshes have the JAX meshes' shape and names
    over 2 devices; rank 0 is every mesh's root."""
    jm = want()
    for r, e in enumerate(_every(ranks)):
        got = e["info"][name]
        assert got["names"] == list(jm.axis_names) == ["dp", "sp"]
        assert got["shape"] == [jm.shape["dp"], jm.shape["sp"]]
        assert got["ranks"] == np.arange(2).reshape(got["shape"]).tolist()
        assert got["root"] == (r == 0)


@pytest.mark.parametrize(
    "name,jax_call,pattern",
    [("make_3", lambda: jmesh.make_mesh(9), "ValueError: requested 3 devices, have 2"),
     ("make_2_sp3", lambda: jmesh.make_mesh(2, sp=3),
      "ValueError: n_devices must be divisible by sp"),
     ("global_sp3", lambda: jdist.global_mesh(sp=3), "ValueError: 2 devices not divisible by sp=3")],
)
def test_mesh_refusals_match_the_reference(ranks, name, jax_call, pattern):
    with pytest.raises(ValueError):
        jax_call()
    for e in _every(ranks):
        assert e["info"][name] == pattern


def test_cuda_mesh_without_cuda_raises(ranks):
    for e in _every(ranks):
        assert e["info"]["make_cuda"].startswith("RuntimeError: device 'cuda' requested")


def test_rank_outside_the_mesh_is_refused(ranks):
    info = [e["info"]["sub_device"] for e in _every(ranks)]
    assert info == ["cpu", "ValueError: rank 1 is not in the mesh [[0]]"]


def test_tiled_gather_along_axis_1_matches_lax_all_gather(ranks):
    blocks = [gather_block(r) for r in range(2)]
    mesh = jmesh.make_mesh(2, sp=2)
    gather = jax.jit(jax.shard_map(
        lambda x: jax.lax.all_gather(x, "sp", axis=1, tiled=True),
        mesh=mesh, in_specs=P(None, "sp"), out_specs=P(), check_vma=False,
    ))
    want = np.asarray(gather(np.concatenate(blocks, axis=1)))
    got = ranks.result()["gathered"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.concatenate(blocks, axis=1))


def test_pair_exchange_max_and_broadcast(ranks):
    for e in _every(ranks):
        assert e["swapped_ok"] is True
        assert e["max"] == 2.0
        assert e["broadcast"] == {"from": 0}
