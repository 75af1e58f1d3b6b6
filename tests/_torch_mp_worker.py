"""One rank of a multi-rank CPU run of the port (NOT collected by pytest).

    python tests/_torch_mp_worker.py <case> <rank> <world> <rendezvous file> <out dir>

Started by ``tests/_torch_mp.py``.  The rank joins a gloo process group
through the port's ``initialize_multihost`` (a ``file://`` rendezvous), runs
the named case (every rank the same calls, as the port's SPMD entry points
require) and, on rank 0, writes the results to ``<out dir>/<case>.npz``.
Imports neither JAX nor the JAX package; the tests compare the results with
the JAX package's functions in their own process.  The inputs are the JAX
tests' own (tests/test_sharding.py:25-44), made here with numpy.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

CPU = "cpu"


def params_kwargs(n_sea=4, **kw) -> dict:
    """tests/test_sharding.py::_params as keyword arguments of
    DipolarRareParams (both packages')."""
    gamma_sea, gamma_rare = 8.1812e7, 6.976e7
    B0 = 3.0
    f1A = 50e3
    base = dict(
        n_sea=n_sea, gamma_sea=gamma_sea, gamma_rare=gamma_rare, B0_sea=B0, B0_rare=B0,
        B1_sea=2 * np.pi * f1A / gamma_sea, B1_rare=2 * np.pi * 70710.678 / gamma_rare,
        omega_rf_sea=gamma_sea * B0 - 2 * np.pi * 1000.0, omega_rf_rare=gamma_rare * B0,
        phi_sea=np.pi / 2, phi_rare=np.pi / 2, dipolar_scale=1e-7 * 1.054571817e-34,
        shell_scale=0.282393e-9, t_final=2.0e-4, steps=21, drive_sea=True, drive_rare=True,
        is_spin_three_half=False, is_center_rare=True,
    )
    base.update(kw)
    return base


def model_of(**kw):
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.models.params import DipolarRareParams

    return build_model(DipolarRareParams(**params_kwargs(**kw)))


def sp_meshes(world: int) -> dict:
    """{sp: mesh}: a ('dp', 'sp') = (1, 2) mesh over ranks 0-1 and a (1, 4)
    mesh over ranks 0-3 (every rank must build both; ranks 2-3 sit out the
    first)."""
    from quantumsimulations_tpu_torch.parallel.mesh import make_mesh

    return {sp: make_mesh(sp, sp=sp, device=CPU) for sp in (2, world)}


def in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def random_state(dim: int, seed: int, normalise: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    return psi / np.linalg.norm(psi) if normalise else psi


# ---------------------------------------------------------------------------
# cases (rank, world size, output directory): each returns the dict rank 0
# saves
# ---------------------------------------------------------------------------


def gather_block(rank: int, shape=(3, 4, 5)) -> np.ndarray:
    """Rank ``rank``'s block of the tiled-gather check: distinct values."""
    return (rank + 1) * 1000.0 + np.arange(np.prod(shape), dtype=np.float64).reshape(shape)


def case_mesh(rank: int, world: int, out_dir: str) -> dict:
    """Mesh shapes and dim names, the refusals, a mesh without this rank,
    and the collective helpers (tiled gather along axis 1, pair exchange,
    MAX all_reduce, broadcast from the root)."""
    import json

    from quantumsimulations_tpu_torch.parallel import mesh as pm
    from quantumsimulations_tpu_torch.parallel.distributed import global_mesh

    info = {}
    for name, fn in (("make_2_sp2", lambda: pm.make_mesh(2, sp=2, device=CPU)),
                     ("make_2_sp1", lambda: pm.make_mesh(2, sp=1, device=CPU)),
                     ("make_all", lambda: pm.make_mesh(device=CPU)),
                     ("global_sp2", lambda: global_mesh(sp=2, device=CPU)),
                     ("global_sp1", lambda: global_mesh(device=CPU))):
        m = fn()
        info[name] = {"shape": list(m.shape), "names": list(m.mesh_dim_names),
                      "ranks": m.mesh.tolist(), "root": pm.is_mesh_root(m)}
    for name, fn in (("make_3", lambda: pm.make_mesh(3, device=CPU)),
                     ("make_2_sp3", lambda: pm.make_mesh(2, sp=3, device=CPU)),
                     ("global_sp3", lambda: global_mesh(sp=3, device=CPU)),
                     ("make_cuda", lambda: pm.make_mesh(2, device="cuda"))):
        try:
            fn()
            info[name] = "no error"
        except (ValueError, RuntimeError) as e:
            info[name] = f"{type(e).__name__}: {e}"
    sub = pm.make_mesh(1, sp=1, device=CPU)
    try:
        info["sub_device"] = str(pm.mesh_device(sub))
    except ValueError as e:
        info["sub_device"] = f"ValueError: {e}"

    m = pm.make_mesh(2, sp=2, device=CPU)
    group = m.get_group("sp")
    me = m.get_local_rank("sp")
    x = torch.as_tensor(gather_block(me))
    gathered = pm.all_gather_cat(x, group, dim=1)
    swapped = pm.exchange(torch.as_tensor(gather_block(me) * (1 + 1j)), me ^ 1, group)
    top = pm.all_reduce(torch.tensor(float(me + 1)), group, dist.ReduceOp.MAX)
    sent = pm.broadcast_from_root({"from": dist.get_rank()}, m)
    every = [None] * world
    dist.all_gather_object(every, {"info": info, "swapped_ok": bool(torch.equal(
        swapped, torch.as_tensor(gather_block(me ^ 1) * (1 + 1j)))), "max": float(top),
        "broadcast": sent})
    return {"gathered": gathered.numpy(), "ranks": np.asarray(json.dumps(every))}


def case_state(rank: int, world: int, out_dir: str) -> dict:
    """Sharded apply at sp 2 and 4 (and the spin-3/2 rare site at sp 2),
    the sharded Krylov step at sp 4, the sharded Krylov trace at sp 2, 4."""
    from quantumsimulations_tpu_torch.dynamics.krylov import make_krylov_step, spectral_norm_bound
    from quantumsimulations_tpu_torch.parallel.mesh import all_gather_cat
    from quantumsimulations_tpu_torch.parallel.state_sharded import (
        krylov_traces_assembled_sharded,
        make_sharded_apply,
    )

    from quantumsimulations_tpu_torch.parallel import state_sharded

    exchanges = []
    real_exchange = state_sharded.exchange

    def counted(x, peer, group):  # a pair exchange with a rank of another process
        exchanges.append(dist.get_global_rank(group, peer))
        return real_exchange(x, peer, group)

    state_sharded.exchange = counted
    out = {}
    meshes = sp_meshes(world)
    cases = {"sp2": (2, {}, 11), "sp4": (4, {}, 11),
             "spin32_sp2": (2, dict(n_sea=3, is_spin_three_half=True), 5)}
    for name, (sp, kw, seed) in cases.items():
        if not in_mesh(meshes[sp]):
            continue
        model = model_of(**kw)
        psi = random_state(model.hamiltonian.dim, seed, normalise=not kw)
        apply_fn, _, rows, _ = make_sharded_apply(model.hamiltonian, meshes[sp])
        got = apply_fn(torch.as_tensor(psi[rows], device=CPU))
        out[f"apply_{name}"] = all_gather_cat(got, meshes[sp].get_group("sp")).numpy()

    # one sharded Krylov time step (Lanczos with all_reduce inner products)
    mesh = meshes[4]
    model = model_of()
    H = model.hamiltonian
    apply_fn, _, rows, _ = make_sharded_apply(H, mesh)
    step, _ = make_krylov_step(H, 2.0e-5, m=24, apply_h=apply_fn, norm_bound=spectral_norm_bound(H),
                               axis_name=mesh.get_group("sp"), device=CPU)
    local = step(torch.as_tensor(model.psi0[rows], device=CPU))
    out["krylov_step_sp4"] = all_gather_cat(local, mesh.get_group("sp")).numpy()

    kw = dict(n_sea=5, steps=12, t_final=12 * 1e-5)
    model = model_of(**kw)
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    for sp in (2, 4):
        if in_mesh(meshes[sp]):
            out[f"krylov_rows_sp{sp}"] = krylov_traces_assembled_sharded(
                model.hamiltonian, model.psi0, t, model.dims, model.n_sea_effective,
                model.idx_rare, meshes[sp])
    out["exchange_peers"] = np.asarray(sorted(set(exchanges)))
    return out


def ext_limbs_input(so, seed: int) -> np.ndarray:
    """Canonical ext limbs (L, 2, DL, DR) of a random normalised state,
    split on the host (the JAX package's grid split)."""
    from quantumsimulations_tpu_torch.ops.split_apply_ext import GRID_BITS, GRID_LIMBS, _split_host

    psi = random_state(so.DL * so.DR, seed)
    planes = np.stack([psi.real, psi.imag]).reshape(2, so.DL, so.DR)
    return _split_host(planes, GRID_BITS, GRID_LIMBS)


def case_cheb(rank: int, world: int, out_dir: str) -> dict:
    """make_ext_apply_sharded's digits and chebyshev_step_traces_sharded's
    rows at sp 2 and 4 (n_sea = 4, scale 1/lambda)."""
    from quantumsimulations_tpu_torch.dynamics.cheb_step import _lambda_bound
    from quantumsimulations_tpu_torch.parallel.cheb_sharded import chebyshev_step_traces_sharded
    from quantumsimulations_tpu_torch.parallel.mesh import all_gather_cat
    from quantumsimulations_tpu_torch.ops.split_apply import split_operator
    from quantumsimulations_tpu_torch.ops.split_apply_ext import make_ext_apply_sharded

    out = {}
    kw = dict(n_sea=4, t_final=2e-3, steps=24)
    model = model_of(**kw)
    H = model.hamiltonian
    lam = _lambda_bound(H, H.dim)
    T_in = ext_limbs_input(split_operator(H), seed=3)
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    for sp, mesh in sp_meshes(world).items():
        if not in_mesh(mesh):
            continue
        group = mesh.get_group("sp")
        apply, so, _ = make_ext_apply_sharded(H, group, sp, scale=1.0 / lam, device=CPU)
        DRl = so.DR // sp
        r = mesh.get_local_rank("sp")
        local = torch.as_tensor(T_in[..., r * DRl:(r + 1) * DRl].copy())
        out[f"digits_sp{sp}"] = all_gather_cat(apply.stacked(local), group, dim=-1).numpy()
        out[f"rows_sp{sp}"] = chebyshev_step_traces_sharded(
            H, model.psi0, t, model.dims, model.n_sea_effective, model.idx_rare, mesh=mesh,
            steps_per_dispatch=8)
    out["lam"] = np.asarray(lam)
    return out


def sweep_batch(batch: int):
    """tests/test_sharding.py's dp-sweep batch: the port's (w, V, psi0, t,
    dims, n_sea_effective, idx_rare), the detunings 500 Hz apart."""
    from quantumsimulations_tpu_torch.dynamics.eig_propagator import eigh_host

    models = [model_of(omega_rf_sea=8.1812e7 * 3.0 - 2 * np.pi * (500.0 * (i + 1)))
              for i in range(batch)]
    kw = params_kwargs()
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    ws, Vs = zip(*[eigh_host(m.hamiltonian.to_dense()) for m in models])
    return (np.stack(ws), np.stack(Vs), np.stack([m.psi0 for m in models]), t, models[0].dims,
            np.asarray([m.n_sea_effective for m in models]), models[0].idx_rare)


#: tests/test_sharding.py::test_grid2d_eig32_sharded's grid (its f_Az is
#: gamma_sea * B0 / 2 pi)
GRID = dict(f_Az=8.1812e7 * 3.0 / (2 * np.pi), f1A_values_Hz=[30e3, 50e3],
            gamma_sea=8.1812e7, gamma_rare=6.976e7, n_detunings=3, n_sea=4,
            t_final=2e-4, steps=40, coarse_window=4, solver_method="eig32", make_plots=False)


def case_sweep(rank: int, world: int, out_dir: str) -> dict:
    """The dp-sharded eig and eig32 rows at batches 4 and 6 on a (4, 1) mesh;
    then the sweep runner and the 2D grid with ``mesh=``, where every rank
    but the root has the runner's writers replaced by a recorder: a write
    there is counted (and must not happen)."""
    import datetime as real_dt
    import itertools
    import json
    import types

    from quantumsimulations_tpu_torch.parallel.mesh import make_mesh
    from quantumsimulations_tpu_torch.parallel.sweep_shard import (
        eig_traces_assembled_sharded,
        eig_traces_assembled_sharded32,
    )
    from quantumsimulations_tpu_torch.sweep import runner
    from quantumsimulations_tpu_torch.sweep.grid2d import run_grid2d

    out = {}
    mesh = make_mesh(world, sp=1, device=CPU)
    for batch in (4, 6):
        args = sweep_batch(batch)
        out[f"eig_b{batch}"] = eig_traces_assembled_sharded(*args, mesh)
        out[f"eig32_b{batch}"] = eig_traces_assembled_sharded32(*args, mesh)

    writes = []
    if rank != 0:
        def record(*a, **k):
            writes.append(a[:1])

        for name in ("json_dump", "save_geometry_npz", "save_params_and_freqs",
                     "save_trace_npz", "write_sweep_csv"):
            setattr(runner, name, record)
    # a clock that moves a second per reading, so grid rows never share a
    # directory (they are named to the second)
    ticks = itertools.count()

    class _Clock(real_dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return real_dt.datetime(2026, 1, 2, 3, 4, 5) + real_dt.timedelta(seconds=next(ticks))

    runner._dt = types.SimpleNamespace(datetime=_Clock)
    root = os.path.join(out_dir, "trees")
    sweep_dir = runner.run_sweep_sea_detuning(
        f_Az=GRID["f_Az"], f1A=50e3, target_sea_detuning=50e3, gamma_sea=GRID["gamma_sea"],
        gamma_rare=GRID["gamma_rare"], sea_detunings_Hz=[0.0, 50e3, 100e3, 150e3], n_sea=4,
        t_final=2e-4, steps=40, coarse_window=4, make_plots=False, out_root=root,
        solver_method="eig", mesh=mesh, device=CPU)
    grid_dirs = run_grid2d(**GRID, out_root=os.path.join(root, "grid"), mesh=mesh, device=CPU)
    every = [None] * world
    dist.all_gather_object(every, {"sweep": sweep_dir, "grid": grid_dirs, "writes": len(writes)})
    out["returned"] = np.asarray(json.dumps(every))
    return out


#: the process group's timeout in the "slow_root" case, and how long the
#: root's writer of each sweep's CSV sleeps there: longer than the timeout
SLOW_ROOT_TIMEOUT_S = 10.0
SLOW_ROOT_SLEEP_S = 14.0
#: the slow-root grid: two rows through the "ext" stepping solver
SLOW_GRID = dict(GRID, f1A_values_Hz=[30e3, 50e3], n_detunings=2, solver_method="ext")


def case_slow_root(rank: int, world: int, out_dir: str) -> dict:
    """A 2-row grid through the "ext" stepping solver on a (2, 1) mesh whose
    process group times out after SLOW_ROOT_TIMEOUT_S, while the root's
    writer of each row's CSV sleeps SLOW_ROOT_SLEEP_S: the other rank must
    never wait for the root's own work in a collective bounded by that
    timeout.  Every rank but the root has the runner's writers replaced by
    a recorder.  The results are gathered over the mesh's host group, where
    the other rank waits for the root's last row."""
    import json
    import time

    from quantumsimulations_tpu_torch.parallel.mesh import host_group, make_mesh
    from quantumsimulations_tpu_torch.sweep import runner
    from quantumsimulations_tpu_torch.sweep.grid2d import run_grid2d

    mesh = make_mesh(world, sp=1, device=CPU)
    writes = []
    if rank == 0:
        real_csv = runner.write_sweep_csv

        def slow_csv(*a, **k):
            time.sleep(SLOW_ROOT_SLEEP_S)
            return real_csv(*a, **k)

        runner.write_sweep_csv = slow_csv
    else:
        def record(*a, **k):
            writes.append(a[:1])

        for name in ("json_dump", "save_geometry_npz", "save_params_and_freqs",
                     "save_trace_npz", "write_sweep_csv"):
            setattr(runner, name, record)
    t0 = time.perf_counter()
    dirs = run_grid2d(**SLOW_GRID, out_root=os.path.join(out_dir, "slow"), mesh=mesh, device=CPU)
    wall = time.perf_counter() - t0
    every = [None] * world
    dist.all_gather_object(every, {"grid": dirs, "writes": len(writes), "wall": wall},
                           group=host_group(mesh))
    return {"returned": np.asarray(json.dumps(every))}


#: tests/test_expm_sharded.py's workloads: (model kwargs, block, panel)
EXPM_CASES = {
    "n5": (dict(n_sea=5, t_final=2.0e-4, steps=48), 32, 16),
    "spin32": (dict(n_sea=4, t_final=1.0e-3, steps=40, is_spin_three_half=True), 16, 16),
}


#: the ext tier's sharded limb products: dim, column panel, replicated block
EXT_PRODUCT = dict(dim=64, panel=16, block=4)


def ext_product_inputs(seed: int = 7) -> dict:
    """Canonical ext limbs (L, rows, cols) of two random complex 64 x 64
    operators A, B (entries below 0.1, so every product stays on the grid)
    and of a replicated (64, 4) block S."""
    from quantumsimulations_tpu_torch.ops.extprec import ext_split_host

    rng = np.random.default_rng(seed)
    dim, block = EXT_PRODUCT["dim"], EXT_PRODUCT["block"]
    out = {}
    for name, shape in (("a", (dim, dim)), ("b", (dim, dim)), ("s", (dim, block))):
        for part in ("re", "im"):
            out[f"{name}_{part}"] = ext_split_host(0.1 * rng.uniform(-1.0, 1.0, shape))
    return out


def case_expm(rank: int, world: int, out_dir: str) -> dict:
    """expm_traces_sharded (Ozaki) and expm_traces_sharded_ext at sp 2 and 4
    on the n5 workload, at sp 4 on the spin-3/2 one; with each result, the
    largest difference between the ranks' rows (all ranks return them).
    The ext tier's two sharded limb products (A @ B by column panels, and
    A applied to a replicated block) at sp 2 and 4, gathered.  Rank 0 also
    runs the single-device ext route on each workload (one thread, where
    the test process would share its cores with the suite)."""
    from quantumsimulations_tpu_torch.dynamics.expm_propagator import expm_traces_assembled_ext
    from quantumsimulations_tpu_torch.ops.extprec import ext_left
    from quantumsimulations_tpu_torch.parallel.expm_sharded import (
        _ext_sharded_apply,
        _ext_sharded_cmatmul,
        expm_traces_sharded,
        expm_traces_sharded_ext,
    )
    from quantumsimulations_tpu_torch.parallel.mesh import all_gather_cat

    out = {}
    meshes = sp_meshes(world)
    x = {k: torch.as_tensor(v) for k, v in ext_product_inputs().items()}
    for sp, mesh in meshes.items():
        if not in_mesh(mesh):
            continue
        group = mesh.get_group("sp")
        n = EXT_PRODUCT["dim"] // sp
        mine = slice(mesh.get_local_rank("sp") * n, (mesh.get_local_rank("sp") + 1) * n)
        left = ext_left(x["a_re"][:, mine].contiguous(), x["a_im"][:, mine].contiguous())
        c = _ext_sharded_cmatmul(left, x["b_re"][:, mine].contiguous(),
                                 x["b_im"][:, mine].contiguous(), group, EXT_PRODUCT["panel"],
                                 EXT_PRODUCT["dim"])
        out[f"ext_product_sp{sp}"] = torch.stack(
            [all_gather_cat(part, group, dim=1) for part in c]).numpy()
        out[f"ext_apply_sp{sp}"] = torch.stack(
            _ext_sharded_apply(left, x["s_re"], x["s_im"], group)).numpy()
    for name, (kw, block, panel) in EXPM_CASES.items():
        model = model_of(**kw)
        t = np.linspace(0.0, kw["t_final"], kw["steps"])
        if rank == 0:
            out[f"single_ext_{name}"] = expm_traces_assembled_ext(
                model.hamiltonian, model.psi0, t, model.dims, model.n_sea_effective,
                model.idx_rare, block=block, panel=panel, device=CPU)
        for sp in ((2, 4) if name == "n5" else (4,)):
            if not in_mesh(meshes[sp]):
                continue
            for tier, fn in (("ozaki", expm_traces_sharded), ("ext", expm_traces_sharded_ext)):
                rows = fn(model.hamiltonian, model.psi0, t, model.dims, model.n_sea_effective,
                          model.idx_rare, mesh=meshes[sp], block=block, panel=panel)
                every = all_gather_cat(torch.as_tensor(rows)[None],
                                       meshes[sp].get_group("sp")).numpy()
                out[f"{tier}_{name}_sp{sp}"] = rows
                out[f"{tier}_{name}_sp{sp}_rank_spread"] = np.asarray(
                    np.abs(every - rows[None]).max())
    return out


CASES = {"mesh": case_mesh, "state": case_state, "cheb": case_cheb, "expm": case_expm,
         "sweep": case_sweep, "slow_root": case_slow_root}


def main() -> None:
    case, rank, world, rdv, out_dir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                       sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    from quantumsimulations_tpu_torch.parallel import distributed
    from quantumsimulations_tpu_torch.parallel.distributed import initialize_multihost

    if case == "slow_root":
        distributed.TIMEOUT_S = SLOW_ROOT_TIMEOUT_S

    if case == "mesh":  # the process count and id from torchrun's variables
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
        started = initialize_multihost(f"file://{rdv}", device=CPU)
    else:
        started = initialize_multihost(f"file://{rdv}", world, rank, device=CPU)
    if not started:
        raise SystemExit("initialize_multihost returned False")
    try:
        out = CASES[case](rank, world, out_dir)
        dist.barrier()
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{case}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
