"""The dp-sharded sweep of the port (parallel/sweep_shard.py, the runner's
and the 2D grid's ``mesh=``) on 4 gloo ranks against the JAX package on its
virtual CPU mesh of the same shape, ('dp', 'sp') = (4, 1).

The ranks run once (tests/_torch_mp.py, case "sweep"); the sizes and bars
are tests/test_sharding.py's: the f64 rows within 1e-12 of the JAX sharded
rows and of the port's unsharded rows (:167), the f32 rows within 1e-6 of
the port's unsharded f32 rows (:237, the same float32 arithmetic) and
within 2e-4, the f32 mode's bar, of the JAX sharded f32 rows (Pallas in
interpret mode, float32 sums in another order); the energy row within
1e-13 relative of the JAX package's (tests/test_torch_dynamics.py's bar).
Batch 6 pads to 8.  The
sharded runner must write one tree, from rank 0 only (the other ranks'
writers are replaced by recorders), whose traces equal the unsharded
runner's within 1e-12; the sharded 2D grid writes two row directories whose
traces agree with the JAX package's sharded grid within 2e-4.  On 2 ranks
whose process group times out after 10 s, a 2-row grid through the "ext"
stepping solver, with the root's writer of each row sleeping 14 s, must
finish on both ranks and write the unsharded grid's traces (1e-12).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from quantumsimulations_tpu.dynamics import eig_propagator as jeig
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.parallel import mesh as jmesh
from quantumsimulations_tpu.parallel import sweep_shard as jshard
from quantumsimulations_tpu_torch.dynamics import eig_propagator as teig
from quantumsimulations_tpu_torch.sweep import runner as trunner
from quantumsimulations_tpu_torch.sweep.grid2d import run_grid2d

from _torch_mp import rank_run_fixture
from _torch_mp_worker import (
    GRID,
    SLOW_GRID,
    SLOW_ROOT_SLEEP_S,
    SLOW_ROOT_TIMEOUT_S,
    params_kwargs,
    sweep_batch,
)

from _torch_parity import no_jax_compile_cache  # noqa: F401  (autouse)
from _torch_parity import one_second_per_sweep

ranks = pytest.fixture(scope="module")(rank_run_fixture(4, "sweep", timeout=240))
slow_root_ranks = pytest.fixture(scope="module")(rank_run_fixture(2, "slow_root", timeout=240))


def _jax_batch(batch: int):
    models = [jbuild(JParams(**params_kwargs(omega_rf_sea=8.1812e7 * 3.0 - 2 * np.pi * (500.0 * (i + 1)))))
              for i in range(batch)]
    kw = params_kwargs()
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    ws, Vs = zip(*[jeig.eigh_host(m.hamiltonian.to_dense()) for m in models])
    return (np.stack(ws), np.stack(Vs), np.stack([m.psi0 for m in models]), t, models[0].dims,
            np.asarray([m.n_sea_effective for m in models]), models[0].idx_rare)


@pytest.mark.parametrize("batch", [4, 6])
@pytest.mark.parametrize("mode", ["eig", "eig32"])
def test_dp_sharded_rows_match(ranks, mode, batch):
    mesh = jmesh.make_mesh(4, sp=1)
    jargs = _jax_batch(batch)
    if mode == "eig":
        want_jax = jshard.eig_traces_assembled_sharded(*jargs, mesh)
        plain = teig.eig_traces_assembled_batched(*sweep_batch(batch), device="cpu")
    else:
        want_jax = jshard.eig_traces_assembled_sharded32(*jargs, mesh)
        plain = teig.eig_traces_assembled_batched32(*sweep_batch(batch), device="cpu")
    got = ranks.result()[f"{mode}_b{batch}"]
    assert got.shape == plain.shape == want_jax.shape == (batch, 8, 21)
    if mode == "eig":
        assert np.abs(got[:, :7] - want_jax[:, :7]).max() <= 1e-12
        # the energy row (~2.5e4 rad/s) is summed in another order than the
        # JAX package's: 1e-13 relative, the port's parity bar for it
        assert np.abs(got[:, 7] - want_jax[:, 7]).max() <= 1e-13 * np.abs(want_jax[:, 7]).max()
        assert np.abs(got - plain).max() <= 1e-12
        assert np.abs(got[:, 6] - 1.0).max() <= 1e-11
    else:
        assert np.abs(got - plain).max() <= 1e-6
        assert np.abs(got[:, :7] - want_jax[:, :7]).max() <= 2e-4


def _returned(ranks) -> list[dict]:
    return json.loads(str(ranks.result()["returned"]))


def _trees_equal(a: str, b: str, atol: float) -> int:
    """Every time_and_obs npz of sweep tree ``a`` within ``atol`` of ``b``'s;
    returns the number of detuning directories."""
    labels = sorted(d for d in os.listdir(b) if d.startswith("delta_"))
    assert labels == sorted(d for d in os.listdir(a) if d.startswith("delta_"))
    for label in labels:
        for tag in ("center_off", "center_on", "shell_off"):
            name = f"time_and_obs_{tag}.npz"
            with np.load(os.path.join(a, label, name)) as za, \
                    np.load(os.path.join(b, label, name)) as zb:
                assert set(za.files) == set(zb.files)
                for key in zb.files:
                    assert np.abs(za[key] - zb[key]).max() <= atol, (label, tag, key)
    return len(labels)


def test_sharded_runner_writes_one_tree_from_rank_0(ranks, tmp_path):
    every = _returned(ranks)
    assert len({e["sweep"] for e in every}) == 1
    assert [e["writes"] for e in every] == [0, 0, 0, 0]
    sharded = every[0]["sweep"]
    for name in ("geometry_and_couplings.npz", "global_params.json", "summary.json",
                 "sweep_results.csv", "timings.json"):
        assert os.path.isfile(os.path.join(sharded, name)), name
    with contextlib.redirect_stdout(io.StringIO()):
        plain = trunner.run_sweep_sea_detuning(
            f_Az=GRID["f_Az"], f1A=50e3, target_sea_detuning=50e3, gamma_sea=GRID["gamma_sea"],
            gamma_rare=GRID["gamma_rare"], sea_detunings_Hz=[0.0, 50e3, 100e3, 150e3], n_sea=4,
            t_final=2e-4, steps=40, coarse_window=4, make_plots=False,
            base_dir=str(tmp_path / "plain"), solver_method="eig", device="cpu")
    assert _trees_equal(sharded, plain, 1e-12) == 4
    with open(os.path.join(sharded, "summary.json")) as f, \
            open(os.path.join(plain, "summary.json")) as g:
        assert json.load(f)["sweep_results"] == json.load(g)["sweep_results"]


def test_sharded_grid2d_writes_two_row_directories(ranks, tmp_path):
    from quantumsimulations_tpu.sweep.grid2d import run_grid2d as jgrid

    every = _returned(ranks)
    dirs = every[0]["grid"]
    assert all(e["grid"] == dirs for e in every)
    assert len(set(dirs)) == 2
    with contextlib.redirect_stdout(io.StringIO()), one_second_per_sweep():
        want = jgrid(**GRID, out_root=str(tmp_path / "jax"), mesh=jmesh.make_mesh(4, sp=1))
    assert len(set(want)) == 2
    for got, ref in zip(dirs, want):
        with open(os.path.join(got, "summary.json")) as f:
            s = json.load(f)
        assert len(s["sweep_results"]) == 3
        for row in s["sweep_results"]:
            assert np.isfinite(row["delta_Hz"])
        assert _trees_equal(got, ref, 2e-4) == 3


def test_slow_root_never_times_out_the_other_ranks(slow_root_ranks, tmp_path):
    every = json.loads(str(slow_root_ranks.result()["returned"]))
    assert SLOW_ROOT_SLEEP_S > SLOW_ROOT_TIMEOUT_S
    dirs = every[0]["grid"]
    assert len(set(dirs)) == 2 and all(e["grid"] == dirs for e in every)
    assert [e["writes"] for e in every] == [0, 0]
    # the root really worked alone for longer than the group's timeout
    assert every[0]["wall"] >= 2 * SLOW_ROOT_SLEEP_S
    with contextlib.redirect_stdout(io.StringIO()), one_second_per_sweep():
        plain = run_grid2d(**SLOW_GRID, out_root=str(tmp_path / "plain"), device="cpu")
    for got, ref in zip(dirs, plain):
        assert os.path.isfile(os.path.join(got, "sweep_results.csv"))
        assert _trees_equal(got, ref, 1e-12) == 2
