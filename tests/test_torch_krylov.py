"""Port vs reference: the Lanczos stepper of ``dynamics/krylov.py`` (CPU).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances and why:
  * the power-iteration norm estimate: 1e-12 relative — the same seeded
    start vector and 40 iterations, the apply summed in another order;
    the substep count taken from it must be equal;
  * the small tridiagonal exponential: 1e-13 absolute — the same matmuls in
    the same order (BLAS blocking may differ);
  * observable traces: 1e-10 absolute and the norm within 1e-12 of 1 (the
    JAX package's own bars, tests/test_steppers.py:66-68); the energy row
    1e-12 relative (its magnitude is ~1e5 rad/s);
  * whole vs segmented substep dispatch: 1e-13 (tests/test_steppers.py:210;
    here both run the same substeps in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from _torch_parity import no_jax_compile_cache, stepper_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import krylov as jk
from quantumsimulations_tpu.dynamics.evolve import simulate_rare as jsim
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops import embed as jembed
from quantumsimulations_tpu.ops.cplx import Cplx
from quantumsimulations_tpu_torch.dynamics import krylov as tk
from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare as tsim
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.ops import embed as tembed

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    kw = stepper_kwargs()
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    return jbuild(JParams(**kw)), tbuild(TParams(**kw)), t


def _args(m, t):
    return (m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective, m.idx_rare)


@pytest.mark.parametrize("n_sea", [3, 5])
def test_norm_estimate_and_substep_count_match(n_sea):
    kw = stepper_kwargs(n_sea=n_sea)
    jm, tm = jbuild(JParams(**kw)), tbuild(TParams(**kw))
    est_j = jk.spectral_norm_estimate(jm.hamiltonian)
    est_t = tk.spectral_norm_estimate(tm.hamiltonian, device=CPU)
    assert abs(est_t - est_j) <= 1e-12 * est_j
    assert tk.spectral_norm_bound(tm.hamiltonian) == jk.spectral_norm_bound(jm.hamiltonian)
    for dt in (1e-5, 30.0 / 19_999):  # this grid's and the production spacing
        nb = min(tk.spectral_norm_bound(tm.hamiltonian), est_t)
        _, n_t = tk.make_krylov_step(tm.hamiltonian, dt, norm_bound=nb, device=CPU)
        nb = min(jk.spectral_norm_bound(jm.hamiltonian), est_j)
        _, n_j = jk.make_krylov_step(jm.hamiltonian, dt, norm_bound=nb)
        assert n_t == n_j


@pytest.mark.parametrize("m,dt,n_sq", [(48, 3e-6, 7), (12, -2e-5, 5), (5, 5e-7, 0)])
def test_tridiag_expm_matches_reference(m, dt, n_sq):
    rng = np.random.default_rng(m)
    alphas = rng.uniform(-4e5, 4e5, m)
    betas = np.abs(rng.normal(0.0, 2e5, m))
    yr_j, yi_j = jk._tridiag_expm_e1(jnp.asarray(alphas), jnp.asarray(betas), dt, n_sq)
    yr_t, yi_t = tk._tridiag_expm_e1(torch.as_tensor(alphas), torch.as_tensor(betas), dt, n_sq)
    assert np.abs(yr_t.numpy() - np.asarray(yr_j)).max() <= 1e-13
    assert np.abs(yi_t.numpy() - np.asarray(yi_j)).max() <= 1e-13
    assert tk._expm_n_squarings(12.0) == jk._expm_n_squarings(12.0) == 6
    # every case keeps ||dt T|| / 2^n_sq within the Taylor core's reach
    T = np.diag(alphas) + np.diag(betas[: m - 1], 1) + np.diag(betas[: m - 1], -1)
    want = scipy.linalg.expm(-1j * dt * T)[:, 0]
    assert np.abs(yr_t.numpy() + 1j * yi_t.numpy() - want).max() <= 1e-12


def test_propagate_traces_match_reference(models):
    jm, tm, t = models
    want = jk.krylov_propagate_traces(jm.hamiltonian, jm.psi0, t, jm.dims)
    got = tk.krylov_propagate_traces(tm.hamiltonian, tm.psi0, t, tm.dims, device=CPU)
    assert got["site_xyz"].shape == (4, 3, len(t))
    assert np.abs(got["site_xyz"] - want["site_xyz"]).max() <= 1e-10
    assert np.abs(got["norm"] - 1.0).max() <= 1e-12
    assert np.abs(got["energy"] - want["energy"]).max() <= 1e-12 * np.abs(want["energy"]).max()


def test_traces_assembled_match_reference(models):
    jm, tm, t = models
    want = jk.krylov_traces_assembled(*_args(jm, t))
    got = tk.krylov_traces_assembled(*_args(tm, t), device=CPU)
    assert got.shape == (8, len(t))
    assert np.abs(got[:7] - want[:7]).max() <= 1e-10
    assert np.abs(got[6] - 1.0).max() <= 1e-12
    assert abs(got[7, 0] - want[7, 0]) <= 1e-12 * abs(want[7, 0])
    assert np.all(got[7] == got[7, 0])


def test_segmented_dispatch_equals_whole(models, monkeypatch):
    _, tm, t = models
    whole = tk.krylov_traces_assembled(*_args(tm, t[:12]), device=CPU)
    monkeypatch.setenv("QST_KRYLOV_DISPATCH_SUBSTEPS", "1")  # force segmented
    segmented = tk.krylov_traces_assembled(*_args(tm, t[:12]), device=CPU)
    np.testing.assert_allclose(segmented, whole, rtol=0, atol=1e-13)


def test_happy_breakdown_stays_finite_and_exact():
    """m > dim: the Krylov space closes after dim vectors; the clamped betas
    freeze the recurrence, and the step matches the exact exponential."""
    kw = stepper_kwargs(n_sea=1)
    jm, tm = jbuild(JParams(**kw)), tbuild(TParams(**kw))
    H = tm.hamiltonian.to_dense()
    dim = H.shape[0]
    rng = np.random.default_rng(11)
    psi = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    psi /= np.linalg.norm(psi)
    dt = 2e-5
    step_t, n_t = tk.make_krylov_step(tm.hamiltonian, dt, m=3 * dim, device=CPU)
    got = step_t(torch.as_tensor(psi)).numpy()
    step_j, n_j = jk.make_krylov_step(jm.hamiltonian, dt, m=3 * dim)
    want = step_j(Cplx.from_numpy(psi)).to_numpy()
    w, V = np.linalg.eigh(H)
    exact = V @ (np.exp(-1j * w * dt) * (V.conj().T @ psi))
    assert n_t == n_j and np.isfinite(got).all()
    assert np.abs(got - exact).max() <= 1e-12
    assert np.abs(got - want).max() <= 1e-12


def test_sharded_form_is_not_ported(tmp_path):
    """The sharded form (axis_name = the 'sp' process group) is ported: on a
    one-rank gloo group its step equals the unsharded step (the reductions
    over one rank leave every value as it was, up to the norm's rounding).
    The multi-rank form runs in tests/test_torch_state_sharded.py."""
    import torch.distributed as dist

    kw = stepper_kwargs(n_sea=3)
    model = tbuild(TParams(**kw))
    H = model.hamiltonian
    psi = torch.as_tensor(model.psi0)
    step, _ = tk.make_krylov_step(H, 2e-5, m=24, device=CPU)
    want = step(psi)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        sharded, _ = tk.make_krylov_step(H, 2e-5, m=24, axis_name=dist.group.WORLD, device=CPU)
        got = sharded(psi)
    finally:
        dist.destroy_process_group()
    assert torch.abs(got - want).max() <= 1e-13


def test_spin32_rare_site_takes_the_generic_apply():
    """A spin-3/2 rare site has no flip apply in either package; both step
    through the generic term apply and agree."""
    kw = stepper_kwargs(n_sea=2, is_spin_three_half=True, t_final=2e-4, steps=11)
    jm, tm = jbuild(JParams(**kw)), tbuild(TParams(**kw))
    assert jembed.make_qubit_flip_apply(jm.hamiltonian) is None
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    want = jk.krylov_traces_assembled(*_args(jm, t))
    got = tk.krylov_traces_assembled(*_args(tm, t), device=CPU)
    assert np.abs(got[:7] - want[:7]).max() <= 1e-10
    assert abs(got[3, 0] - 1.5) <= 1e-14  # Iz_R[0] of a spin-3/2 rare


def test_simulate_rare_krylov_matches_reference():
    kw = stepper_kwargs(solver_method="krylov", t_final=3e-4, steps=31)
    t_t, tr_t = tsim(TParams(**kw), device="cpu")
    t_j, tr_j = jsim(JParams(**kw))
    assert np.array_equal(t_t, t_j) and set(tr_t) == set(tr_j)
    for key in tr_j:
        assert np.abs(tr_t[key] - tr_j[key]).max() <= 1e-10, key
