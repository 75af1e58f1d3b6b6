"""Port vs reference: phases, observables, the eig / eig32 propagators and
``simulate_rare`` (CPU, small sizes).

Tolerances and why:
  * phases: 1e-13 absolute — the same float64 operations in the same order;
  * per-site observables: 1e-12 absolute — the sums run in another order;
  * assembled f64 rows: 1e-10 absolute on the seven observable rows (the
    bar the issue sets for the propagator) and 1e-13 relative on the energy
    row, whose magnitude is ~1e4 rad/s at these parameters;
  * eig32: within 2e-4 of the f64 path, the reference's own bar
    (tests/test_steppers.py, eig_propagator.py docstring of _batched32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, production_params_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import eig_propagator as jeig
from quantumsimulations_tpu.dynamics import observables as jobs
from quantumsimulations_tpu.dynamics import phase as jphase
from quantumsimulations_tpu.dynamics.evolve import simulate_rare as jsim
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops.cplx import Cplx
from quantumsimulations_tpu_torch.dynamics import eig_propagator as teig
from quantumsimulations_tpu_torch.dynamics import observables as tobs
from quantumsimulations_tpu_torch.dynamics import phase as tphase
from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare as tsim
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams

CPU = torch.device("cpu")
OBS_ROWS = slice(0, 7)


def _f64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _phase_inputs(seed, dim=64, T=500, t_final=30.0, steps=20_000, k0=19_000):
    rng = np.random.default_rng(seed)
    w = np.sort(rng.uniform(-3e6, 3e6, dim))
    times = np.linspace(0.0, t_final, steps)
    dt, eps = jphase.uniform_grid_decomposition(times)
    r = jphase.reduce_wdt_host(w, dt)
    k = np.arange(k0, k0 + T, dtype=np.float64)
    return w, r, k, eps[k0 : k0 + T]


def test_host_reductions_identical():
    times = np.linspace(0.0, 30.0, 20_000)
    dt_t, eps_t = tphase.uniform_grid_decomposition(times)
    dt_j, eps_j = jphase.uniform_grid_decomposition(times)
    assert dt_t == dt_j and np.array_equal(eps_t, eps_j)
    w = np.random.default_rng(0).uniform(-5e6, 5e6, 128)
    assert np.array_equal(tphase.reduce_wdt_host(w, dt_t), jphase.reduce_wdt_host(w, dt_j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_expi_neg_matches(seed):
    w, r, k, eps = _phase_inputs(seed)
    got = tphase.grid_expi_neg(_f64(r), _f64(k), _f64(w), _f64(eps))
    assert got.dtype == torch.complex128 and got.shape == (len(w), len(k))
    re, im = jphase.grid_expi_neg(jnp.asarray(r), jnp.asarray(k), jnp.asarray(w), jnp.asarray(eps))
    assert np.abs(got.real.numpy() - np.asarray(re)).max() <= 1e-13
    assert np.abs(got.imag.numpy() - np.asarray(im)).max() <= 1e-13


def test_grid_angles_batched_rows_match_unbatched():
    w, r, k, eps = _phase_inputs(3, dim=16, T=64)
    wb, rb = np.stack([w, -w]), np.stack([r, -r])
    got = tphase.grid_angles(_f64(rb), _f64(k), _f64(wb), _f64(eps))
    for b in range(2):
        one = tphase.grid_angles(_f64(rb[b]), _f64(k), _f64(wb[b]), _f64(eps))
        assert torch.equal(got[b], one)


def _random_states(rng, dim, T):
    psi = rng.standard_normal((dim, T)) + 1j * rng.standard_normal((dim, T))
    return psi / np.linalg.norm(psi, axis=0, keepdims=True)


@pytest.mark.parametrize(
    "dims", [(2, 2), (2, 2, 2, 2), (2, 2, 4), (2, 2, 2, 4), (4, 2, 2)],
    ids=lambda d: "x".join(map(str, d)),
)
def test_site_xyz_expectations_match(dims):
    rng = np.random.default_rng(len(dims) * 7 + dims[-1])
    psi = _random_states(rng, int(np.prod(dims)), 37)
    got = tobs.site_xyz_expectations(torch.as_tensor(psi), dims).numpy()
    want = np.asarray(jobs.site_xyz_expectations(Cplx.from_numpy(psi), dims))
    assert got.shape == want.shape == (len(dims), 3, 37)
    assert np.abs(got - want).max() <= 1e-12
    norms_t = tobs.state_norms(torch.as_tensor(psi)).numpy()
    norms_j = np.asarray(jobs.state_norms(Cplx.from_numpy(psi)))
    assert np.abs(norms_t - norms_j).max() <= 1e-12


def test_assemble_traces_matches():
    rng = np.random.default_rng(8)
    xyz, norms = rng.standard_normal((5, 3, 20)), rng.standard_normal(20)
    for nse, idx in ((4, 4), (5, 4)):
        got = tobs.assemble_traces(xyz, norms, nse, idx)
        want = jobs.assemble_traces(xyz, norms, nse, idx)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_site_xyz_expectations_batched_and_f32():
    dims = (2, 2, 4)
    rng = np.random.default_rng(5)
    psi = np.stack([_random_states(rng, 16, 11) for _ in range(3)])
    got = tobs.site_xyz_expectations(torch.as_tensor(psi), dims)
    assert got.shape == (3, 3, 3, 11)
    for b in range(3):
        one = tobs.site_xyz_expectations(torch.as_tensor(psi[b]), dims)
        assert torch.allclose(got[b], one, rtol=0, atol=1e-14)
    got32 = tobs.site_xyz_expectations(torch.as_tensor(psi).to(torch.complex64), dims)
    assert got32.dtype == torch.float32
    assert torch.allclose(got32.double(), got, rtol=0, atol=1e-5)


_VARIANTS = (
    dict(drive_rare=False, is_center_rare=True),
    dict(drive_rare=True, is_center_rare=True),
    dict(drive_rare=False, is_center_rare=False),
)


def _batch(n_sea, variants=_VARIANTS, **overrides):
    """Variants of one detuning (default: the sweep's three), solved on the host."""
    kw = production_params_kwargs(n_sea, **overrides)
    models = [jbuild(JParams(**{**kw, **v})) for v in variants]
    eig = [np.linalg.eigh(m.hamiltonian.to_dense()) for m in models]
    w = np.stack([e[0] for e in eig])
    V = np.stack([e[1] for e in eig])
    psi0 = np.stack([m.psi0 for m in models])
    nse = np.asarray([m.n_sea_effective for m in models])
    return w, V, psi0, models[0].dims, nse, models[0].idx_rare


@pytest.fixture(scope="module")
def n4_batch():
    return _batch(4)


@pytest.fixture(scope="module")
def times_400():
    return np.linspace(0.0, 0.03, 401)


@pytest.fixture(scope="module")
def port_rows_f64(n4_batch, times_400):
    w, V, psi0, dims, nse, idx = n4_batch
    return teig.eig_traces_assembled_batched(w, V, psi0, times_400, dims, nse, idx, device=CPU)


def _assert_rows_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got[:, OBS_ROWS] - want[:, OBS_ROWS]).max() <= 1e-10
    energy_scale = np.abs(want[:, 7]).max()
    assert np.abs(got[:, 7] - want[:, 7]).max() <= 1e-13 * energy_scale


def test_eig_traces_f64_match_reference(n4_batch, times_400, port_rows_f64):
    w, V, psi0, dims, nse, idx = n4_batch
    want = jeig.eig_traces_assembled_batched(w, V, psi0, times_400, dims, nse, idx, pack=False)
    assert port_rows_f64.shape == (3, 8, 401)
    _assert_rows_close(port_rows_f64, want)


@pytest.mark.parametrize("t_chunk", [64, 100, 401])
def test_eig_traces_chunking_invariant(n4_batch, times_400, port_rows_f64, t_chunk):
    w, V, psi0, dims, nse, idx = n4_batch
    got = teig.eig_traces_assembled_batched(
        w, V, psi0, times_400, dims, nse, idx, t_chunk=t_chunk, pack=True, device=CPU
    )
    _assert_rows_close(got, port_rows_f64)


def test_eig_traces_physics(n4_batch, port_rows_f64):
    rows = port_rows_f64
    assert np.abs(rows[:, 6] - 1.0).max() < 1e-12  # state_norm
    assert np.allclose(rows[:2, 2, 0], -2.0, atol=1e-14)  # Iz_sea[0] = -n_sea/2
    assert np.isclose(rows[2, 2, 0], -2.5, atol=1e-14)  # shell_off: center counts as sea
    assert np.allclose(rows[:2, 3, 0], 0.5, atol=1e-14)  # Iz_R[0]
    assert np.abs(rows[:, 7] - rows[:, 7, :1]).max() <= 1e-12 * np.abs(rows[:, 7]).max()


def test_eig32_within_bound_of_f64(n4_batch, times_400, port_rows_f64):
    w, V, psi0, dims, nse, idx = n4_batch
    got = teig.eig_traces_assembled_batched32(w, V, psi0, times_400, dims, nse, idx, device=CPU)
    assert got.dtype == np.float64 and got.shape == port_rows_f64.shape
    assert np.abs(got[:, OBS_ROWS] - port_rows_f64[:, OBS_ROWS]).max() <= 2e-4


def test_eig32_matches_reference_eig32(n4_batch, times_400):
    """Both f32 paths carry ~1e-6 rounding; they agree well inside 2e-4."""
    w, V, psi0, dims, nse, idx = n4_batch
    got = teig.eig_traces_assembled_batched32(w, V, psi0, times_400, dims, nse, idx, device=CPU)
    want = jeig.eig_traces_assembled_batched32(w, V, psi0, times_400, dims, nse, idx, interpret=True)
    assert np.abs(got[:, OBS_ROWS] - want[:, OBS_ROWS]).max() <= 2e-4


def test_eig_traces_spin32_match_reference(times_400):
    # the two rare-at-center variants; shell_off has a spin-1/2 center
    w, V, psi0, dims, nse, idx = _batch(3, _VARIANTS[:2], is_spin_three_half=True)
    assert dims == (2, 2, 2, 4)
    got = teig.eig_traces_assembled_batched(w, V, psi0, times_400, dims, nse, idx, device=CPU)
    want = jeig.eig_traces_assembled_batched(w, V, psi0, times_400, dims, nse, idx, pack=False)
    _assert_rows_close(got, want)
    assert np.allclose(got[:, 3, 0], 1.5, atol=1e-14)  # Iz_R[0] of a spin-3/2 rare


@pytest.mark.parametrize("method", ["auto", "eig", "eig32"])
def test_simulate_rare_matches_reference(method):
    kw = production_params_kwargs(3, t_final=2.0e-3, steps=150, solver_method=method)
    t_t, tr_t = tsim(TParams(**kw), device="cpu")
    t_j, tr_j = jsim(JParams(**kw))
    assert np.array_equal(t_t, t_j)
    assert set(tr_t) == set(tr_j)
    atol = 2e-4 if method == "eig32" else 1e-10
    for key in tr_j:
        assert np.abs(tr_t[key] - tr_j[key]).max() <= atol, key


@pytest.mark.parametrize(
    "method", ["expm", "ext", "krylov", "chebyshev", "cheb_step", "dopri"]
)
def test_unported_solvers_raise(method):
    kw = production_params_kwargs(3, t_final=1e-3, steps=10, solver_method=method)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        tsim(TParams(**kw), device="cpu")


def test_unknown_solver_and_bad_grid_raise():
    with pytest.raises(ValueError):
        tsim(TParams(**production_params_kwargs(3, solver_method="bogus")), device="cpu")
    with pytest.raises(ValueError):
        tsim(TParams(**production_params_kwargs(3, steps=1)), device="cpu")


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-fallback error cannot show here")
    kw = production_params_kwargs(3, t_final=1e-3, steps=10)
    with pytest.raises(RuntimeError, match="cuda"):
        tsim(TParams(**kw))
    assert dataclasses.asdict(TParams(**kw)) == dataclasses.asdict(JParams(**kw))
