"""Port vs reference: the adaptive Dormand–Prince integrator
(dynamics/dopri.py) on the CPU.

Bounds (tests/test_steppers.py:109-156): each package within 1e-8 of the
eig propagator on the n_sea = 3 fixture (atol 1e-12, rtol 1e-11), the norm
within 1e-9 of one; the time-dependent Rabi case within 5e-8 of scipy's
DOP853; the port within 1e-9 of the JAX package's traces.  The step
sequences coincide on these cases: the same number of accepted and rejected
steps (the right-hand sides agree to float64 rounding, and no error norm
falls within rounding of an accept decision here; where one did, the counts
could differ by a step).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import no_jax_compile_cache, stepper_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import dopri as jd
from quantumsimulations_tpu.dynamics.eig_propagator import eig_propagate_traces, eigh_host
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops import embed as jembed
from quantumsimulations_tpu_torch.dynamics import dopri as td
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.ops import embed as tembed

TOL = dict(atol=1e-12, rtol=1e-11)


@pytest.fixture(scope="module")
def fixture_runs():
    kw = stepper_kwargs()
    jm, tm = jbuild(JParams(**kw)), tbuild(TParams(**kw))
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    w, V = eigh_host(jm.hamiltonian.to_dense())
    exact = eig_propagate_traces(w, V, jm.psi0, t, jm.dims)
    ref = jd.dopri_propagate_traces(jm.hamiltonian, jm.psi0, t, jm.dims, **TOL)
    out = td.dopri_propagate_traces(tm.hamiltonian, tm.psi0, t, tm.dims, device="cpu", **TOL)
    return exact, ref, out


@pytest.mark.parametrize("package", ["port", "jax"])
def test_dopri_matches_eig(fixture_runs, package):
    exact, ref, out = fixture_runs
    res = out if package == "port" else ref
    assert res["n_accepted"] > 0
    assert np.abs(res["site_xyz"] - exact["site_xyz"]).max() <= 1e-8
    assert np.abs(res["norm"] - 1.0).max() <= 1e-9


def test_dopri_port_matches_reference_step_for_step(fixture_runs):
    _, ref, out = fixture_runs
    assert (out["n_accepted"], out["n_rejected"]) == (ref["n_accepted"], ref["n_rejected"])
    assert np.abs(out["site_xyz"] - ref["site_xyz"]).max() <= 1e-9
    assert np.abs(out["norm"] - ref["norm"]).max() <= 1e-9
    np.testing.assert_allclose(out["energy"], ref["energy"], rtol=1e-12)
    assert set(out) == set(ref)


def _rabi(emb, cos):
    w0, w1 = 2 * np.pi * 1.0e5, 2 * np.pi * 4.0e3
    dims = (2,)
    H0 = emb.OperatorSum(dims, (emb.ProductTerm(w0, ((0, "z"),)),))
    V = emb.OperatorSum(dims, (emb.ProductTerm(2 * w1, ((0, "x"),)),))
    return H0, V, w0, w1, dims, cos


def test_dopri_time_dependent_rabi():
    """Lab-frame cosine drive on one spin against scipy's DOP853 (the JAX
    test's case), and against the JAX package's integrator."""
    from scipy.integrate import solve_ivp

    H0, V, w0, w1, dims, _ = _rabi(tembed, math.cos)
    Ht = td.TimeDependentHamiltonian(H0, [(V, lambda t: math.cos(w0 * t))])
    psi0 = np.array([1.0, 0.0], dtype=np.complex128)
    t = np.linspace(0.0, 2.5e-4, 101)
    out = td.dopri_propagate_traces(Ht, psi0, t, dims, device="cpu", **TOL)
    assert "energy" not in out

    sz = 0.5 * np.array([[1, 0], [0, -1]], dtype=complex)
    Vd = 2 * w1 * 0.5 * np.array([[0, 1], [1, 0]], dtype=complex)

    def rhs(tt, y):
        psi = y[:2] + 1j * y[2:]
        d = -1j * ((w0 * sz + np.cos(w0 * tt) * Vd) @ psi)
        return np.concatenate([d.real, d.imag])

    sol = solve_ivp(rhs, (0, t[-1]), np.concatenate([psi0.real, psi0.imag]),
                    t_eval=t, method="DOP853", rtol=1e-12, atol=1e-14)
    psis = sol.y[:2] + 1j * sol.y[2:]
    want_z = np.real(np.einsum("it,ij,jt->t", psis.conj(), sz, psis))
    assert np.abs(out["site_xyz"][0, 2] - want_z).max() <= 5e-8
    assert want_z.min() < 0.45  # the drive actually does something

    jH0, jV, *_ = _rabi(jembed, None)
    ref = jd.dopri_propagate_traces(
        jd.TimeDependentHamiltonian(jH0, [(jV, lambda t: jnp.cos(w0 * t))]), psi0, t, dims, **TOL)
    assert (out["n_accepted"], out["n_rejected"]) == (ref["n_accepted"], ref["n_rejected"])
    assert np.abs(out["site_xyz"] - ref["site_xyz"]).max() <= 1e-9


def test_dopri_nan_divergence_exits_gracefully():
    """A NaN-producing coefficient function rejects every step from then
    on: the loop exits through the floor on h, with the stall in
    n_rejected and the unfilled tail at zero, as in the JAX package."""
    dims = (2,)
    psi0 = np.array([1.0, 0.0], dtype=np.complex128)
    t = np.linspace(0.0, 1e-3, 11)

    def bad(emb, mod):
        H0 = emb.OperatorSum(dims, (emb.ProductTerm(1.0e5, ((0, "z"),)),))
        V = emb.OperatorSum(dims, (emb.ProductTerm(1.0e4, ((0, "x"),)),))
        return mod.TimeDependentHamiltonian(H0, [(V, fns[mod])])

    fns = {td: lambda t: math.nan if t > 1e-5 else 1.0,
           jd: lambda t: jnp.where(t > 1e-5, jnp.nan, 1.0)}
    out = td.dopri_propagate_traces(bad(tembed, td), psi0, t, dims, device="cpu")
    ref = jd.dopri_propagate_traces(bad(jembed, jd), psi0, t, dims)
    assert out["n_rejected"] > 0 and out["n_accepted"] + out["n_rejected"] < 20_000_000
    assert (out["n_accepted"], out["n_rejected"]) == (ref["n_accepted"], ref["n_rejected"])
    assert np.all(out["norm"][1:] == 0.0) and out["norm"][0] == 1.0
    np.testing.assert_array_equal(out["norm"] == 0.0, np.asarray(ref["norm"]) == 0.0)
