"""Port vs reference: the float64 ``expm`` route (dynamics/expm_propagator.py)
on the CPU, on tests/test_steppers.py's n_sea = 3 fixture.

Bounds (tests/test_steppers.py:91-106): site traces within 1e-10 of the eig
propagator (1e-11 on the short non-power-of-two-block grid), the norm within
1e-11 of one; against the JAX package's traces 1e-10 (complex128 matmuls
against its (re, im) float64 planes, summed in another order); the energy
constant 1e-12 relative.
"""

import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, stepper_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import expm_propagator as jep
from quantumsimulations_tpu.dynamics.eig_propagator import eig_propagate_traces, eigh_host
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu_torch.dynamics import expm_propagator as tep
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams


def _case(**kw):
    kw = stepper_kwargs(**kw)
    jm, tm = jbuild(JParams(**kw)), tbuild(TParams(**kw))
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    w, V = eigh_host(jm.hamiltonian.to_dense())
    return jm, tm, t, eig_propagate_traces(w, V, jm.psi0, t, jm.dims)


@pytest.mark.parametrize("kw,block,atol", [
    (dict(), 16, 1e-10),
    (dict(steps=7, t_final=1e-4), 3, 1e-11),  # non-power-of-two block, short grid
    (dict(), 128, 1e-10),  # block clipped to T
])
def test_expm_matches_eig_and_reference(kw, block, atol):
    jm, tm, t, exact = _case(**kw)
    out = tep.expm_propagate_traces(tm.hamiltonian, tm.psi0, t, tm.dims, block=block, device="cpu")
    ref = jep.expm_propagate_traces(jm.hamiltonian, jm.psi0, t, jm.dims, block=block)
    assert out["site_xyz"].shape == exact["site_xyz"].shape
    assert np.abs(out["site_xyz"] - exact["site_xyz"]).max() <= atol
    assert np.abs(out["norm"] - 1.0).max() <= 1e-11
    assert np.abs(out["site_xyz"] - ref["site_xyz"]).max() <= 1e-10
    np.testing.assert_allclose(out["energy"], ref["energy"], rtol=1e-12)


def test_step_operator_is_unitary_and_matches_reference():
    jm, tm, t, _ = _case()
    dt = float(t[1] - t[0])
    U = tep.build_step_operator(tm.hamiltonian, dt, device="cpu").numpy()
    Uj = jep.build_step_operator(jm.hamiltonian, dt)
    assert np.abs(U @ U.conj().T - np.eye(U.shape[0])).max() < 1e-13
    assert np.abs(U - (np.asarray(Uj.re) + 1j * np.asarray(Uj.im))).max() < 1e-13
    P = tep._matrix_power(torch.as_tensor(U), 5).numpy()
    assert np.abs(P - np.linalg.matrix_power(U, 5)).max() < 1e-13


def test_expm_rejects_a_nonuniform_grid():
    _, tm, t, _ = _case()
    with pytest.raises(ValueError, match="uniform"):
        tep.expm_propagate_traces(tm.hamiltonian, tm.psi0, t ** 1.5, tm.dims, device="cpu")
