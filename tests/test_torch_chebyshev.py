"""Port vs reference: the global Chebyshev basis sweep of
``dynamics/chebyshev.py`` (CPU).

Both packages run the same model and grid (tests/test_steppers.py:24-50's
parameters, n_sea = 3) with phi_block 16 and terms_per_dispatch 64, as
tests/test_steppers.py:216 runs the JAX package.  Tolerances: the output
states and the seven observable rows within 1e-10 absolute (the JAX
package's bar against the exact propagator), the norm within 1e-11 of 1,
the energy row 1e-12 relative (~1e5 rad/s).  The port's per-block product
is one complex128 matmul where the JAX package takes four real ones, and
its apply sums the terms in another order, so agreement is at rounding
level, not bit for bit.
"""

import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, stepper_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import chebyshev as jc
from quantumsimulations_tpu.dynamics.evolve import simulate_rare as jsim
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu_torch.dynamics import chebyshev as tc
from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare as tsim
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams

CPU = torch.device("cpu")
SWEEP_KW = dict(phi_block=16, terms_per_dispatch=64)


@pytest.fixture(scope="module")
def models():
    kw = stepper_kwargs()
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    return jbuild(JParams(**kw)), tbuild(TParams(**kw)), t


def test_states_match_reference(models):
    jm, tm, t = models
    want = jc.chebyshev_states(jm.hamiltonian, jm.psi0, t, **SWEEP_KW)
    got = tc.chebyshev_states(tm.hamiltonian, tm.psi0, t, **SWEEP_KW, device=CPU)
    assert got.shape == want.shape == (len(t), len(jm.psi0))
    assert np.abs(got - want).max() <= 1e-10
    assert np.array_equal(got[0], tm.psi0)  # c_k(0) = delta_k0


def test_traces_assembled_match_reference(models):
    jm, tm, t = models
    args = lambda m: (m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective, m.idx_rare)  # noqa: E731
    want = jc.chebyshev_traces_assembled(*args(jm), **SWEEP_KW)
    got = tc.chebyshev_traces_assembled(*args(tm), **SWEEP_KW, device=CPU)
    assert got.shape == (8, len(t))
    assert np.abs(got[:7] - want[:7]).max() <= 1e-10
    assert np.abs(got[6] - 1.0).max() <= 1e-11
    assert abs(got[7, 0] - want[7, 0]) <= 1e-12 * abs(want[7, 0])
    assert np.all(got[7] == got[7, 0])


@pytest.mark.parametrize("terms", ["16", "4096"])
def test_dispatch_split_does_not_change_the_states(models, monkeypatch, terms):
    """On the card the dispatch size only splits the host loop: the states
    are the same bit for bit whatever it is."""
    _, tm, t = models
    base = tc.chebyshev_states(tm.hamiltonian, tm.psi0, t[:9], **SWEEP_KW, device=CPU)
    monkeypatch.setenv("QST_CHEB_DISPATCH_TERMS", terms)
    got = tc.chebyshev_states(tm.hamiltonian, tm.psi0, t[:9], **SWEEP_KW, device=CPU)
    np.testing.assert_array_equal(got, base)


def test_simulate_rare_chebyshev_matches_reference():
    kw = stepper_kwargs(solver_method="chebyshev", t_final=3e-4, steps=31)
    t_t, tr_t = tsim(TParams(**kw), device="cpu")
    t_j, tr_j = jsim(JParams(**kw))
    assert np.array_equal(t_t, t_j) and set(tr_t) == set(tr_j)
    for key in tr_j:
        assert np.abs(tr_t[key] - tr_j[key]).max() <= 1e-10, key
