"""The port's sharded statevector (parallel/state_sharded.py and the sharded
Lanczos substep of dynamics/krylov.py) on 4 gloo ranks against the JAX
package on its virtual CPU mesh.

The ranks run once (tests/_torch_mp.py, case "state"): meshes ('dp', 'sp')
= (1, 2) over ranks 0-1 and (1, 4) over ranks 0-3, so every pair exchange
of a mask group crosses a process boundary (the test
``test_multiprocess.py`` gives the JAX package).
Sizes and bars are tests/test_sharding.py's: the sharded apply within
1e-12 relative of the dense product and of the JAX sharded apply at the
same sp (spin-3/2 rare site at sp 2 included); the sharded Krylov step
within 1e-11 of the unsharded one (the port's and the JAX package's) with
its norm within 1e-11; the sharded Krylov trace within 1e-10 of eig and of
the JAX sharded trace at the same sp, the norm within 1e-11 of 1, the
energy within 1e-8 of eig's.  The sums run in another order than the JAX
package's (one gather table per mask group, ``all_reduce``), so nothing is
held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumsimulations_tpu.dynamics import eig_propagator as jeig
from quantumsimulations_tpu.dynamics import krylov as jkry
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops.cplx import Cplx
from quantumsimulations_tpu.parallel import mesh as jmesh
from quantumsimulations_tpu.parallel import state_sharded as jss
from quantumsimulations_tpu_torch.dynamics import krylov as tkry

from _torch_mp import rank_run_fixture
from _torch_mp_worker import model_of, params_kwargs, random_state

from _torch_parity import no_jax_compile_cache  # noqa: F401  (autouse)

ranks = pytest.fixture(scope="module")(rank_run_fixture(4, "state", timeout=240))

_APPLY = {"sp2": (2, {}, 11), "sp4": (4, {}, 11),
          "spin32_sp2": (2, dict(n_sea=3, is_spin_three_half=True), 5)}
_TRACE = dict(n_sea=5, steps=12, t_final=12 * 1e-5)


def _jmodel(**kw):
    return jbuild(JParams(**params_kwargs(**kw)))


@pytest.mark.parametrize("name", list(_APPLY))
def test_sharded_apply_matches_dense_and_reference(ranks, name):
    sp, kw, seed = _APPLY[name]
    model = _jmodel(**kw)
    dim = model.hamiltonian.dim
    psi = random_state(dim, seed, normalise=not kw)
    want = model.hamiltonian.to_dense() @ psi
    apply_fn, _, sharding, _ = jss.make_sharded_apply(model.hamiltonian, jmesh.make_mesh(sp, sp=sp))
    re, im = apply_fn(jax.device_put(jnp.asarray(psi.real), sharding),
                      jax.device_put(jnp.asarray(psi.imag), sharding))
    ref = np.asarray(re) + 1j * np.asarray(im)
    got = ranks.result()[f"apply_{name}"]
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-12 * scale
    assert np.abs(got - ref).max() <= 1e-12 * scale


def test_sharded_krylov_step_matches_unsharded(ranks):
    dt = 2.0e-5
    jm = _jmodel()
    step, _ = jkry.make_krylov_step(jm.hamiltonian, dt, m=24)
    want_jax = step(Cplx.from_numpy(jm.psi0)).to_numpy()
    tm = model_of()
    tstep, _ = tkry.make_krylov_step(tm.hamiltonian, dt, m=24, device="cpu")
    want_port = tstep(torch.as_tensor(tm.psi0)).numpy()
    got = ranks.result()["krylov_step_sp4"]
    assert np.abs(got - want_jax).max() <= 1e-11
    assert np.abs(got - want_port).max() <= 1e-11
    assert abs(np.linalg.norm(got) - 1.0) <= 1e-11


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_krylov_trace_matches_eig_and_reference(ranks, sp):
    model = _jmodel(**_TRACE)
    t = np.linspace(0.0, _TRACE["t_final"], _TRACE["steps"])
    args = (model.hamiltonian, model.psi0, t, model.dims, model.n_sea_effective, model.idx_rare)
    w, V = jeig.eigh_host(model.hamiltonian.to_dense())
    eig = jeig.eig_traces_assembled_batched(
        w[None], V[None], model.psi0[None], t, model.dims,
        np.asarray([model.n_sea_effective]), model.idx_rare)[0]
    ref = jss.krylov_traces_assembled_sharded(*args, jmesh.make_mesh(sp, sp=sp))
    rows = ranks.result()[f"krylov_rows_sp{sp}"]
    assert rows.shape == eig.shape == ref.shape == (8, len(t))
    assert np.abs(rows[:7] - eig[:7]).max() < 1e-10
    assert np.abs(rows[:7] - ref[:7]).max() < 1e-10
    assert np.allclose(rows[6], 1.0, rtol=0, atol=1e-11)
    assert np.allclose(rows[7], eig[7][0], rtol=0, atol=1e-8)
    assert np.allclose(rows[7], ref[7], rtol=0, atol=1e-8)


def test_pair_exchanges_cross_process_boundaries(ranks):
    """Rank 0 exchanged blocks with ranks 1, 2 and 3 (one process each)."""
    np.testing.assert_array_equal(ranks.result()["exchange_peers"], [1, 2, 3])
