"""The port's DR-sharded limb-domain apply and Chebyshev stepper
(ops/split_apply_ext.py::make_ext_apply_sharded, parallel/cheb_sharded.py)
on 4 gloo ranks against the JAX package on its virtual CPU mesh.

The ranks run once (tests/_torch_mp.py, case "cheb"; meshes (1, 2) over
ranks 0-1 and (1, 4) over ranks 0-3).  The apply's digits are integers summed exactly (one int32
``all_reduce`` of canonical digits per apply), so they must equal the
single-rank ``make_ext_apply``'s and the JAX sharded apply's bit for bit
(``assert_array_equal``) at sp 2 and 4.  The stepper runs at sp 2 and 4:
its rows must agree within 1e-13 with the single-device ext tier and with
the JAX sharded rows at sp 2 (tests/test_sharding.py:337-360's sizes and
bar; the JAX stepper at sp 2 takes ~17 s of compile and run, ~28 s at sp 4,
minutes under the suite's load, and its rows do not depend on sp), the
norm within 1e-12.  The JAX references are computed while the ranks run.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from quantumsimulations_tpu.dynamics import cheb_step as jcs
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops import split_apply_ext as jspx
from quantumsimulations_tpu.parallel import cheb_sharded as jcheb
from quantumsimulations_tpu.parallel import mesh as jmesh
from quantumsimulations_tpu_torch.dynamics import cheb_step as tcs
from quantumsimulations_tpu_torch.ops import split_apply_ext as tspx

from _torch_mp import rank_run_fixture
from _torch_mp_worker import ext_limbs_input, model_of, params_kwargs

from _torch_parity import no_jax_compile_cache  # noqa: F401  (autouse)

ranks = pytest.fixture(scope="module")(rank_run_fixture(4, "cheb", timeout=300))

_KW = dict(n_sea=4, t_final=2e-3, steps=24)


@pytest.fixture(scope="module")
def jmodel():
    return jbuild(JParams(**params_kwargs(**_KW)))


@pytest.fixture(scope="module")
def single_device_ext_rows():
    m = model_of(**_KW)
    t = np.linspace(0.0, _KW["t_final"], _KW["steps"])
    return tcs.chebyshev_step_traces(m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective,
                                     m.idx_rare, steps_per_dispatch=8, arithmetic="ext",
                                     device="cpu")


@pytest.fixture(scope="module")
def jax_sharded_rows_sp2(jmodel):
    t = np.linspace(0.0, _KW["t_final"], _KW["steps"])
    return jcheb.chebyshev_step_traces_sharded(
        jmodel.hamiltonian, jmodel.psi0, t, jmodel.dims, jmodel.n_sea_effective,
        jmodel.idx_rare, mesh=jmesh.make_mesh(2, sp=2), axis="sp", steps_per_dispatch=8)


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_stepper_matches_reference(ranks, jax_sharded_rows_sp2, sp):
    ref = jax_sharded_rows_sp2
    rows = ranks.result()[f"rows_sp{sp}"]
    assert rows.shape == ref.shape == (8, _KW["steps"])
    np.testing.assert_allclose(rows, ref, rtol=0.0, atol=1e-13)


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_stepper_matches_single_device(ranks, single_device_ext_rows, sp):
    rows = ranks.result()[f"rows_sp{sp}"]
    np.testing.assert_allclose(rows, single_device_ext_rows, rtol=0.0, atol=1e-13)
    assert np.abs(rows[6] - 1.0).max() < 1e-12


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_apply_digits_equal_single_rank_and_reference(ranks, jmodel, sp):
    lam = float(ranks.result()["lam"])
    H = jmodel.hamiltonian
    assert lam == jcs._lambda_bound(H, H.dim)
    apply_local, so, _ = jspx.make_ext_apply_sharded(H, "sp", sp, scale=1.0 / lam)
    T_in = ext_limbs_input(so, seed=3)
    spec = P(None, None, "sp")
    run = jax.jit(jax.shard_map(apply_local, mesh=jmesh.make_mesh(sp, sp=sp),
                                in_specs=(spec, spec), out_specs=(spec, spec)))
    re, im = run(T_in[:, 0], T_in[:, 1])
    want_jax = np.stack([np.asarray(re), np.asarray(im)], axis=1)
    apply, _, _ = tspx.make_ext_apply(model_of(**_KW).hamiltonian, scale=1.0 / lam, device="cpu")
    want_port = apply.stacked(torch.as_tensor(T_in)).numpy()
    got = ranks.result()[f"digits_sp{sp}"]
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want_port)
    np.testing.assert_array_equal(got, want_jax)
