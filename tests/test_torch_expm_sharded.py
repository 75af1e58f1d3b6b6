"""The port's row-sharded dense step-operator engines
(parallel/expm_sharded.py: the Ozaki tier and the exact ext-limb tier) on 4
gloo ranks against the JAX package on its virtual CPU mesh.

The ranks run once (tests/_torch_mp.py, case "expm"; meshes (1, 2) over
ranks 0-1 and (1, 4) over ranks 0-3) on tests/test_expm_sharded.py's workloads, with its bars: 1e-10
against the eig oracle, the norm within 1e-12 of 1, the ext tier within
1e-12 of the single-device ext route (the port's, which its own tests hold
against the JAX package's), the energy row constant.  The Ozaki rows
against the JAX sharded function at the same sp (2 and 4, the n5
workload): 1e-12 on the observable rows (the same limb products; the
scale products and the observables rounded in another order: 1.7e-14
measured, not bit for bit).  The JAX sharded ext chain is not run here:
it compiles for ~40-70 s per workload, several minutes under the suite's
load; the port's ext rows are held instead against the single-device ext
route (whose limbs equal the JAX package's bit for bit,
tests/test_torch_ext_route.py) and equal across sp 2 and 4 bit for bit (an
exact integer chain; a rank's rows of a product do not depend on the
partition), and on the card against the single-card chain's states
(smoke phase G4).  Every rank returns the same rows: the largest
difference between the ranks' rows must be 0 (the JAX package's closing
``pmax`` is a retyping).
"""

import numpy as np
import pytest
import torch

from quantumsimulations_tpu.dynamics import eig_propagator as jeig
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.parallel import expm_sharded as jex
from quantumsimulations_tpu.parallel import mesh as jmesh
from quantumsimulations_tpu_torch.parallel import expm_sharded as tex

from _torch_mp import rank_run_fixture
from _torch_mp_worker import EXPM_CASES, EXT_PRODUCT, ext_product_inputs, params_kwargs

from _torch_parity import no_jax_compile_cache  # noqa: F401  (autouse)

ranks = pytest.fixture(scope="module")(rank_run_fixture(4, "expm", timeout=240))

_RUNS = [("ozaki", "n5", 2), ("ozaki", "n5", 4), ("ozaki", "spin32", 4),
         ("ext", "n5", 2), ("ext", "n5", 4), ("ext", "spin32", 4)]


def _case(name):
    kw, block, panel = EXPM_CASES[name]
    return kw, block, panel, np.linspace(0.0, kw["t_final"], kw["steps"])


@pytest.mark.parametrize("dim", [64, 128, 8192, 16384, 32768, 65536, 190000])
def test_auto_limb_cfg_matches_reference(dim):
    assert tex.auto_limb_cfg(dim) == jex.auto_limb_cfg(dim)


def test_auto_limb_cfg_refuses_too_large_dims():
    for fn in (tex.auto_limb_cfg, jex.auto_limb_cfg):
        with pytest.raises(ValueError):
            fn(1 << 30)


@pytest.mark.parametrize("name,sp", [("n5", 2), ("n5", 4), ("spin32", 4)])
def test_ozaki_matches_reference_at_same_sp(ranks, name, sp):
    kw, block, panel, t = _case(name)
    m = jbuild(JParams(**params_kwargs(**kw)))
    ref = jex.expm_traces_sharded(m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective,
                                  m.idx_rare, mesh=jmesh.make_mesh(sp, sp=sp), block=block,
                                  panel=panel)
    rows = ranks.result()[f"ozaki_{name}_sp{sp}"]
    assert rows.shape == ref.shape == (8, len(t))
    assert np.abs(rows[:7] - ref[:7]).max() <= 1e-12
    assert np.abs(rows[7] - ref[7]).max() <= 1e-13 * np.abs(ref[7]).max()


def test_ext_matches_reference_at_same_sp(ranks):
    kw, block, panel, t = _case("n5")
    m = jbuild(JParams(**params_kwargs(**kw)))
    ref = jex.expm_traces_sharded_ext(m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective,
                                      m.idx_rare, mesh=jmesh.make_mesh(2, sp=2), block=block,
                                      panel=panel)
    rows = ranks.result()["ext_n5_sp2"]
    assert rows.shape == ref.shape == (8, len(t))
    # the chain's limbs are equal (the products above); the observables of
    # its float64 states are summed in another order: 1.1e-15 measured
    assert np.abs(rows[:7] - ref[:7]).max() <= 1e-14
    assert np.abs(rows[7] - ref[7]).max() <= 1e-13 * np.abs(ref[7]).max()


@pytest.mark.parametrize("sp", [2, 4])
def test_ext_limb_products_equal_reference_at_same_sp(ranks, sp):
    import jax
    from jax.sharding import PartitionSpec as P

    from quantumsimulations_tpu_torch.ops import extprec as tep

    x = ext_product_inputs()
    dim, panel = EXT_PRODUCT["dim"], EXT_PRODUCT["panel"]
    rows, rep = P(None, "sp", None), P(None, None, None)
    jmesh_sp = jmesh.make_mesh(sp, sp=sp)
    product = jax.jit(jax.shard_map(
        lambda ar, ai, br, bi: jex._ext_sharded_cmatmul(ar, ai, br, bi, "sp", panel, dim),
        mesh=jmesh_sp, in_specs=(rows,) * 4, out_specs=(rows, rows)))
    apply = jax.jit(jax.shard_map(
        lambda ar, ai, sr, si: jex._ext_sharded_apply(ar, ai, sr, si, "sp"),
        mesh=jmesh_sp, in_specs=(rows, rows, rep, rep), out_specs=(rep, rep),
        check_vma=False))  # the gathered product is replicated (JAX cannot infer it)
    want_product = np.stack([np.asarray(v) for v in product(
        x["a_re"], x["a_im"], x["b_re"], x["b_im"])])
    want_apply = np.stack([np.asarray(v) for v in apply(
        x["a_re"], x["a_im"], x["s_re"], x["s_im"])])
    got_product = ranks.result()[f"ext_product_sp{sp}"]
    got_apply = ranks.result()[f"ext_apply_sp{sp}"]
    assert got_product.dtype == got_apply.dtype == np.int8
    np.testing.assert_array_equal(got_product, want_product)
    np.testing.assert_array_equal(got_apply, want_apply)
    # and the port's single-device product of the same limbs
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    np.testing.assert_array_equal(got_product, torch.stack(tep.ext_cmatmul(
        t["a_re"], t["a_im"], t["b_re"], t["b_im"], panel=panel)).numpy())


def test_ext_rows_do_not_depend_on_sp(ranks):
    np.testing.assert_array_equal(ranks.result()["ext_n5_sp2"], ranks.result()["ext_n5_sp4"])


@pytest.mark.parametrize("tier,name,sp", _RUNS)
def test_sharded_rows_match_eig_and_single_device_ext(ranks, tier, name, sp):
    kw, block, panel, t = _case(name)
    jm = jbuild(JParams(**params_kwargs(**kw)))
    w, V = jeig.eigh_host(jm.hamiltonian.to_dense())
    eig = jeig.eig_traces_assembled_batched(
        w[None], V[None], jm.psi0[None], t, jm.dims, np.asarray([jm.n_sea_effective]),
        jm.idx_rare)[0]
    rows = ranks.result()[f"{tier}_{name}_sp{sp}"]
    assert np.abs(rows[:6] - eig[:6]).max() < 1e-10
    assert np.abs(rows[6] - 1.0).max() < 1e-12
    assert np.allclose(rows[7], rows[7][0])
    assert float(ranks.result()[f"{tier}_{name}_sp{sp}_rank_spread"]) == 0.0
    if tier == "ext":  # the single-device ext route, run by rank 0
        single = ranks.result()[f"single_ext_{name}"]
        assert np.abs(rows[:7] - single[:7]).max() < 1e-12
