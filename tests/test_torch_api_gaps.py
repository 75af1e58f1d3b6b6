"""Port vs reference: the public functions of modules ported earlier that
the port lacked (eig_propagator, phase, embed, artifacts/writer), on the CPU.

Bounds: host assemblies (to_dense_kron, dense_matrix_host, the time-chunk
table, the writer's readers) equal exactly; the per-site eig traces within
1e-12 of the JAX package's (tests/test_propagation.py's bar for batched
against single); reduced_angles within 1e-12 rad of an exact Decimal
reduction and of the JAX package; device assemblies and reduced densities
within 1e-14 / 1e-13 (tests/test_cplx_and_embed.py's bars).
"""

import os
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, stepper_kwargs  # noqa: F401
from quantumsimulations_tpu.artifacts import writer as jw
from quantumsimulations_tpu.dynamics import eig_propagator as jeig
from quantumsimulations_tpu.dynamics import phase as jphase
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops import embed as je
from quantumsimulations_tpu.ops.cplx import Cplx
from quantumsimulations_tpu_torch.artifacts import writer as tw
from quantumsimulations_tpu_torch.dynamics import eig_propagator as teig
from quantumsimulations_tpu_torch.dynamics import phase as tphase
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.ops import embed as te

TERMS = (
    (0.7, ((0, "z"),)),
    (1.9, ((1, "z"), (3, "z"))),
    (-1.3, ((1, "x"), (2, "y"))),
    (0.25, ((0, "y"), (3, "y"))),
    (0.4, ((2, "x"),)),
)
DIMS = (2, 2, 4, 2)


def _ops(dims=DIMS, terms=TERMS):
    return (te.OperatorSum(dims, tuple(te.ProductTerm(c, f) for c, f in terms)),
            je.OperatorSum(dims, tuple(je.ProductTerm(c, f) for c, f in terms)))


def _psi(dim, seed=0):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    return psi / np.linalg.norm(psi)


@pytest.fixture(scope="module")
def eig_case():
    kw = stepper_kwargs()
    jm, tm = jbuild(JParams(**kw)), tbuild(TParams(**kw))
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    w, V = teig.eigh_host(teig.dense_matrix_host(tm.hamiltonian))
    return jm, tm, t, w, V


def test_eig_propagate_traces_matches_reference(eig_case):
    jm, tm, t, w, V = eig_case
    got = teig.eig_propagate_traces(w, V, tm.psi0, t, tm.dims, device="cpu")
    want = jeig.eig_propagate_traces(w, V, jm.psi0, t, jm.dims)
    assert set(got) == set(want) == {"site_xyz", "norm", "energy"}
    for key in want:
        assert got[key].shape == np.asarray(want[key]).shape
    assert np.abs(got["site_xyz"] - want["site_xyz"]).max() <= 1e-12
    assert np.abs(got["norm"] - want["norm"]).max() <= 1e-12
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-12)


def test_eig_propagate_traces_batched_matches_single(eig_case):
    jm, tm, t, w, V = eig_case
    w2, V2 = teig.eigh_host(teig.dense_matrix_host(
        tbuild(TParams(**stepper_kwargs(drive_rare=False))).hamiltonian))
    psi = np.stack([tm.psi0, tm.psi0])
    got = teig.eig_propagate_traces_batched(np.stack([w, w2]), np.stack([V, V2]), psi, t, tm.dims,
                                            t_chunk=7, device="cpu")
    want = jeig.eig_propagate_traces_batched(np.stack([w, w2]), np.stack([V, V2]), psi, t, jm.dims)
    assert np.abs(got["site_xyz"] - want["site_xyz"]).max() <= 1e-12
    single = teig.eig_propagate_traces(w2, V2, tm.psi0, t, tm.dims, device="cpu")
    assert np.abs(got["site_xyz"][1] - single["site_xyz"]).max() <= 1e-12


def test_dense_matrix_host_and_default_time_chunk(eig_case, monkeypatch):
    jm, tm, *_ = eig_case
    np.testing.assert_array_equal(teig.dense_matrix_host(tm.hamiltonian),
                                  jeig.dense_matrix_host(jm.hamiltonian))
    for dim, T, batch in ((128, 20_000, 39), (8192, 20_000, 1), (16, 50, 1), (1 << 20, 100, 4)):
        assert teig.default_time_chunk(dim, T, batch) == jeig.default_time_chunk(dim, T, batch)
    monkeypatch.setenv("QST_TCHUNK", "17")
    assert teig.default_time_chunk(128, 20_000) == jeig.default_time_chunk(128, 20_000) == 17


def _exact_mod_2pi(x):
    two_pi = Decimal("6.283185307179586476925286766559005768394338798750211641949889")
    n = (x / two_pi).quantize(Decimal(1), rounding="ROUND_HALF_EVEN")
    return float(x - n * two_pi)


def test_reduced_angles_accuracy_and_reference():
    w = np.array([3.7e6, -2.9e6, 1.234567e5])
    t = np.array([29.99, 17.3, 3.0])
    got = tphase.reduced_angles(torch.as_tensor(w), torch.as_tensor(t)).numpy()
    want = np.asarray(jphase.reduced_angles(jnp.asarray(w), jnp.asarray(t)))
    for i in range(len(w)):
        for j in range(len(t)):
            r = _exact_mod_2pi(Decimal(w[i]) * Decimal(t[j]))
            assert abs((got[i, j] - r + np.pi) % (2 * np.pi) - np.pi) < 1e-12
    assert np.abs(got - want).max() <= 1e-12


def test_operator_sum_constructors_and_arithmetic():
    for mod in (te, je):
        assert mod.OperatorSum.single_site(DIMS, 2, "x", 0.5).terms == (
            mod.ProductTerm(0.5, ((2, "x"),)),)
    a = te.OperatorSum.sum_over_sites(DIMS, [0, 1, 3], "z", 2.0)
    b = je.OperatorSum.sum_over_sites(DIMS, [0, 1, 3], "z", 2.0)
    assert [(t.coeff, t.factors) for t in a.terms] == [(t.coeff, t.factors) for t in b.terms]
    s = 3.0 * a + te.OperatorSum.single_site(DIMS, 2, "y")
    sj = 3.0 * b + je.OperatorSum.single_site(DIMS, 2, "y")
    np.testing.assert_array_equal(s.to_dense(), sj.to_dense())
    assert sum([a, a]).terms == (a + a).terms
    with pytest.raises(ValueError, match="dims mismatch"):
        a + te.OperatorSum((2, 2), ())


@pytest.mark.parametrize("dims,terms", [(DIMS, TERMS), ((2, 2, 3), (
    (0.7, ((0, "z"),)), (-1.1, ((0, "x"), (2, "y"))), (0.4, ((1, "y"),))))])
def test_dense_assemblies_match_reference(dims, terms):
    t_op, j_op = _ops(dims, terms)
    host = j_op.to_dense()
    np.testing.assert_array_equal(t_op.to_dense_kron(), j_op.to_dense_kron())
    assert np.abs(t_op.to_dense_kron() - host).max() <= 1e-14
    # a column block that does not divide dim: the tail block is exact too
    for cb in (5, 256):
        dev = t_op.to_dense_device(col_block=cb, device="cpu").numpy()
        assert np.abs(dev - host).max() <= 1e-14
        assert np.abs(dev - j_op.to_dense_device(col_block=cb).to_numpy()).max() <= 1e-14
    c64 = t_op.to_dense_cplx(device="cpu")
    assert c64.dtype == torch.complex128
    np.testing.assert_array_equal(c64.numpy(), j_op.to_dense_cplx().to_numpy())
    c32 = t_op.to_dense_cplx(dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(c32.numpy(), j_op.to_dense_cplx(dtype=jnp.float32).to_numpy())


def test_site_reduced_density_and_expect_site():
    dims = (2, 4, 2)
    psi = _psi(16)
    tp, jp = torch.as_tensor(psi), Cplx.from_numpy(psi)
    for site in range(3):
        rho = te.site_reduced_density(tp, dims, site).numpy()
        t_moved = np.moveaxis(psi.reshape(dims), site, 0).reshape(dims[site], -1)
        assert np.abs(rho - t_moved @ t_moved.conj().T).max() <= 1e-13
        assert np.abs(rho - je.site_reduced_density(jp, dims, site).to_numpy()).max() <= 1e-13
        for which in "xyz":
            got = float(te.expect_site(tp, dims, site, which))
            assert abs(got - float(je.expect_site(jp, dims, site, which))) <= 1e-12


def test_writer_readers_match_reference(tmp_path):
    obs = {"Iz_sea": np.linspace(-3, 3, 5), "state_norm": np.ones(5)}
    t = np.linspace(0.0, 1.0, 5)
    tw.save_trace_npz(str(tmp_path), "center_on", t, obs)
    tw.json_dump(str(tmp_path / "x.json"), {"a": 1.5, "b": [1, 2], "c": np.float64(0.25)})
    for mod in (tw, jw):
        t2, obs2 = mod.load_trace_npz(str(tmp_path), "center_on")
        np.testing.assert_array_equal(t2, t)
        assert set(obs2) == set(obs)
        for k in obs:
            np.testing.assert_array_equal(obs2[k], obs[k])
        assert mod.json_load(str(tmp_path / "x.json")) == {"a": 1.5, "b": [1, 2], "c": 0.25}
    assert os.path.isfile(tmp_path / "time_and_obs_center_on.npz")
