"""Port vs reference: spin operators, parameters, geometry, Hamiltonian, psi0.

Tolerances: the port assembles the same terms in the same order in numpy
complex128, so dense H and psi0 agree to 1e-12 relative (observed: exactly);
geometry and couplings agree to 1e-12 relative point for point.
"""

import numpy as np
import pytest

from _torch_parity import no_jax_compile_cache, production_params_kwargs  # noqa: F401
from quantumsimulations_tpu.models import dipolar as jdip
from quantumsimulations_tpu.models import geometry as jgeo
from quantumsimulations_tpu.models import params as jpar
from quantumsimulations_tpu.ops import spin as jspin
from quantumsimulations_tpu_torch.models import dipolar as tdip
from quantumsimulations_tpu_torch.models import geometry as tgeo
from quantumsimulations_tpu_torch.models import params as tpar
from quantumsimulations_tpu_torch.ops import spin as tspin
from quantumsimulations_tpu_torch.ops.embed import OperatorSum, ProductTerm

RTOL = 1e-12


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300)
    return a.shape == b.shape and np.abs(a - b).max() <= rtol * scale


@pytest.mark.parametrize("s", [0.5, 1.0, 1.5, 2.5])
@pytest.mark.parametrize("which", ["x", "y", "z", "p", "m", "i"])
def test_spin_matrix_matches(s, which):
    assert np.array_equal(tspin.spin_matrix(s, which), jspin.spin_matrix(s, which))


@pytest.mark.parametrize("s", [0.5, 1.5])
@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("sign", [1, -1])
def test_eigenstate_matches(s, axis, sign):
    assert _close(tspin.eigenstate(s, axis, sign), jspin.eigenstate(s, axis, sign))


def test_derived_frequencies_match():
    kw = production_params_kwargs(6)
    got = tpar.get_derived_frequencies(tpar.DipolarRareParams(**kw))
    want = jpar.get_derived_frequencies(jpar.DipolarRareParams(**kw))
    assert got == want


@pytest.mark.parametrize("n_sea", [1, 3, 4, 5, 6, 7, 8, 12, 20])
def test_geometry_point_for_point(n_sea):
    pos_t = tgeo.shell_positions_with_rare_center(n_sea, radius=0.282393e-9)
    pos_j = jgeo.shell_positions_with_rare_center(n_sea, radius=0.282393e-9)
    assert pos_t.shape == (n_sea + 1, 3)
    assert np.array_equal(pos_t, pos_j)
    if n_sea >= 2:
        b_t = tgeo.dipolar_couplings_from_positions(pos_t, 1.05e-41, 8.1812e7, 6.976e7)
        b_j = jgeo.dipolar_couplings_from_positions(pos_j, 1.05e-41, 8.1812e7, 6.976e7)
        assert _close(b_t, b_j)
        st, sj = tgeo.coupling_statistics(b_t, n_sea), jgeo.coupling_statistics(b_j, n_sea)
        assert st.keys() == sj.keys()
        for key in st:
            assert np.isclose(st[key], sj[key], rtol=RTOL, atol=0.0), key


@pytest.mark.parametrize("n_sea", [3, 4, 5])
@pytest.mark.parametrize(
    "variant",
    [
        dict(is_center_rare=True, drive_rare=False),
        dict(is_center_rare=True, drive_rare=True),
        dict(is_center_rare=False, drive_rare=False),
        dict(is_center_rare=True, drive_rare=True, is_spin_three_half=True),
    ],
    ids=["center_off", "center_on", "shell_off", "spin32_on"],
)
def test_dense_hamiltonian_and_psi0_match(n_sea, variant):
    kw = production_params_kwargs(n_sea, **variant)
    mt = tdip.build_model(tpar.DipolarRareParams(**kw))
    mj = jdip.build_model(jpar.DipolarRareParams(**kw))
    assert mt.dims == mj.dims
    assert (mt.n_sea_effective, mt.idx_rare) == (mj.n_sea_effective, mj.idx_rare)
    assert np.array_equal(mt.positions, mj.positions)
    assert _close(mt.couplings, mj.couplings)
    H_t = mt.hamiltonian.to_dense()
    H_j = mj.hamiltonian.to_dense()
    assert _close(H_t, H_j)
    assert np.allclose(H_t, H_t.conj().T, rtol=0, atol=1e-12 * np.abs(H_t).max())
    assert _close(mt.psi0, mj.psi0)
    assert np.isclose(np.linalg.norm(mt.psi0), 1.0, rtol=0, atol=1e-15)


def test_embed_matches_reference_kron_assembly():
    dims = (2, 4, 2)
    terms = (
        ProductTerm(0.7, ((0, "x"), (1, "y"))),
        ProductTerm(-1.3, ((1, "z"), (2, "x"))),
        ProductTerm(0.2, ((0, "p"), (2, "m"))),
    )
    from quantumsimulations_tpu.ops.embed import OperatorSum as JOp
    from quantumsimulations_tpu.ops.embed import ProductTerm as JTerm

    got = OperatorSum(dims, terms).to_dense()
    want = JOp(dims, tuple(JTerm(t.coeff, t.factors) for t in terms)).to_dense_kron()
    assert _close(got, want)


def test_product_term_rejects_unsorted_sites():
    with pytest.raises(ValueError):
        ProductTerm(1.0, ((2, "x"), (1, "z")))
