"""Port vs reference: the Ozaki float64 tier (ops/extprec.py) and the Ozaki
``expm`` route (dynamics/expm_propagator.py) on the CPU.

Bounds:

  * ``_limb_split``: limbs and scale equal bit for bit
    (``assert_array_equal``), including maxima at, just below and just above
    a power of two, where XLA's inexact log2 picks the exponent;
  * ``matmul_f64``, ``matmul_f64_prelimbed``, ``cmatmul_f64``: equal bit for
    bit (the int32 digit sums are exact in any order, and the float64 sum
    over the diagonals runs in the JAX package's order with its weights and
    scale product);
  * the Ozaki step operator: equal bit for bit (XLA's CPU code fuses the
    Horner step's A + t / k into one multiply-add; the port's
    ``torch.add(..., alpha=)`` is one too);
  * ``expm_traces_assembled_ozaki``: 1e-10 against the eig route
    (tests/test_extprec.py:74's bar) and against the JAX package's rows.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, stepper_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import expm_propagator as jep
from quantumsimulations_tpu.dynamics.eig_propagator import eig_traces_assembled_batched, eigh_host
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops import extprec as jx
from quantumsimulations_tpu.ops.cplx import Cplx
from quantumsimulations_tpu_torch.dynamics import expm_propagator as tep
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.ops import extprec as tx

MAXIMA = [1.0, 0.37, 2.0**-7, np.nextafter(2.0**-7, 0.0), np.nextafter(2.0**-7, 1.0),
          2.0**20, np.nextafter(2.0**20, 0.0), 3.0e5, 1.7e-9]


def _matrix(rng, shape, maxabs):
    x = rng.standard_normal(shape)
    return x * (maxabs / np.abs(x).max())


@pytest.mark.parametrize("maxabs", MAXIMA)
def test_limb_split_equals_reference_bit_for_bit(maxabs):
    rng = np.random.default_rng(0)
    for shape in ((40, 24), (17,)):
        x = _matrix(rng, shape, maxabs)
        for n_limbs, bits in ((11, 5), (9, 6)):
            lj, sj = jx._limb_split(jnp.asarray(x), n_limbs, bits)
            lt, st = tx._limb_split(torch.as_tensor(x), n_limbs, bits)
            np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
            assert st == float(sj)


def test_limb_split_of_zeros_and_the_exponent_edges():
    lj, sj = jx._limb_split(jnp.zeros((4, 4)), 11, 5)
    lt, st = tx._limb_split(torch.zeros((4, 4), dtype=torch.float64), 11, 5)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert st == float(sj)
    # XLA's log2 is log * (1/ln 2): at these maxima floor(log2) is off by
    # one from the exact exponent, and the port must follow
    for k in (-58, 24, 26):
        for m in (2.0**k, np.nextafter(2.0**k, 0.0)):
            x = np.array([[m, -m / 3]])
            assert tx._limb_split(torch.as_tensor(x))[1] == float(jx._limb_split(jnp.asarray(x), 11, 5)[1])


@pytest.mark.parametrize("case", range(8))
def test_matmul_f64_equals_reference_bit_for_bit(case):
    rng = np.random.default_rng(100 + case)
    m, k, n = rng.integers(3, 40, 3)
    a = _matrix(rng, (m, k), 10 ** rng.uniform(-8, 8))
    b = _matrix(rng, (k, n), 10 ** rng.uniform(-8, 8))
    want = np.asarray(jx.matmul_f64(jnp.asarray(a), jnp.asarray(b)))
    got = tx.matmul_f64(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - a @ b).max() <= 1e-14 * np.abs(a).max() * np.abs(b).max() * k
    Lj, sj = jx.limbs_of(jnp.asarray(a))
    Lt, st = tx.limbs_of(torch.as_tensor(a))
    np.testing.assert_array_equal(
        tx.matmul_f64_prelimbed(Lt, st, torch.as_tensor(b)).numpy(),
        np.asarray(jx.matmul_f64_prelimbed(Lj, sj, jnp.asarray(b))))


@pytest.mark.parametrize("case", range(6))
def test_cmatmul_f64_equals_reference_bit_for_bit(case):
    rng = np.random.default_rng(200 + case)
    m, k, n = rng.integers(3, 40, 3)
    sa, sb = 10 ** rng.uniform(-6, 6, 2)
    planes = [_matrix(rng, (m, k), sa), _matrix(rng, (m, k), sa * rng.uniform(0.1, 3)),
              _matrix(rng, (k, n), sb), _matrix(rng, (k, n), sb * rng.uniform(0.1, 3))]
    want = jx.cmatmul_f64(*(jnp.asarray(p) for p in planes))
    got = tx.cmatmul_f64(*(torch.as_tensor(p) for p in planes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a, b = planes[0] + 1j * planes[1], planes[2] + 1j * planes[3]
    c = tx.cmatmul_f64_cplx(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(c.real, np.asarray(want[0]))
    np.testing.assert_array_equal(c.imag, np.asarray(want[1]))


def test_int32_headroom_is_checked():
    with pytest.raises(ValueError, match="overflows int32"):
        tx.matmul_f64(torch.zeros((2, 1 << 18), dtype=torch.float64),
                      torch.zeros((1 << 18, 2), dtype=torch.float64))
    with pytest.raises(TypeError):
        tx.matmul_f64(torch.zeros((2, 2), dtype=torch.float32), torch.zeros((2, 2)))


def test_unitary_product_precision():
    """tests/test_extprec.py's use case: U @ U^dag ~ I at float64 precision."""
    import scipy.linalg

    rng = np.random.default_rng(3)
    H = rng.standard_normal((128, 128)) + 1j * rng.standard_normal((128, 128))
    U = scipy.linalg.expm(-1j * (H + H.conj().T) * 0.01)
    eye = tx.cmatmul_f64_cplx(torch.as_tensor(U), torch.as_tensor(U.conj().T)).numpy()
    assert np.abs(eye - np.eye(128)).max() < 1e-13


def _ozaki_params():
    """tests/test_extprec.py:74's workload (n_sea = 3, 37 steps over 0.4 ms)."""
    return stepper_kwargs(omega_rf_sea=8.1812e7 * 3.0 - 2 * np.pi * 900.0,
                          B1_sea=2 * np.pi * 5e4 / 8.1812e7, t_final=4.0e-4, steps=37)


@pytest.fixture(scope="module")
def ozaki_case():
    kw = _ozaki_params()
    jm, tm = jbuild(JParams(**kw)), tbuild(TParams(**kw))
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    w, V = eigh_host(jm.hamiltonian.to_dense())
    exact = eig_traces_assembled_batched(w[None], V[None], jm.psi0[None], t, jm.dims,
                                         np.asarray([jm.n_sea_effective]), jm.idx_rare)[0]
    return jm, tm, t, exact


def test_ozaki_step_operator_equals_reference_bit_for_bit(ozaki_case):
    jm, tm, t, _ = ozaki_case
    dt = float(t[1] - t[0])
    Uj = jep._ozaki_expm(jm.hamiltonian, dt)
    Ut = tep._ozaki_expm(tm.hamiltonian, dt, torch.device("cpu"), lambda n: contextlib.nullcontext())
    for got, want in zip(Ut, (Uj.re, Uj.im)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ozaki_matrix_power_equals_reference_bit_for_bit(ozaki_case):
    jm, tm, t, _ = ozaki_case
    rng = np.random.default_rng(9)
    re, im = rng.standard_normal((2, 24, 24)) * 0.1
    got = tep._cpower_ozaki((torch.as_tensor(re), torch.as_tensor(im)), 5)
    want = jep._cpower_ozaki(Cplx(jnp.asarray(re), jnp.asarray(im)), 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.re))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want.im))


def test_expm_ozaki_traces_match_eig_and_reference(ozaki_case):
    jm, tm, t, exact = ozaki_case
    args = (t, tm.dims, tm.n_sea_effective, tm.idx_rare)
    rows = tep.expm_traces_assembled_ozaki(tm.hamiltonian, tm.psi0, *args, block=8, device="cpu")
    want = jep.expm_traces_assembled_ozaki(jm.hamiltonian, jm.psi0, *args, block=8)
    assert rows.shape == exact.shape == (8, len(t))
    assert np.abs(rows[:7] - exact[:7]).max() <= 1e-10
    assert np.abs(rows[:7] - want[:7]).max() <= 1e-10
    np.testing.assert_allclose(rows[7], want[7], rtol=1e-12)


def test_simulate_rare_expm_routes_like_the_reference(monkeypatch):
    """Ozaki only at dim >= 2048 off the CPU: on the CPU "expm" takes the
    float64 route in both packages, at every dim."""
    from quantumsimulations_tpu.dynamics.evolve import simulate_rare as jsim
    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare as tsim

    kw = dict(stepper_kwargs(steps=12, t_final=1e-4), solver_method="expm")
    called = []
    monkeypatch.setattr(tep, "expm_traces_assembled_ozaki", lambda *a, **k: called.append(1))
    t_t, tr_t = tsim(TParams(**kw), device="cpu")
    t_j, tr_j = jsim(JParams(**kw))
    assert not called and set(tr_t) == set(tr_j)
    for key in tr_j:
        assert np.abs(tr_t[key] - tr_j[key]).max() <= 1e-10, key
    assert dataclasses.asdict(TParams(**kw)) == dataclasses.asdict(JParams(**kw))
