"""Port vs reference: the matrix-free H @ psi of ``ops/embed.py`` (CPU).

The port's ``OperatorSum.apply`` (term by term, any local dims) and
``make_qubit_flip_apply`` (all-spin-1/2, one gather for all terms) against
the JAX package's on the same random states, made with numpy from a seed.
Tolerance: 1e-13 of the largest |H psi| entry.  The generic apply contracts
the same factors in the same order; the flip apply sums its terms in another
order than the JAX package's (one column sum over the term table), so the
two agree to float64 rounding, not bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, production_params_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics.krylov import default_matrix_free_apply as jdefault
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops import embed as jembed
from quantumsimulations_tpu.ops.cplx import Cplx
from quantumsimulations_tpu_torch.dynamics.krylov import default_matrix_free_apply as tdefault
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.ops import embed as tembed

RTOL = 1e-13

VARIANTS = {
    "qubits": {},
    "detuned_sea_center": dict(is_center_rare=False, omega_rf_sea=2 * np.pi * 1e6),
    "spin32_rare": dict(is_spin_three_half=True),
}


def _models(variant, n_sea=4):
    kw = production_params_kwargs(n_sea, t_final=1e-3, steps=11, **VARIANTS[variant])
    return jbuild(JParams(**kw)), tbuild(TParams(**kw))


def _psi(dim, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(dim) + 1j * rng.standard_normal(dim)


def _close(got, want):
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generic_apply_matches_reference(variant):
    jm, tm = _models(variant)
    psi = _psi(jm.hamiltonian.dim)
    want = jm.hamiltonian.apply(Cplx.from_numpy(psi)).to_numpy()
    _close(tm.hamiltonian.apply(torch.as_tensor(psi)).numpy(), want)
    diag = torch.as_tensor(tm.hamiltonian.diagonal_part())
    _close(tm.hamiltonian.apply(torch.as_tensor(psi), diag=diag).numpy(), want)
    _close(want, jm.hamiltonian.to_dense() @ psi)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flip_apply_matches_reference(variant):
    jm, tm = _models(variant)
    jflip = jembed.make_qubit_flip_apply(jm.hamiltonian)
    tflip = tembed.make_qubit_flip_apply(tm.hamiltonian, device="cpu")
    # outside the qubit family both return None and callers use the generic apply
    assert (jflip is None) == (tflip is None) == (variant == "spin32_rare")
    for seed in range(3):
        psi = _psi(jm.hamiltonian.dim, seed)
        want = jdefault(jm.hamiltonian)(Cplx.from_numpy(psi)).to_numpy()
        got = tdefault(tm.hamiltonian, device="cpu")(torch.as_tensor(psi)).numpy()
        _close(got, want)
        if jflip is not None:
            diag = jm.hamiltonian.diagonal_part()
            want = jflip(Cplx.from_numpy(psi), jnp.asarray(diag)).to_numpy()
            _close(tflip(torch.as_tensor(psi), torch.as_tensor(diag)).numpy(), want)


def test_flip_apply_refuses_terms_outside_the_family():
    dims = (2, 2, 2)
    terms = (tembed.ProductTerm(1.0, ((0, "x"), (2, "z"))),)
    assert tembed.make_qubit_flip_apply(tembed.OperatorSum(dims, terms), device="cpu") is None
    jterms = (jembed.ProductTerm(1.0, ((0, "x"), (2, "z"))),)
    assert jembed.make_qubit_flip_apply(jembed.OperatorSum(dims, jterms)) is None
    # the generic apply still takes it, as a dense product would
    H = tembed.OperatorSum(dims, terms + (tembed.ProductTerm(0.3, ((1, "y"), (2, "x"))),))
    psi = _psi(8, seed=5)
    _close(H.apply(torch.as_tensor(psi)).numpy(), H.to_dense() @ psi)


def test_flip_apply_with_only_a_diagonal():
    H = tembed.OperatorSum((2, 2), (tembed.ProductTerm(2.0, ((0, "z"),)),))
    diag = torch.as_tensor(H.diagonal_part())
    psi = torch.as_tensor(_psi(4, seed=1))
    out = tembed.make_qubit_flip_apply(H, device="cpu")(psi, diag)
    assert torch.equal(out, psi * diag)


def test_flip_apply_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    _, tm = _models("qubits", n_sea=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tembed.make_qubit_flip_apply(tm.hamiltonian)
