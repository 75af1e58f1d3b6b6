"""Port vs reference: the int8-limb split apply (ops/split_apply_limb.py)
and the ``limb`` tier of the Chebyshev stepper, on the CPU.

Bounds: the limb apply within 2e-15 of the dense matvec's largest
magnitude (tests/test_cheb_step.py:131's bar) and within 2e-15 of the JAX
package's limb apply (both float64-rounding off the exact product, summed
in another order); the limb tier's rows within 1e-12 of the port's f64
tier and of the JAX package's limb tier, and within 5e-12 of the eig route
(tests/test_cheb_step.py:125).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, production_params_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import cheb_step as jcs
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops import split_apply_limb as jsl
from quantumsimulations_tpu.ops.cplx import Cplx
from quantumsimulations_tpu_torch.dynamics import cheb_step as tcs
from quantumsimulations_tpu_torch.dynamics import eig_propagator as teig
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.ops import split_apply_limb as tsl

CASES = {
    "n4": dict(n_sea=4),
    "n3-spin32": dict(n_sea=3, is_spin_three_half=True),
    "n4-center-off": dict(n_sea=4, is_center_rare=False),
}


def _models(case):
    kw = production_params_kwargs(**CASES[case], t_final=0.01, steps=4)
    return jbuild(JParams(**kw)), tbuild(TParams(**kw))


@pytest.mark.parametrize("case", list(CASES))
def test_split_apply_limb_matches_dense_matvec_and_reference(case):
    mj, mt = _models(case)
    ap, so = tsl.make_split_apply_limb(mt.hamiltonian, scale=0.25, device="cpu")
    rng = np.random.default_rng(7)
    psi = rng.standard_normal(so.DL * so.DR) + 1j * rng.standard_normal(so.DL * so.DR)
    re, im = ap(torch.as_tensor(psi.real.reshape(so.DL, so.DR)),
                torch.as_tensor(psi.imag.reshape(so.DL, so.DR)))
    got = (re.numpy() + 1j * im.numpy()).reshape(-1)
    ref = 0.25 * (mt.hamiltonian.to_dense() @ psi)
    bound = 2e-15 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    aj, _ = jsl.make_split_apply_limb(mj.hamiltonian, scale=0.25)
    out = aj(Cplx(jnp.asarray(psi.real.reshape(so.DL, so.DR)),
                  jnp.asarray(psi.imag.reshape(so.DL, so.DR))))
    want = (np.asarray(out.re) + 1j * np.asarray(out.im)).reshape(-1)
    assert np.abs(got - want).max() <= bound


def test_split_apply_limb_checks_int32_headroom():
    from quantumsimulations_tpu_torch.ops.embed import OperatorSum, ProductTerm

    H = OperatorSum((2, 2), (ProductTerm(1.0, ((0, "x"), (1, "x"))),))
    with pytest.raises(ValueError, match="overflows int32"):
        tsl.make_split_apply_limb(H, limb_bits=14, device="cpu")


@pytest.mark.parametrize("case", ["n4", "n3-spin32"])
def test_limb_tier_matches_f64_eig_and_reference(case):
    mj, mt = _models(case)
    t = np.linspace(0.0, 1.0e-4, 3)
    args = (t, mt.dims, mt.n_sea_effective, mt.idx_rare)
    rows = tcs.chebyshev_step_traces(mt.hamiltonian, mt.psi0, *args, arithmetic="limb", device="cpu")
    f64 = tcs.chebyshev_step_traces(mt.hamiltonian, mt.psi0, *args, arithmetic="f64", device="cpu")
    ref = jcs.chebyshev_step_traces(mj.hamiltonian, mj.psi0, *args, arithmetic="limb")
    w, V = teig.eigh_host(mt.hamiltonian.to_dense())
    exact = teig.eig_traces_assembled_batched(
        w[None], V[None], mt.psi0[None], t, mt.dims, np.asarray([mt.n_sea_effective]),
        mt.idx_rare, device="cpu")[0]
    assert np.abs(rows[:7] - f64[:7]).max() <= 1e-12
    assert np.abs(rows[:7] - ref[:7]).max() <= 1e-12
    assert np.abs(rows[:7] - exact[:7]).max() <= 5e-12
    np.testing.assert_allclose(rows[7], ref[7], rtol=1e-9)
