"""Port vs reference: the fused per-site z expectations (``ops/zexp.py``,
kernel 4 of the kernel table) on the CPU, where the wrapper runs its plain
version.

The JAX function runs its Pallas kernel in interpret mode, as
tests/test_pallas_kernels.py:41-65 runs it.  Tolerances: the sign table
equal element for element; the plain version within 1e-5 absolute of the
JAX kernel and of a float64 numpy reference on normalised states (the JAX
test's bar: the JAX kernel sums the float32 products in float32, the plain
version in float64, rounding once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.ops import pallas_kernels as jpk
from quantumsimulations_tpu_torch.kernels import launch_counts
from quantumsimulations_tpu_torch.ops import zexp


@pytest.mark.parametrize("dims", [(2, 2, 4), (2,) * 5, (4,), (2, 2, 2, 2, 2, 2, 2)])
def test_sign_table_equals_reference(dims):
    got = zexp.z_sign_table(dims)
    np.testing.assert_array_equal(got, jpk.z_sign_table(dims))
    assert got.shape == (len(dims), int(np.prod(dims))) and got.dtype == np.float64


def _states(dim, T, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((dim, T)) + 1j * rng.standard_normal((dim, T))
    return psi / np.linalg.norm(psi, axis=0, keepdims=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims,T", [((2, 2, 2, 2), 37), ((2, 2, 4), 5), ((2,) * 7, 130)])
def test_plain_matches_reference_kernel(dims, T, dtype):
    dim = int(np.prod(dims))
    psi = _states(dim, T, seed=dim + T)
    re, im = psi.real.astype(dtype), psi.imag.astype(dtype)
    signs = zexp.z_sign_table(dims)
    want = np.asarray(jpk.z_expectations_f32(jnp.asarray(re), jnp.asarray(im),
                                             jnp.asarray(signs), interpret=True))
    got = zexp.z_expectations_f32_plain(torch.as_tensor(re), torch.as_tensor(im),
                                        torch.as_tensor(signs))
    assert got.dtype == torch.float32 and got.shape == (len(dims), T)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert np.abs(got.numpy() - signs @ (np.abs(psi) ** 2)).max() <= 1e-5


def test_wrapper_runs_the_plain_version_on_cpu():
    psi = _states(32, 9, seed=1)
    args = (torch.as_tensor(psi.real), torch.as_tensor(psi.imag),
            torch.as_tensor(zexp.z_sign_table((2,) * 5)))
    before = dict(launch_counts)
    assert torch.equal(zexp.z_expectations_f32(*args), zexp.z_expectations_f32_plain(*args))
    assert launch_counts == before  # no kernel launch on the host


def test_wrapper_rejects_malformed_input():
    re = torch.zeros((16, 3), dtype=torch.float64)
    signs = torch.as_tensor(zexp.z_sign_table((2,) * 4))
    with pytest.raises(TypeError):
        zexp.z_expectations_f32(re, re.float(), signs)
    with pytest.raises(ValueError):
        zexp.z_expectations_f32(re, re[:8], signs)
    with pytest.raises(ValueError):
        zexp.z_expectations_f32(re[:8], re[:8], signs)
