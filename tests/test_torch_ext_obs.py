"""Port vs reference: the int8 limb-pair observable sums (CPU).

The port's plain version ``ext_obs_diagonals_plain`` (what its wrapper runs
on a CPU tensor, and what the CUDA kernel is held against on the card) must
equal the JAX package's Pallas kernel ``ext_obs_diagonals_int8`` in
interpret mode bit for bit: int32 sums are exact in any order.  The float64
observables built on them (``_ext_site_obs_fused``) and the general-dims
reduction (``_ext_site_obs``, spin-3/2 rare spins) agree with the JAX
package's within 1e-13 (tests/test_extprec.py:312-339).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.dynamics import expm_propagator as jep
from quantumsimulations_tpu.ops import extprec as jx
from quantumsimulations_tpu.ops.pallas_kernels import ext_obs_diagonals_int8 as jkernel
from quantumsimulations_tpu_torch.dynamics import expm_propagator as tep
from quantumsimulations_tpu_torch.kernels import launch_counts
from quantumsimulations_tpu_torch.ops import ext_obs as tobs

JJ, II, _ = jep._EXT_PAIRS


def _limbs(rng, shape):
    """Random canonical-range limbs, negative digits included, limb 0 at
    its full range [-33, 33] with both extremes present."""
    x = rng.integers(-16, 17, (15,) + shape).astype(np.int8)
    x[0] = rng.integers(-33, 34, shape)
    x[0].flat[0], x[0].flat[-1] = 33, -33
    return x


@pytest.mark.parametrize("shape,t_tile", [((16, 128), 128), ((32, 256), 128), ((16, 200), 8)])
def test_plain_equals_pallas_interpret(shape, t_tile):
    rng = np.random.default_rng(shape[0] + shape[1])
    S_re, S_im = _limbs(rng, shape), _limbs(rng, shape)
    want = np.asarray(jkernel(jnp.asarray(S_re), jnp.asarray(S_im), jnp.asarray(JJ),
                              jnp.asarray(II), n_diag=11, t_tile=t_tile, interpret=True))
    got = tobs.ext_obs_diagonals_plain(torch.from_numpy(S_re), torch.from_numpy(S_im), JJ, II, 11)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(3)
    S_re, S_im = (torch.from_numpy(_limbs(rng, (8, 40))) for _ in range(2))
    before = dict(launch_counts)
    got = tobs.ext_obs_diagonals_int8(S_re, S_im, JJ, II, n_diag=11, t_tile=128, interpret=True)
    assert launch_counts == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, tobs.ext_obs_diagonals_plain(S_re, S_im, JJ, II, 11),
                               rtol=0, atol=0)
    assert got.shape == (11, 16, 40)  # R = 3*3 + 1 rounded up to 8


def test_asserts_kept():
    z = torch.zeros((15, 24, 8), dtype=torch.int8)
    with pytest.raises(AssertionError, match="power-of-two"):
        tobs.ext_obs_diagonals_int8(z, z, JJ, II, 11)
    big = torch.zeros((1, 1 << 18, 1), dtype=torch.int8)
    with pytest.raises(AssertionError, match="overflow"):
        tobs.ext_obs_diagonals_int8(big, big, JJ, II, 11)
    with pytest.raises(TypeError):
        tobs.ext_obs_diagonals_int8(z.to(torch.int32), z, JJ, II, 11)


def test_pair_table_check_of_the_cuda_path():
    assert tobs._is_triangle(JJ, II, 11)
    assert tobs._is_triangle(JJ[::-1], II[::-1], 11)  # any order: int32 sums commute
    assert not tobs._is_triangle(JJ[:-1], II[:-1], 11)
    assert not tobs._is_triangle(JJ, II, 10)


def _states(rng, dim, T):
    psis = rng.standard_normal((dim, T)) + 1j * rng.standard_normal((dim, T))
    psis /= np.linalg.norm(psis, axis=0, keepdims=True)
    return (np.array(jx.ext_split(jnp.asarray(psis.real))),
            np.array(jx.ext_split(jnp.asarray(psis.imag))))


@pytest.mark.parametrize("dims", [(2, 2, 2, 2), (2, 2, 2, 2, 2)])
def test_fused_site_obs_matches_reference(dims):
    rng = np.random.default_rng(7)
    S_re, S_im = _states(rng, int(np.prod(dims)), 128)
    xyz_j, nr_j = jep._ext_site_obs_fused(jnp.asarray(S_re), jnp.asarray(S_im), dims)
    xyz_t, nr_t = tep._ext_site_obs_fused(torch.from_numpy(S_re), torch.from_numpy(S_im), dims)
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), rtol=0, atol=1e-13)
    np.testing.assert_allclose(nr_t.numpy(), np.asarray(nr_j), rtol=0, atol=1e-13)
    np.testing.assert_allclose(nr_t.numpy(), 1.0, rtol=0, atol=1e-12)  # normalised states


@pytest.mark.parametrize("dims", [(2, 2, 2, 2), (2, 2, 2, 4), (4, 2, 2)])
def test_site_obs_matches_reference(dims):
    """The general-dims reduction, spin-3/2 sites included, and (all-spin-1/2)
    the fused path on the same limbs."""
    rng = np.random.default_rng(11)
    S_re, S_im = _states(rng, int(np.prod(dims)), 24)
    xyz_j, nr_j = jep._ext_site_obs(jnp.asarray(S_re), jnp.asarray(S_im), dims)
    xyz_t, nr_t = tep._ext_site_obs(torch.from_numpy(S_re), torch.from_numpy(S_im), dims)
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), rtol=0, atol=1e-13)
    np.testing.assert_allclose(nr_t.numpy(), np.asarray(nr_j), rtol=0, atol=1e-13)
    if all(d == 2 for d in dims):
        xyz_f, nr_f = tep._ext_site_obs_fused(torch.from_numpy(S_re), torch.from_numpy(S_im), dims)
        np.testing.assert_allclose(xyz_f.numpy(), xyz_t.numpy(), rtol=0, atol=1e-13)
        np.testing.assert_allclose(nr_f.numpy(), nr_t.numpy(), rtol=0, atol=1e-13)
