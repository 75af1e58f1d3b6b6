"""Port vs reference: the limb-domain matmul ``limb_matmul_canon`` (CPU).

On the CPU the port's wrapper runs its plain PyTorch version (exact float64
matmuls of the limb pairs, int32 digits, the carry cascade); the JAX
package's Pallas kernel runs in interpret mode, as tests/test_limb_kernels.py
runs it.  Integer results are compared bit for bit (``assert_array_equal``):
int32 sums are exact in any order, so there is no tolerance to argue.  The
value-grade check against the float64 product keeps the JAX package's bound
(2e-15, tests/test_limb_kernels.py:69).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.ops import limb_kernels as jlk
from quantumsimulations_tpu.ops import split_apply_ext as jx
from quantumsimulations_tpu_torch.kernels import launch_counts
from quantumsimulations_tpu_torch.ops import limb_kernels as tlk
from quantumsimulations_tpu_torch.ops import split_apply_ext as tx

BITS, L = jx.GRID_BITS, jx.GRID_LIMBS


def _canon(rng, shape, scale=0.3):
    """Canonical limbs of random values, negative ones included."""
    x = scale * rng.standard_normal(shape)
    return x, jx._split_host(x, BITS, L)


def _both(a, b, **kw):
    got = tlk.limb_matmul_canon(torch.as_tensor(a), torch.as_tensor(b), bits=BITS, **kw)
    want = jlk.limb_matmul_canon(jnp.asarray(a), jnp.asarray(b), bits=BITS, interpret=True, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize(
    "M,K,N", [(48, 32, 40), (33, 17, 70), (5, 130, 3), (128, 64, 128), (1, 1, 1)]
)
def test_plain_matches_pallas_interpret(M, K, N):
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    _, a = _canon(rng, (M, K))
    _, b = _canon(rng, (K, N))
    got, want = _both(a, b)
    assert got.dtype == np.int8 and got.shape == (L, M, N)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tm,A,K,N", [(16, 3, 16, 24), (8, 6, 8, 8), (32, 2, 40, 50)])
def test_transpose_out_matches_pallas_interpret(tm, A, K, N):
    rng = np.random.default_rng(tm + A + K + N)
    _, a = _canon(rng, (A * tm, K))
    _, b = _canon(rng, (K, N))
    got, want = _both(a, b, tm=tm, transpose_out=True)
    assert got.shape == (L, tm, A * N)
    np.testing.assert_array_equal(got, want)
    plain = tlk.limb_matmul_canon(torch.as_tensor(a), torch.as_tensor(b), bits=BITS).numpy()
    for i in range(A):
        np.testing.assert_array_equal(got[:, :, i * N:(i + 1) * N], plain[:, i * tm:(i + 1) * tm, :])


@pytest.mark.parametrize("seed", [0, 1])
def test_extreme_and_negative_limbs_match(seed):
    """Full-range int8 limbs (not canonical): large negative digits through
    the arithmetic shift, and limb 0 wrapping to int8 in both packages."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, size=(L, 24, 20)).astype(np.int8)
    b = rng.integers(-128, 128, size=(L, 20, 36)).astype(np.int8)
    a[:, 0, :] = -128  # the most negative products
    b[:, :, 0] = 127
    got, want = _both(a, b)
    np.testing.assert_array_equal(got, want)


def test_carry_matches_reference_on_negative_digits():
    rng = np.random.default_rng(11)
    d = rng.integers(-(2**27), 2**27, size=(L + 2, 7, 9)).astype(np.int32)
    d[:, 0, 0] = -(2**27)
    ops_j, ops_t = jx._make_grid_ops(BITS, L), tx._make_grid_ops(BITS, L)
    np.testing.assert_array_equal(ops_t.carry(torch.as_tensor(d)).numpy(),
                                  np.asarray(ops_j.carry(jnp.asarray(d))))
    np.testing.assert_array_equal(tlk.carry_digits(torch.as_tensor(d), BITS, L).numpy(),
                                  np.asarray(ops_j.carry(jnp.asarray(d)))[:L])


def test_headroom_assert_raises_in_both():
    K = 2**31 // (2 ** (2 * BITS) * L) + 1
    a = np.zeros((L, 1, K), np.int8)
    b = np.zeros((L, K, 1), np.int8)
    with pytest.raises(AssertionError, match="i32 would overflow"):
        jlk.limb_matmul_canon(jnp.asarray(a), jnp.asarray(b), bits=BITS, interpret=True)
    with pytest.raises(AssertionError, match="i32 would overflow"):
        tlk.limb_matmul_canon(torch.as_tensor(a), torch.as_tensor(b), bits=BITS)


def test_value_grade_against_float64_product():
    rng = np.random.default_rng(3)
    xa, a = _canon(rng, (64, 48), 0.2)
    xb, b = _canon(rng, (48, 32), 0.2)
    ops = tx._make_grid_ops(BITS, L)
    got = ops.val(tlk.limb_matmul_canon(torch.as_tensor(a), torch.as_tensor(b), bits=BITS))
    assert np.abs(got.numpy() - xa @ xb).max() < 2e-15


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(5)
    _, a = _canon(rng, (16, 16))
    before = launch_counts["limb_matmul_canon"]
    out = tlk.limb_matmul_canon(torch.as_tensor(a), torch.as_tensor(a), bits=BITS)
    assert launch_counts["limb_matmul_canon"] == before
    assert torch.equal(out, tlk.limb_matmul_canon_plain(torch.as_tensor(a), torch.as_tensor(a), BITS))


@pytest.mark.parametrize("bad", ["dtype", "noncontiguous", "shape", "transpose_tile"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros((L, 48, 16), dtype=torch.int8)
    b = torch.zeros((L, 16, 8), dtype=torch.int8)
    kw = {}
    if bad == "dtype":
        a, err = a.to(torch.int32), TypeError
    elif bad == "noncontiguous":
        b, err = torch.zeros((L, 8, 16), dtype=torch.int8).transpose(1, 2), ValueError
    elif bad == "shape":
        b, err = torch.zeros((L, 15, 8), dtype=torch.int8), ValueError
    else:
        kw, err = dict(tm=32, transpose_out=True), ValueError
    with pytest.raises(err):
        tlk.limb_matmul_canon(a, b, bits=BITS, **kw)


def test_live_pairs_count():
    assert tlk.live_pairs(L) == 72
