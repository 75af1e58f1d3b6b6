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
from quantumsimulations_tpu_torch.kernels import launches
from quantumsimulations_tpu_torch.ops import extprec as tep
from quantumsimulations_tpu_torch.ops import limb_kernels as tlk
from quantumsimulations_tpu_torch.ops import split_apply_ext as tx
from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing

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
    timer = StageTimer()
    with tracing(timer):
        out = tlk.limb_matmul_canon(torch.as_tensor(a), torch.as_tensor(a), bits=BITS)
    assert not launches(timer)
    assert torch.equal(out, tlk.limb_matmul_canon_plain(torch.as_tensor(a), torch.as_tensor(a), BITS))


@pytest.mark.parametrize(
    "bits,n_limbs,M,K,N",
    [
        (5, 15, 40, 64, 24),  # the ext chain's grid: 5-bit limbs, L 15, S 17
        (6, 10, 33, 48, 70),  # the cheb_step ext tier's grid: 6-bit limbs, L 10, S 12
        (5, 15, 16, 37, 1),  # ragged: K not a multiple of 16, M below 17, N 1
        (6, 10, 5, 21, 1),
        (6, 10, 1, 130, 3),
    ],
)
def test_diagonal_gemm_digits_equal_product_digits(bits, n_limbs, M, K, N):
    """Every exact limb product's digits (``extprec.diagonal_mm``: one int8
    GEMM over the diagonal's K range of the concatenated operands) equal the
    plain float64 digits of the limb kernel, bit for bit, for every s; so do
    the ``ext`` tier's whole digit stacks."""
    gen = torch.Generator().manual_seed(bits * 1000 + M + K + N)
    half = 2 ** (bits - 1)
    a = torch.randint(-half, half + 1, (n_limbs, M, K), generator=gen, dtype=torch.int8)
    b = torch.randint(-half, half + 1, (n_limbs, K, N), generator=gen, dtype=torch.int8)
    a[0, 0], b[0, :, 0] = -2 * half, 2 * half  # limb 0 after a carry fold
    want = tlk.product_digits(a, b)
    assert want.shape[0] == n_limbs + tlk.GRID_GUARD
    left, right = tep._cat_k(a), tep._right_rev(b)
    for s in range(n_limbs + tlk.GRID_GUARD):
        got = tep.diagonal_mm(left, right, n_limbs, s)
        assert got.dtype == torch.int32 and torch.equal(got, want[s]), s
    assert torch.equal(tx._product_digits(a, b, n_limbs, K, bits), want)


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


#: the four products of the n13 extp apply (chip_smoke.LIMB_SHAPES) and
#: ragged ones: (M, K, N)
MAIN_PATH_SHAPES = [(256, 128, 256), (1792, 128, 128), (128, 1792, 128), (256, 128, 256)]
RAGGED_SHAPES = [(33, 50, 70), (7, 45, 5), (12, 100, 9), (1, 1, 1), (5, 0, 3), (640, 301, 700),
                 (128, 4096, 64), (2048, 2048, 2048), (40000, 16, 8)]


@pytest.mark.parametrize("M,K,N", MAIN_PATH_SHAPES + RAGGED_SHAPES)
def test_launch_plan_covers_every_tile_once_and_partitions_k(M, K, N):
    plan = tlk.limb_launch_plan(M, K, N)
    # output tiles: a grid that covers M x N with no tile wholly outside it
    assert plan.grid_m * plan.tile_m >= M > (plan.grid_m - 1) * plan.tile_m or M == 0
    assert plan.grid_n * plan.tile_n >= N > (plan.grid_n - 1) * plan.tile_n or N == 0
    assert plan.blocks == plan.grid_m * plan.grid_n * plan.ksplit
    # K slices: whole K steps, contiguous, none empty, covering [0, K)
    assert plan.kslice % plan.k_step == 0 and plan.kslice >= plan.k_step
    slices = plan.k_slices(K)
    assert len(slices) == plan.ksplit
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(b0 == a1 for (_, a1), (b0, _) in zip(slices, slices[1:]))
    assert all(e > b for b, e in slices) or K == 0
    # the kernel's own check of the plan (csrc/limb_matmul_canon.cu)
    assert (plan.ksplit - 1) * plan.kslice < max(K, 1) <= plan.ksplit * plan.kslice or K == 0


@pytest.mark.parametrize("M,K,N", MAIN_PATH_SHAPES)
def test_launch_plan_fills_the_card_on_the_main_path(M, K, N):
    assert tlk.limb_launch_plan(M, K, N).blocks >= tlk.H100_SMS


@pytest.mark.parametrize("bits", [1, 6, 7])
def test_launch_plan_slices_stay_within_the_int32_headroom(bits):
    """The wrapper asserts K * 2^(2*bits) * L < 2^31 for the full K; every
    slice is shorter, so its digit sums (and their sum) stay exact."""
    K = (2**31 - 1) // (2 ** (2 * bits) * L)
    for M, N in [(16, 16), (128, 128)]:
        plan = tlk.limb_launch_plan(M, K, N)
        assert plan.ksplit > 1
        for b, e in plan.k_slices(K):
            assert (e - b) * 2 ** (2 * bits) * L < 2**31


@pytest.mark.parametrize("M,K,N", [(128, 1792, 128), (12, 100, 9), (256, 128, 256)])
def test_split_k_digit_sums_equal_the_whole_k(M, K, N):
    """What the kernel's last-arriving block does: the int32 digits of each
    K slice, summed, then one carry, equal the plain version bit for bit."""
    rng = np.random.default_rng(M + K + N)
    _, a = _canon(rng, (M, K))
    _, b = _canon(rng, (K, N))
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    plan = tlk.limb_launch_plan(M, K, N)
    assert plan.ksplit > 1
    digits = sum(tlk.product_digits(at[:, :, s:e].contiguous(), bt[:, s:e].contiguous())
                 for s, e in plan.k_slices(K))
    np.testing.assert_array_equal(tlk.carry_digits(digits, BITS, L).numpy(),
                                  tlk.limb_matmul_canon_plain(at, bt, BITS).numpy())
