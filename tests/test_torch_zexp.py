"""Port vs reference: the fused per-site z expectations (``ops/zexp.py``,
kernel 4 of the kernel table) on the CPU, where the wrapper runs its plain
version.

The JAX function runs its Pallas kernel in interpret mode, as
tests/test_pallas_kernels.py:41-65 runs it.  Tolerances: the sign table
equal element for element; the plain version within 1e-5 absolute of the
JAX kernel and of a float64 numpy reference on normalised states (the JAX
test's bar: the JAX kernel sums the float32 products in float32, the plain
version in float64, rounding once).

The CUDA kernel's launch plan (``zexp_launch_plan``, pure Python) is checked
here too: every column in one tile, the row slices a partition, two blocks
per SM at the n14 shapes, the workspace its size; and a float64 emulation of
the kernel's split summation under the plan (slice sums, cluster sums in
rank order, the clusters' partials in order, one rounding) is held within
1e-5 of the largest output of the plain version and of the JAX function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.ops import pallas_kernels as jpk
from quantumsimulations_tpu_torch.kernels import launches
from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing
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
    timer = StageTimer()
    with tracing(timer):
        got = zexp.z_expectations_f32(*args)
    assert torch.equal(got, zexp.z_expectations_f32_plain(*args))
    assert not launches(timer)  # no kernel launch on the host


def test_wrapper_rejects_malformed_input():
    re = torch.zeros((16, 3), dtype=torch.float64)
    signs = torch.as_tensor(zexp.z_sign_table((2,) * 4))
    with pytest.raises(TypeError):
        zexp.z_expectations_f32(re, re.float(), signs)
    with pytest.raises(ValueError):
        zexp.z_expectations_f32(re, re[:8], signs)
    with pytest.raises(ValueError):
        zexp.z_expectations_f32(re[:8], re[:8], signs)


# --- the CUDA kernel's launch plan and its split summation, on the CPU ------

#: (n, dim, T, itemsize): the smoke's shapes, the route's, a wide-site one
#: and ragged ones (T 1, 33, 2049; dim 16)
PLAN_SHAPES = [(14, 16384, 21, 8), (14, 16384, 2048, 8), (7, 128, 20000, 4), (4, 16, 37, 8),
               (16, 65536, 64, 4), (14, 16384, 1, 8), (14, 16384, 33, 8), (14, 16384, 2049, 8),
               (4, 16, 1, 8), (4, 16, 33, 4), (1, 16, 2049, 4), (16, 4096, 128, 8)]


def _column_ranges(plan):
    """Columns of each block column tile, as the kernel indexes them."""
    w = plan.tile_cols
    return [(i * w, min(plan.T, (i + 1) * w)) for i in range(plan.col_tiles)]


def _row_ranges(plan):
    """Rows of each row slice, as the kernel indexes them (cut at dim)."""
    r = plan.slice_rows
    return [(min(plan.dim, s * r), min(plan.dim, (s + 1) * r)) for s in range(plan.row_slices)]


@pytest.mark.parametrize("n,dim,T,itemsize", PLAN_SHAPES)
def test_launch_plan_covers_every_output_once(n, dim, T, itemsize):
    plan = zexp.zexp_launch_plan(n, dim, T, itemsize)
    cols = [c for a, b in _column_ranges(plan) for c in range(a, b)]
    assert cols == list(range(T))  # every column in exactly one tile
    ranges = [r for r in _row_ranges(plan) if r[1] > r[0]]
    assert ranges[0][0] == 0 and ranges[-1][1] == dim
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # slices partition [0, dim)
    assert all(a == b == dim for a, b in _row_ranges(plan)[len(ranges):])  # then only empty ones
    assert plan.threads <= 128 and plan.tile_cols <= 128
    assert plan.cols in (1, 2) and (plan.cols == 1 or T % 2 == 0)
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.row_slices % plan.cluster == 0
    assert plan.row_slices <= 65535
    if (n, dim) == (14, 16384) and T in (21, 2048):
        assert plan.blocks >= 264  # two blocks per SM of an H100, at least


@pytest.mark.parametrize("n,dim,T,itemsize", PLAN_SHAPES)
def test_launch_plan_workspace_matches_the_plan(n, dim, T, itemsize):
    plan = zexp.zexp_launch_plan(n, dim, T, itemsize)
    stride = plan.tile_stride
    assert stride % 2 == 0 and n * plan.tile_cols <= stride <= n * plan.tile_cols + 1
    if plan.partials > 1:
        assert plan.workspace_doubles == stride * plan.col_tiles * plan.partials
        assert plan.counters == plan.col_tiles
    else:
        assert plan.workspace_doubles == plan.counters == 0


def test_launch_plan_vector_width_follows_alignment():
    assert zexp.zexp_launch_plan(14, 16384, 2048, 8).cols == 2
    assert zexp.zexp_launch_plan(14, 16384, 2048, 8, align=8).cols == 1
    assert zexp.zexp_launch_plan(7, 128, 20000, 4, align=8).cols == 2
    assert zexp.zexp_launch_plan(7, 128, 20000, 4, align=4).cols == 1
    with pytest.raises(ValueError):
        zexp.zexp_launch_plan(17, 16, 4, 8)


def _split_sum(re, im, signs, plan):
    """float64 emulation of the kernel's summation under ``plan``: each
    slice's sums over its rows, each cluster's sum of its slices in rank
    order, the clusters' partials added in order from 0.0, rounded once to
    float32."""
    p2 = (re * re + im * im).astype(np.float32).astype(np.float64)
    s32 = signs.astype(np.float32).astype(np.float64)
    parts = [s32[:, a:b] @ p2[a:b] for a, b in _row_ranges(plan)]
    c = plan.cluster
    clusters = [sum(parts[k * c + 1:(k + 1) * c], parts[k * c]) for k in range(plan.partials)]
    total = np.zeros_like(clusters[0])
    for x in clusters:
        total = total + x
    return total.astype(np.float32)


@pytest.mark.parametrize("n,dim,T,dtype", [(14, 16384, 21, np.float64),
                                           (7, 128, 2000, np.float32)])
def test_split_summation_matches_plain_and_reference(n, dim, T, dtype):
    rng = np.random.default_rng(n * dim + T)
    re, im = (rng.standard_normal((dim, T)).astype(dtype) for _ in range(2))
    signs = zexp.z_sign_table((2,) * n)
    plan = zexp.zexp_launch_plan(n, dim, T, np.dtype(dtype).itemsize)
    got = _split_sum(re, im, signs, plan)
    plain = zexp.z_expectations_f32_plain(torch.as_tensor(re), torch.as_tensor(im),
                                          torch.as_tensor(signs)).numpy()
    want = np.asarray(jpk.z_expectations_f32(jnp.asarray(re), jnp.asarray(im), jnp.asarray(signs),
                                             interpret=True))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-5 * scale
    assert np.abs(got - want).max() <= 1e-5 * scale
