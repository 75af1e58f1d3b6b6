"""The fused complex-f32 matmul: port vs the Pallas kernel, and the CUDA kernel.

On the CPU the wrapper runs its plain PyTorch version; it is held against
``cmatmul_f32(..., interpret=True)`` at the shapes of
tests/test_pallas_kernels.py with the same bound, 5e-4 of the output's
largest magnitude (float32 sums in another order on both sides).

The kernel itself is tested on the card in tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.ops.pallas_kernels import cmatmul_f32 as jax_cmatmul_f32
from quantumsimulations_tpu_torch.kernels import launches
from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing
from quantumsimulations_tpu_torch.ops.cmatmul import cmatmul_f32, cmatmul_f32_plain


def _planes(rng, *shape):
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x.real.copy(), x.imag.copy()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 200, 96), (300, 513, 130)])
def test_plain_matches_pallas_interpret(shape):
    M, K, N = shape
    rng = np.random.default_rng(9 + M)
    ar, ai = _planes(rng, M, K)
    br, bi = _planes(rng, K, N)
    jr, ji = jax_cmatmul_f32(
        jnp.asarray(ar), jnp.asarray(ai), jnp.asarray(br), jnp.asarray(bi),
        tm=64, tn=128, tk=128, interpret=True,
    )
    want = np.asarray(jr) + 1j * np.asarray(ji)
    timer = StageTimer()
    with tracing(timer):
        cr, ci = cmatmul_f32(_t(ar), _t(ai), _t(br), _t(bi))
    assert not launches(timer)  # CPU tensors launch nothing
    assert cr.dtype == ci.dtype == torch.float32 and cr.shape == (M, N)
    got = cr.numpy() + 1j * ci.numpy()
    assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()


def test_batched_plain_matches_pallas_per_entry():
    rng = np.random.default_rng(11)
    B, M, K, N = 3, 40, 72, 50
    ar, ai = _planes(rng, B, M, K)
    br, bi = _planes(rng, B, K, N)
    cr, ci = cmatmul_f32(_t(ar), _t(ai), _t(br), _t(bi))
    assert cr.shape == (B, M, N)
    for b in range(B):
        jr, ji = jax_cmatmul_f32(
            jnp.asarray(ar[b]), jnp.asarray(ai[b]), jnp.asarray(br[b]), jnp.asarray(bi[b]),
            tm=64, tn=128, tk=128, interpret=True,
        )
        want = np.asarray(jr) + 1j * np.asarray(ji)
        got = cr[b].numpy() + 1j * ci[b].numpy()
        assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()


def test_plain_matches_complex_matmul_exactly_in_structure():
    rng = np.random.default_rng(2)
    ar, ai = _planes(rng, 7, 5)
    br, bi = _planes(rng, 5, 3)
    cr, ci = cmatmul_f32_plain(_t(ar), _t(ai), _t(br), _t(bi))
    want = (ar.astype(np.float64) + 1j * ai) @ (br.astype(np.float64) + 1j * bi)
    assert np.allclose(cr.numpy(), want.real, rtol=0, atol=1e-5)
    assert np.allclose(ci.numpy(), want.imag, rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape_re_im", "contraction", "batch", "ndim", "noncontiguous"],
)
def test_wrapper_rejects_bad_inputs(bad):
    rng = np.random.default_rng(3)
    a = [_t(x) for x in _planes(rng, 2, 4, 6)]
    b = [_t(x) for x in _planes(rng, 2, 6, 5)]
    if bad == "dtype":
        a[0] = a[0].double()
    elif bad == "shape_re_im":
        a[1] = a[1][:, :3]
    elif bad == "contraction":
        b = [x[:, :5].contiguous() for x in b]
    elif bad == "batch":
        b = [x[:1] for x in b]
    elif bad == "ndim":
        a = [x[0] for x in a]
    elif bad == "noncontiguous":
        b = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in b]
    with pytest.raises((TypeError, ValueError)):
        cmatmul_f32(a[0], a[1], b[0], b[1])
