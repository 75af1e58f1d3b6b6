"""The 3xTF32 split of cmatmul_f32's CUDA kernel, emulated in plain torch (CPU).

The kernel (quantumsimulations_tpu_torch/csrc/cmatmul_f32.cu) splits every
float32 operand x into hi = tf32_rna(x) and lo = tf32_rna(x - hi), where
tf32_rna rounds as ``cvt.rna.tf32.f32`` does (to nearest, ties away from
zero, the 13 low mantissa bits cleared), and sums hi*hi + hi*lo + lo*hi for
each of the four real products of the complex product.  The emulation below
makes the same split with integer operations on the float32 bits, forms the
twelve products as float32 matmuls and is held within the port's kernel bar,
1e-5 of the output's largest magnitude, against ``cmatmul_f32_plain`` and
against the JAX package's Pallas ``cmatmul_f32`` in interpret mode.  The
emulation lives in this test only; the port's main path never runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.ops.pallas_kernels import cmatmul_f32 as jax_cmatmul_f32
from quantumsimulations_tpu_torch.ops.cmatmul import cmatmul_f32_plain

REL_TOL = 1e-5


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32 as cvt.rna.tf32.f32 rounds finite
    values: add half of the kept part's last unit to the sign-magnitude bits
    and clear the 13 low bits (int32 addition wraps as uint32 addition)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def emulate(ar, ai, br, bi, terms: int = 3):
    """(cr, ci) from the split operands: hi*hi + hi*lo + lo*hi per real
    product (terms=3), or hi*hi alone (terms=1)."""
    (arh, arl), (aih, ail), (brh, brl), (bih, bil) = map(split, (ar, ai, br, bi))

    def prod(ah, al, bh, bl):
        out = ah @ bh
        return out if terms == 1 else al @ bh + ah @ bl + out

    return (prod(arh, arl, brh, brl) - prod(aih, ail, bih, bil),
            prod(arh, arl, bih, bil) + prod(aih, ail, brh, brl))


def _planes(rng, *shape):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


def _rel(got, want):
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err / max(float(w.abs().max()) for w in want)


def test_tf32_rna_is_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20_000) * 10.0 ** rng.integers(-30, 30, 20_000)).astype(np.float32)
    # exact ties: the 13 dropped bits are 0x1000, so the magnitude rounds up
    tie_bits = (rng.integers(0x3F000000, 0x40FFFFFF, 2_000, dtype=np.int64) & ~0x1FFF) | 0x1000
    ties = tie_bits.astype(np.int32).view(np.float32)
    x = np.concatenate([x, ties, -ties, np.float32([0.0, -0.0, 1.0, -1.0])])
    got = tf32_rna(torch.from_numpy(x)).numpy()
    # reference in float64: with x = m 2^e, m in [0.5, 1), the TF32 unit is 2^(e - 11)
    mant, expo = np.frexp(x.astype(np.float64))
    unit = np.ldexp(1.0, expo - 11)
    want = np.sign(x) * np.floor(np.abs(x.astype(np.float64)) / unit + 0.5) * unit
    np.testing.assert_array_equal(got.astype(np.float64), want)
    assert np.all(got.view(np.int32) & 0x1FFF == 0)
    t = torch.from_numpy(ties)
    assert torch.all(tf32_rna(t).abs() > t.abs())  # ties go away from zero


def test_split_recovers_float32_to_2e22():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    hi, lo = split(x)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert float((rest / x.double().abs()).max()) <= 2.0**-22


@pytest.mark.parametrize("shape", [(2, 64, 200, 96), (39, 128, 128, 1680)])
def test_three_tf32_products_meet_the_kernel_bar(shape):
    B, M, K, N = shape
    rng = np.random.default_rng(sum(shape))
    ar, ai = _planes(rng, B, M, K)
    br, bi = _planes(rng, B, K, N)
    got = emulate(ar, ai, br, bi)
    assert _rel(got, cmatmul_f32_plain(ar, ai, br, bi)) <= REL_TOL
    jr, ji = jax.vmap(
        lambda a, b, c, d: jax_cmatmul_f32(a, b, c, d, tm=128, tn=128, tk=128, interpret=True)
    )(*(jnp.asarray(x.numpy()) for x in (ar, ai, br, bi)))
    want = (torch.from_numpy(np.array(jr)), torch.from_numpy(np.array(ji)))
    assert _rel(got, want) <= REL_TOL
    # one TF32 product alone misses the bar: the split is what carries it
    assert _rel(emulate(ar, ai, br, bi, terms=1), want) > 10 * REL_TOL
