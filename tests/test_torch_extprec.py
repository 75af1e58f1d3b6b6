"""Port vs reference: the fixed-grid ext limb arithmetic and the dense ext
chain's preamble (CPU).

Both packages get the same seeded limbs or the same model.  Bounds:

  * splits, carries, adds, scalar products, ext_cmatmul (Karatsuba int8
    GEMMs here, XLA int8 dots there), the Taylor-Horner recursion and the
    preamble's limb stacks (seed states S and the step power B): equal bit
    for bit, as integer sums are exact in any order;
  * ext_cmatmul against exact rational arithmetic: the JAX package's
    truncation bound (tests/test_extprec.py:152);
  * the squaring count n_sq from both packages' norm estimates: equal.
"""

import contextlib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, production_params_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import expm_propagator as jep
from quantumsimulations_tpu.dynamics.krylov import spectral_norm_bound as jbound
from quantumsimulations_tpu.dynamics.krylov import spectral_norm_estimate_dense as jdense
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops import extprec as jx
from quantumsimulations_tpu_torch.dynamics import expm_propagator as tep
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.ops import extprec as tx

L = tx.EXT_LIMBS


def _limbs(rng, shape, top=33):
    """Random canonical-range limbs, negative digits included: limb 0 in
    [-top, top] with both extremes present, the others in [-16, 16]."""
    x = rng.integers(-16, 17, (L,) + shape).astype(np.int8)
    x[0] = rng.integers(-top, top + 1, shape)
    x[0].flat[0], x[0].flat[-1] = top, -top
    return x


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got_torch, want_jax):
    np.testing.assert_array_equal(got_torch.numpy(), np.asarray(want_jax))


def test_constants_identical():
    assert (tx.EXT_LIMBS, tx.EXT_GUARD, tx.EXT_E) == (jx.EXT_LIMBS, jx.EXT_GUARD, jx.EXT_E)
    assert all(tx._ext_w(j) == jx._ext_w(j) for j in range(L))
    assert (tep._EXT_THETA, tep._EXT_DEGREE, tep._EXT_OBS_Q, tep._EXT_CHUNK_DIM,
            tep._EXT_ADV_CHUNK) == (jep._EXT_THETA, jep._EXT_DEGREE, jep._EXT_OBS_Q,
                                    jep._EXT_CHUNK_DIM, jep._EXT_ADV_CHUNK)
    for got, want in zip(tep._EXT_PAIRS, jep._EXT_PAIRS):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tx._ext_pairs(L), jx._ext_pairs(L)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tx.taylor_coeff_limbs(10), jx.taylor_coeff_limbs(10))


@pytest.mark.parametrize("shape", [(16, 16), (24, 40), (7,)])
def test_splits_and_value_identical(shape):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.1, 1.1, shape) * 2.0 ** rng.integers(-30, 1, shape)
    _eq(tx.ext_split(_t(x)), jx.ext_split(_j(x)))
    np.testing.assert_array_equal(tx.ext_split_host(x), jx.ext_split_host(x))
    _eq(tx.ext_split_upload(x, device="cpu"), jx.ext_split_upload(x))
    limbs = np.asarray(jx.ext_split(_j(x)))
    _eq(tx.ext_val(_t(limbs)), jx.ext_val(_j(limbs)))


def test_coo_pair_split_identical():
    rng = np.random.default_rng(7)
    dim, nnz = 48, 200
    flat = rng.choice(dim * dim, nnz, replace=False)
    rows, cols = (flat // dim).astype(np.int64), (flat % dim).astype(np.int64)
    va = rng.standard_normal(nnz) * 2.0 ** rng.integers(-40, 3, nnz)
    vb = rng.standard_normal(nnz) * 2.0 ** rng.integers(-40, 3, nnz)
    got = tx.ext_split_upload_coo_pair_host(rows, cols, va, vb, dim, device="cpu")
    want = jx.ext_split_upload_coo_pair_host(rows, cols, va, vb, dim)
    for g, w in zip(got, want):
        _eq(g, w)


def test_upload_helpers_default_to_the_card():
    """Like every entry point of the port, the two upload helpers default to
    device "cuda" and raise where there is none, never falling back to the
    host on their own; device="cpu" is asked for explicitly."""
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    x = np.linspace(-0.5, 0.5, 12).reshape(3, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.ext_split_upload(x)
    r = np.arange(3, dtype=np.int64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.ext_split_upload_coo_pair_host(r, r, x[0, :3], x[1, :3], 4)
    assert tx.ext_split_upload(x, device="cpu").device.type == "cpu"


def test_carries_identical():
    rng = np.random.default_rng(3)
    caps = [int(min(2**26, 32**j)) for j in range(L + tx.EXT_GUARD)]
    d = np.stack([rng.integers(-c, c + 1, size=(8, 8)) for c in caps])
    _eq(tx._ext_carry_i32(torch.tensor(d, dtype=torch.int32)),
        jx._ext_carry_i32(jnp.asarray(d, jnp.int32)))
    _eq(tx._ext_carry(torch.tensor(d, dtype=torch.float64)),
        jx._ext_carry(jnp.asarray(d, jnp.float64)))
    d8 = rng.integers(-48, 49, (L, 6, 5)).astype(np.int8)
    _eq(tx._ext_carry_i8_digits(_t(d8)), jx._ext_carry_i8_digits(_j(d8)))


def test_add_and_neg_identical():
    rng = np.random.default_rng(4)
    a, b = _limbs(rng, (9, 11)), _limbs(rng, (9, 11))
    _eq(tx.ext_add(_t(a), _t(b)), jx.ext_add(_j(a), _j(b)))
    _eq(tx.ext_neg(_t(a)), jx.ext_neg(_j(a)))


@pytest.mark.parametrize("k", [2, 3, 7, 10])
def test_scalar_products_identical(k):
    """The Horner step's a + p * c by a Taylor coefficient's limbs (the
    port's one fused call) and the product by an exact rational scalar."""
    rng = np.random.default_rng(k)
    a, p = _limbs(rng, (10, 12)), _limbs(rng, (10, 12))
    cl = jx.taylor_coeff_limbs(10)[k]
    _eq(tx.ext_axpy_traced(_t(a), _t(p), cl),
        jx.ext_add(_j(a), jx._ext_scalar_mul_traced(_j(p), _j(cl))))
    sl = jx.ext_scalar_limbs(Fraction(1, k))
    assert tx.ext_scalar_limbs(Fraction(1, k)) == sl
    _eq(tx.ext_scalar_mul(_t(a), sl), jx.ext_scalar_mul(_j(a), sl))


@pytest.mark.parametrize("shape,panel", [((12, 12, 12), 12), ((24, 40, 20), 7), ((17, 33, 9), 4),
                                         ((32, 32, 3), 512)])
def test_ext_cmatmul_identical(shape, panel):
    """Karatsuba int8 GEMMs along the concatenated pair K, ragged and padded
    shapes, several column panels: the JAX package's limbs bit for bit."""
    M, K, N = shape
    rng = np.random.default_rng(M * K + N)
    are, aim = _limbs(rng, (M, K)), _limbs(rng, (M, K))
    bre, bim = _limbs(rng, (K, N)), _limbs(rng, (K, N))
    want = jx.ext_cmatmul(_j(are), _j(aim), _j(bre), _j(bim), panel=N)
    got = tx.ext_cmatmul(_t(are), _t(aim), _t(bre), _t(bim), panel=panel)
    for g, w in zip(got, want):
        _eq(g, w)
    left = tx.ext_left(_t(are), _t(aim))  # the prepared left operand: same limbs
    for g, w in zip(tx.ext_cmatmul(left, None, _t(bre), _t(bim)), want):
        _eq(g, w)


def _frac_of(limbs):
    """Exact Fraction value of a limb stack (entrywise)."""
    lf = np.asarray(limbs, dtype=np.float64)
    out = [[Fraction(0)] * lf.shape[2] for _ in range(lf.shape[1])]
    for j in range(lf.shape[0]):
        w = Fraction(2) ** (tx.EXT_E - 5 * (j + 1))
        for r in range(lf.shape[1]):
            for c in range(lf.shape[2]):
                out[r][c] += Fraction(int(lf[j, r, c])) * w
    return out


def test_ext_cmatmul_exact_vs_fractions():
    """The port's ext complex matmul is exact to the JAX package's
    truncation bound, against rational arithmetic."""
    rng = np.random.default_rng(1)
    M = 12
    ar, ai = rng.uniform(-1.1, 1.1, (2, M, M))
    br, bi = rng.uniform(-1.1, 1.1, (2, M, M))
    Are, Aim, Bre, Bim = (tx.ext_split(torch.from_numpy(x)) for x in (ar, ai, br, bi))
    Cre, Cim = tx.ext_cmatmul(Are, Aim, Bre, Bim, panel=5)
    fa_re, fa_im, fb_re, fb_im = map(_frac_of, (Are, Aim, Bre, Bim))
    fc_re, fc_im = _frac_of(Cre), _frac_of(Cim)
    wLG = Fraction(2) ** (tx.EXT_E - 5 * (L + tx.EXT_GUARD + 1))
    wL = Fraction(2) ** (tx.EXT_E - 5 * (L + 1))
    tol = 2 * (L * M * 512 * wLG * 2 + tx.EXT_GUARD * 16 * wL)
    worst = Fraction(0)
    for r in range(M):
        for c in range(M):
            er = sum(fa_re[r][k] * fb_re[k][c] - fa_im[r][k] * fb_im[k][c] for k in range(M))
            ei = sum(fa_re[r][k] * fb_im[k][c] + fa_im[r][k] * fb_re[k][c] for k in range(M))
            worst = max(worst, abs(fc_re[r][c] - er), abs(fc_im[r][c] - ei))
    assert worst < tol, float(worst)


@pytest.mark.parametrize("shape", [(5, 3, 2), (16, 7, 3), (20, 16, 8)])
def test_int_mm_pads_small_and_ragged_operands(shape):
    M, K, N = shape
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(-66, 67, (M, K)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-66, 67, (K, N)).astype(np.int8))
    got = tx.int_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    torch.testing.assert_close(got, a.to(torch.int32) @ b.to(torch.int32), rtol=0, atol=0)


def test_ext_cmatmul_headroom_assert():
    z = torch.zeros((L, 20, 22000), dtype=torch.int8)
    with pytest.raises(AssertionError, match="overflow"):
        tx.ext_cmatmul(z, z, z.transpose(1, 2).contiguous(), z.transpose(1, 2).contiguous())


@pytest.mark.parametrize("chunk", [7, 100])
def test_carry_blocks_change_no_bit(chunk, monkeypatch):
    """The Horner step's a + p * c carried in blocks of a few columns (the
    memory plan that fits dim 16384 on one card) equals the JAX package's
    whole-stack ext_add of its scalar product bit for bit, and the Horner
    recursion on it its whole-stack self (held to the JAX package's
    below)."""
    rng = np.random.default_rng(chunk)
    x = rng.uniform(-0.06, 0.06, (2, 16, 16))
    Are, Aim = (_t(np.asarray(jx.ext_split(_j(v)))) for v in x)
    cl = jx.taylor_coeff_limbs(10)
    whole = tx.ext_taylor_horner(Are, Aim, cl, 10, panel=8)
    monkeypatch.setattr(tx, "_CARRY_CHUNK", chunk)
    a, p = _limbs(rng, (9, 11)), _limbs(rng, (9, 11))
    for k in (2, 7, 10):
        _eq(tx.ext_axpy_traced(_t(a), _t(p), cl[k]),
            jx.ext_add(_j(a), jx._ext_scalar_mul_traced(_j(p), _j(cl[k]))))
    for g, w in zip(tx.ext_taylor_horner(Are, Aim, cl, 10, panel=8), whole):
        assert torch.equal(g, w)


def test_taylor_horner_and_identity_identical():
    rng = np.random.default_rng(5)
    a = rng.uniform(-0.06, 0.06, (2, 24, 24))
    Are, Aim = (np.asarray(jx.ext_split(_j(x))) for x in a)
    cl = jx.taylor_coeff_limbs(10)
    want = jx.ext_taylor_horner(_j(Are), _j(Aim), _j(cl), 10, panel=8)
    got = tx.ext_taylor_horner(_t(Are), _t(Aim), cl, 10, panel=8)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(tx.ext_add_identity(got[0]), jx.ext_add_identity(want[0]))


# ---------------------------------------------------------------------------
# The dense ext chain's preamble: limb stacks on both sides of the split switch
# ---------------------------------------------------------------------------

CASES = {"n4": dict(n_sea=4), "n3-spin32": dict(n_sea=3, is_spin_three_half=True),
         "n4-center-off": dict(n_sea=4, is_center_rare=False)}


def _models(case):
    kw = production_params_kwargs(**CASES[case], t_final=0.01, steps=4)
    return jbuild(JParams(**kw)), tbuild(TParams(**kw))


@pytest.mark.parametrize("dt", [1e-4, 1.5e-3])
@pytest.mark.parametrize("case", list(CASES))
def test_squaring_count_matches(case, dt):
    """n_sq from the port's norm estimates equals the JAX package's, on both
    sides of the split switch (dense float32 power iteration below it, host
    power iteration on the CSR at and above)."""
    mj, mt = _models(case)
    dim = int(np.prod(mt.dims))
    Hd = mj.hamiltonian.to_dense()
    for chunk_dim, jnorm in ((1 << 20, jdense(Hd)), (16, jep._spectral_norm_host(Hd))):
        norm = min(jbound(mj.hamiltonian), jnorm)
        want = max(0, int(np.ceil(np.log2(max(norm * dt, 1e-30) / jep._EXT_THETA))))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tep, "_EXT_CHUNK_DIM", chunk_dim)
            e0, n_sq, dt_s, _ = tep._ext_host_setup(mt.hamiltonian, mt.psi0, dt, dim, "cpu")
        assert n_sq == want
        assert dt_s == dt / 2**want
        # the energy: the same numpy product (the CSR one sums in another order)
        assert np.isclose(e0, float(np.real(np.vdot(mj.psi0, Hd @ mj.psi0))), rtol=1e-13, atol=0.0)


@pytest.mark.parametrize("split", ["dense", "coo"])
def test_preamble_limb_stacks_identical(split, monkeypatch):
    """(S, B) of the port's one loop equal the JAX package's fused program
    (dense float32 triple split, below the switch) and its chunked preamble
    (host canonical COO split, at and above the switch) bit for bit."""
    mj, mt = _models("n4")
    dim = int(np.prod(mt.dims))
    dt, block = 2e-4, 16
    log2_block, pan = 4, 32
    chunk_dim = 1 << 20 if split == "dense" else 16
    monkeypatch.setattr(tep, "_EXT_CHUNK_DIM", chunk_dim)
    monkeypatch.setattr(jep, "_EXT_CHUNK_DIM", chunk_dim)
    _, n_sq, dt_s, op = tep._ext_host_setup(mt.hamiltonian, mt.psi0, dt, dim, "cpu")
    assert op[0] == split
    Are, Aim = tep._ext_split_operator(op, dt_s, dim, "cpu")
    stage = lambda name: contextlib.nullcontext()  # noqa: E731
    got = tep._ext_powers(list(tep._ext_taylor(Are, Aim, pan, stage)), mt.psi0, n_sq, log2_block,
                          pan, stage)

    coeffs = jnp.asarray(jx.taylor_coeff_limbs(jep._EXT_DEGREE))
    psi0 = mj.psi0
    if split == "dense":
        Hd = mj.hamiltonian.to_dense()
        want = jep._ext_expm_program(
            jx.ext_split_upload(Hd.imag * dt_s), jx.ext_split_upload(-Hd.real * dt_s),
            jx.ext_split_upload(np.ascontiguousarray(psi0.real)),
            jx.ext_split_upload(np.ascontiguousarray(psi0.imag)),
            coeffs, n_sq=n_sq, degree=jep._EXT_DEGREE, log2_block=log2_block, panel=pan)
    else:
        r, c, v = mj.hamiltonian.to_coo()
        planes = list(jx.ext_split_upload_coo_pair_host(r, c, v.imag * dt_s, -v.real * dt_s, dim))
        _eq(Are, planes[0])
        _eq(Aim, planes[1])
        want = jep._ext_preamble_chunked(planes, psi0, coeffs, n_sq, log2_block, pan, dim, block,
                                         lambda *a, **k: None)
    for g, w in zip(got, want):
        _eq(g, w)
