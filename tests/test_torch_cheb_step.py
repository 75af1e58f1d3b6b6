"""Port vs reference: the beyond-dense Chebyshev stepper and its modules (CPU).

Both packages get the same model (built from the same parameters; the
operator IR is host numpy in both) and the same seeded inputs.  Bounds:

  * host decompositions (diagonal, off-diagonal terms, COO triplet, split
    planes, Chebyshev coefficients, lambda): equal bit for bit — the same
    numpy/scipy operations;
  * float64 split apply, fused and unfused: 1e-13 of the output's largest
    magnitude (matmuls summed in another order);
  * limb grid (split, carry, val) and the ``ext`` / ``extp`` apply outputs:
    bit-identical (integer digit sums are exact in any order; the JAX
    Pallas kernel runs in interpret mode);
  * stepper rows: 1e-12 against the JAX package's rows for every tier, and
    5e-12 against the port's eig route (tests/test_cheb_step.py:125);
  * checkpoint resume: bit-identical.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, production_params_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import cheb_step as jcs
from quantumsimulations_tpu.dynamics import checkpoint as jck
from quantumsimulations_tpu.dynamics.chebyshev import chebyshev_coefficients as jcoef
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu.ops import split_apply as jsa
from quantumsimulations_tpu.ops import split_apply_ext as jx
from quantumsimulations_tpu.ops.cplx import Cplx
from quantumsimulations_tpu_torch.dynamics import cheb_step as tcs
from quantumsimulations_tpu_torch.dynamics import checkpoint as tck
from quantumsimulations_tpu_torch.dynamics import eig_propagator as teig
from quantumsimulations_tpu_torch.dynamics.chebyshev import chebyshev_coefficients as tcoef
from quantumsimulations_tpu_torch.dynamics.evolve import _auto_method, simulate_rare
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.ops import split_apply as tsa
from quantumsimulations_tpu_torch.ops import split_apply_ext as tx

CASES = {
    "n5": dict(n_sea=5),
    "n6-spin32": dict(n_sea=6, is_spin_three_half=True),
    "n5-center-off": dict(n_sea=5, is_center_rare=False),
}
LAM = 2.6e6
#: output times of the stepper comparisons: 3 steps of 5e-5 s (about 200
#: Chebyshev terms per step at n_sea=5), short enough for the CPU
TIMES = np.linspace(0.0, 1.0e-4, 3)


def _models(case):
    kw = production_params_kwargs(**CASES[case], t_final=0.01, steps=4)
    return jbuild(JParams(**kw)), tbuild(TParams(**kw))


def _psi(dim, seed=0):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    return psi / np.linalg.norm(psi)


@pytest.mark.parametrize("case", list(CASES))
def test_operator_decomposition_identical(case):
    mj, mt = _models(case)
    Hj, Ht = mj.hamiltonian, mt.hamiltonian
    assert np.array_equal(Ht.diagonal_part(), Hj.diagonal_part())
    assert [(t.coeff, t.factors) for t in Ht.offdiagonal_terms()] == [
        (t.coeff, t.factors) for t in Hj.offdiagonal_terms()
    ]
    for got, want in zip(Ht.to_coo(), Hj.to_coo()):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_split_operator_planes_identical(case):
    mj, mt = _models(case)
    so_t, so_j = tsa.split_operator(mt.hamiltonian), jsa.split_operator(mj.hamiltonian)
    assert (so_t.split, so_t.DL, so_t.DR) == (so_j.split, so_j.DL, so_j.DR)
    for f in ("diag", "HL_re", "HL_im", "HR_re", "HR_im",
              "cross_re_L", "cross_re_R", "cross_im_L", "cross_im_R"):
        assert np.array_equal(getattr(so_t, f), getattr(so_j, f)), f
    assert tsa.default_split((2,) * 14) == jsa.default_split((2,) * 14) == 7


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_split_apply_matches_reference(case, fused):
    mj, mt = _models(case)
    at, so = tsa.make_split_apply(mt.hamiltonian, scale=1.0 / LAM, fused=fused, device="cpu")
    aj, _ = jsa.make_split_apply(mj.hamiltonian, scale=1.0 / LAM, fused=fused)
    psi = _psi(so.DL * so.DR).reshape(so.DL, so.DR)
    got_re, got_im = at(torch.as_tensor(psi.real), torch.as_tensor(psi.imag))
    want = aj(Cplx(jnp.asarray(psi.real), jnp.asarray(psi.imag)))
    scale = max(np.abs(np.asarray(want.re)).max(), np.abs(np.asarray(want.im)).max())
    assert np.abs(got_re.numpy() - np.asarray(want.re)).max() <= 1e-13 * scale
    assert np.abs(got_im.numpy() - np.asarray(want.im)).max() <= 1e-13 * scale


def test_grid_ops_identical():
    ops_t = tx._make_grid_ops(tx.GRID_BITS, tx.GRID_LIMBS)
    ops_j = jx._make_grid_ops(jx.GRID_BITS, jx.GRID_LIMBS)
    rng = np.random.default_rng(3)
    x = rng.uniform(-3.0, 3.0, size=(64, 32))
    lt, lj = ops_t.split(torch.as_tensor(x)), ops_j.split(jnp.asarray(x))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(lt.numpy(), tx._split_host(x, tx.GRID_BITS, tx.GRID_LIMBS))
    assert np.array_equal(ops_t.val(lt).numpy(), np.asarray(ops_j.val(lj)))
    y = rng.uniform(-1.0, 1.0, size=(64, 32))
    d = 2 * lt.numpy().astype(np.int32) - tx._split_host(y, tx.GRID_BITS, tx.GRID_LIMBS).astype(np.int32)
    np.testing.assert_array_equal(ops_t.carry(torch.as_tensor(d)).numpy(),
                                  np.asarray(ops_j.carry(jnp.asarray(d))))


@pytest.mark.parametrize("tier", ["ext", "extp"])
@pytest.mark.parametrize("case", list(CASES))
def test_limb_apply_bit_identical(case, tier):
    mj, mt = _models(case)
    if tier == "ext":
        at, so, ops = tx.make_ext_apply(mt.hamiltonian, scale=1.0 / LAM, device="cpu")
        aj, _, ops_j = jx.make_ext_apply(mj.hamiltonian, scale=1.0 / LAM)
    else:
        at, so, ops = tx.make_ext_apply_pallas(mt.hamiltonian, scale=1.0 / LAM, device="cpu")
        aj, _, ops_j = jx.make_ext_apply_pallas(mj.hamiltonian, scale=1.0 / LAM, interpret=True)
    psi = _psi(so.DL * so.DR, seed=1).reshape(so.DL, so.DR)
    tr, ti = ops.split(torch.as_tensor(psi.real)), ops.split(torch.as_tensor(psi.imag))
    yr, yi = at(tr, ti)
    wr, wi = aj(ops_j.split(jnp.asarray(psi.real)), ops_j.split(jnp.asarray(psi.imag)))
    np.testing.assert_array_equal(yr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(wi))


def test_chebyshev_coefficients_and_lambda_identical():
    times = np.array([0.0, 1e-4, 7.5e-4])
    assert np.array_equal(tcoef(LAM, times), jcoef(LAM, times))
    for n_sea in (5, 8):  # dim 64: triangle bound; dim 512: power iteration too
        kw = production_params_kwargs(n_sea, t_final=0.01, steps=4)
        mj, mt = jbuild(JParams(**kw)), tbuild(TParams(**kw))
        dim = int(np.prod(mt.dims))
        assert tcs._lambda_bound(mt.hamiltonian, dim) == jcs._lambda_bound(mj.hamiltonian, dim)


@pytest.fixture(scope="module")
def n5_rows():
    """Rows of every tier from both packages, and the port's eig rows."""
    mj, mt = _models("n5")
    args_t = (mt.hamiltonian, mt.psi0, TIMES, mt.dims, mt.n_sea_effective, mt.idx_rare)
    args_j = (mj.hamiltonian, mj.psi0, TIMES, mj.dims, mj.n_sea_effective, mj.idx_rare)
    out = {}
    for arith in ("f64", "ext", "extp"):
        out[arith] = (
            tcs.chebyshev_step_traces(*args_t, arithmetic=arith, steps_per_dispatch=2, device="cpu"),
            jcs.chebyshev_step_traces(*args_j, arithmetic=arith, steps_per_dispatch=2),
        )
    w, V = np.linalg.eigh(mt.hamiltonian.to_dense())
    out["eig"] = teig.eig_traces_assembled_batched(
        w[None], V[None], mt.psi0[None], TIMES, mt.dims, np.asarray([mt.n_sea_effective]),
        mt.idx_rare, device="cpu",
    )[0]
    return out


@pytest.mark.parametrize("arith", ["f64", "ext", "extp"])
def test_step_rows_match_reference_and_eig(n5_rows, arith):
    port, ref = n5_rows[arith]
    assert port.shape == ref.shape == (8, len(TIMES))
    assert np.abs(port - ref).max() <= 1e-12
    eig = n5_rows["eig"]
    assert np.abs(port[:7] - eig[:7]).max() <= 5e-12
    np.testing.assert_allclose(port[7], eig[7, 0], rtol=1e-9)
    assert np.abs(port[6] - 1.0).max() < 1e-12
    assert port[2, 0] == pytest.approx(-2.5, abs=1e-14)  # Iz_sea[0] = -n_sea/2


def _n4():
    kw = production_params_kwargs(4, t_final=0.01, steps=4)
    m = tbuild(TParams(**kw))
    t = np.linspace(0.0, 2.4e-4, 12)
    return m, (m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective, m.idx_rare)


def test_checkpoint_resume_bit_identical(monkeypatch, tmp_path):
    _, args = _n4()
    full = tcs.chebyshev_step_traces(*args, steps_per_dispatch=4, device="cpu")
    monkeypatch.setenv("QST_CHEB_ABORT_AFTER_DISPATCHES", "1")
    with pytest.raises(RuntimeError, match="aborted after 1"):
        tcs.chebyshev_step_traces(*args, steps_per_dispatch=4, ckpt_dir=str(tmp_path), device="cpu")
    monkeypatch.delenv("QST_CHEB_ABORT_AFTER_DISPATCHES")
    assert os.path.isfile(tck._ext_advance_path(str(tmp_path)))
    resumed = tcs.chebyshev_step_traces(*args, steps_per_dispatch=4, ckpt_dir=str(tmp_path),
                                        device="cpu")
    assert np.array_equal(full, resumed)
    assert not os.path.exists(tck._ext_advance_path(str(tmp_path)))


def test_cooperative_stop_leaves_resumable_checkpoint(monkeypatch, tmp_path):
    _, args = _n4()
    full = tcs.chebyshev_step_traces(*args, steps_per_dispatch=4, device="cpu")
    stop = tmp_path / "stop_flag"
    monkeypatch.setenv("QST_STOP_FILE", str(stop))
    stop.write_text("claimed\n")
    with pytest.raises(tcs.CooperativeStop, match="at step 4/12"):
        tcs.chebyshev_step_traces(*args, steps_per_dispatch=4, ckpt_dir=str(tmp_path / "ck"),
                                  device="cpu")
    stop.unlink()
    resumed = tcs.chebyshev_step_traces(*args, steps_per_dispatch=4, ckpt_dir=str(tmp_path / "ck"),
                                        device="cpu")
    assert np.array_equal(full, resumed)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_files_load_across_packages(tmp_path, writer):
    rng = np.random.default_rng(2)
    fp = {"engine": "cheb-step", "dim": 64, "T": 12, "dt": 2e-5, "K": 93, "lam": 2.5e6,
          "spd": 4, "e0": -784953.98, "arith": "extp"}
    flats = [rng.standard_normal(32), rng.standard_normal(32)]
    s_re, s_im = rng.standard_normal(64), rng.standard_normal(64)
    save, load = (tck.save_ext_advance, jck.load_ext_advance) if writer == "port" else (
        jck.save_ext_advance, tck.load_ext_advance)
    save(str(tmp_path), fp, 8, flats, s_re, s_im)
    done, got_flats, got_re, got_im = load(str(tmp_path), fp)
    assert done == 8
    assert all(np.array_equal(g, w) for g, w in zip(got_flats, flats)) and len(got_flats) == 2
    assert np.array_equal(got_re, s_re) and np.array_equal(got_im, s_im)
    assert load(str(tmp_path), dict(fp, arith="ext")) is None  # another workload


def test_simulate_rare_cheb_step_matches_eig():
    kw = production_params_kwargs(3, t_final=5e-4, steps=12)
    p = TParams(**kw, solver_method="cheb_step")
    t, traces = simulate_rare(p, device="cpu")
    _, ref = simulate_rare(dataclasses.replace(p, solver_method="eig"), device="cpu")
    assert set(traces) == set(ref) and len(t) == 12
    for k in traces:
        np.testing.assert_allclose(traces[k], ref[k], rtol=0.0, atol=5e-12)


def test_auto_route_and_default_tier():
    assert _auto_method(2048) == "eig"
    assert _auto_method(16384) == "cheb_step"
    assert tcs._default_arith("cuda") == "f64"
    assert tcs._default_arith("cpu") == "f64"
    assert jcs._default_arith("gpu") == jcs._default_arith("cpu") == "f64"


def test_limb_tier_raises_naming_roadmap_item():
    """The "limb" tier is ported (its parity tests:
    tests/test_torch_split_apply_limb.py): it runs and agrees with f64."""
    _, args = _n4()
    rows = tcs.chebyshev_step_traces(*args[:2], args[2][:3], *args[3:], arithmetic="limb",
                                     device="cpu")
    f64 = tcs.chebyshev_step_traces(*args[:2], args[2][:3], *args[3:], device="cpu")
    assert np.abs(rows[:7] - f64[:7]).max() <= 1e-12


def test_engine_cache_reuse_and_clear():
    m, args = _n4()
    tcs.clear_engine_cache()
    rows1 = tcs.chebyshev_step_traces(*args, device="cpu")
    assert len(tcs._ENGINE_CACHE) == 1
    (entry,) = tcs._ENGINE_CACHE.values()
    assert entry["H"] is m.hamiltonian
    rows2 = tcs.chebyshev_step_traces(*args, device="cpu")
    assert len(tcs._ENGINE_CACHE) == 1
    np.testing.assert_array_equal(rows1, rows2)
    assert tcs.clear_engine_cache() == 1


@pytest.mark.parametrize("arith", ["f64", "ext"])
def test_new_dt_at_equal_K_steps_with_its_own_coefficients(arith):
    """Two calls on one H object whose dt differ but give the same K: the
    second call must step with its own coefficients.  Its rows equal a fresh
    engine's bit for bit and the JAX package's within the file's 1e-12."""
    mj, mt = _models("n5")
    t1, t2 = np.linspace(0.0, 1.0e-4, 3), np.linspace(0.0, 1.0002e-4, 3)
    assert tcoef(LAM, t1[1:2]).shape == tcoef(LAM, t2[1:2]).shape  # equal K
    assert not np.array_equal(tcoef(LAM, t1[1:2]), tcoef(LAM, t2[1:2]))

    def port(t):
        return tcs.chebyshev_step_traces(
            mt.hamiltonian, mt.psi0, t, mt.dims, mt.n_sea_effective, mt.idx_rare,
            norm_bound=LAM, arithmetic=arith, device="cpu")

    tcs.clear_engine_cache()
    port(t1)
    second = port(t2)
    tcs.clear_engine_cache()
    fresh = port(t2)
    np.testing.assert_array_equal(second, fresh)
    ref = jcs.chebyshev_step_traces(
        mj.hamiltonian, mj.psi0, t2, mj.dims, mj.n_sea_effective, mj.idx_rare,
        norm_bound=LAM, arithmetic=arith)
    assert np.abs(second - ref).max() <= 1e-12


@pytest.mark.parametrize("dim", [128, 8192, 16384, 32768, 1 << 16])
def test_default_steps_per_dispatch_table_matches(dim):
    assert tcs._default_steps_per_dispatch(dim) == jcs._default_steps_per_dispatch(dim)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, args = _n4()
    with pytest.raises(RuntimeError, match="cuda"):
        tcs.chebyshev_step_traces(*args)
