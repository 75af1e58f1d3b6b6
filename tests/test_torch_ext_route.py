"""Port vs reference: the dense ext route end to end (CPU).

``expm_traces_assembled_ext`` on both packages with the same model (n_sea=4,
dim 32, and a spin-3/2 rare spin).  Bounds, from the JAX package's own tests:

  * rows against the JAX package's rows: 1e-13 (the limb stacks are equal
    bit for bit, tests/test_torch_extprec.py; only the float64 combine of
    the observables sums in another order), and the port's fused and plain
    observables against each other 1e-12 (tests/test_extprec.py:428-453);
  * rows against the JAX package's eig route at t_final = 1 s: 5e-9, and
    the norm within 1e-12 of 1 (tests/test_extprec.py:196-232);
  * checkpoint abort and resume: bit-identical (tests/test_extprec.py:342);
  * ``simulate_rare`` on "auto" resolving to "ext" (with _EIG_MAX_DIM
    lowered in both packages so that a small model takes the route): 1e-12
    against the JAX package's ``simulate_rare``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache, production_params_kwargs  # noqa: F401
from quantumsimulations_tpu.dynamics import evolve as jevolve
from quantumsimulations_tpu.dynamics import expm_propagator as jep
from quantumsimulations_tpu.dynamics.eig_propagator import eig_traces_assembled_batched as jeig
from quantumsimulations_tpu.dynamics.eig_propagator import eigh_host as jeigh
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu_torch.dynamics import checkpoint as tck
from quantumsimulations_tpu_torch.dynamics import evolve as tevolve
from quantumsimulations_tpu_torch.dynamics import expm_propagator as tep
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.utils.profiling import StageTimer

#: 200 output steps of 1e-4 s: two 128-column blocks (a ragged tail of 56)
TIMES = np.linspace(0.0, 0.0199, 200)


def _models(**kw):
    kw = production_params_kwargs(**kw, t_final=0.01, steps=4)
    return jbuild(JParams(**kw)), tbuild(TParams(**kw))


def _args(m, t):
    return (m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective, m.idx_rare)


@pytest.fixture(scope="module")
def n4():
    return _models(n_sea=4)


@pytest.mark.parametrize("block,fused", [(16, False), (64, False), (128, True)])
def test_rows_match_reference(n4, block, fused):
    mj, mt = n4
    want = jep.expm_traces_assembled_ext(*_args(mj, TIMES), block=block, fused_obs=fused)
    timer = StageTimer()
    got = tep.expm_traces_assembled_ext(*_args(mt, TIMES), block=block, fused_obs=fused,
                                        device="cpu", timer=timer)
    assert got.shape == want.shape == (8, len(TIMES))
    assert np.abs(got - want).max() <= 1e-13
    assert {"setup", "split", "horner", "squarings", "doubling", "advance", "obs"} == set(
        timer.stages)
    if fused:  # the plain observables on the same limbs (JAX bar: 1e-12)
        plain = tep.expm_traces_assembled_ext(*_args(mt, TIMES), block=block, fused_obs=False,
                                              device="cpu")
        assert np.abs(plain - got).max() <= 1e-12


def test_fused_obs_needs_spin_half_and_block_multiple_of_128(n4):
    _, mt = n4
    with pytest.raises(ValueError, match="fused_obs"):
        tep.expm_traces_assembled_ext(*_args(mt, TIMES), block=64, fused_obs=True, device="cpu")


def _refuse_build(monkeypatch):
    def setup(*a, **k):
        raise AssertionError("the step-operator build ran")

    monkeypatch.setattr(tep, "_ext_host_setup", setup)


def test_fused_obs_above_the_kernel_dim_raises_before_the_setup(monkeypatch):
    # 15 spin-1/2 sites (dim 32768): the CUDA kernel holds dim <= 16384, so the
    # route refuses fused observables there before the step-operator build
    _refuse_build(monkeypatch)
    dims = (2,) * 15
    psi0 = np.zeros(1 << 15, dtype=np.complex128)
    for fused in (None, True):
        with pytest.raises(ValueError, match="dim <= 16384"):
            tep.expm_traces_assembled_ext(None, psi0, TIMES[:128], dims, 14, 14,
                                          block=128, fused_obs=fused, device="cpu")
    with pytest.raises(AssertionError, match="step-operator build"):
        tep.expm_traces_assembled_ext(None, psi0, TIMES[:128], dims, 14, 14,
                                      block=128, fused_obs=False, device="cpu")


def test_fused_obs_at_dim_16384_reaches_the_setup(monkeypatch):
    # 14 spin-1/2 sites (dim 16384, n_sea 13): the kernel's two-block path
    # holds the column, so the gate lets the route go on to its build
    _refuse_build(monkeypatch)
    dims = (2,) * 14
    psi0 = np.zeros(1 << 14, dtype=np.complex128)
    for fused in (None, True):
        with pytest.raises(AssertionError, match="step-operator build"):
            tep.expm_traces_assembled_ext(None, psi0, TIMES[:128], dims, 13, 13,
                                          block=128, fused_obs=fused, device="cpu")


def test_rows_match_reference_eig_at_one_second():
    """The ext rows against the exact eig route on a 1 s horizon."""
    mj, mt = _models(n_sea=4)
    t = np.linspace(0.0, 1.0, 400)
    w, V = jeigh(mj.hamiltonian.to_dense())
    exact = jeig(w[None], V[None], mj.psi0[None], t, mj.dims,
                 np.asarray([mj.n_sea_effective]), mj.idx_rare)[0]
    rows = tep.expm_traces_assembled_ext(*_args(mt, t), block=64, device="cpu")
    assert rows.shape == exact.shape
    assert np.abs(rows[:6] - exact[:6]).max() < 5e-9
    assert np.abs(rows[6] - 1.0).max() < 1e-12
    assert rows[2, 0] == pytest.approx(-2.0, abs=1e-14)  # Iz_sea[0] = -n_sea/2


def test_spin_three_half_rows_match_reference():
    """A spin-3/2 rare spin takes the general-dims observables."""
    mj, mt = _models(n_sea=3, is_spin_three_half=True)
    t = TIMES[:40]
    want = jep.expm_traces_assembled_ext(*_args(mj, t), block=16)
    got = tep.expm_traces_assembled_ext(*_args(mt, t), block=16, device="cpu")
    assert np.abs(got - want).max() <= 1e-13
    assert got[3, 0] == pytest.approx(1.5, abs=1e-14)  # Iz_R[0] of a spin-3/2 rare


def test_checkpoint_abort_and_resume_bit_identical(monkeypatch, tmp_path):
    _, mt = _models(n_sea=4)
    t = np.linspace(0.0, 2.0e-4, 64)
    monkeypatch.setattr(tep, "_EXT_CHUNK_DIM", 16)  # the COO split, as at dim >= 4096
    ref = tep.expm_traces_assembled_ext(*_args(mt, t), block=16, device="cpu")
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("QST_EXT_ABORT_AFTER_CHUNKS", "1")
    with pytest.raises(RuntimeError, match="aborted after 1 advance chunks"):
        tep.expm_traces_assembled_ext(*_args(mt, t), block=16, ckpt_dir=ck, ckpt_every_blocks=1,
                                      device="cpu")
    assert os.path.isfile(tck._ext_advance_path(ck))
    monkeypatch.delenv("QST_EXT_ABORT_AFTER_CHUNKS")
    resumed = tep.expm_traces_assembled_ext(*_args(mt, t), block=16, ckpt_dir=ck,
                                            ckpt_every_blocks=1, device="cpu")
    assert np.array_equal(resumed, ref), "resume must be bit-identical"
    assert not os.path.isfile(tck._ext_advance_path(ck))  # cleared after success


def test_auto_resolves_to_ext_between_2048_and_8192():
    assert tevolve._auto_method(2048) == jevolve._auto_method(2048) == "eig"
    for dim in (4096, 8192):
        assert tevolve._auto_method(dim) == jevolve._auto_method(dim) == "ext"
    assert tevolve._auto_method(16384) == jevolve._auto_method(16384) == "cheb_step"
    tevolve.check_method("ext")  # ported: no refusal


def test_simulate_rare_auto_takes_ext_and_matches_reference(monkeypatch):
    monkeypatch.setattr(tevolve, "_EIG_MAX_DIM", 8)
    monkeypatch.setattr(jevolve, "_EIG_MAX_DIM", 8)
    kw = production_params_kwargs(3, t_final=2.0e-3, steps=150)  # dim 16 > 8: "ext"
    assert tevolve._auto_method(16) == "ext"
    seen = []
    real = tep.expm_traces_assembled_ext
    monkeypatch.setattr(tep, "expm_traces_assembled_ext",
                        lambda *a, **k: seen.append(k) or real(*a, **k))
    t_t, tr_t = tevolve.simulate_rare(TParams(**kw), device="cpu")
    assert seen and seen[0]["device"] == "cpu"
    t_j, tr_j = jevolve.simulate_rare(JParams(**kw))
    assert np.array_equal(t_t, t_j) and set(tr_t) == set(tr_j)
    for key in tr_j:
        assert np.abs(tr_t[key] - tr_j[key]).max() <= 1e-12, key
    # the explicit solver name takes the same route
    _, tr_e = tevolve.simulate_rare(dataclasses.replace(TParams(**kw), solver_method="ext"),
                                    device="cpu")
    for key in tr_t:
        np.testing.assert_array_equal(tr_e[key], tr_t[key])


def test_cuda_device_without_a_card_raises(n4):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, mt = n4
    with pytest.raises(RuntimeError, match="cuda"):
        tep.expm_traces_assembled_ext(*_args(mt, TIMES))
