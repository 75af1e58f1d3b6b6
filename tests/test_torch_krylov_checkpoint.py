"""Port vs reference: the Krylov snapshot half of ``dynamics/checkpoint.py``
(CPU).

The file format is the JAX package's, so a snapshot either package writes
resumes in the other.  Bars: a resumed port run equals an uninterrupted one
bit for bit (the same substeps on the same state); against the JAX package
the traces agree within 1e-10 and the norm within 1e-12 (its own bars,
tests/test_checkpoint.py:91-92).
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.dynamics import checkpoint as jck
from quantumsimulations_tpu.models.dipolar import build_model as jbuild
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu_torch.dynamics import checkpoint as tck
from quantumsimulations_tpu_torch.models.dipolar import build_model as tbuild
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams

CPU = torch.device("cpu")


def _kwargs():
    """tests/test_checkpoint.py's parameters (n_sea = 2, 21 steps)."""
    gamma = 8.1812e7
    return dict(
        n_sea=2, gamma_sea=gamma, gamma_rare=6.976e7, B0_sea=3.0, B0_rare=3.0,
        B1_sea=2 * np.pi * 5e4 / gamma, B1_rare=2 * np.pi * 7e4 / 6.976e7,
        omega_rf_sea=gamma * 3.0 - 2 * np.pi * 800.0, omega_rf_rare=6.976e7 * 3.0,
        dipolar_scale=1e-7 * 1.054571817e-34, shell_scale=0.282393e-9,
        t_final=2.0e-4, steps=21, drive_sea=True, drive_rare=True,
        is_spin_three_half=False, is_center_rare=True,
    )


@pytest.fixture(scope="module")
def setup():
    kw = _kwargs()
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    return TParams(**kw), tbuild(TParams(**kw)), jbuild(JParams(**kw)), t


def _run(model, t, ckpt_dir, every, params=None):
    return tck.krylov_propagate_traces_checkpointed(
        model.hamiltonian, model.psi0, t, model.dims, ckpt_dir=str(ckpt_dir),
        ckpt_every=every, params=params, m=24, device=CPU)


def test_snapshots_roundtrip_prune_and_cross_packages(tmp_path):
    psi = np.arange(8, dtype=np.complex128) + 1j
    for k in (1, 5, 10):
        tck.save_snapshot(str(tmp_path), k, k * psi, keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["state_00000005.npz", "state_00000010.npz"]
    assert tck.snapshot_path(str(tmp_path), 10) == jck.snapshot_path(str(tmp_path), 10)
    for latest in (tck.latest_snapshot, jck.latest_snapshot):
        step, got = latest(str(tmp_path))
        assert step == 10 and np.array_equal(got, 10 * psi)
    assert tck.latest_snapshot(str(tmp_path / "none")) is None


def test_resume_is_bit_identical(setup, tmp_path):
    params, tm, _, t = setup
    full = _run(tm, t, tmp_path / "a", 0)
    ck = tmp_path / "b"
    _run(tm, t[:15], ck, 7, params=params)  # interrupted after step 14
    step, _ = tck.latest_snapshot(str(ck))
    assert step == 14
    with open(ck / "params.json", encoding="utf-8") as f:
        assert json.load(f)["n_sea"] == 2
    resumed = _run(tm, t, ck, 7)
    np.testing.assert_array_equal(resumed["site_xyz"], full["site_xyz"])
    np.testing.assert_array_equal(resumed["norm"], full["norm"])


def test_resumes_a_snapshot_the_reference_wrote(setup, tmp_path):
    _, tm, jm, t = setup
    ck = str(tmp_path / "ck")
    partial = jck.krylov_propagate_traces_checkpointed(
        jm.hamiltonian, jm.psi0, t[:15], jm.dims, ckpt_dir=ck, ckpt_every=7, m=24)
    assert jck.latest_snapshot(ck)[0] == 14
    resumed = _run(tm, t, ck, 7)
    # rows 0..13 come from the reference's stash as it wrote them
    np.testing.assert_array_equal(resumed["site_xyz"][..., :14], partial["site_xyz"][..., :14])
    ref = jck.krylov_propagate_traces_checkpointed(
        jm.hamiltonian, jm.psi0, t, jm.dims, ckpt_dir=str(tmp_path / "ref"), ckpt_every=0, m=24)
    assert np.abs(resumed["site_xyz"] - ref["site_xyz"]).max() <= 1e-10
    assert np.abs(resumed["norm"] - ref["norm"]).max() <= 1e-12
