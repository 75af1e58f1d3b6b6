"""Port vs reference: the lab-frame cosine-drive model
(models/labframe.py) on the CPU, at tests/test_labframe.py's scaled
frequencies.

Bounds (tests/test_labframe.py:80, :102-103): Iz_sea within 1e-7 of a
DOP853 oracle of the same H(t) (norm 1e-8); lab frame against the rotating
frame within 5e-3 (the RWA error ~ omega1 / omega_z); the port within 1e-9
of the JAX package's lab-frame traces (both integrate at atol 1e-12, rtol
1e-11).
"""

import dataclasses

import numpy as np
import pytest
from scipy.integrate import solve_ivp

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.models import labframe as jlab
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams
from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
from quantumsimulations_tpu_torch.models import labframe as tlab
from quantumsimulations_tpu_torch.models.dipolar import build_model
from quantumsimulations_tpu_torch.models.params import DipolarRareParams as TParams
from quantumsimulations_tpu_torch.ops.spin import spin_matrix


def _kw(**kw):
    gamma, B0, f1 = 1.0e5, 1.0, 1.0e3
    base = dict(
        n_sea=2, gamma_sea=gamma, gamma_rare=gamma * 0.8, B0_sea=B0, B0_rare=B0,
        B1_sea=2 * np.pi * f1 / gamma, B1_rare=2 * np.pi * f1 / (gamma * 0.8),
        phi_sea=0.3, phi_rare=1.1, dipolar_scale=1e-7 * 1.054571817e-34 * 7e5,
        shell_scale=0.282393e-9, t_final=2.0e-3, steps=81, drive_sea=True, drive_rare=True,
        is_spin_three_half=False, is_center_rare=True,
    )
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def oracle_case():
    params = TParams(**_kw())
    t, traces = tlab.simulate_lab_frame(params, atol=1e-12, rtol=1e-11, device="cpu")
    return params, t, traces


def test_lab_frame_matches_scipy_oracle(oracle_case):
    params, t, traces = oracle_case
    model = build_model(params)
    Ht, _ = tlab.build_lab_frame_model(params)
    H0 = Ht.H0.to_dense()
    Vs = [(V.to_dense(), fn) for V, fn in Ht.pieces]
    dim = H0.shape[0]

    def rhs(tt, y):
        psi = y[:dim] + 1j * y[dim:]
        H = H0.copy()
        for Vd, fn in Vs:
            H = H + float(fn(tt)) * Vd
        d = -1j * (H @ psi)
        return np.concatenate([d.real, d.imag])

    sol = solve_ivp(rhs, (0, params.t_final), np.concatenate([model.psi0.real, model.psi0.imag]),
                    t_eval=t, method="DOP853", rtol=1e-12, atol=1e-14)
    assert sol.success
    psis = sol.y[:dim] + 1j * sol.y[dim:]

    def embed(op, site):
        out = np.array([[1.0 + 0j]])
        for k, d in enumerate(model.dims):
            out = np.kron(out, op if k == site else np.eye(d, dtype=complex))
        return out

    Iz_sea = sum(embed(spin_matrix(0.5, "z"), j) for j in range(model.n_sea_effective))
    want = np.real(np.einsum("it,ij,jt->t", psis.conj(), Iz_sea, psis))
    assert np.abs(traces["Iz_sea"] - want).max() <= 1e-7
    assert np.abs(traces["state_norm"] - 1.0).max() <= 1e-8


def test_lab_frame_port_matches_reference(oracle_case):
    params, t, traces = oracle_case
    t_j, ref = jlab.simulate_lab_frame(JParams(**_kw()), atol=1e-12, rtol=1e-11)
    assert np.array_equal(t, t_j) and set(traces) == set(ref)
    for key in ref:
        assert np.abs(traces[key] - ref[key]).max() <= 1e-9, key
    Ht, freqs = tlab.build_lab_frame_model(params)
    Hj, freqs_j = jlab.build_lab_frame_model(JParams(**_kw()))
    assert freqs == freqs_j
    np.testing.assert_array_equal(Ht.H0.to_dense(), Hj.H0.to_dense())
    assert len(Ht.pieces) == len(Hj.pieces) == 2
    for (V, fn), (Vj, fnj) in zip(Ht.pieces, Hj.pieces):
        np.testing.assert_array_equal(V.to_dense(), Vj.to_dense())
        for tt in (0.0, 3.3e-4, 1.9e-3):
            assert abs(fn(tt) - float(fnj(tt))) <= 1e-15


def test_lab_frame_rwa_matches_rotating_frame():
    """On resonance, lab-frame <Iz> ~ rotating-frame <Iz> (Iz commutes with
    the frame rotation; RWA error ~ omega1/omega_z ~ 3e-3)."""
    params = TParams(**_kw(B1_sea=2 * np.pi * 50.0 / 1.0e5, B1_rare=2 * np.pi * 50.0 / 0.8e5,
                           dipolar_scale=0.0, shell_scale=1.0, t_final=5.0e-3, steps=101))
    t, lab = tlab.simulate_lab_frame(params, atol=1e-12, rtol=1e-11, device="cpu")
    t2, rot = simulate_rare(params, device="cpu")
    assert np.abs(lab["Iz_sea"] - rot["Iz_sea"]).max() <= 5e-3
    assert np.abs(lab["Iz_R"] - rot["Iz_R"]).max() <= 5e-3
    assert rot["Iz_sea"].max() - rot["Iz_sea"].min() > 0.1
    assert dataclasses.asdict(params)["solver_method"] == "auto"
