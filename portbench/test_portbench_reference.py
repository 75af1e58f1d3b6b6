"""The plain reference and the comparison that decides ``correct``, on the
CPU at a few sea spins: it accepts the port's traces on both routes and
both spin types, and it fails the reference computed one precision lower
(the control)."""

import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import harness
import reference
import traffic as gen
from smallcells import HERE, ROOT, limit_of, small_config

from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
from quantumsimulations_tpu_torch.dynamics.expm_propagator import expm_traces_assembled_ozaki
from quantumsimulations_tpu_torch.models.dipolar import build_model
from quantumsimulations_tpu_torch.models.params import DipolarRareParams

SIZES = [(3, False), (4, False), (3, True), (4, True)]


def _record(n_sea: int, s32: bool, detuning: float = 75000.0) -> dict:
    params = small_config("bath-n12", n_sea, s32)["params"]
    return gen.params_record(params, detuning, params["t_final"], params["steps"])


@pytest.mark.parametrize("n_sea,s32", SIZES)
def test_accepts_the_ext_route(n_sea, s32):
    rec = _record(n_sea, s32)
    _, traces = simulate_rare(DipolarRareParams(**rec, solver_method="ext"), device="cpu")
    gap = reference.trace_gap(traces, reference.reference_rows(rec))
    assert gap <= limit_of()


@pytest.mark.parametrize("n_sea,s32", SIZES)
def test_accepts_the_ozaki_route(n_sea, s32):
    # simulate_rare takes Ozaki only on the card at dim >= 2048: its chain
    # is called directly here
    rec = _record(n_sea, s32)
    model = build_model(DipolarRareParams(**rec))
    t = np.linspace(0.0, rec["t_final"], rec["steps"])
    rows = expm_traces_assembled_ozaki(model.hamiltonian, model.psi0, t, model.dims,
                                       model.n_sea_effective, model.idx_rare, device="cpu")
    gap = reference.trace_gap(dict(zip(reference.ROWS, rows)), reference.reference_rows(rec))
    assert gap <= limit_of()


@pytest.mark.parametrize("n_sea,s32", [(3, False), (3, True)])
def test_control_comes_out_not_correct(n_sea, s32):
    rec = _record(n_sea, s32)
    low = reference.reference_rows(rec, dtype=torch.complex64)
    gap = reference.trace_gap(dict(zip(reference.ROWS, low)), reference.reference_rows(rec))
    assert math.isfinite(gap) and gap > limit_of()


def test_reference_conserves_what_the_physics_does():
    rec = _record(4, True)
    rows = reference.reference_rows(rec)
    assert rows[2, 0] == pytest.approx(-2.0, abs=1e-14)  # every sea spin down
    assert rows[3, 0] == pytest.approx(1.5, abs=1e-14)  # the spin-3/2 rare spin at +3/2
    assert np.abs(rows[6] - 1.0).max() < 1e-12
    H = reference.hamiltonian(rec)
    assert torch.allclose(H, H.conj().T, rtol=0, atol=0)


def test_gap_is_infinite_for_missing_or_broken_answers():
    ref = np.zeros((7, 5))
    good = {k: np.zeros(5) for k in reference.ROWS}
    assert reference.trace_gap(good, ref) == 0.0
    assert reference.trace_gap({k: v for k, v in good.items() if k != "Iy_R"}, ref) == math.inf
    assert reference.trace_gap(dict(good, Iz_R=np.full(5, np.nan)), ref) == math.inf
    assert reference.trace_gap(dict(good, Iz_R=np.zeros(4)), ref) == math.inf


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "quantumsimulations_tpu_torch_lookalike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jaxlib"]


def test_nothing_the_benchmark_runs_imports_jax(tmp_path):
    """A whole traced run of a small cell in a fresh interpreter, then the
    top-level names of every module it loaded."""
    code = f"""
import sys, time
t0 = time.perf_counter()
sys.path[:0] = [{str(HERE)!r}, {str(ROOT)!r}]
import smallcells, harness
root = smallcells.make_root(__import__("pathlib").Path({str(tmp_path)!r}), {{
    "tiny": (smallcells.small_config("bath-n12", 3, False), smallcells.traffic_of("ext", "ext"), 1e-3)}})
cell = harness.load_cell(root, "tiny.tiny")
result = harness.run_cell(cell, 2**33 + 5, 0.0, True, "cpu", t0)
import control, counts, devtrace, reference, traffic
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print(harness.forbidden_modules(), result["correct"])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    names, last = out.stdout.strip().splitlines()[-2:]
    assert "'quantumsimulations_tpu_torch'" in names
    for bad in harness.FORBIDDEN:
        assert f"'{bad}'" not in names
    assert last == "[] True"
