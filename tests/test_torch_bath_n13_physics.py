"""The physics of the benchmark's ``bath-n13`` configuration, cut to a few
sea spins, through the port's exact-limb ``ext`` route on the CPU, against
the benchmark's plain reference (``portbench/reference.py``: a dense
complex128 ``eigh`` of the same parameter record, no code of the port).

n_sea 5 and 7 sit on Fibonacci shells, as 13 does (no Platonic solid has
that many vertices), so the geometry the n13 cell runs is the one held
here.  200 output steps of the configuration's spacing (0.3 s) at one of its
detunings.

Tolerance 1e-8: the ext chain is exact to its 75-bit limbs, and what it
loses (the limb truncation amplified by 2^(squarings + log2 block), the
observables' limb pairs kept to 2^-45) reads ~1e-10 here (1.1e-10 at n_sea
5, 2.2e-10 at 7); the reference's float64 eigenpairs are good to ~1e-12 over
0.3 s.  1e-8 is the bar PERF.md holds the exact float64 routes to against an
exact oracle, with room for neither side to pass it by rounding alone.
"""

import importlib.util
import json
from pathlib import Path

import pytest

from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
from quantumsimulations_tpu_torch.models.params import DipolarRareParams

BENCH = Path(__file__).resolve().parent.parent / "portbench"
STEPS = 200
DETUNING_HZ = 75000.0


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_{name}_n13", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference = _load("reference")
traffic = _load("traffic")


def _record(n_sea: int) -> dict:
    cfg = json.loads((BENCH / "configs" / "bath-n13.json").read_text())
    assert cfg["params"]["n_sea"] == 13 and DETUNING_HZ in cfg["detunings_Hz"]
    params = dict(cfg["params"], n_sea=n_sea)
    dt = params["t_final"] / (params["steps"] - 1)
    return traffic.params_record(params, DETUNING_HZ, dt * (STEPS - 1), STEPS)


@pytest.mark.parametrize("n_sea", [5, 7])
def test_ext_route_matches_the_plain_reference(n_sea):
    rec = _record(n_sea)
    assert n_sea not in (4, 6, 8, 12, 20)  # the Fibonacci shell, as at 13
    _, traces = simulate_rare(DipolarRareParams(**rec, solver_method="ext"), device="cpu")
    gap = reference.trace_gap(traces, reference.reference_rows(rec))
    assert gap <= 1e-8, gap
