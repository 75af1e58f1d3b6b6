"""The int8 GEMMs' launch spans and counters on the limb-product routes (CPU).

Under an active tracer every ``ops/extprec.py::int_mm`` is a launch span
``int8_gemm`` and adds ``int8_gemm.calls`` and ``int8_gemm.ops`` (2 M K N of
the padded operands) to the innermost open stage; every call of the
observables kernel's wrapper is a launch span ``ext_obs`` and adds
``ext_obs.columns`` and ``ext_obs.bytes`` (its least HBM bytes); every call
of the digit epilogue (``ops/ext_carry.py``: one per column panel of an ext
product, one per Horner axpy) is a launch span ``ext_carry`` and adds
``ext_carry.calls`` and ``ext_carry.bytes`` (its least HBM bytes).  The
counts here are made from the routes' product schedules and the padding
rule, independently of the code that counts; the rows must not depend on
whether a timer is given.
"""

import numpy as np
import pytest
import torch

from _torch_parity import production_params_kwargs, stepper_kwargs
from quantumsimulations_tpu_torch.dynamics import evolve as tevolve
from quantumsimulations_tpu_torch.dynamics import expm_propagator as tep
from quantumsimulations_tpu_torch.models.dipolar import build_model
from quantumsimulations_tpu_torch.models.params import DipolarRareParams
from quantumsimulations_tpu_torch.ops import extprec as tx
from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing

#: 200 output steps of 1e-4 s, as tests/test_torch_ext_route.py
TIMES = np.linspace(0.0, 0.0199, 200)


def _up8(x):
    return -(-x // 8) * 8


def _gemm(m, k, n):
    """(calls, ops) of one int_mm of (m, k) @ (k, n) after its padding."""
    return 1, 2 * max(m, 17) * _up8(k) * _up8(n)


def _add(acc, stage, calls_ops, kind="int8_gemm", unit="ops"):
    c = acc.setdefault(stage, {})
    c[f"{kind}.calls"] = c.get(f"{kind}.calls", 0) + calls_ops[0]
    c[f"{kind}.{unit}"] = c.get(f"{kind}.{unit}", 0) + calls_ops[1]


def _ext_product(acc, stage, m, k, n, panel):
    """ext_cmatmul of (L, m, k) @ (L, k, n): per column panel, three
    Karatsuba GEMMs per kept diagonal over its limb pairs along K, then one
    digit epilogue reading the 3 (L + G) int32 digits and writing 2 L limbs
    of each of its m w elements."""
    L, G = tx.EXT_LIMBS, tx.EXT_GUARD
    panel = max(1, min(panel, n))
    for p0 in range(0, n, panel):
        w = min(panel, n - p0)
        for s in range(L + G):
            pairs = min(s + 1, L) - max(0, s - L + 1)
            for _ in range(3):
                _add(acc, stage, _gemm(m, pairs * k, w))
        _add(acc, stage, (1, (3 * (L + G) * 4 + 2 * L) * m * w), "ext_carry", "bytes")


def _ext_schedule(dim, n_sq, block, T, panel=512, fused=False):
    acc = {}
    pan = min(panel, dim)
    for _ in range(tep._EXT_DEGREE - 1):
        _ext_product(acc, "horner", dim, dim, dim, pan)
        for _ in range(2):  # a + p c, one plane each: p's and a's limbs in, the sum's out
            _add(acc, "horner", (1, 3 * tx.EXT_LIMBS * dim * dim), "ext_carry", "bytes")
    for _ in range(n_sq):
        _ext_product(acc, "squarings", dim, dim, dim, pan)
    for k in range(block.bit_length() - 1):
        _ext_product(acc, "doubling", dim, dim, 1 << k, pan)
        _ext_product(acc, "doubling", dim, dim, dim, pan)
    n_blocks = -(-T // block)
    chunk = min(tep._EXT_ADV_CHUNK, n_blocks)
    for _ in range(-(-n_blocks // chunk) * chunk):
        _ext_product(acc, "advance", dim, dim, block, block)
    if fused:  # one kernel call per advance chunk over its stacked columns
        rows = -(-(3 * (dim.bit_length() - 1) + 1) // 8) * 8
        cols = -(-n_blocks // chunk) * chunk * block
        acc["obs"] = {"ext_obs.columns": cols,
                      "ext_obs.bytes": (2 * 11 * dim + 4 * 11 * rows) * cols}
    return acc


def _ozaki_product(acc, stage, m, k, n, real_products):
    """``real_products`` Ozaki real products (m, k) @ (k, n): K padded to
    whole 16-byte rows, then one GEMM per diagonal s over s + 1 limb pairs."""
    kp = -(-k // 16) * 16
    for _ in range(real_products):
        for s in range(tx.N_LIMBS):
            _add(acc, stage, _gemm(m, (s + 1) * kp, n))


def _ozaki_schedule(dim, n_sq, block, T):
    acc = {}
    _ozaki_product(acc, "horner", dim, dim, dim, 4 * (tep._TAYLOR_DEGREE - 1))
    _ozaki_product(acc, "squarings", dim, dim, dim, 4 * n_sq)
    for k in range(block.bit_length() - 1):
        _ozaki_product(acc, "doubling", dim, dim, 1 << k, 4)
        _ozaki_product(acc, "doubling", dim, dim, dim, 4)
    _ozaki_product(acc, "advance", dim, dim, block, 4 * (-(-T // block) - 1))
    return acc


def _args(m, t):
    return (m.hamiltonian, m.psi0, t, m.dims, m.n_sea_effective, m.idx_rare)


@pytest.fixture(scope="module")
def n4():
    return build_model(DipolarRareParams(**production_params_kwargs(4, t_final=0.01, steps=4)))


@pytest.mark.parametrize("block,fused", [(16, False), (128, True)])
def test_ext_gemm_counters_match_the_padded_shapes(n4, block, fused):
    timer = StageTimer()
    with tracing(timer):
        got = tep.expm_traces_assembled_ext(*_args(n4, TIMES), block=block, fused_obs=fused,
                                            device="cpu", timer=timer)
    plain = tep.expm_traces_assembled_ext(*_args(n4, TIMES), block=block, fused_obs=fused,
                                          device="cpu")
    np.testing.assert_array_equal(got, plain)
    want = _ext_schedule(32, timer.counts["squarings"], block, len(TIMES), fused=fused)
    assert timer.counters == want
    n_gemms = sum(c.get("int8_gemm.calls", 0) for c in want.values())
    gemms = [s for s in timer.spans if s.name == "int8_gemm"]
    assert len(gemms) == n_gemms
    # each GEMM's parent is the stage that counted it
    by_stage = {}
    for s in gemms:
        by_stage[timer.spans[s.parent].name] = by_stage.get(timer.spans[s.parent].name, 0) + 1
    assert by_stage == {k: v["int8_gemm.calls"] for k, v in want.items() if "int8_gemm.calls" in v}
    obs = [s for s in timer.spans if s.name == "ext_obs"]
    assert len(obs) == (timer.counts["obs"] if fused else 0)
    assert all(timer.spans[s.parent].name == "obs" for s in obs)


def test_ext_carry_calls_are_the_panels_and_the_axpys(n4):
    """One ``ext_carry`` span and call per column panel of every ext product
    (four panels of 8 at dim 32), and one per Horner axpy (two a step), each
    inside the stage that counted it."""
    timer = StageTimer()
    with tracing(timer):
        tep.expm_traces_assembled_ext(*_args(n4, TIMES), block=16, panel=8, device="cpu",
                                      timer=timer)
    n_blocks = -(-len(TIMES) // 16)
    want = {"horner": (4 + 2) * (tep._EXT_DEGREE - 1),
            "squarings": 4 * timer.counts["squarings"],
            "doubling": 4 + 4 * 4,  # 4 seed-state products of N <= 8, 4 whole products
            # whole chunks of block advances, each one panel (panel = block)
            "advance": -(-n_blocks // min(tep._EXT_ADV_CHUNK, n_blocks))
            * min(tep._EXT_ADV_CHUNK, n_blocks)}
    got = {k: v["ext_carry.calls"] for k, v in timer.counters.items() if "ext_carry.calls" in v}
    assert got == want
    spans = [s for s in timer.spans if s.name == "ext_carry"]
    by_stage = {}
    for s in spans:
        by_stage[timer.spans[s.parent].name] = by_stage.get(timer.spans[s.parent].name, 0) + 1
    assert by_stage == want


def test_simulate_rare_traces_the_evolution_with_one_build_model_stage(monkeypatch):
    monkeypatch.setattr(tevolve, "_EIG_MAX_DIM", 8)  # dim 16: "auto" takes "ext"
    params = DipolarRareParams(**production_params_kwargs(3, t_final=2.0e-3, steps=150))
    timer = StageTimer()
    runs = [tevolve.simulate_rare(params, device="cpu", timer=timer) for _ in range(2)]
    t0, plain = tevolve.simulate_rare(params, device="cpu")
    for t, traced in runs:
        np.testing.assert_array_equal(t, t0)
        assert set(traced) == set(plain)
        for key in plain:
            np.testing.assert_array_equal(traced[key], plain[key])
    assert timer.counts["build_model"] == 2 and timer.evolutions == 2
    builds = [s for s in timer.spans if s.name == "build_model"]
    assert [(s.parent, s.evolution) for s in builds] == [(None, 0), (None, 1)]
    # every span of the route lies in one of the two evolutions
    assert {s.evolution for s in timer.spans} == {0, 1}
    assert "build_model" not in timer.counters
    assert {"horner", "squarings", "doubling", "advance", "obs"} == set(timer.counters)
    # both evolutions counted the same GEMMs and observables columns
    want = _ext_schedule(16, timer.counts["squarings"] // 2, 128, 150, fused=True)
    for stage, c in want.items():
        assert timer.counters[stage] == {k: 2 * v for k, v in c.items()}


def test_ozaki_gemms_count_under_its_own_stages():
    kw = stepper_kwargs(t_final=4.0e-4, steps=37)
    m = build_model(DipolarRareParams(**kw))
    t = np.linspace(0.0, kw["t_final"], kw["steps"])
    timer = StageTimer()
    with tracing(timer):
        got = tep.expm_traces_assembled_ozaki(*_args(m, t), block=8, device="cpu", timer=timer)
    plain = tep.expm_traces_assembled_ozaki(*_args(m, t), block=8, device="cpu")
    np.testing.assert_array_equal(got, plain)
    assert timer.counters == _ozaki_schedule(16, timer.counts["squarings"], 8, len(t))
    assert not {"setup", "split"} & set(timer.counters)


def test_int_mm_outside_a_tracer_records_nothing():
    a = torch.ones((3, 5), dtype=torch.int8)
    b = torch.ones((5, 2), dtype=torch.int8)
    timer = StageTimer()
    with timer.stage("s"):
        out = tx.int_mm(a, b)
    assert torch.equal(out, torch.full((3, 2), 5, dtype=torch.int32))
    assert timer.counters == {} and [s.name for s in timer.spans] == ["s"]
    with tracing(timer):
        with timer.stage("s"):
            tx.int_mm(a, b)
    assert timer.counters == {"s": {"int8_gemm.calls": 1, "int8_gemm.ops": 2 * 17 * 8 * 8}}


def test_ext_obs_span_and_counters_outside_and_inside_a_stage():
    from quantumsimulations_tpu_torch.ops.ext_obs import ext_obs_diagonals_int8

    S = torch.ones((15, 64, 24), dtype=torch.int8)
    jj, ii = zip(*[(j, s - j) for s in range(11) for j in range(s + 1)])
    plain = ext_obs_diagonals_int8(S, S, jj, ii, 11)
    timer = StageTimer(memory=True)  # no CUDA device: no memory counter
    with tracing(timer):
        with timer.stage("obs"):
            got = ext_obs_diagonals_int8(S, S, jj, ii, 11)
        ext_obs_diagonals_int8(S[:, :, :8].contiguous(), S[:, :, :8].contiguous(), jj, ii, 11)
    assert torch.equal(got, plain)
    # R = 3 * 6 + 1 rounded up to 8 = 24 rows of sums
    assert timer.counters == {
        "obs": {"ext_obs.columns": 24, "ext_obs.bytes": (2 * 11 * 64 + 4 * 11 * 24) * 24},
        None: {"ext_obs.columns": 8, "ext_obs.bytes": (2 * 11 * 64 + 4 * 11 * 24) * 8}}
    spans = [s for s in timer.spans if s.name == "ext_obs"]
    assert [None if s.parent is None else timer.spans[s.parent].name for s in spans] == ["obs", None]
