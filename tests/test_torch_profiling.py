"""The port's tracing/profiling hooks (utils/profiling.py): the cases of
tests/test_profiling.py, the timer's spans and counters as the program's
tracer, the profiler trace and the compile-cache no-op (utils/cache.py)."""

import json
import time

import pytest
import torch

from quantumsimulations_tpu_torch.utils import profiling
from quantumsimulations_tpu_torch.utils.cache import enable_persistent_compile_cache
from quantumsimulations_tpu_torch.utils.profiling import (
    StageTimer,
    device_trace,
    disable_debug_mode,
    enable_debug_mode,
    fetch_sync,
)


def test_stage_timer_accumulates_and_counts():
    t = StageTimer()
    for _ in range(3):
        with t.stage("work"):
            pass
    with t.stage("other"):
        pass
    d = t.as_dict()
    assert d["work"]["calls"] == 3
    assert d["other"]["calls"] == 1
    assert d["work"]["seconds"] >= 0.0
    lines = t.report().splitlines()
    assert len(lines) == 2 and lines[0].startswith("work")


def test_stage_timer_records_on_exception():
    t = StageTimer()
    with pytest.raises(RuntimeError):
        with t.stage("boom"):
            raise RuntimeError("inside")
    assert t.counts["boom"] == 1
    assert "boom" in t.stages


def test_stage_timer_dump_roundtrip(tmp_path):
    t = StageTimer()
    with t.stage("s"):
        pass
    p = tmp_path / "timings.json"
    t.dump(str(p))
    with open(p, encoding="utf-8") as f:
        assert json.load(f) == t.as_dict()


def test_fetch_sync_accepts_tensors_and_nests():
    x = torch.arange(8.0)
    fetch_sync(x)
    fetch_sync({"a": x * 2, "b": (x, x + 1)})
    fetch_sync([])


def test_debug_mode_toggles_nan_check():
    enable_debug_mode()
    try:
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(2) - 1.0)
        with pytest.raises(FloatingPointError):
            torch.ones(2) / torch.zeros(2)  # infinities too, as jax_debug_infs
        assert torch.equal(torch.ones(2) + 1.0, torch.full((2,), 2.0))  # finite passes
    finally:
        disable_debug_mode()
    # after disabling, the same op silently yields NaN again
    assert torch.isnan(torch.log(torch.zeros(2) - 1.0)).all()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "trace" / "trace.json", encoding="utf-8") as f:
        assert "traceEvents" in json.load(f)


def test_compile_cache_is_a_named_no_op():
    assert enable_persistent_compile_cache() is None
    assert enable_persistent_compile_cache("/nonexistent/dir") is None


# --- the timer as the program's tracer: spans, launch spans, counters ---


def test_spans_nest_with_parent_and_evolution_on_time_ns():
    t = StageTimer()
    with t.stage("outside"):
        pass
    for _ in range(2):
        n0 = time.time_ns()
        with profiling.tracing(t):
            with t.stage("chain"):
                with profiling.launch_span("int8_gemm"):
                    pass
                with t.stage("inner"):
                    with profiling.launch_span("int8_gemm"):
                        pass
        n1 = time.time_ns()
        for s in t.spans[-4:]:
            assert n0 <= s.start_ns <= s.end_ns <= n1
    assert t.evolutions == 2
    names = [(s.name, s.parent, s.evolution) for s in t.spans]
    assert names == [("outside", None, None),
                     ("chain", None, 0), ("int8_gemm", 1, 0), ("inner", 1, 0), ("int8_gemm", 3, 0),
                     ("chain", None, 1), ("int8_gemm", 5, 1), ("inner", 5, 1), ("int8_gemm", 7, 1)]
    chain, gemm, inner = t.spans[1:4]
    assert chain.start_ns <= gemm.start_ns <= gemm.end_ns <= inner.start_ns <= chain.end_ns
    # launch spans are spans, not stages
    assert set(t.stages) == {"outside", "chain", "inner"}
    assert t.counts == {"outside": 1, "chain": 2, "inner": 2}


def test_launch_span_does_not_sync(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    t = StageTimer(device=torch.device("cuda"))
    with profiling.tracing(t):
        with t.launch_span("a"):
            pass
        with profiling.launch_span("b"):
            pass
        assert syncs == []
        with t.stage("s"):
            assert len(syncs) == 1
        assert len(syncs) == 2
    assert [s.name for s in t.spans] == ["a", "b", "s"]


def test_counters_land_under_the_innermost_open_stage():
    t = StageTimer()
    with profiling.tracing(t):
        profiling.count("n", 1)  # no stage open
        with t.stage("outer"):
            profiling.count("n", 2)
            with t.stage("inner"):
                with profiling.launch_span("gemm"):
                    profiling.count("n", 5)  # a launch span is not a stage
                profiling.count("ops", 7)
            profiling.count("n", 3)
    assert t.counters == {None: {"n": 1}, "outer": {"n": 5}, "inner": {"n": 5, "ops": 7}}
    d = t.as_dict()
    assert d["outer"] == {"seconds": t.stages["outer"], "calls": 1, "counters": {"n": 5}}
    assert d["inner"]["counters"] == {"n": 5, "ops": 7}


def test_count_and_launch_span_do_nothing_without_an_active_tracer():
    t = StageTimer()
    with t.stage("s"):  # a stage of a timer that is not active
        with profiling.launch_span("gemm"):
            profiling.count("n", 1)
    with profiling.tracing(None):
        profiling.count("n", 1)
    assert profiling._active is None
    assert [s.name for s in t.spans] == ["s"] and t.counters == {}
    # the active tracer is restored when a nested one ends
    outer, inner = StageTimer(), StageTimer()
    with profiling.tracing(outer):
        with profiling.tracing(inner):
            profiling.count("n", 1)
        profiling.count("n", 2)
    assert profiling._active is None
    assert inner.counters == {None: {"n": 1}} and outer.counters == {None: {"n": 2}}


def test_as_dict_keys_stay_the_stage_names(tmp_path):
    t = StageTimer()
    with profiling.tracing(t):
        with t.stage("solve"):
            with profiling.launch_span("int8_gemm"):
                profiling.count("int8_gemm.calls", 1)
        with t.stage("rows"):
            pass
    d = t.as_dict()
    assert list(d) == ["solve", "rows"]
    assert d["rows"] == {"seconds": t.stages["rows"], "calls": 1}
    assert d["solve"]["counters"] == {"int8_gemm.calls": 1}
    t.dump(str(tmp_path / "timings.json"))
    assert json.loads((tmp_path / "timings.json").read_text()) == d
