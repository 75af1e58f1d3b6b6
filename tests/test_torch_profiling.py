"""The port's tracing/profiling hooks (utils/profiling.py): the cases of
tests/test_profiling.py, plus the profiler trace and the compile-cache
no-op (utils/cache.py)."""

import json

import pytest
import torch

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
