"""Device time by launching program span (``launches.py``), on synthetic
profiler events over the spans of a real evolution's tracer, and the new
metric reader on a context from a program without the span it reads."""

from pathlib import Path

import numpy as np
import pytest

import launches
from harness import reader

HERE = Path(__file__).resolve().parent


class _Span:
    def __init__(self, name, a, b):
        self.name, self.start_ns, self.end_ns = name, a, b


def test_attribution_by_launch_on_synthetic_events():
    spans = [_Span("horner", 100, 200), _Span("int8_gemm", 120, 130),
             _Span("int8_gemm", 150, 150), _Span("advance", 300, 400)]
    launch = [(125, 1), (140, 2), (350, 3), (250, 4), (10, 5), (160, 8)]
    # (start, end, correlation): kernels run after their launch, some after
    # the launching span ended (a launch span does not synchronise)
    device = [(126, 136, 1), (190, 198, 2), (360, 380, 3), (260, 262, 4), (20, 30, 5),
              (199, 211, 6), (500, 510, 7)]
    got = launches.attribute(device, launch, spans, 0, 450)
    assert got.keys() == {"int8_gemm", "horner", "advance", "outside", "unattributed"}
    assert got["int8_gemm"] == {"seconds": pytest.approx(10e-9), "kernels": 1}
    assert got["horner"] == {"seconds": pytest.approx(8e-9), "kernels": 1}
    assert got["advance"] == {"seconds": pytest.approx(20e-9), "kernels": 1}
    assert got["outside"] == {"seconds": pytest.approx(12e-9), "kernels": 2}
    # no launch call for correlation 6; 7 lies outside the window
    assert got["unattributed"] == {"seconds": pytest.approx(12e-9), "kernels": 1}
    clipped = launches.attribute(device, launch, spans, 128, 450)
    assert clipped["int8_gemm"]["seconds"] == pytest.approx(8e-9)
    assert "outside" in clipped and clipped["outside"]["kernels"] == 1


def test_attribution_over_the_spans_of_a_traced_evolution():
    """Each int8 GEMM span of a small ext evolution launches one kernel, each
    chain stage one more outside its GEMMs, and one kernel has no launch."""
    import torch

    from quantumsimulations_tpu_torch.dynamics.expm_propagator import expm_traces_assembled_ext
    from quantumsimulations_tpu_torch.models.dipolar import build_model
    from quantumsimulations_tpu_torch.models.params import DipolarRareParams
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing
    from smallcells import small_config
    from traffic import params_record

    record = params_record(small_config("bath-n12", 3, False)["params"], 75e3, 1e-3, 40)
    m = build_model(DipolarRareParams(**record))
    timer = StageTimer(device=torch.device("cpu"))
    with tracing(timer):
        expm_traces_assembled_ext(m.hamiltonian, m.psi0, np.linspace(0.0, 1e-3, 40), m.dims,
                                  m.n_sea_effective, m.idx_rare, block=8, device="cpu",
                                  timer=timer)
    spans = timer.spans
    device, launch, corr = [], [], 0
    for s in spans:
        corr += 1
        launch.append((s.start_ns, corr))  # the launch call opens with the span
        device.append((s.end_ns + 1, s.end_ns + 1001, corr))  # 1 us of device time
    device.append((spans[0].start_ns, spans[0].start_ns + 500, corr + 1))  # never launched
    w0, w1 = spans[0].start_ns, max(s.end_ns for s in spans) + 2000
    got = launches.attribute(device, launch, spans, w0, w1)
    n_gemm = sum(c["int8_gemm.calls"] for c in timer.counters.values())
    assert got["int8_gemm"]["kernels"] == n_gemm > 0
    assert got["int8_gemm"]["seconds"] == pytest.approx(n_gemm * 1e-6)
    for stage in ("horner", "squarings", "doubling", "advance", "setup"):
        assert got[stage]["kernels"] == timer.counts[stage], stage
    assert got["unattributed"] == {"seconds": pytest.approx(5e-7), "kernels": 1}
    assert "outside" not in got


@pytest.mark.parametrize("ctx,want", [
    ({"stages": {"horner": 1.0}, "n_evolutions": 3}, None),  # the parent: no such stage
    ({"stages": {}, "n_evolutions": 3}, None),  # an untimed run
    ({"stages": {"build_model": 0.3}, "n_evolutions": 3}, 0.1),
])
def test_model_build_s_reads_the_build_model_stage(ctx, want):
    got = reader(HERE, "model_build_s")(ctx)
    assert got == (None if want is None else pytest.approx(want))
