"""The benchmark's run of one cell: set-up, the measured window, the
comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the names in ``BENCHMARK.json``:

  * ``configs/<config>.json`` (the ``file`` of its ``configs`` entry): the
    bath's parameters under ``params`` and its detunings (see ``traffic.py``);
  * ``traffic/<traffic>.json``: the solver, the route and the warm-up;
  * ``cells/<workload>.json``: the limits of the numbers ``correct`` compares;
  * ``metrics/<metric>.py``: one reader per metric, ``read(ctx)`` returning
    the value or None where it finds nothing to read.

The window drives the port's public single-evolution entry
``simulate_rare`` back to back, each evolution at the next detuning of the
seed's order, until ``--seconds`` have passed; the evolution in flight then
completes and counts.  With ``--trace 1`` a ``StageTimer`` goes to every
evolution through ``simulate_rare(timer=)`` and ``torch.profiler`` traces the
first one.  Once the window has closed and the program's state is freed,
the reference recomputes every timed evolution from its parameter record and
each is compared row by row at every output time.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

#: top-level module names no benchmark process may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "quantumsimulations_tpu")


@dataclass
class Cell:
    name: str
    dir: Path  # the benchmark's directory in the checkout
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # the BENCHMARK.json metric entries this cell reports


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files, under
    ``root/portbench``."""
    bench = root / "portbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    workload = next((w for w in spec["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == workload["config"])
    metrics = [m for m in spec["end_to_end"] + spec["per_layer"]
               if name in m.get("workloads", [name])]
    for m in metrics:
        m["kind"] = "end_to_end" if m in spec["end_to_end"] else "per_layer"
    return Cell(
        name=name,
        dir=bench,
        workload=workload,
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{workload['traffic']}.json").read_text()),
        limits=json.loads((bench / "cells" / f"{name}.json").read_text())["limits"],
        metrics=metrics,
    )


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``quantumsimulations_tpu_torch`` is not ``quantumsimulations_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reader(bench: Path, metric: str):
    """The ``read`` function of ``metrics/<metric>.py`` under ``bench``."""
    path = bench / "metrics" / f"{metric}.py"
    mod_name = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Evolution:
    record: dict
    times: object
    traces: dict
    wall_s: float


def _evolve(record: dict, solver: str, device, timer):
    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
    from quantumsimulations_tpu_torch.models.params import DipolarRareParams

    return simulate_rare(DipolarRareParams(**record, solver_method=solver), device=device,
                         timer=timer)


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _traced_timer(torch, device, spans: list):
    """A ``StageTimer`` that also appends each stage to ``spans`` as
    (start, end, "stage:<name>") in ``time.time_ns``, the profiler's clock."""
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    class SpanTimer(StageTimer):
        @contextlib.contextmanager
        def stage(self, name: str):
            t0 = time.time_ns()
            try:
                with super().stage(name):
                    yield
            finally:
                spans.append((t0, time.time_ns(), "stage:" + name))

    return SpanTimer(device=torch.device(device))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """The result line of one run; ``t_start`` is the ``time.perf_counter()``
    of the process start."""
    import numpy as np
    import torch

    import counts
    import reference
    import traffic as gen
    from devtrace import breakdown, reduce_profile

    params, tr = cell.config["params"], cell.traffic
    order = gen.detuning_order(cell.config, seed)

    # set-up: this cell's shapes, once (builds and loads the kernels)
    _evolve(gen.warmup_record(params, tr), tr["solver"], device, None)
    _sync(torch, device)
    setup_s = time.perf_counter() - t_start

    spans: list = []
    timer = _traced_timer(torch, device, spans) if trace else None
    # device activity only: recording every host operation as well costs
    # microseconds a launch, which the launch-bound stages cannot hide
    is_cuda = torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CUDA if is_cuda
                  else torch.profiler.ProfilerActivity.CPU]
    evolutions: list[Evolution] = []
    prof = None
    w0 = time.perf_counter()
    while True:
        record = gen.timed_record(params, order, len(evolutions))
        traced = trace and not evolutions
        if traced:
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        e0, n0 = time.perf_counter(), time.time_ns()
        t, traces = _evolve(record, tr["solver"], device, timer)
        _sync(torch, device)
        evolutions.append(Evolution(record, t, traces, time.perf_counter() - e0))
        if traced:
            spans.append((n0, time.time_ns(), "evolution"))
            prof.stop()
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0

    peak = int(torch.cuda.max_memory_allocated(device)) if is_cuda else 0
    summary = reduce_profile(prof, spans) if prof is not None else None
    del prof
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    limit = float(cell.limits["trace_gap"])
    compared, failed = {}, 0
    for k, ev in enumerate(evolutions):
        ref = reference.reference_rows(ev.record, device=device)
        grid = np.linspace(0.0, ev.record["t_final"], ev.record["steps"])
        same_grid = np.shape(ev.times) == grid.shape and np.allclose(ev.times, grid, rtol=0, atol=1e-12)
        gap = reference.trace_gap(ev.traces, ref) if same_grid else math.inf
        # a missing or non-finite answer reads null
        compared[f"trace_gap.{k}"] = {"value": gap if math.isfinite(gap) else None, "limit": limit}
        failed += not gap <= limit

    name = torch.cuda.get_device_name(device) if is_cuda else "cpu"
    ctx = {
        "setup_s": setup_s, "window_s": window_s, "n_evolutions": len(evolutions),
        "evolution_walls": [ev.wall_s for ev in evolutions],
        "stages": dict(timer.stages) if timer else {}, "calls": dict(timer.counts) if timer else {},
        "trace": summary, "peaks": counts.card_peaks(name) if is_cuda else None,
        "route": tr["route"], "dim": int(np.prod(reference.dims_of(evolutions[0].record))),
        "steps": int(params["steps"]), "counts": counts,
    }
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m["kind"] == kind:
            value = reader(cell.dir, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu", "kind": name,
           "count": cell.workload["chips"] if is_cuda else 1, "memory_peak_bytes": peak}
    result = {"correct": failed == 0, "attempted": len(evolutions), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown(summary)
    result["compared"] = compared  # last: the numbers compared, each with its limit
    return result


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc!r}"


def emit(result: dict, cell: Cell, seed: int) -> None:
    """Print the run: the card and the peak memory, then the result line
    last on standard output; the compared numbers last on standard error."""
    d = result["device"]
    print(f"portbench {cell.name} seed {seed}: {d['kind']} ({card_line()}), "
          f"peak memory {d['memory_peak_bytes']} bytes", flush=True)
    print(json.dumps(result), flush=True)
    for k, v in result["compared"].items():
        print(f"{k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
