"""Device time of one ext evolution by the program span that launched it,
on the card, and what the program's tracing costs.

Runs the work of a benchmark cell (``--workload``, default ``bath-n12.ext``:
its configuration and traffic under ``portbench/``, the seed's first
detuning): a warm-up evolution; one evolution through
``simulate_rare(timer=)`` under ``torch.profiler`` with CUDA activity only,
as the benchmark's traced run, its timer keeping each stage's device-memory
high water; then evolutions without a timer and with one (no profiler) in
turns.  Prints, and writes as JSON to ``--out`` where given:

  * the device seconds and intervals by launching program span
    (``portbench/launches.py``), the unattributed seconds and their share of
    the busy time, and the launch calls the profiler recorded;
  * where the int8 GEMM kernels (by name) landed, against the program's
    ``int8_gemm.calls``, and the kernel variants launched
    (``int8_gemm.wide``, ``int8_gemm.narrow``);
  * ``int8_gemm_s``, ``int8_gemm_roofline``, ``limb_elementwise_s`` and
    ``model_build_s`` as PERF.md's list of layers defines them;
  * the observables kernel's device seconds under the ``ext_obs`` span, the
    program's ``ext_obs.columns`` and ``ext_obs.bytes``, and its roofline
    (those bytes over the card's HBM rate, over its seconds);
  * each stage's ``memory.peak_bytes`` and the evolution's largest;
  * the sum check: ``int8_gemm_s`` + ``limb_elementwise_s`` + the card's idle
    seconds inside the chain and advance stages against those stages' seconds;
  * the walls of the untimed and the timed evolutions.

    python3 experiments/torch_launch_attribution.py [--workload NAME] [--seed N] [--pairs 2]
        [--out FILE]

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]

#: stages whose non-GEMM launches are the limb arithmetic between the GEMMs
LIMB_STAGES = ("horner", "squarings", "doubling", "advance")


def _union(iv):
    """The sorted disjoint union of the (start, end) intervals ``iv``, as
    two int64 arrays."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    arr = np.asarray(out, dtype=np.int64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


def _covered(union, a, b):
    """ns of [a, b) that the disjoint ``union`` covers."""
    s, t = union
    return int((np.clip(t, a, b) - np.clip(s, a, b)).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="bath-n12.ext")
    ap.add_argument("--seed", type=int, default=2147920101)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import counts
    import harness
    import launches
    import reference
    import traffic as gen
    from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
    from quantumsimulations_tpu_torch.models.params import DipolarRareParams
    from quantumsimulations_tpu_torch.utils.profiling import StageTimer

    card = harness.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cell = harness.load_cell(ROOT, args.workload)
    params, tr = cell.config["params"], cell.traffic
    order = gen.detuning_order(cell.config, args.seed)
    record = gen.timed_record(params, order, 0)

    def evolve(rec, timer=None):
        t0 = time.perf_counter()
        simulate_rare(DipolarRareParams(**rec, solver_method=tr["solver"]), device="cuda",
                      timer=timer)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    evolve(gen.warmup_record(params, tr))

    timer = StageTimer(device=torch.device("cuda"), memory=True)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    w0 = time.time_ns()
    traced_wall = evolve(record, timer)
    w1 = time.time_ns()
    prof.stop()

    p0 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    device, names, launch, launch_names = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            a = e.start_ns()
            device.append((a, a + e.duration_ns(), e.correlation_id()))
            names.append(e.name())
        elif e.name().startswith("cu") and e.correlation_id():
            launch.append((e.start_ns(), e.correlation_id()))
            launch_names[e.correlation_id()] = e.name()
    del prof
    reduce_s = time.perf_counter() - p0
    spans = [s for s in timer.spans if s.evolution == 0]
    by_span = launches.attribute(device, launch, spans, w0, w1)
    # cuBLASLt's int8 kernels (a parent without the port's own) and the port's
    gemm_idx = [i for i, n in enumerate(names) if "gemm_s8" in n or "int8_gemm_kernel" in n]
    gemm_by_span = launches.attribute([device[i] for i in gemm_idx], launch, spans, w0, w1)
    linked = Counter(launch_names.get(c, "<none>") for _, _, c in device)

    union = _union((max(a, w0), min(b, w1)) for a, b, _ in device if b > w0 and a < w1)
    busy_ns = int((union[1] - union[0]).sum())
    stage_spans = [s for s in spans if s.name in LIMB_STAGES]
    idle_s = sum((s.end_ns - s.start_ns) - _covered(union, s.start_ns, s.end_ns)
                 for s in stage_spans) * 1e-9
    stage_s = sum(timer.stages[s] for s in LIMB_STAGES)
    span_s = sum(s.end_ns - s.start_ns for s in stage_spans) * 1e-9

    gemm_s = by_span.get("int8_gemm", {}).get("seconds", 0.0)
    limb_s = sum(by_span.get(s, {}).get("seconds", 0.0) for s in LIMB_STAGES)
    unattr = by_span.get(launches.UNATTRIBUTED, {"seconds": 0.0, "kernels": 0})
    ops = sum(c.get("int8_gemm.ops", 0) for c in timer.counters.values())
    calls = sum(c.get("int8_gemm.calls", 0) for c in timer.counters.values())
    variants = {v: sum(c.get(f"int8_gemm.{v}", 0) for c in timer.counters.values())
                for v in ("wide", "narrow")}
    peaks = counts.card_peaks(torch.cuda.get_device_name(0))
    obs_s = by_span.get("ext_obs", {}).get("seconds", 0.0)
    obs_bytes = sum(c.get("ext_obs.bytes", 0) for c in timer.counters.values())
    stage_peaks = {str(k): v["memory.peak_bytes"] for k, v in timer.counters.items()
                   if "memory.peak_bytes" in v}
    dim = int(np.prod(reference.dims_of(record)))
    least = (counts.chain_ops("ext", dim, timer.counts, 1)
             + counts.advance_ops("ext", dim, params["steps"]))
    out = {
        "card": card, "torch": torch.__version__, "seed": args.seed,
        "detuning_Hz": order[0],
        "traced_wall_s": traced_wall, "profile_reduce_s": reduce_s,
        "window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
        "device_intervals": len(device), "launch_calls": len(launch),
        "launch_call_names": dict(linked.most_common(12)),
        "spans": len(spans), "by_span": by_span, "gemm_kernels_by_span": gemm_by_span,
        "gemm_kernel_names": dict(Counter(names[i][:64] for i in gemm_idx)),
        "unattributed_share_of_busy": unattr["seconds"] / (busy_ns * 1e-9) if busy_ns else None,
        "unattributed_names": dict(Counter(
            names[i][:64] for i, (_, _, c) in enumerate(device)
            if c not in launch_names).most_common(8)),
        "stages": dict(timer.stages), "stage_calls": dict(timer.counts),
        "counters": {str(k): v for k, v in timer.counters.items()},
        "int8_gemm.calls": calls, "int8_gemm.ops": ops, "least_ops": least,
        "int8_gemm.wide": variants["wide"], "int8_gemm.narrow": variants["narrow"],
        "ops_over_least": ops / least - 1.0,
        "int8_gemm_s": gemm_s,
        "int8_gemm_roofline": 100.0 * ops / peaks["int8_ops_per_s"] / gemm_s if gemm_s else None,
        "limb_elementwise_s": limb_s,
        "model_build_s": timer.stages.get("build_model"),
        "ext_obs_s": obs_s,
        "ext_obs.columns": sum(c.get("ext_obs.columns", 0) for c in timer.counters.values()),
        "ext_obs.bytes": obs_bytes,
        "ext_obs_roofline": (100.0 * obs_bytes / peaks["hbm_bytes_per_s"] / obs_s
                             if obs_s else None),
        "memory_peak_bytes": stage_peaks,
        "memory_peak_bytes_max": max(stage_peaks.values(), default=None),
        "sum_check": {"gemm_plus_limb_plus_idle_s": gemm_s + limb_s + idle_s,
                      "idle_in_stages_s": idle_s, "stage_s": stage_s, "stage_span_s": span_s,
                      "rel": (gemm_s + limb_s + idle_s) / stage_s - 1.0},
    }
    print(json.dumps(out, indent=1), flush=True)

    walls = {"untimed": [], "timed": []}
    for i in range(args.pairs):
        order = ("untimed", "timed") if i % 2 == 0 else ("timed", "untimed")
        for kind in order:
            w = evolve(record, StageTimer(device=torch.device("cuda")) if kind == "timed" else None)
            walls[kind].append(w)
            print(f"{kind} evolution: {w:.4f} s", flush=True)
    out["walls"] = walls
    if args.pairs:
        out["timed_over_untimed"] = sum(walls["timed"]) / sum(walls["untimed"]) - 1.0
        print(f"timed / untimed - 1: {out['timed_over_untimed']:+.5f}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
