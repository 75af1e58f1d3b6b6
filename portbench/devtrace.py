"""Reduction of one ``torch.profiler`` window to what the metrics read.

The harness records the traced evolution as a host span ``evolution`` and
each of the port's ``StageTimer`` stages as a span ``stage:<name>``.  From
the profiler's device events and those spans this module takes:

  * the device intervals (kernels, copies, fills) and their union, the
    seconds in which the card worked (``busy_s``), over the traced window's
    length (``window_s``);
  * the device seconds and launches of each kernel, by name;
  * the idle seconds of the card by what the host was doing at the time: the
    innermost span around each gap's midpoint (a stage, ``evolution`` outside
    the stages, or ``harness`` outside the evolution).
"""

from __future__ import annotations

import numpy as np
import torch


def reduce_profile(prof, spans: list) -> dict | None:
    """The summary of ``prof`` (a stopped ``torch.profiler.profile``) over
    the traced window: from the start of the first ``evolution`` of
    ``spans`` to the end of the last.  ``spans`` are the harness's host spans
    (start ns, end ns, name) on ``time.time_ns``, the clock of the
    profiler's timestamps.  None where no evolution was traced."""
    starts, ends, names = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            a = e.start_ns()
            starts.append(a)
            ends.append(a + e.duration_ns())
            names.append(e.name())
    evos = [(a, b) for a, b, n in spans if n == "evolution"]
    if not evos:
        return None
    w0, w1 = min(a for a, _ in evos), max(b for _, b in evos)
    s = np.clip(np.asarray(starts, dtype=np.int64), w0, w1)
    t = np.clip(np.asarray(ends, dtype=np.int64), w0, w1)
    kernels: dict[str, list] = {}
    for name, a, b in zip(names, s, t):
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) * 1e-9
        k[1] += 1
    busy_ns, g0, g1 = _union(s, t, w0, w1)
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "kernels": {k: {"seconds": v[0], "launches": v[1]} for k, v in kernels.items()},
        "idle_by_host": _attribute(g0, g1, spans),
    }


def _union(s: np.ndarray, t: np.ndarray, w0: int, w1: int):
    """(busy ns, idle gap starts, idle gap ends) of the intervals [s, t)
    inside [w0, w1)."""
    if len(s) == 0:
        return 0, np.asarray([w0]), np.asarray([w1])
    order = np.argsort(s, kind="stable")
    s, t = s[order], t[order]
    reach = np.maximum.accumulate(t)
    # a new busy run starts where an interval begins after all before it ended
    new = np.empty(len(s), dtype=bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    run_start = s[new]
    run_end = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    busy = int((run_end - run_start).sum())
    gap_start = np.concatenate([[w0], run_end])
    gap_end = np.concatenate([run_start, [w1]])
    keep = gap_end > gap_start
    return busy, gap_start[keep], gap_end[keep]


def _attribute(g0: np.ndarray, g1: np.ndarray, spans) -> dict[str, float]:
    """Idle seconds per innermost host span at each gap's midpoint."""
    stages = sorted((a, b, n[len("stage:"):]) for a, b, n in spans if n.startswith("stage:"))
    evos = sorted((a, b) for a, b, n in spans if n == "evolution")
    labels = ["harness", "evolution"] + sorted({n for _, _, n in stages})
    mid = (g0 + g1) // 2
    label = np.zeros(len(mid), dtype=np.int64)
    for (a, b), lab in [(e, 1) for e in evos] + [((a, b), labels.index(n)) for a, b, n in stages]:
        label[(mid >= a) & (mid < b)] = lab  # stages lie inside evolutions: set after
    sec = np.bincount(label, weights=(g1 - g0) * 1e-9, minlength=len(labels))
    return {name: float(v) for name, v in zip(labels, sec) if v > 0}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The ``breakdown`` of a result line: the kernels that took the most
    device time, and the host spans the card waited on the longest."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["seconds"])[:top]
    idle = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:64], v["seconds"]] for name, v in ops],
            "idle_gaps": [[name, sec] for name, sec in idle]}
