"""Device time by the program span that launched it.

The port's ``StageTimer`` records its stages and launch spans (the int8
GEMMs' ``int8_gemm``, ``ops/extprec.py::int_mm``) on ``time.time_ns``, the
clock of ``torch.profiler``'s timestamps.  The profiler's CUDA activity
records each kernel, copy and fill on the card and the CUDA API call that
launched it (``cudaLaunchKernel``, or ``cuLaunchKernel`` from cuBLASLt),
both under one correlation id.  So each device interval goes to the
innermost program span that was open when its launch call began: a kernel
launched inside an ``int8_gemm`` span counts to it, one launched elsewhere
inside the ``horner`` stage counts to ``horner``.  A device interval whose launch call is not in the trace counts
to ``unattributed``; one launched outside every program span counts to
``outside``.

Stages synchronise the card at both edges, so the device time of the work a
stage launched also lies inside it; a launch span does not synchronise, and
only the pairing with its launch call ties a kernel to it.
"""

from __future__ import annotations

import numpy as np

#: the label of device time whose launch call the trace lacks
UNATTRIBUTED = "unattributed"
#: the label of device time launched outside every program span
OUTSIDE = "outside"


def profile_events(prof) -> tuple[list, list]:
    """(device, launches) of a stopped ``torch.profiler.profile``: the device
    intervals as (start ns, end ns, correlation id) and the CUDA API calls
    (names starting ``cu``) as (start ns, correlation id)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, launches = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            a = e.start_ns()
            device.append((a, a + e.duration_ns(), e.correlation_id()))
        elif e.name().startswith("cu") and e.correlation_id():
            launches.append((e.start_ns(), e.correlation_id()))
    return device, launches


def _segments(spans) -> tuple[np.ndarray, list[str]]:
    """The innermost open span as a step function of time: (the times at
    which it changes, its name from each such time on, "" for none).
    ``spans`` nest, as the timer's context managers make them."""
    bounds = []
    for i, s in enumerate(spans):
        if s.end_ns > s.start_ns:  # an empty span contains no launch
            bounds.append((s.start_ns, 1, i))
            bounds.append((s.end_ns, 0, i))
    bounds.sort()  # at equal times a span ends before the next begins
    times, names, stack = [], [], []
    for t, starts, i in bounds:
        if starts:
            stack.append(i)
        else:
            stack.remove(i)
        times.append(t)
        names.append(spans[stack[-1]].name if stack else "")
    return np.asarray(times, dtype=np.int64), names


def attribute(device, launches, spans, w0: int, w1: int) -> dict[str, dict]:
    """Device seconds and intervals by the innermost program span around
    their launch: ``{label: {"seconds": s, "kernels": n}}``.

    ``device`` and ``launches`` as :func:`profile_events` gives them;
    ``spans`` the program's spans (name, ``start_ns``, ``end_ns``) of the
    traced evolution; each device interval is clipped to the traced window
    [w0, w1], as the busy time of ``devtrace.reduce_profile`` is, and one
    that lies wholly outside it is left out."""
    when = {}
    for ts, corr in launches:
        when.setdefault(corr, ts)
    times, names = _segments(spans)
    out: dict[str, dict] = {}
    for a, b, corr in device:
        if b < w0 or a > w1:
            continue
        a, b = max(a, w0), min(b, w1)
        ts = when.get(corr)
        if ts is None:
            label = UNATTRIBUTED
        else:
            k = int(np.searchsorted(times, ts, side="right")) - 1
            label = (names[k] if k >= 0 else "") or OUTSIDE
        v = out.setdefault(label, {"seconds": 0.0, "kernels": 0})
        v["seconds"] += (b - a) * 1e-9
        v["kernels"] += 1
    return out
