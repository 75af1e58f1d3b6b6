"""Hand-written CUDA kernels of the port: build and load (``_build.py``,
whose ``SOURCES`` lists them), and the launches a tracer counted.

A kernel's wrapper counts each launch, on the card only, in the active
tracer (``utils/profiling.py::count``) as ``<kernel>.launches`` (e.g.
``ext_carry.launches``); the int8 GEMM counts the variant it launched,
``int8_gemm.wide`` or ``int8_gemm.narrow``.  A run shows that its path went
through the kernels by running under a ``StageTimer`` made the active tracer
(``profiling.tracing``, or ``simulate_rare(timer=)``, whose timer takes the
counts of its evolution) and reading :func:`launches` of it.
"""

from __future__ import annotations

from collections import Counter


def launches(timer) -> Counter:
    """Launches per kernel that the ``StageTimer`` ``timer`` counted, summed
    over its stages (a kernel it did not count reads 0)."""
    out: Counter = Counter()
    for counters in timer.counters.values():
        for name, n in counters.items():
            kernel, _, what = name.rpartition(".")
            if what == "launches" or (kernel == "int8_gemm" and what in ("wide", "narrow")):
                out[kernel] += n
    return out
