"""Per-stage wall-clock timing, serializable into run artifacts.

The reference's only observability is wall-clock prints around each solve
(sweep_sea_detuning.py:672-690).  :class:`StageTimer` keeps that per-stage
timing in machine-readable form (``timings.json``).  CUDA work is
asynchronous, so on a CUDA device each stage ends with
``torch.cuda.synchronize()`` before its clock is read.

Not yet ported from ``quantumsimulations_tpu/utils/profiling.py``: the
profiler trace context and the NaN-debug mode (ROADMAP.md queue 1 item 2).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import torch


@dataclass
class StageTimer:
    """Accumulates named wall-clock stages; serializable into run artifacts."""

    device: torch.device | None = None
    stages: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self) -> dict:
        return {
            name: {"seconds": self.stages[name], "calls": self.counts[name]}
            for name in self.stages
        }

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.as_dict(), f, indent=2)

    def report(self) -> str:
        lines = [f"{name:30s} {v['seconds']:10.3f}s  x{v['calls']}"
                 for name, v in self.as_dict().items()]
        return "\n".join(lines)
