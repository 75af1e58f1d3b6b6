"""Small cells for the benchmark's CPU tests: a temporary checkout holding a
copy of the benchmark and cells at a few sea spins."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def small_config(base: str, n_sea: int, spin_three_half: bool) -> dict:
    """The configuration ``base`` at ``n_sea`` sea spins, every other value
    as the configuration states it (30 s over 20,000 output steps)."""
    cfg = json.loads((HERE / "configs" / f"{base}.json").read_text())
    cfg["params"].update(n_sea=n_sea, is_spin_three_half=spin_three_half)
    return cfg


def make_root(tmp: Path, cells: dict) -> Path:
    """A checkout in ``tmp``: a copy of the benchmark plus, for each
    ``name -> (config dict, traffic dict, limit)`` of ``cells``, a
    configuration, a traffic mix, a cell file and a workload, every metric
    of the shipped cells extended to it."""
    root = tmp / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (cfg, traffic, limit) in cells.items():
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        (root / "portbench" / "cells" / f"{name}.{name}.json").write_text(
            json.dumps({"limits": {"trace_gap": limit}}))
        spec["configs"].append({"name": name, "source": "test", "reduced": ["n_sea"], "why": "test",
                                "file": f"portbench/configs/{name}.json"})
        spec["workloads"].append({"name": f"{name}.{name}", "config": name, "traffic": name,
                                  "chips": 1, "why": "test"})
        for m in spec["per_layer"]:
            m["workloads"].append(f"{name}.{name}")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def traffic_of(name: str, solver: str | None = None) -> dict:
    """The shipped traffic mix ``name``, its solver replaced where given."""
    tr = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if solver is not None:
        tr["solver"] = solver
    return tr


def limit_of(cell: str = "bath-n12.ext") -> float:
    """The trace-gap limit of the shipped cell ``cell``: the one limit set
    from sound runs, which the small cells of every route are held to."""
    return float(json.loads((HERE / "cells" / f"{cell}.json").read_text())["limits"]["trace_gap"])
