"""A new cell and a new metric need only new files: a configuration, a
traffic mix, a cell file and a metric reader put into a temporary copy of
the benchmark, with entries added to its ``BENCHMARK.json``, make a cell
that runs and reports the metric, and no file of the copy is edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from smallcells import HERE, ROOT, limit_of, small_config, traffic_of

READER = '''"""chain_products: the chain's stage calls per evolution."""


def read(ctx):
    calls = [ctx["calls"].get(s, 0) for s in ("horner", "squarings", "doubling")]
    return sum(calls) / ctx["n_evolutions"] if all(calls) else None
'''


def _digests(bench):
    return {p.relative_to(bench): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(bench.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell_and_metric(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench)

    cfg = small_config("bath-n12", 3, False)
    cfg["name"] = "bath-n3"
    (bench / "configs" / "bath-n3.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "ext-forced.json").write_text(json.dumps(traffic_of("ext", "ext")))
    (bench / "cells" / "bath-n3.ext-forced.json").write_text(
        json.dumps({"limits": {"trace_gap": limit_of()}}))
    (bench / "metrics" / "chain_products.py").write_text(READER)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "bath-n3", "source": "test", "file": "portbench/configs/bath-n3.json",
                            "reduced": ["n_sea"], "why": "test"})
    spec["workloads"].append({"name": "bath-n3.ext-forced", "config": "bath-n3",
                              "traffic": "ext-forced", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "chain_products", "unit": "products", "better": "lower",
                              "source": "program_span", "layer": "step-operator chain",
                              "moves": "evolution_s", "workloads": ["bath-n3.ext-forced"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before

    # the copy's own harness, as its run.py would load it (run.py itself
    # refuses to run without a card)
    code = f"""
import json, sys, time
t0 = time.perf_counter()
sys.path[:0] = [{str(bench)!r}, {str(ROOT)!r}]
import harness
from pathlib import Path
cell = harness.load_cell(Path({str(root)!r}), "bath-n3.ext-forced")
for trace in (False, True):
    result = harness.run_cell(cell, 7 * 2**31 + 1, 0.0, trace, "cpu", t0)
    print(json.dumps(result))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    plain, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"evolution_s", "setup_s"}
    # 9 Horner steps, the squarings of this chain, 9 doubling passes
    assert traced["metrics"]["chain_products"]["value"] >= 18
    assert traced["metrics"]["chain_products"]["unit"] == "products"
    # the shipped metrics list their cells, so the new cell reports its own
    assert set(traced["metrics"]) == {"chain_products"}
