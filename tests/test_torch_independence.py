"""The port and chip_smoke.py import neither JAX nor the JAX package.

Each check runs in a fresh interpreter (this test process has JAX loaded by
conftest.py) and lists the forbidden modules found in ``sys.modules``.  The
sweep without plots must also run where matplotlib is not installed (the
GPU machine has none), so the package and its CLIs must not import it; nor
must the 2D grid and the post-processing modules, whose plots and report
pages import it where they draw.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
{imports}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "quantumsimulations_tpu" or m.startswith("quantumsimulations_tpu."))
print("FORBIDDEN:" + ",".join(bad))
print("MATPLOTLIB:" + str("matplotlib" in sys.modules))
"""

_ALL_PORT_MODULES = """
import quantumsimulations_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
"""


def _probe(imports: str) -> tuple[list[str], bool]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=REPO, imports=imports)],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    bad = [ln for ln in lines if ln.startswith("FORBIDDEN:")][-1][len("FORBIDDEN:"):]
    mpl = [ln for ln in lines if ln.startswith("MATPLOTLIB:")][-1] == "MATPLOTLIB:True"
    return [m for m in bad.split(",") if m], mpl


@pytest.mark.parametrize(
    "imports",
    [
        _ALL_PORT_MODULES,
        "import chip_smoke",
        "import quantumsimulations_tpu_torch.ops.extprec, quantumsimulations_tpu_torch.ops.ext_obs, "
        "quantumsimulations_tpu_torch.dynamics.expm_propagator",
        "import quantumsimulations_tpu_torch.dynamics.dopri, quantumsimulations_tpu_torch.models.labframe, "
        "quantumsimulations_tpu_torch.cli.simulate, quantumsimulations_tpu_torch.ops.split_apply_limb, "
        "quantumsimulations_tpu_torch.utils.cache, quantumsimulations_tpu_torch.utils.profiling",
        "import quantumsimulations_tpu_torch.parallel.mesh, "
        "quantumsimulations_tpu_torch.parallel.distributed, "
        "quantumsimulations_tpu_torch.parallel.sweep_shard, "
        "quantumsimulations_tpu_torch.parallel.state_sharded, "
        "quantumsimulations_tpu_torch.parallel.cheb_sharded, "
        "quantumsimulations_tpu_torch.parallel.expm_sharded, "
        "quantumsimulations_tpu_torch.native",
    ],
    ids=["every_port_module", "chip_smoke", "ext_route_modules", "solver_and_cli_modules",
         "parallel_and_native_modules"],
)
def test_no_jax_and_no_reference_package(imports):
    assert _probe(imports)[0] == []


@pytest.mark.parametrize(
    "imports",
    [
        "import quantumsimulations_tpu_torch, quantumsimulations_tpu_torch.cli.sweep",
        "import chip_smoke",
        "import quantumsimulations_tpu_torch.cli.simulate",
        "import quantumsimulations_tpu_torch.sweep.grid2d, quantumsimulations_tpu_torch.sweep.reprocess, "
        "quantumsimulations_tpu_torch.sweep.reprocess_exponential, "
        "quantumsimulations_tpu_torch.analysis.exponential, "
        "quantumsimulations_tpu_torch.analysis.aggregate, "
        "quantumsimulations_tpu_torch.analysis.stable_region",
        "import quantumsimulations_tpu_torch.cli.sweep2d, quantumsimulations_tpu_torch.cli.reprocess, "
        "quantumsimulations_tpu_torch.cli.reprocess_exponential, "
        "quantumsimulations_tpu_torch.cli.report2d, quantumsimulations_tpu_torch.cli._interactive",
    ],
    ids=["package_and_cli", "chip_smoke", "simulate_cli", "post_processing_and_grid2d",
         "post_processing_clis"],
)
def test_sweep_without_plots_needs_no_matplotlib(imports):
    assert _probe(imports) == ([], False)


def test_port_sources_have_no_forbidden_import_lines():
    pkg = os.path.join(REPO, "quantumsimulations_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                words = line.split()
                if len(words) >= 2 and words[0] in ("import", "from"):
                    mod = words[1].rstrip(",")
                    assert not (mod == "jax" or mod.startswith("jax.")), (path, n)
                    assert not (
                        mod == "quantumsimulations_tpu" or mod.startswith("quantumsimulations_tpu.")
                    ), (path, n)


_RUN_WITHOUT_MATPLOTLIB = """
import sys
sys.path.insert(0, {repo!r})
sys.modules["matplotlib"] = None  # any import of it raises
from quantumsimulations_tpu_torch.cli.sweep2d import main
from quantumsimulations_tpu_torch.sweep.reprocess import find_sweep_dirs, reprocess_sweep
from quantumsimulations_tpu_torch.sweep.reprocess_exponential import reprocess_exponential
main(["--f1a-khz", "50", "--n-detunings", "2", "--n-sea", "3", "--t-final", "0.01",
      "--steps", "40", "--coarse-window", "5", "--no-plots", "--skip-report",
      "--device", "cpu", "--out-root", {root!r}])
(row,) = find_sweep_dirs({root!r})
print("DONE", reprocess_sweep(row, 0), reprocess_sweep(row, 4),
      reprocess_exponential(row, make_plots=False))
"""


def test_grid_and_reprocessing_run_without_matplotlib(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_WITHOUT_MATPLOTLIB.format(repo=REPO, root=str(tmp_path))],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("DONE")]
    assert len(done) == 1 and done[0].count(".json") == 3
