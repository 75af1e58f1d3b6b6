"""Port vs reference: the 2D (f1A x detuning) grid and its CLI.

Both packages run ``run_grid2d`` on the same small grid (2 rows x 2
detunings, n_sea 3, 200 steps), the port on the CPU.  Each row's summary and
the aggregation over each root agree within METRIC_RTOL (the port propagates
its own traces, ~1e-14 from the JAX package's).  Cross-read: each package's
L3 tools (``aggregate_points``, ``cli.report2d --stable``) read both trees
and give the same arrays and the same ``stable_region_stats.json``.

Rows are named to the second.  The JAX package writes two rows started
within one second into one directory; the port's runner waits for the next
second (``test_fast_rows_get_their_own_directories``, on the real clock).
Every other grid here runs under ``one_second_per_sweep``, so that neither
package's rows can merge and the tests cannot flake.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    F_AZ,
    GAMMA_RARE,
    GAMMA_SEA,
    assert_identical,
    no_jax_compile_cache,
    one_second_per_sweep,
)
from test_torch_sweep import METRIC_RTOL, _assert_values_close
from quantumsimulations_tpu.analysis.aggregate import aggregate_points as jagg
from quantumsimulations_tpu.cli.report2d import main as jreport
from quantumsimulations_tpu.sweep.grid2d import run_grid2d as jgrid
from quantumsimulations_tpu_torch.analysis.aggregate import aggregate_points as tagg
from quantumsimulations_tpu_torch.cli.report2d import main as treport
from quantumsimulations_tpu_torch.cli.sweep2d import main as tsweep2d
from quantumsimulations_tpu_torch.sweep.grid2d import run_grid2d as tgrid

GRID = dict(
    f_Az=F_AZ,
    f1A_values_Hz=[30e3, 50e3],
    gamma_sea=GAMMA_SEA,
    gamma_rare=GAMMA_RARE,
    n_detunings=2,
    n_sea=3,
    t_final=2.0,
    steps=200,
    coarse_window=10,
    make_plots=False,
)
CLI_ARGS = ["--f1a-khz", "30", "50", "--n-detunings", "2", "--n-sea", "3", "--t-final", "2.0",
            "--steps", "200", "--coarse-window", "10", "--no-plots", "--device", "cpu"]


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _rows_by_f1a(dirs):
    out = {}
    for d in dirs:
        summary = _load(os.path.join(d, "summary.json"))
        out[summary["global_params"]["f1A_Hz"]] = (d, summary)
    return out


def _files(base):
    return {
        os.path.relpath(os.path.join(root, f), base)
        for root, _, files in os.walk(base)
        for f in files
    }


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid2d")
    with one_second_per_sweep():
        jdirs = jgrid(**GRID, out_root=str(root / "jax"))
        tdirs = tgrid(**GRID, out_root=str(root / "port"), device="cpu")
    return str(root), jdirs, tdirs


def test_rows_and_summaries_match_reference(grids):
    _, jdirs, tdirs = grids
    assert len(set(tdirs)) == len(tdirs) == 2
    assert all(os.path.basename(d).startswith("sea_detuning_sweep_") for d in tdirs)
    jrows, trows = _rows_by_f1a(jdirs), _rows_by_f1a(tdirs)
    assert sorted(trows) == sorted(jrows) == [30e3, 50e3]
    for f1A in jrows:
        (jd, js), (td, ts) = jrows[f1A], trows[f1A]
        _assert_values_close(ts, js, f"{f1A} summary.json")
        assert [r["delta_Hz"] for r in ts["sweep_results"]] == [0.0, 3.0 * f1A]
        assert _files(td) == _files(jd)


def test_aggregate_points_within_metric_rtol(grids):
    root, _, _ = grids
    got, want = tagg(os.path.join(root, "port")), jagg(os.path.join(root, "jax"))
    assert list(got) == list(want)
    assert len(got["eta"]) == 4
    for key in ("delta_Hz", "f1A_Hz"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("eta", "contrast", "abs_delta_slope"):
        assert np.allclose(got[key], want[key], rtol=METRIC_RTOL, atol=0.0, equal_nan=True), key
    assert got["delta_Hz"].max() == 3.0 * 50e3


@pytest.mark.parametrize("tree", ["port", "jax"])
def test_each_package_reads_the_other_tree(grids, tree, tmp_path, capsys):
    """The parity criterion of the post-processing: aggregation and the
    stable-region report of both packages on one tree are the same."""
    root, _, _ = grids
    tree_root = os.path.join(root, tree)
    assert_identical(tagg(tree_root), jagg(tree_root), tree)
    stats, lines = [], []
    for pkg, report in (("jax", jreport), ("port", treport)):
        out = tmp_path / pkg
        capsys.readouterr()
        report([tree_root, "-o", str(out / "report.pdf"), "--stable",
                "--stable-json", str(out / "stable_region_stats.json")])
        lines.append(capsys.readouterr().out.replace(str(out), "<out>"))
        with open(out / "stable_region_stats.json", encoding="utf-8") as f:
            stats.append(f.read())
        assert _files(str(out)) == {"report.pdf", "stable_region_stats.json",
                                    "graphs/01_contrast_vs_eta.png",
                                    "graphs/02_contrast_vs_scaled_detuning.png",
                                    "graphs/03_abs_slope_diff_vs_eta_zoom.png",
                                    "graphs/04_abs_slope_diff_vs_scaled_detuning_zoom.png",
                                    "graphs/05_pass_fraction_vs_scaled_detuning.png"}
    assert stats[1] == stats[0]
    assert lines[1] == lines[0]
    assert "Aggregated 4 points" in lines[1]


def test_fast_rows_get_their_own_directories(tmp_path):
    """Rows far shorter than a second, on the real clock: each row still gets
    its own directory (the runner waits for the next second where the name
    is taken)."""
    tiny = dict(GRID, f1A_values_Hz=[10e3, 20e3, 50e3], t_final=0.01, steps=20, coarse_window=5)
    dirs = tgrid(**tiny, out_root=str(tmp_path), device="cpu")
    assert len(set(dirs)) == 3
    assert sorted(os.listdir(tmp_path)) == sorted(os.path.basename(d) for d in dirs)
    for d, f1A in zip(dirs, tiny["f1A_values_Hz"]):
        summary = _load(os.path.join(d, "summary.json"))
        assert summary["global_params"]["f1A_Hz"] == f1A
        assert [r["delta_Hz"] for r in summary["sweep_results"]] == [0.0, 3.0 * f1A]


def test_sweep2d_cli_end_to_end(tmp_path, capsys):
    root = str(tmp_path / "grid")
    with one_second_per_sweep():
        tsweep2d(CLI_ARGS + ["--out-root", root])
    out = capsys.readouterr().out
    assert "grid2d complete: 2 sweep rows" in out
    rows = sorted(d for d in os.listdir(root) if d.startswith("sea_detuning_sweep_"))
    assert len(rows) == 2
    for d in rows:
        for name in ("summary.json", "sweep_results.csv", "timings.json"):
            assert os.path.isfile(os.path.join(root, d, name)), name
    assert os.path.isfile(os.path.join(root, "contrast_vs_coupling_summary.pdf"))
    stats = _load(os.path.join(root, "stable_region_stats.json"))
    assert list(stats) == ["criteria", "per_bin", "best_region", "all_regions"]
    assert stats["criteria"]["c_min"] == 0.2 and stats["criteria"]["p_min"] == 0.8
    assert sum(b["n"] for b in stats["per_bin"]) == 4


def test_sweep2d_cli_skip_report(tmp_path):
    root = str(tmp_path / "grid")
    with one_second_per_sweep():
        tsweep2d(CLI_ARGS + ["--out-root", root, "--skip-report"])
    assert len([d for d in os.listdir(root) if d.startswith("sea_detuning_sweep_")]) == 2
    assert not os.path.isfile(os.path.join(root, "contrast_vs_coupling_summary.pdf"))
    assert not os.path.isfile(os.path.join(root, "stable_region_stats.json"))


def test_unported_mesh_and_missing_cuda_write_nothing(tmp_path, monkeypatch, capsys):
    """What cannot run raises before anything is written: ``--mesh-devices``
    outside torchrun (the sharded grid itself runs in
    tests/test_torch_sweep_shard.py), a mesh on another device than the one
    asked for, and CUDA where there is none."""
    import types

    root = tmp_path / "grid"
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit):
        tsweep2d(CLI_ARGS + ["--out-root", str(root), "--mesh-devices", "2"])
    assert "run under torchrun --nproc_per_node 2" in capsys.readouterr().err
    cuda_mesh = types.SimpleNamespace(device_type="cuda", get_coordinate=lambda: (0, 0))
    with pytest.raises(ValueError, match="the mesh is on 'cuda'"):
        tgrid(**GRID, out_root=str(root), mesh=cuda_mesh, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        tgrid(**GRID, out_root=str(root))
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        tsweep2d([a for a in CLI_ARGS if a not in ("--device", "cpu")] + ["--out-root", str(root)])
    assert not root.exists()
