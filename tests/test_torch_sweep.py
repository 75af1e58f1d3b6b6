"""Port vs reference: the sea-detuning sweep end to end, metrics, and the CLI.

Both packages run ``run_sweep_sea_detuning`` (the function, not the CLI) on
the same miniature sweep, each into its own explicit ``base_dir``.  They must
write the same file tree with the same JSON keys; metric values agree to
1e-8 relative and trace values to 1e-10 absolute (the same host eigh feeds
both, and the traces agree to ~1e-14).
"""

import csv
import json
import os

import numpy as np
import pytest

from _torch_parity import F1A, F_AZ, GAMMA_RARE, GAMMA_SEA, no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.analysis import metrics as jmet
from quantumsimulations_tpu.cli.sweep import build_parser as jparser
from quantumsimulations_tpu.sweep.runner import run_sweep_sea_detuning as jsweep
from quantumsimulations_tpu_torch.analysis import metrics as tmet
from quantumsimulations_tpu_torch.cli.sweep import build_parser as tparser
from quantumsimulations_tpu_torch.cli.sweep import main as tmain
from quantumsimulations_tpu_torch.sweep.runner import run_sweep_sea_detuning as tsweep

SWEEP = dict(
    f_Az=F_AZ,
    f1A=F1A,
    target_sea_detuning=F1A,
    gamma_sea=GAMMA_SEA,
    gamma_rare=GAMMA_RARE,
    sea_detunings_Hz=[0.0, 25_000.0, 50_000.0],
    n_sea=3,
    t_final=0.02,
    steps=300,
    phi_sea=np.pi / 2,
    phi_rare=np.pi / 2,
    solver_atol=1e-10,
    solver_rtol=1e-9,
    coarse_window=20,
    make_plots=False,
)
METRIC_RTOL = 1e-8


def _tree(base):
    out = set()
    for root, _, files in os.walk(base):
        for f in files:
            out.add(os.path.relpath(os.path.join(root, f), base))
    return out


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _assert_values_close(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_values_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_values_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert np.isclose(got, want, rtol=METRIC_RTOL, atol=0.0, equal_nan=True), (where, got, want)
    else:
        assert got == want, (where, got, want)


@pytest.fixture(scope="module")
def sweep_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweeps")
    port = tsweep(**SWEEP, base_dir=str(root / "port"), device="cpu")
    ref = jsweep(**SWEEP, base_dir=str(root / "ref"))
    return port, ref


def test_same_artifact_tree(sweep_pair):
    port, ref = sweep_pair
    tree = _tree(port)
    assert tree == _tree(ref)
    for label in ("delta_p0.0Hz", "delta_p25000.0Hz", "delta_p50000.0Hz"):
        for tag in ("center_off", "center_on", "shell_off"):
            assert os.path.join(label, f"time_and_obs_{tag}.npz") in tree


@pytest.mark.parametrize("name", ["summary.json", "global_params.json"])
def test_top_level_json_match(sweep_pair, name):
    port, ref = sweep_pair
    _assert_values_close(_load(os.path.join(port, name)), _load(os.path.join(ref, name)), name)


@pytest.mark.parametrize("label", ["delta_p0.0Hz", "delta_p25000.0Hz", "delta_p50000.0Hz"])
def test_per_point_metrics_params_and_traces_match(sweep_pair, label):
    port, ref = sweep_pair
    for name in sorted(os.listdir(os.path.join(ref, label))):
        p, r = os.path.join(port, label, name), os.path.join(ref, label, name)
        if name.endswith(".json"):
            _assert_values_close(_load(p), _load(r), f"{label}/{name}")
        elif name.endswith(".npz"):
            got, want = np.load(p), np.load(r)
            assert set(got.files) == set(want.files)
            assert np.array_equal(got["t"], want["t"])
            for key in want.files:
                assert np.abs(got[key] - want[key]).max() <= 1e-10, (name, key)


def test_csv_geometry_and_timings_match(sweep_pair):
    port, ref = sweep_pair
    with open(os.path.join(port, "sweep_results.csv")) as f:
        rows_p = list(csv.DictReader(f))
    with open(os.path.join(ref, "sweep_results.csv")) as f:
        rows_r = list(csv.DictReader(f))
    assert [list(r) for r in rows_p] == [list(r) for r in rows_r]
    assert [r["delta_Hz"] for r in rows_p] == [r["delta_Hz"] for r in rows_r]
    gp, gr = (np.load(os.path.join(d, "geometry_and_couplings.npz")) for d in (port, ref))
    assert set(gp.files) == set(gr.files)
    for key in gr.files:
        assert np.array_equal(gp[key], gr[key]), key
    assert set(_load(os.path.join(port, "timings.json"))) == set(
        _load(os.path.join(ref, "timings.json"))
    )


def test_sweep_physics(sweep_pair):
    port, _ = sweep_pair
    for label in ("delta_p0.0Hz", "delta_p50000.0Hz"):
        off = np.load(os.path.join(port, label, "time_and_obs_center_off.npz"))
        assert np.isclose(off["Iz_sea"][0], -1.5, rtol=0, atol=1e-14)
        for tag in ("center_off", "center_on", "shell_off"):
            tr = np.load(os.path.join(port, label, f"time_and_obs_{tag}.npz"))
            assert np.abs(tr["state_norm"] - 1.0).max() < 1e-12


def test_resume_skips_finished_points(sweep_pair, tmp_path, capsys):
    port, _ = sweep_pair
    summary = _load(os.path.join(port, "summary.json"))
    base = tmp_path / "resumed"
    first = dict(SWEEP, sea_detunings_Hz=[0.0])
    tsweep(**first, base_dir=str(base), device="cpu")
    capsys.readouterr()
    tsweep(**SWEEP, base_dir=str(base), resume=True, device="cpu")
    assert "resume: skipping" in capsys.readouterr().out
    got = _load(os.path.join(base, "summary.json"))["sweep_results"]
    _assert_values_close(got, summary["sweep_results"], "resumed")


def test_each_sweep_gets_its_own_directory(tmp_path):
    cfg = dict(SWEEP, sea_detunings_Hz=[10_000.0], steps=40)
    a = tsweep(**cfg, out_root=str(tmp_path), device="cpu")
    b = tsweep(**cfg, out_root=str(tmp_path), device="cpu")
    assert a != b
    for d in (a, b):
        assert os.path.basename(d).startswith("sea_detuning_sweep_")
        assert os.path.isfile(os.path.join(d, "summary.json"))


def test_unported_solver_writes_nothing(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tsweep(**SWEEP, solver_method="dopri", base_dir=str(tmp_path / "x"), device="cpu")
    assert not (tmp_path / "x").exists()


def test_cli_flags_and_defaults_match_reference():
    def actions(parser):
        return {a.dest: (a.default, a.choices) for a in parser._actions if a.dest != "help"}

    port, ref = actions(tparser()), actions(jparser())
    assert port.pop("device") == ("cuda", ("cuda", "cpu"))
    assert ref.pop("platform")[0] == "auto"
    assert port == ref


def test_cli_runs_on_cpu(tmp_path):
    base = tmp_path / "cli"
    out = tmain([
        "--n-sea", "3", "--t-final", "0.01", "--steps", "60", "--detunings", "0", "50000",
        "--coarse-window", "10", "--no-plots", "--base-dir", str(base), "--device", "cpu",
    ])
    assert out == str(base)
    assert len(_load(base / "summary.json")["sweep_results"]) == 2


def _series(seed, n=400):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n)
    return t, -1.5 + 0.3 * t + 0.01 * rng.standard_normal(n)


@pytest.mark.parametrize("window", [1, 7, 20, 1000])
def test_metrics_match_reference(window):
    t, y = _series(window)
    tc_p, yc_p = tmet.coarse_grain(t, y, window)
    tc_r, yc_r = jmet.coarse_grain(t, y, window)
    assert np.array_equal(tc_p, tc_r) and np.array_equal(yc_p, yc_r)
    _assert_values_close(
        tmet.iz_slope_from_coarse(tc_p, yc_p), jmet.iz_slope_from_coarse(tc_r, yc_r), "slope"
    )
    args = (0.3, -0.2, 3.0, 0.5)
    assert tmet.contrast_michelson_with_t_gate(*args) == jmet.contrast_michelson_with_t_gate(*args)
    assert tmet.detuning_label(-window * 1.5) == jmet.detuning_label(-window * 1.5)
    assert tmet.f1R_for_resonance(5e4, window * 1e3) == jmet.f1R_for_resonance(5e4, window * 1e3)
    assert tmet.eta_mismatch(window * 1e3, 5e4, 7e4, 12.0) == jmet.eta_mismatch(
        window * 1e3, 5e4, 7e4, 12.0
    )
