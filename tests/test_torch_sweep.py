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


def test_each_sweep_gets_its_own_directory(tmp_path, monkeypatch):
    """Without base_dir both packages name the sweep directory to the second
    from the same clock reading (frozen here), so they pick the same name."""
    import datetime as real_dt
    import types

    import quantumsimulations_tpu.sweep.runner as jrunner
    import quantumsimulations_tpu_torch.sweep.runner as trunner

    frozen = real_dt.datetime(2026, 3, 4, 5, 6, 7)

    class _Clock(real_dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return frozen

    clock = types.SimpleNamespace(datetime=_Clock)
    monkeypatch.setattr(jrunner, "_dt", clock)
    monkeypatch.setattr(trunner, "_dt", clock)
    cfg = dict(SWEEP, sea_detunings_Hz=[10_000.0], steps=40)
    a = tsweep(**cfg, out_root=str(tmp_path / "port"), device="cpu")
    b = jsweep(**cfg, out_root=str(tmp_path / "ref"))
    assert os.path.basename(a) == os.path.basename(b) == "sea_detuning_sweep_20260304_050607"
    assert os.path.dirname(a) == str(tmp_path / "port")
    for d in (a, b):
        assert os.path.isfile(os.path.join(d, "summary.json"))


def test_a_sweep_never_writes_into_an_earlier_sweeps_directory(tmp_path, monkeypatch):
    """Two sweeps into one root while the clock reads the same second: the
    second waits for the next second and gets its own directory (the JAX
    package would write both into one)."""
    import datetime as real_dt
    import types

    import quantumsimulations_tpu_torch.sweep.runner as trunner

    readings = []

    class _Clock(real_dt.datetime):
        @classmethod
        def now(cls, tz=None):
            readings.append(None)  # the same second for the first three readings
            return real_dt.datetime(2026, 3, 4, 5, 6, 7 + (len(readings) > 3))

    sleeps = []
    monkeypatch.setattr(trunner, "_dt", types.SimpleNamespace(datetime=_Clock))
    monkeypatch.setattr(trunner.time, "sleep", sleeps.append)
    cfg = dict(SWEEP, steps=40)
    a = tsweep(**dict(cfg, sea_detunings_Hz=[10_000.0]), out_root=str(tmp_path), device="cpu")
    b = tsweep(**dict(cfg, sea_detunings_Hz=[20_000.0]), out_root=str(tmp_path), device="cpu")
    assert os.path.basename(a) == "sea_detuning_sweep_20260304_050607"
    assert os.path.basename(b) == "sea_detuning_sweep_20260304_050608"
    assert len(sleeps) == 2 and len(readings) == 4
    for d, label in ((a, "delta_p10000.0Hz"), (b, "delta_p20000.0Hz")):
        assert sorted(x for x in os.listdir(d) if x.startswith("delta_")) == [label]
        rows = _load(os.path.join(d, "summary.json"))["sweep_results"]
        assert [r["delta_Hz"] for r in rows] == [float(label[7:-2])]


def test_unported_solver_writes_nothing(tmp_path):
    """Every solver and the sharded sweep (mesh=, tests/test_torch_sweep_shard.py)
    are ported now; a mesh on another device than the one asked for and an
    unknown solver raise before anything is written."""
    import types

    cuda_mesh = types.SimpleNamespace(device_type="cuda", get_coordinate=lambda: (0, 0))
    with pytest.raises(ValueError, match="the mesh is on 'cuda'"):
        tsweep(**SWEEP, mesh=cuda_mesh, base_dir=str(tmp_path / "x"), device="cpu")
    with pytest.raises(ValueError, match="unknown solver_method"):
        tsweep(**SWEEP, solver_method="bogus", base_dir=str(tmp_path / "x"), device="cpu")
    assert not (tmp_path / "x").exists()


EXT_SWEEP = dict(SWEEP, sea_detunings_Hz=[0.0, 50_000.0], steps=40, solver_method="ext")


@pytest.fixture(scope="module")
def ext_sweep_pair(tmp_path_factory):
    """The same miniature sweep on the stepping solver "ext" (one solve per
    simulation, snapshots under .solver_ckpt/simNNNN)."""
    root = tmp_path_factory.mktemp("ext_sweeps")
    port = tsweep(**EXT_SWEEP, base_dir=str(root / "port"), device="cpu")
    ref = jsweep(**EXT_SWEEP, base_dir=str(root / "ref"))
    return port, ref


def test_ext_sweep_tree_and_values_match(ext_sweep_pair):
    port, ref = ext_sweep_pair
    tree = _tree(port)
    assert tree == _tree(ref)
    assert not [p for p in tree if ".solver_ckpt" in p]  # snapshots cleared
    _assert_values_close(_load(os.path.join(port, "summary.json")),
                         _load(os.path.join(ref, "summary.json")), "summary.json")
    for name in sorted(p for p in tree if p.endswith(".npz") and "time_and_obs" in p):
        got, want = np.load(os.path.join(port, name)), np.load(os.path.join(ref, name))
        assert np.array_equal(got["t"], want["t"])
        for key in want.files:
            assert np.abs(got[key] - want[key]).max() <= 1e-12, (name, key)


@pytest.mark.parametrize("solver,atol", [("expm", 1e-10), ("dopri", 1e-9)])
def test_expm_and_dopri_sweeps_match(tmp_path, solver, atol):
    """The sweep runner routes "expm" (dense, at every dim) and "dopri" (at
    its default tolerances) one simulation at a time, as the JAX runner:
    the same tree and the same traces (dopri: 1e-9, the port-vs-JAX bar of
    its solver tests)."""
    cfg = dict(SWEEP, sea_detunings_Hz=[25_000.0], t_final=2e-4, steps=21, solver_method=solver)
    port = tsweep(**cfg, base_dir=str(tmp_path / "port"), device="cpu")
    ref = jsweep(**cfg, base_dir=str(tmp_path / "ref"))
    tree = _tree(port)
    assert tree == _tree(ref)
    names = sorted(p for p in tree if p.endswith(".npz") and "time_and_obs" in p)
    assert len(names) == 3
    for name in names:
        got, want = np.load(os.path.join(port, name)), np.load(os.path.join(ref, name))
        assert set(got.files) == set(want.files)
        for key in want.files:
            assert np.abs(got[key] - want[key]).max() <= atol, (name, key)


def test_ext_sweep_resumes_inside_a_solve(tmp_path, monkeypatch):
    """A solve aborted after its first advance chunk leaves a snapshot under
    <base_dir>/.solver_ckpt/sim0000; the rerun resumes it and the sweep's
    traces equal an uninterrupted sweep's bit for bit."""
    cfg = dict(EXT_SWEEP, sea_detunings_Hz=[0.0], steps=2100, t_final=0.021)  # 5 blocks
    full = tsweep(**cfg, base_dir=str(tmp_path / "full"), device="cpu")
    base = tmp_path / "cut"
    monkeypatch.setenv("QST_EXT_ABORT_AFTER_CHUNKS", "1")
    with pytest.raises(RuntimeError, match="aborted after 1 advance chunks"):
        tsweep(**cfg, base_dir=str(base), device="cpu")
    assert (base / ".solver_ckpt" / "sim0000" / "ext_advance.npz").is_file()
    monkeypatch.delenv("QST_EXT_ABORT_AFTER_CHUNKS")
    tsweep(**cfg, base_dir=str(base), device="cpu")
    assert not (base / ".solver_ckpt" / "sim0000" / "ext_advance.npz").exists()
    for tag in ("center_off", "center_on", "shell_off"):
        name = os.path.join("delta_p0.0Hz", f"time_and_obs_{tag}.npz")
        got, want = np.load(base / name), np.load(os.path.join(full, name))
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])


STEP_SWEEP = dict(SWEEP, sea_detunings_Hz=[0.0, 50_000.0], t_final=2.0e-3, steps=40)


@pytest.mark.parametrize("solver", ["krylov", "chebyshev"])
def test_matrix_free_sweep_tree_and_values_match(solver, tmp_path):
    """The miniature sweep on the matrix-free stepping solvers (one solve
    per simulation): the same tree, metrics within 1e-8 relative and traces
    within 1e-10 of the JAX package's."""
    cfg = dict(STEP_SWEEP, solver_method=solver)
    port = tsweep(**cfg, base_dir=str(tmp_path / "port"), device="cpu")
    ref = jsweep(**cfg, base_dir=str(tmp_path / "ref"))
    tree = _tree(port)
    assert tree == _tree(ref)
    _assert_values_close(_load(os.path.join(port, "summary.json")),
                         _load(os.path.join(ref, "summary.json")), "summary.json")
    names = sorted(p for p in tree if p.endswith(".npz") and "time_and_obs" in p)
    assert len(names) == 6
    for name in names:
        got, want = np.load(os.path.join(port, name)), np.load(os.path.join(ref, name))
        assert np.array_equal(got["t"], want["t"])
        for key in want.files:
            assert np.abs(got[key] - want[key]).max() <= 1e-10, (name, key)


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
