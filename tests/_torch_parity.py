"""Shared pieces of the port-vs-reference tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed, and are
compared as numpy arrays.  The JAX reference stays on the CPU (conftest.py).
"""

from __future__ import annotations

import contextlib
import json
import os

import jax
import numpy as np
import pytest
from jax.experimental.compilation_cache import compilation_cache

GAMMA_SEA, GAMMA_RARE = 8.1812e7, 6.976e7
B0 = 3.0
F_AZ = GAMMA_SEA * B0 / (2 * np.pi)
F1A = 50e3


@pytest.fixture(autouse=True, scope="module")
def no_jax_compile_cache():
    """Keep the reference from writing persistent compile-cache entries.

    QST_COMPILE_CACHE=0 covers entry points that would enable the cache; the
    cache is also switched off for the whole module, in case an earlier test
    in the same worker process pointed it at a directory.  Module scope, so
    that module-scoped fixtures which run the reference are covered too.
    """
    prev = jax.config.jax_enable_compilation_cache
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("QST_COMPILE_CACHE", "0")
        jax.config.update("jax_enable_compilation_cache", False)
        compilation_cache.reset_cache()
        yield
    jax.config.update("jax_enable_compilation_cache", prev)
    compilation_cache.reset_cache()


def production_params_kwargs(n_sea: int, **overrides) -> dict:
    """Keyword arguments of DipolarRareParams at the production physics
    (71Ga sea / 27Al rare at 3 T, f1A = 50 kHz, rare on Hartmann-Hahn)."""
    f1r = np.hypot(F1A, F1A)
    kw = dict(
        n_sea=n_sea,
        gamma_sea=GAMMA_SEA,
        gamma_rare=GAMMA_RARE,
        B0_sea=B0,
        B0_rare=B0,
        B1_sea=2 * np.pi * F1A / GAMMA_SEA,
        B1_rare=2 * np.pi * f1r / GAMMA_RARE,
        omega_rf_sea=2 * np.pi * (F_AZ - F1A),
        omega_rf_rare=GAMMA_RARE * B0,
        phi_sea=np.pi / 2,
        phi_rare=np.pi / 2,
        dipolar_scale=1e-7 * 1.054571817e-34,
        shell_scale=0.282393e-9,
        drive_sea=True,
        drive_rare=True,
        is_spin_three_half=False,
        is_center_rare=True,
    )
    kw.update(overrides)
    return kw


def stepper_kwargs(**kw):
    """tests/test_steppers.py:24-50's parameters (n_sea = 3, 1 kHz sea
    detuning, 51 steps over 0.5 ms)."""
    gamma_sea, gamma_rare, B0, f1A = 8.1812e7, 6.976e7, 3.0, 50e3
    base = dict(
        n_sea=3, gamma_sea=gamma_sea, gamma_rare=gamma_rare, B0_sea=B0, B0_rare=B0,
        B1_sea=2 * np.pi * f1A / gamma_sea, B1_rare=2 * np.pi * 70710.678 / gamma_rare,
        omega_rf_sea=gamma_sea * B0 - 2 * np.pi * 1000.0, omega_rf_rare=gamma_rare * B0,
        phi_sea=np.pi / 2, phi_rare=np.pi / 2, dipolar_scale=1e-7 * 1.054571817e-34,
        shell_scale=0.282393e-9, t_final=5.0e-4, steps=51, drive_sea=True, drive_rare=True,
        is_spin_three_half=False, is_center_rare=True,
    )
    base.update(kw)
    return base


#: the sweep the post-processing tests read (n_sea 3, three detunings, 400
#: steps over 2 s, window 20): rare-center contrasts of 0 and -1 and the fit
#: statuses OK, FLAT, TOO_FEW and BAD_FIT among its traces
POST_SWEEP = dict(
    f_Az=F_AZ,
    f1A=F1A,
    target_sea_detuning=F1A,
    gamma_sea=GAMMA_SEA,
    gamma_rare=GAMMA_RARE,
    sea_detunings_Hz=[0.0, 25_000.0, 50_000.0],
    n_sea=3,
    t_final=2.0,
    steps=400,
    phi_sea=np.pi / 2,
    phi_rare=np.pi / 2,
    coarse_window=20,
    make_plots=False,
)
POST_SWEEP_NAME = "sea_detuning_sweep_20260102_030405"


def sweep_copies(root) -> tuple[str, str]:
    """One sweep tree made by the JAX runner, copied once per package.

    Returns the sweep directories of the copies ``root/jax`` and
    ``root/port``; each package's post-processing then writes only into its
    own copy.
    """
    import io
    import shutil

    from quantumsimulations_tpu.sweep.runner import run_sweep_sea_detuning

    made = os.path.join(str(root), "made")
    with contextlib.redirect_stdout(io.StringIO()):
        run_sweep_sea_detuning(**POST_SWEEP, base_dir=os.path.join(made, POST_SWEEP_NAME))
    out = []
    for pkg in ("jax", "port"):
        shutil.copytree(made, os.path.join(str(root), pkg))
        out.append(os.path.join(str(root), pkg, POST_SWEEP_NAME))
    return out[0], out[1]


@contextlib.contextmanager
def one_second_per_sweep():
    """Both runners name a sweep directory to the second; within this
    context their clock advances one second per reading, so that two grid
    rows never share a directory however fast they run."""
    import datetime as real_dt
    import itertools
    import types

    import quantumsimulations_tpu.sweep.runner as jrunner
    import quantumsimulations_tpu_torch.sweep.runner as trunner

    ticks = itertools.count()
    start = real_dt.datetime(2026, 1, 2, 3, 4, 5)

    class _Clock(real_dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return start + real_dt.timedelta(seconds=next(ticks))

    clock = types.SimpleNamespace(datetime=_Clock)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner, "_dt", clock)
        mp.setattr(trunner, "_dt", clock)
        yield


def assert_identical(got, want, where: str = "") -> None:
    """Equal values of equal types, float for float bit for bit, NaN for NaN
    (lists, tuples, dicts and numpy arrays compared element by element)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, got, want)
        for k in want:
            assert_identical(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_identical(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want, equal_nan=want.dtype.kind in "fc"), where
    elif isinstance(want, float):
        assert type(got) is type(want), (where, got, want)
        assert got == want or (np.isnan(got) and np.isnan(want)), (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _row(rng, delta, f1A, legacy=False):
    x = delta / f1A if f1A else 0.0
    row = {
        "delta_Hz": float(delta),
        "DeltaOmega_over_geff": float(rng.normal(3.0 * x, 0.5)),
        # negative and large near x ~ 1, small elsewhere
        "contrast_rare_center": float(-0.6 * np.exp(-((x - 1.0) ** 2) / 0.2)
                                      + rng.normal(0.0, 0.15)),
    }
    if not legacy:
        row["I_z_slope_on_center"] = float(rng.normal(0.0, 1e-3))
        row["I_z_slope_off_center"] = float(rng.normal(0.0, 1e-3))
    return row


def _write(root, rel, summary):
    path = os.path.join(root, rel, "summary.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(summary, f)


def make_synthetic_root(root, seed, legacy_only=False):
    """Summaries written from a seed, as sweep rows of the 2D grid.

    Seven summaries: three 13-detuning rows, a legacy one (no slope fields),
    f1A 0, NaN and missing, and rows with non-finite or missing fields; with
    ``legacy_only``, three legacy rows and nothing else."""
    rng = np.random.default_rng(seed)
    if legacy_only:
        for f1A in (10e3, 20e3, 50e3):
            _write(root, f"legacy/sweep_{int(f1A)}", {"global_params": {"f1A_Hz": f1A},
                   "sweep_results": [_row(rng, d, f1A, legacy=True)
                                     for d in np.linspace(0.0, 3.0 * f1A, 13)]})
        return root
    for i, f1A in enumerate((10e3, 20e3, 50e3)):
        rows = [_row(rng, d, f1A) for d in np.linspace(0.0, 3.0 * f1A, 13)]
        if i == 0:
            rows[3]["DeltaOmega_over_geff"] = float("nan")
            del rows[5]["contrast_rare_center"]
            rows[7]["I_z_slope_off_center"] = float("inf")
        if i == 2:
            del rows[2]["I_z_slope_on_center"]
        _write(root, f"grid/sea_detuning_sweep_2026010{i}_000000",
               {"global_params": {"f1A_Hz": f1A}, "sweep_results": rows})
    _write(root, "legacy/sweep_a", {"global_params": {"f1A_Hz": 30e3}, "sweep_results": [
        _row(rng, d, 30e3, legacy=True) for d in np.linspace(0.0, 90e3, 13)]})
    _write(root, "zero/f1a_zero", {"global_params": {"f1A_Hz": 0.0},
                                   "sweep_results": [_row(rng, 1e3, 0.0)]})
    _write(root, "nan/f1a_nan", {"global_params": {"f1A_Hz": float("nan")},
                                 "sweep_results": [_row(rng, 1e3, 1e3)]})
    _write(root, "nested/deeper/no_f1a", {"sweep_results": [_row(rng, 1e3, 1e3)]})
    return root
