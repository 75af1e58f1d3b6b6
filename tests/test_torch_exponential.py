"""Port vs reference: the exponential-to-plateau fits (analysis/exponential.py).

Host numpy in both packages, the same calls in the same order: every result
must equal the JAX package's exactly, NaN for NaN.  The traces are made with
numpy from fixed seeds and cover every status of the fit.
"""

import dataclasses

import numpy as np
import pytest

from _torch_parity import assert_identical
from quantumsimulations_tpu.analysis import exponential as jexp
from quantumsimulations_tpu_torch.analysis import exponential as texp

STATUSES = {"OK", "FLAT", "CENSORED", "BAD_FIT", "TOO_FEW"}


def _decay(seed, n=120, tau=8.0, noise=1e-3, a=0.6, plateau=-0.2):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 60.0, n)
    return t, plateau + a * np.exp(-t / tau) + noise * rng.standard_normal(n)


def _censored():
    # late window of four values at +-0.1 around its median: no sample within
    # 0.1 R0 of the plateau, and only the first three above 3 sigma
    y = np.concatenate([np.full(3, 1.35), np.full(20, 0.4), [0.55, 0.55, 0.75, 0.75]])
    return np.arange(y.size, dtype=float), y


def _rising_then_flat(seed):
    rng = np.random.default_rng(seed)
    y = np.concatenate([1.0 + 0.2 * np.arange(8), 1e-4 * rng.standard_normal(32)])
    return np.arange(y.size, dtype=float), y


def _with_nans(seed):
    t, y = _decay(seed)
    y[[5, 17, 60]] = np.nan
    t[40] = np.inf
    return t, y


CASES = {
    "ok_decay": lambda: _decay(1),
    "ok_rise_to_plateau": lambda: _decay(2, a=-0.9, plateau=0.3),
    "ok_with_nans": lambda: _with_nans(3),
    "ok_noisy": lambda: _decay(4, noise=2e-2, tau=15.0),
    "flat": lambda: _decay(5, a=0.0, noise=1e-2),
    "flat_exact": lambda: (np.arange(10.0), np.full(10, 0.25)),
    "censored": _censored,
    "bad_fit": lambda: _rising_then_flat(6),
    "too_few_samples": lambda: (np.arange(3.0), np.array([1.0, 0.5, 0.2])),
    "too_few_finite": lambda: (np.arange(6.0), np.array([1.0, np.nan, 0.5, np.nan, np.nan, 0.1])),
    "too_few_fit_points": lambda: _decay(7, n=40, tau=0.8, noise=1e-4),
    "empty": lambda: (np.zeros(0), np.zeros(0)),
    "lists": lambda: ([0.0, 1.0, 2.0, 3.0, 4.0, 5.0], [3.0, 2.0, 1.5, 1.2, 1.1, 1.05]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fit_equals_reference(name):
    t, y = CASES[name]()
    want = jexp.fit_exponential_to_plateau(t, y)
    got = texp.fit_exponential_to_plateau(t, y)
    assert type(got).__name__ == "RelaxFit" and dataclasses.is_dataclass(got)
    assert_identical(dataclasses.asdict(got), dataclasses.asdict(want), name)


def test_cases_cover_every_status():
    got = {texp.fit_exponential_to_plateau(*CASES[n]()).status for n in CASES}
    assert got == STATUSES


@pytest.mark.parametrize(
    "kw",
    [dict(plateau_frac=0.3), dict(early_frac=0.25), dict(alpha_noise=10.0), dict(min_points=40)],
)
def test_fit_options_equal_reference(kw):
    for name in ("ok_decay", "ok_noisy", "bad_fit"):
        t, y = CASES[name]()
        assert_identical(
            dataclasses.asdict(texp.fit_exponential_to_plateau(t, y, **kw)),
            dataclasses.asdict(jexp.fit_exponential_to_plateau(t, y, **kw)),
            f"{name} {kw}",
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mad_sigma_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for x in (
        rng.standard_normal(1 + 37 * seed),
        rng.standard_t(2.0, size=64) * 1e-3,
        np.array([np.nan, 1.0, 2.0]),
        np.zeros(0),
    ):
        assert_identical(texp.mad_sigma(x), jexp.mad_sigma(x), str(x[:3]))


def test_interp_threshold_time_equals_reference():
    rng = np.random.default_rng(11)
    t = np.sort(rng.uniform(0.0, 5.0, 50))
    r = np.exp(-t) + 1e-3 * rng.standard_normal(50)
    cases = [
        (t, r, 0.3),  # crossing between samples
        (t, r, 2.0),  # below at the first sample
        (t, r, -1.0),  # never below
        (np.zeros(0), np.zeros(0), 0.1),  # empty
        (t[:4], np.array([1.0, np.nan, 0.05, 0.01]), 0.1),  # non-finite before the crossing
        (t[:4], np.array([1.0, np.inf, 0.05, 0.01]), 0.1),
        (t[:3], np.array([0.5, 0.2, 0.1]), 0.2),  # lands on a sample
    ]
    for i, (tt, rr, thr) in enumerate(cases):
        assert_identical(texp.interp_threshold_time(tt, rr, thr),
                         jexp.interp_threshold_time(tt, rr, thr), str(i))


def test_eval_fit_curve_equals_reference():
    t = np.linspace(0.0, 30.0, 77)
    for name in ("ok_decay", "flat", "censored", "empty"):
        tt, y = CASES[name]()
        fj = jexp.fit_exponential_to_plateau(tt, y)
        ft = texp.fit_exponential_to_plateau(tt, y)
        for sign0 in (1.0, -1.0):
            assert_identical(texp.eval_fit_curve(t, ft, sign0), jexp.eval_fit_curve(t, fj, sign0),
                             f"{name} {sign0}")
    fit = texp.fit_exponential_to_plateau(*CASES["ok_decay"]())
    assert_identical(texp.eval_fit_curve([0.0, 1.0], fit, 1.0),
                     jexp.eval_fit_curve([0.0, 1.0], jexp.fit_exponential_to_plateau(
                         *CASES["ok_decay"]()), 1.0))
    assert np.isfinite(texp.eval_fit_curve(t, fit, 1.0)).all()
    assert np.isnan(texp.eval_fit_curve(t, texp.fit_exponential_to_plateau(
        *CASES["flat"]()), 1.0)).all()
