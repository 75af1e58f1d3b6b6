"""The port's native C++ analysis helpers (quantumsimulations_tpu_torch/native,
its own copy of analysis_kernels.cpp) against the JAX package's native
library and the port's pure-numpy metrics (analysis/metrics.py), on the same
seeded inputs, with tests/test_native.py's bars.  Skips without a C++
toolchain, as that test does; the fallback without one is held against the
metrics too.
"""

import numpy as np
import pytest

from quantumsimulations_tpu import native as jnative
from quantumsimulations_tpu_torch import native
from quantumsimulations_tpu_torch.analysis.metrics import (
    coarse_grain,
    contrast_michelson_with_t_gate,
    iz_slope_from_coarse,
)


@pytest.fixture
def needs_native():
    """Build (or load) both libraries here, not while the module is collected."""
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")


def _same(a: float, b: float, rtol: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or bool(np.isclose(a, b, rtol=rtol, atol=1e-300))


def test_library_builds_outside_the_package():
    from pathlib import Path

    import quantumsimulations_tpu_torch

    pkg = Path(quantumsimulations_tpu_torch.__file__).resolve().parent
    assert native._SO.parent == pkg.parent / "build" / "native"
    assert not list(pkg.rglob("*.so"))


def test_coarse_grain_batch_matches_reference_and_python(needs_native):
    rng = np.random.default_rng(17)
    y = rng.standard_normal((5, 1003))
    t = np.linspace(0, 1, 1003)
    got = native.coarse_grain_batch(y, window=25)
    np.testing.assert_array_equal(got, jnative.coarse_grain_batch(y, window=25))
    for i in range(5):
        _, want = coarse_grain(t, y[i], window=25)
        assert np.allclose(got[i], want, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("window", [1, 100])
def test_coarse_grain_batch_noop_window(needs_native, window):
    y = np.random.default_rng(3).standard_normal((2, 10))
    np.testing.assert_array_equal(native.coarse_grain_batch(y, window=window), y)


@pytest.mark.parametrize("n", [3, 4, 10, 50, 400])
def test_slope_fit_matches_reference_and_python(needs_native, n):
    rng = np.random.default_rng(100 + n)
    t = np.linspace(0.0, 3.0, n)
    y = 0.3 + 1.7 * t + 0.05 * rng.standard_normal(n)
    got = native.iz_slope_from_coarse(t, y)
    ref = jnative.iz_slope_from_coarse(t, y)
    py = iz_slope_from_coarse(t, y)
    assert list(got) == list(ref)
    for k in py:
        assert _same(got[k], ref[k], 0.0), k
        assert _same(got[k], py[k], 1e-12), k


def test_slope_batch_matches_reference_and_python(needs_native):
    rng = np.random.default_rng(17)
    t = np.linspace(0.0, 1.0, 60)
    Y = rng.standard_normal((7, 60)).cumsum(axis=1)
    got = native.iz_slope_batch(t, Y)
    ref = jnative.iz_slope_batch(t, Y)
    for i in range(7):
        single = iz_slope_from_coarse(t, Y[i])
        for k in single:
            assert _same(got[i][k], ref[i][k], 0.0), (i, k)
            assert _same(got[i][k], single[k], 1e-12), (i, k)


_CONTRAST = [(2.0, 1.0, 10.0, 10.0), (2.0, 1.0, 0.5, 10.0), (2.0, 1.0, 10.0, 0.5),
             (2.0, 1.0, 0.5, 0.5), (-2.0, 1.0, -10.0, 10.0), (np.nan, 1.0, 10.0, 10.0),
             (2.0, 1.0, np.nan, 10.0)]


@pytest.mark.parametrize("case", _CONTRAST)
def test_contrast_matches_reference_and_python(needs_native, case):
    want = contrast_michelson_with_t_gate(*case)
    ref = jnative.load().contrast_michelson_with_t_gate(*case, 1.0)
    got = native.load().contrast_michelson_with_t_gate(*case, 1.0)
    assert _same(got, want, 0.0) and _same(got, ref, 0.0)


def test_fallback_without_compiler_equals_python(monkeypatch):
    """Where no library can be built, every helper takes the numpy path."""
    monkeypatch.setattr(native, "load", lambda: None)
    rng = np.random.default_rng(5)
    t = np.linspace(0.0, 1.0, 40)
    Y = rng.standard_normal((3, 40))
    assert not native.available()
    np.testing.assert_array_equal(native.coarse_grain_batch(Y, 4),
                                  Y.reshape(3, 10, 4).mean(axis=2))
    for i, fit in enumerate(native.iz_slope_batch(t, Y)):
        want = iz_slope_from_coarse(t, Y[i])
        assert all(_same(fit[k], want[k], 0.0) for k in want)
