"""Native (C++) analysis kernels with ctypes bindings.

Port of ``quantumsimulations_tpu/native``, with its own copy of
``analysis_kernels.cpp``.  ``load()`` builds ``libqstnative.so`` on first use
with ``g++ -O3 -shared -fPIC`` into the git-ignored ``build/native/``
beside the package (never into the package directory) and loads it with
ctypes; a library newer than its source is reused.  Without a compiler
every function falls back to the pure-numpy implementations in
``analysis/metrics.py``, which the native ones equal to rounding (they are
golden-tested against each other).  Nothing is built at import time.

No production path calls these helpers, in either package; the tests and
the smoke do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "analysis_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_SO = BUILD_DIR / "libqstnative.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".so.{os.getpid()}")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _SO)  # atomic: a concurrent loader never sees half a file
    return True


def load():
    """Return the loaded ctypes library, building it if needed; None if
    unavailable (no compiler, unsupported platform)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SO.is_file() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None
        c_d = ctypes.c_double
        c_i64 = ctypes.c_int64
        pd = ctypes.POINTER(c_d)
        lib.coarse_grain_batch.restype = c_i64
        lib.coarse_grain_batch.argtypes = [pd, c_i64, c_i64, c_i64, pd]
        lib.iz_slope_from_coarse.restype = None
        lib.iz_slope_from_coarse.argtypes = [pd, pd, c_i64, pd]
        lib.iz_slope_batch.restype = None
        lib.iz_slope_batch.argtypes = [pd, pd, c_i64, c_i64, pd]
        lib.contrast_michelson_with_t_gate.restype = c_d
        lib.contrast_michelson_with_t_gate.argtypes = [c_d, c_d, c_d, c_d, c_d]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


_SLOPE_KEYS = (
    "I_z_slope", "t_start", "t_end", "I_z_start", "I_z_end",
    "slope", "slope_std", "t_value", "R_value", "R2_value",
)


def _as_c(arr: np.ndarray):
    a = np.ascontiguousarray(arr, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def coarse_grain_batch(y: np.ndarray, window: int) -> np.ndarray:
    """Block-average each row of y over `window`; native-accelerated."""
    lib = load()
    y = np.atleast_2d(np.asarray(y, dtype=np.float64))
    n_traces, n = y.shape
    if window <= 1 or n < window:
        return y.copy()
    m = n // window
    if lib is None:
        return y[:, : m * window].reshape(n_traces, m, window).mean(axis=2)
    out = np.empty((n_traces, m), dtype=np.float64)
    ya, yp = _as_c(y)
    oa, op = _as_c(out)
    got = lib.coarse_grain_batch(yp, n_traces, n, window, op)
    if got != m:
        raise RuntimeError(f"coarse_grain_batch returned {got}, expected {m}")
    return oa.reshape(n_traces, m)


def iz_slope_from_coarse(t: np.ndarray, y: np.ndarray) -> dict[str, float]:
    """Native drift-metric fit; same contract as the analysis.metrics version."""
    lib = load()
    if lib is None:
        from ..analysis.metrics import iz_slope_from_coarse as py_impl

        return py_impl(np.asarray(t), np.asarray(y))
    ta, tp = _as_c(t)
    ya, yp = _as_c(y)
    if ya.shape != ta.shape:
        raise ValueError(f"t {ta.shape} and y {ya.shape} differ in shape")
    out = np.empty(10, dtype=np.float64)
    _oa, op = _as_c(out)
    lib.iz_slope_from_coarse(tp, yp, len(ta), op)
    return dict(zip(_SLOPE_KEYS, (float(v) for v in _oa)))


def iz_slope_batch(t: np.ndarray, y: np.ndarray) -> list[dict[str, float]]:
    """Batched slope fits over rows of y (shared time grid)."""
    lib = load()
    y2 = np.atleast_2d(np.asarray(y, dtype=np.float64))
    if lib is None:
        from ..analysis.metrics import iz_slope_from_coarse as py_impl

        return [py_impl(np.asarray(t), row) for row in y2]
    ta, tp = _as_c(t)
    if ta.shape != (y2.shape[1],):
        raise ValueError(f"t {ta.shape} does not match the rows of y {y2.shape}")
    ya, yp = _as_c(y2)
    out = np.empty((y2.shape[0], 10), dtype=np.float64)
    oa, op = _as_c(out)
    lib.iz_slope_batch(tp, yp, y2.shape[0], y2.shape[1], op)
    return [dict(zip(_SLOPE_KEYS, (float(v) for v in row))) for row in oa.reshape(-1, 10)]

