"""Shared pieces of the port-vs-reference tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed, and are
compared as numpy arrays.  The JAX reference stays on the CPU (conftest.py).
"""

from __future__ import annotations

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
