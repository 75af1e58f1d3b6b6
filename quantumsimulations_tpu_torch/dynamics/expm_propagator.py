"""Host power iteration for the spectral norm.

Port of ``quantumsimulations_tpu/dynamics/expm_propagator.py::_spectral_norm_host``,
the one piece of that module the Chebyshev stepper (cheb_step.py) needs.
Not ported yet: the dense exact-limb step-operator chain
(``expm_traces_assembled_ext``, ROADMAP.md queue 1 item 6) and the other
expm solvers (item 7).
"""

from __future__ import annotations

import numpy as np


def _spectral_norm_host(Hd, iters: int = 40, seed: int = 0) -> float:
    """||H||_2 estimate by power iteration in native host f64 (numpy).

    ``Hd`` is a dense array or a scipy sparse matrix.  Power iteration
    converges from below, so the estimate is inflated 5%, as the JAX
    package's."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(Hd.shape[0]) + 1j * rng.standard_normal(Hd.shape[0])
    v /= np.linalg.norm(v)
    nrm = 0.0
    for _ in range(iters):
        w = Hd @ v
        nrm = np.linalg.norm(w)
        if nrm == 0.0:
            return 0.0
        v = w / nrm
    return float(nrm) * 1.05
