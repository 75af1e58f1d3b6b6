"""Spectral-norm bound and estimate of an operator.

Port of ``quantumsimulations_tpu/dynamics/krylov.py::spectral_norm_bound``
(the Chebyshev stepper's lambda, cheb_step.py) and
``spectral_norm_estimate_dense`` (the dense ext chain's squaring count,
expm_propagator.py).  Not ported yet: the Lanczos stepper itself (ROADMAP.md
queue 1 item 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.embed import OperatorSum, local_op


def spectral_norm_bound(H: OperatorSum) -> float:
    """Cheap upper bound: sum_k |coeff_k| * prod ||op||_2 over the factors."""
    total = 0.0
    for term in H.terms:
        nrm = abs(term.coeff)
        for site, which in term.factors:
            op = local_op(H.dims[site], which)
            nrm *= float(np.linalg.norm(op, 2))
        total += nrm
    return total


def spectral_norm_estimate_dense(Hd: np.ndarray, iters: int = 40, seed: int = 0,
                                 device: str | torch.device = "cpu") -> float:
    """||H||_2 estimate by float32 power iteration on the dense matrix, as
    the JAX package's: (re, im) float32 planes, the same seeded start vector
    and iteration count, inflated 5%.  float32 is plenty for a scaling
    decision; the sums run in another order than XLA's, so the estimate can
    differ in its last float32 bits."""
    rng = np.random.default_rng(seed)
    dim = Hd.shape[0]
    v = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    v /= np.linalg.norm(v)

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    h_re, h_im, re, im = f32(Hd.real), f32(Hd.imag), f32(v.real), f32(v.imag)
    nrm = torch.zeros((), dtype=torch.float32, device=device)
    for _ in range(iters):
        ore = h_re @ re - h_im @ im
        oim = h_re @ im + h_im @ re
        nrm = torch.linalg.vector_norm(torch.stack([ore, oim]))
        re, im = ore / nrm, oim / nrm
    return float(nrm) * 1.05
