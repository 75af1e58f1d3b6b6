"""Spectral-norm bound of an operator sum.

Port of ``quantumsimulations_tpu/dynamics/krylov.py::spectral_norm_bound``,
the one piece of that module the Chebyshev stepper (cheb_step.py) needs.
Not ported yet: the Lanczos stepper itself (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import numpy as np

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
