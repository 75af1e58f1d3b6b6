"""Chebyshev expansion coefficients of exp(-i x y) on y in [-1, 1].

Port of ``quantumsimulations_tpu/dynamics/chebyshev.py::chebyshev_coefficients``,
the one piece of that module the Chebyshev stepper (cheb_step.py) needs:

    exp(-i lambda t H/lambda) = sum_k c_k(lambda t) T_k(H / lambda),
    c_k(x) = (2 - delta_k0) (-i)^k J_k(x).

Not ported yet: the global Chebyshev sweep (``chebyshev_states``,
``chebyshev_traces_assembled``), ROADMAP.md queue 1 item 3.
"""

from __future__ import annotations

import numpy as np

_TAIL_EPS = 1e-16  # coefficient cutoff (relative)


def chebyshev_coefficients(lam: float, times: np.ndarray) -> np.ndarray:
    """(T, K) complex coefficients c_k(lambda t_j), truncated where every
    row's |c_k| has fallen below _TAIL_EPS for good."""
    from scipy.special import jv

    x = np.asarray(lam * times, dtype=np.float64)
    x_max = float(x.max())
    # J_k(x) decays superexponentially once k > x: a ~ x^(1/3) transition
    # width plus margin covers machine precision
    K = int(np.ceil(x_max + 12.0 * max(x_max, 1.0) ** (1.0 / 3.0) + 40))
    k = np.arange(K)
    J = jv(k[None, :], x[:, None])  # (T, K)
    pre = np.where(k == 0, 1.0, 2.0)[None, :]
    ik = (-1j) ** (k % 4)
    C = pre * ik[None, :] * J
    # trim the common tail
    keep = np.abs(C).max(axis=0) > _TAIL_EPS
    if keep.any():
        K_eff = int(np.nonzero(keep)[0].max()) + 1
    else:  # times == 0
        K_eff = 1
    return np.ascontiguousarray(C[:, :K_eff])
