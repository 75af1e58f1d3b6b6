"""Accurate evaluation of exp(-i * w * t) phases for long horizons.

The spin problem integrates to t = 30 s with eigenfrequencies up to a few
1e6 rad/s, so raw phase arguments reach ~1e8 rad.  A naive float64 product
w * t carries an absolute rounding error of ~ulp(1e8) ≈ 1.5e-8 rad — already
at the parity budget — so the product is never formed at full size.

The scheme exploits the uniform output grid t_k = k*dt + eps_k
(eps_k = the tiny linspace rounding residual):

  1. HOST (true IEEE f64 + 80-bit longdouble): reduce each eigenfrequency's
     per-step phase r_n = (w_n * dt) mod 2pi exactly.
  2. DEVICE: theta_{n,k} = reduce(k * r_n) + w_n * eps_k.  All magnitudes stay
     <= T*pi (~6e4 rad), so the three-piece Cody–Waite reduction keeps the
     absolute error near 1e-13 rad.

The device step is written as separate float64 torch operations.  Eager
PyTorch runs each elementwise operation as its own kernel, so no compiler can
contract the Cody–Waite chain ``(p - n*A) - n*B - n*C`` into fused
multiply-adds, which would change its rounding.  Any future fusion of this
chain into one CUDA kernel must keep that property: build it with
``--fmad=false`` or spell each step with ``__dmul_rn`` / ``__dsub_rn``.
"""

from __future__ import annotations

from decimal import Decimal, getcontext

import numpy as np
import torch

getcontext().prec = 60

# 2*pi to 50+ significant digits
_TWO_PI_D = Decimal("6.283185307179586476925286766559005768394338798750211641949889")
_TWO_PI_HI = float(_TWO_PI_D)  # float64 nearest
_TWO_PI_LO = float(_TWO_PI_D - Decimal(_TWO_PI_HI))
_INV_TWO_PI = float(Decimal(1) / _TWO_PI_D)


def _mask_low_bits(x: float, keep_bits: int = 26) -> float:
    """Zero mantissa bits below ``keep_bits`` (Cody–Waite piece maker)."""
    u = np.float64(x).view(np.uint64)
    drop = 53 - keep_bits
    u &= np.uint64(~((1 << drop) - 1) & 0xFFFFFFFFFFFFFFFF)
    return float(np.uint64(u).view(np.float64))


_PI2_A = _mask_low_bits(float(_TWO_PI_D))
_PI2_B = _mask_low_bits(float(_TWO_PI_D - Decimal(_PI2_A)))
_PI2_C = float(_TWO_PI_D - Decimal(_PI2_A) - Decimal(_PI2_B))


# ---------------------------------------------------------------------------
# Host-side exact reduction (numpy, 80-bit longdouble on x86)
# ---------------------------------------------------------------------------

_TWO_PI_LD = np.longdouble(_TWO_PI_HI) + np.longdouble(_TWO_PI_LO)


def reduce_wdt_host(w: np.ndarray, dt: float) -> np.ndarray:
    """(w * dt) mod 2pi to ~1e-18 absolute, on the host, result in [-pi, pi]."""
    p = np.asarray(w, dtype=np.longdouble) * np.longdouble(dt)
    n = np.rint(p / _TWO_PI_LD)
    return np.asarray(p - n * _TWO_PI_LD, dtype=np.float64)


def uniform_grid_decomposition(times: np.ndarray) -> tuple[float, np.ndarray]:
    """Split an (approximately uniform) time grid into t_k = k*dt + eps_k.

    eps_k is measured against the EXACT real product k*dt (longdouble), so it
    also captures the float64 rounding of k*dt itself — at 30 s horizons and
    MHz frequencies that rounding alone is worth ~1e-8 rad of phase.
    """
    times = np.asarray(times, dtype=np.float64)
    if len(times) < 2:
        return 1.0, times.copy()
    dt = float(times[1] - times[0])
    k = np.arange(len(times), dtype=np.longdouble)
    eps = np.asarray(times, dtype=np.longdouble) - k * np.longdouble(dt)
    return dt, np.asarray(eps, dtype=np.float64)


# ---------------------------------------------------------------------------
# Device-side small-argument reduction (float64 torch operations)
# ---------------------------------------------------------------------------

def _reduce_small(p: torch.Tensor) -> torch.Tensor:
    """p mod 2pi for |p| <~ 1e6 rad, one uncontracted float64 op at a time."""
    n = torch.round(p * _INV_TWO_PI)
    return ((p - n * _PI2_A) - n * _PI2_B) - n * _PI2_C


def grid_angles(
    r: torch.Tensor,  # (..., dim)  per-step reduced phases from reduce_wdt_host
    k: torch.Tensor,  # (T,)        output-step indices as float64
    w: torch.Tensor,  # (..., dim)  raw eigenfrequencies (for the eps correction)
    eps: torch.Tensor,  # (T,)      linspace residuals t_k - k*dt
) -> torch.Tensor:
    """theta[..., n, t] = (w_n * t_k) mod 2pi, accurate to ~1e-11 rad absolute."""
    p = r.unsqueeze(-1) * k
    return _reduce_small(p) + w.unsqueeze(-1) * eps


def grid_expi_neg(r, k, w, eps) -> torch.Tensor:
    """exp(-i w t) on the uniform grid, as a complex128 tensor (..., dim, T).

    Built with ``torch.polar`` rather than ``torch.cos``/``torch.sin``: on the
    CPU those two go through MKL's vector math library, whose first call in
    a process was seen to return values accurate to only ~1e-9 for one
    thread's share of the elements (rarely, under load), while ``polar``
    uses the C library's cos/sin.  cos(-x) = cos(x) and sin(-x) = -sin(x)
    hold exactly, so this equals (cos theta, -sin theta).
    """
    theta = grid_angles(r, k, w, eps)
    return torch.polar(torch.ones_like(theta), -theta)
