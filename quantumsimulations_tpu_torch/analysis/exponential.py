"""Exponential-to-plateau relaxation metrics (tau / t90).

Alternative metric kernel to the linear slope/contrast pipeline, matching the
reference reprocessor (reprocess_detuning_sweep_exponential.py:37-302):

  * plateau I_inf    — median of the last ``plateau_frac`` of samples;
  * noise sigma      — MAD of the late window * 1.4826;
  * R0               — median |residual| over the first ``early_frac``;
  * t90 (model-free) — first time |y - I_inf| <= 0.1 * R0, linearly
                       interpolated between samples;
  * tau              — linear fit of ln(residual) over points above
                       max(0.1*R0, alpha*sigma), requiring >= min_points and
                       a negative slope;
  * status           — OK | FLAT | CENSORED | BAD_FIT | TOO_FEW.

Port of ``quantumsimulations_tpu/analysis/exponential.py``: host numpy with
the same calls in the same order, so every fit equals the JAX package's bit
for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def mad_sigma(x: np.ndarray) -> float:
    """Robust sigma: 1.4826 * median(|x - median(x)|)."""
    if x.size == 0:
        return float("nan")
    med = float(np.median(x))
    return 1.4826 * float(np.median(np.abs(x - med)))


@dataclass
class RelaxFit:
    status: str
    I_inf: float
    tau_s: float
    A: float
    t0_s: float
    r2: float
    n_fit: int
    sigma_noise: float
    R0: float
    t90_s: float


def _nan_fit(status: str, **overrides) -> RelaxFit:
    base = dict(
        status=status,
        I_inf=float("nan"),
        tau_s=float("nan"),
        A=float("nan"),
        t0_s=float("nan"),
        r2=float("nan"),
        n_fit=0,
        sigma_noise=float("nan"),
        R0=float("nan"),
        t90_s=float("nan"),
    )
    base.update(overrides)
    return RelaxFit(**base)


def interp_threshold_time(t: np.ndarray, r: np.ndarray, thr: float) -> float:
    """First time r(t) <= thr with linear interpolation; NaN if never."""
    if t.size == 0:
        return float("nan")
    below = np.where(r <= thr)[0]
    if below.size == 0:
        return float("nan")
    i = int(below[0])
    if i == 0:
        return float(t[0])
    t0, t1 = float(t[i - 1]), float(t[i])
    r0, r1 = float(r[i - 1]), float(r[i])
    if not (math.isfinite(r0) and math.isfinite(r1)) or r1 == r0:
        return float(t1)
    frac = min(1.0, max(0.0, (thr - r0) / (r1 - r0)))
    return t0 + frac * (t1 - t0)


def fit_exponential_to_plateau(
    t: np.ndarray,
    y: np.ndarray,
    *,
    plateau_frac: float = 0.15,
    early_frac: float = 0.10,
    alpha_noise: float = 3.0,
    min_points: int = 6,
) -> RelaxFit:
    """Fit y(t) = I_inf + sign0 * A * exp(-t / tau) with robust gating."""
    t = np.asarray(t, dtype=float)
    y = np.asarray(y, dtype=float)
    finite = np.isfinite(t) & np.isfinite(y)
    t, y = t[finite], y[finite]

    if t.size < 4:
        return _nan_fit("TOO_FEW")

    k_plateau = max(3, int(round(plateau_frac * t.size)))
    y_late = y[-k_plateau:]
    I_inf = float(np.median(y_late))
    sigma_noise = float(mad_sigma(y_late))

    res = y - I_inf
    abs_res = np.abs(res)
    k_early = max(3, int(round(early_frac * t.size)))
    R0 = float(np.median(abs_res[:k_early]))

    if R0 <= 0.0 or not math.isfinite(R0):
        t90_s = float("nan")
    else:
        t90_s = interp_threshold_time(t, abs_res, 0.1 * R0)

    # trace starts already at the plateau (within noise)
    if math.isfinite(sigma_noise) and R0 <= alpha_noise * sigma_noise:
        return _nan_fit(
            "FLAT",
            I_inf=I_inf,
            t0_s=float(t[0]),
            sigma_noise=sigma_noise,
            R0=R0,
            t90_s=0.0 if math.isfinite(t[0]) else float("nan"),
        )

    sign0 = float(np.sign(np.median(res[:k_early])))
    if sign0 == 0.0:
        nz = res[np.nonzero(res)]
        sign0 = float(np.sign(nz[0])) if nz.size else 1.0
    rpos = res * sign0

    if not math.isfinite(R0) or R0 <= 0.0:
        thr_fit = float("nan")
    else:
        thr_fit = max(0.1 * R0, alpha_noise * sigma_noise if math.isfinite(sigma_noise) else 0.0)

    fit_mask = np.isfinite(rpos) & (rpos > thr_fit)
    t_fit, r_fit = t[fit_mask], rpos[fit_mask]

    if t_fit.size < min_points:
        status = "CENSORED" if not math.isfinite(t90_s) else "TOO_FEW"
        return _nan_fit(
            status,
            I_inf=I_inf,
            t0_s=float(t[0]),
            n_fit=int(t_fit.size),
            sigma_noise=sigma_noise,
            R0=R0,
            t90_s=t90_s,
        )

    slope, intercept = np.polyfit(t_fit, np.log(r_fit), 1)
    if not math.isfinite(slope) or slope >= 0.0:
        return _nan_fit(
            "BAD_FIT",
            I_inf=I_inf,
            t0_s=float(t_fit[0]),
            n_fit=int(t_fit.size),
            sigma_noise=sigma_noise,
            R0=R0,
            t90_s=t90_s,
        )

    ln_r = np.log(r_fit)
    ln_pred = slope * t_fit + intercept
    ss_res = float(np.sum((ln_r - ln_pred) ** 2))
    ss_tot = float(np.sum((ln_r - float(np.mean(ln_r))) ** 2))
    r2 = float(1.0 - ss_res / ss_tot) if ss_tot > 0.0 else float("nan")

    return RelaxFit(
        status="OK",
        I_inf=I_inf,
        tau_s=float(-1.0 / slope),
        A=float(math.exp(intercept)),
        t0_s=float(t_fit[0]),
        r2=r2,
        n_fit=int(t_fit.size),
        sigma_noise=sigma_noise,
        R0=R0,
        t90_s=t90_s,
    )


def eval_fit_curve(t: np.ndarray, fit: RelaxFit, sign0: float) -> np.ndarray:
    """y_fit(t) = I_inf + sign0 * A * exp(-t/tau) (plotting helper)."""
    if not (math.isfinite(fit.I_inf) and math.isfinite(fit.A) and math.isfinite(fit.tau_s)):
        return np.full_like(np.asarray(t, dtype=float), np.nan)
    return fit.I_inf + sign0 * fit.A * np.exp(-np.asarray(t, dtype=float) / fit.tau_s)
