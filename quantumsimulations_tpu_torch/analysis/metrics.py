"""Metric/analysis kernel: coarse-graining, slope fits, contrasts, eta.

These pure functions are the de-facto contract between the sweep layer and
the reprocess/report layer; the reference re-imports them across scripts to
stay definitionally in sync (reprocess_sweep_results.py:87-92).  Behavioral
parity targets:

  * coarse_grain            — sweep_sea_detuning.py:116-141
  * iz_slope_from_coarse    — sweep_sea_detuning.py:148-268
  * contrast_michelson_with_t_gate — sweep_sea_detuning.py:279-317
  * detuning_label          — sweep_sea_detuning.py:342-349
  * f1R_for_resonance       — sweep_sea_detuning.py:1168-1194
  * eta_mismatch            — sweep_sea_detuning.py:748-767
"""

from __future__ import annotations

import math

import numpy as np

#: Minimum |t|-statistic for a slope to count as reliably non-zero
#: (sweep_sea_detuning.py:276).
SLOPE_T_MIN: float = 1.0

_NAN_SLOPE_RESULT = {
    "I_z_slope": float("nan"),
    "t_start": float("nan"),
    "t_end": float("nan"),
    "I_z_start": float("nan"),
    "I_z_end": float("nan"),
    "slope": float("nan"),
    "slope_std": float("nan"),
    "t_value": float("nan"),
    "R_value": float("nan"),
    "R2_value": float("nan"),
}


def coarse_grain(t: np.ndarray, y: np.ndarray, window: int = 25):
    """Block-average y(t) over ``window`` consecutive samples.

    The trailing remainder (len % window) is dropped; a window <= 1 or a
    trace shorter than one window returns the inputs unchanged.
    """
    n = (len(t) // window) * window
    if n == 0 or window <= 1:
        return t, y
    return (
        t[:n].reshape(-1, window).mean(axis=1),
        y[:n].reshape(-1, window).mean(axis=1),
    )


def iz_slope_from_coarse(t_coarse: np.ndarray, iz_coarse: np.ndarray) -> dict[str, float]:
    """Drift metric: linear fit over the central ~60% of the coarse envelope.

    Fits iz ≈ a + b t on points [0.2*n, 0.8*n) and reports the fitted rise
    I_z_slope = fit(t_end) - fit(t_start), the slope b with its standard
    error and t-statistic, and the segment's Pearson R / R^2.  Returns NaNs
    when fewer than 4 coarse points exist.
    """
    n = int(t_coarse.size)
    if n < 4 or iz_coarse.size < 4:
        return dict(_NAN_SLOPE_RESULT)

    frac_edge = 0.2
    i0 = int(frac_edge * n)
    i1 = int((1.0 - frac_edge) * n)
    i0 = max(0, min(i0, n - 2))
    i1 = max(i0 + 2, min(i1, n))

    t_seg = t_coarse[i0:i1]
    iz_seg = iz_coarse[i0:i1]
    if t_seg.size < 2:
        return dict(_NAN_SLOPE_RESULT)

    b, a = np.polyfit(t_seg, iz_seg, 1)

    t_start = float(t_seg[0])
    t_end = float(t_seg[-1])
    iz_start = float(a + b * t_start)
    iz_end = float(a + b * t_end)

    t_d = t_seg - np.mean(t_seg)
    iz_d = iz_seg - np.mean(iz_seg)
    ss_t = float(np.sum(t_d * t_d))
    ss_iz = float(np.sum(iz_d * iz_d))
    if ss_t > 0.0 and ss_iz > 0.0:
        R_value = float(np.dot(t_d, iz_d) / np.sqrt(ss_t * ss_iz))
        R2_value = R_value * R_value
    else:
        R_value = float("nan")
        R2_value = float("nan")

    if t_seg.size > 2 and ss_t > 0.0:
        resid = iz_seg - (a + b * t_seg)
        s2 = float(np.sum(resid**2)) / (t_seg.size - 2)
        slope_var = s2 / ss_t
        slope_std = float(np.sqrt(slope_var)) if slope_var > 0.0 else float("nan")
        t_value = (
            float(b / slope_std)
            if (slope_std > 0.0 and math.isfinite(slope_std))
            else float("nan")
        )
    else:
        slope_std = float("nan")
        t_value = float("nan")

    return {
        "I_z_slope": float(iz_end - iz_start),
        "t_start": t_start,
        "t_end": t_end,
        "I_z_start": iz_start,
        "I_z_end": iz_end,
        "slope": float(b),
        "slope_std": slope_std,
        "t_value": t_value,
        "R_value": R_value,
        "R2_value": R2_value,
    }


def contrast_michelson_with_t_gate(
    slope_on: float,
    slope_off: float,
    t_on: float,
    t_off: float,
    t_min: float = SLOPE_T_MIN,
) -> float:
    """Michelson contrast of slope magnitudes with t-statistic gating.

        C = (|s_on_eff| - |s_off_eff|) / (|s_on_eff| + |s_off_eff|)

    A slope whose |t| < t_min is treated as exactly 0.  Both effectively zero
    -> C = 0.0 (no measurable contrast).  Any non-finite slope or t -> NaN.
    """
    if not (np.isfinite(slope_on) and np.isfinite(slope_off)):
        return float("nan")
    if not (np.isfinite(t_on) and np.isfinite(t_off)):
        return float("nan")
    eff_on = 0.0 if abs(t_on) < t_min else slope_on
    eff_off = 0.0 if abs(t_off) < t_min else slope_off
    denom = abs(eff_on) + abs(eff_off)
    if not np.isfinite(denom) or denom <= 1e-16:
        return 0.0
    return (abs(eff_on) - abs(eff_off)) / denom


def detuning_label(delta_Hz: float) -> str:
    """Per-detuning directory name, e.g. +1000.0 Hz -> 'delta_p1000.0Hz'.

    Load-bearing for post-processing discovery (reprocess_sweep_results.py:295).
    """
    return f"delta_{delta_Hz:+.1f}Hz".replace("+", "p").replace("-", "m")


def f1R_for_resonance(f1A_Hz: float, deltaA_Hz: float, deltaR_Hz: float = 0.0) -> float:
    """Rare Rabi frequency matching the sea effective field (Hartmann–Hahn):

        sqrt(deltaA^2 + f1A^2) = sqrt(deltaR^2 + f1R^2)
    """
    return (deltaA_Hz**2 + f1A_Hz**2 - deltaR_Hz**2) ** 0.5


def eta_mismatch(delta_Hz: float, f1A: float, f1R: float, rms_b_AR_Hz: float) -> dict[str, float]:
    """Dimensionless mismatch x = (Omega_A - Omega_R) / |g_eff|.

    Omega_A = sqrt(delta^2 + f1A^2), Omega_R = f1R (rare on resonance);
    g_eff = (rms|b_AR|/4) * sin(theta_A) * sin(theta_R) with sin(theta)=f1/Omega.
    Keeps the sign of DeltaOmega, normalizes by |g_eff| — NaN when g_eff is 0
    or undefined (sweep_sea_detuning.py:748-767).
    """
    Omega_A = math.sqrt(delta_Hz**2 + f1A**2)
    Omega_R = math.sqrt(0.0**2 + f1R**2)
    DeltaOmega = Omega_A - Omega_R
    sin_theta_A = f1A / Omega_A if Omega_A != 0.0 else 0.0
    sin_theta_R = f1R / Omega_R if Omega_R != 0.0 else 0.0
    g_eff_Hz = (rms_b_AR_Hz / 4.0) * sin_theta_A * sin_theta_R
    if g_eff_Hz == 0.0 or np.isnan(g_eff_Hz):
        ratio = float("nan")
    else:
        ratio = float(DeltaOmega / abs(g_eff_Hz))
    return {
        "DeltaOmega_Hz": float(DeltaOmega),
        "g_eff_Hz": float(g_eff_Hz),
        "DeltaOmega_over_geff": ratio,
    }
