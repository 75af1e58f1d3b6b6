"""The one generator of the benchmark's work: a configuration file and a
traffic file in, the parameter records of the warm-up and of the timed
evolutions out.

A configuration (``configs/<name>.json``) holds the bath under ``params``:
the sizes and physics of the reference's parameter record, with the drives
given as Rabi frequencies in Hz and the field as ``B0`` (both species);
and under ``detunings_Hz`` the sea detunings of the sweep it runs, which
the timed evolutions take one after another in an order drawn from the
seed, starting over when all were taken.  A traffic mix
(``traffic/<name>.json``) holds:

  * ``solver``: the ``solver_method`` every evolution asks for;
  * ``route``: the chain that solver takes at the configurations' dims
    (``ext`` or ``ozaki``), which the frozen counts follow;
  * ``warmup``: one short evolution before the window at ``detuning_Hz``,
    ``steps`` output steps of the configuration's spacing divided by
    ``dt_divisor`` (the same products and shapes as a timed evolution, a
    shorter chain).

The records are what the reference code's sweep builds for one detuning:
sea carrier f_Az - delta, rare carrier on resonance, B1 = 2 pi f1 / gamma.
Both the program and the plain reference take them as they are.
"""

from __future__ import annotations

import math

import numpy as np


def params_record(params: dict, detuning_Hz: float, t_final: float, steps: int) -> dict:
    """The ``DipolarRareParams`` fields of one evolution."""
    f_Az = params["gamma_sea"] * params["B0"] / (2 * math.pi)
    return {
        "n_sea": int(params["n_sea"]),
        "gamma_sea": params["gamma_sea"], "gamma_rare": params["gamma_rare"],
        "B0_sea": params["B0"], "B0_rare": params["B0"],
        "B1_sea": 2 * math.pi * params["f1A_Hz"] / params["gamma_sea"],
        "B1_rare": 2 * math.pi * params["f1R_Hz"] / params["gamma_rare"],
        "omega_rf_sea": 2 * math.pi * (f_Az - detuning_Hz),
        "omega_rf_rare": params["gamma_rare"] * params["B0"],
        "phi_sea": params["phi_sea"], "phi_rare": params["phi_rare"],
        "dipolar_scale": params["dipolar_scale"], "shell_scale": params["shell_scale"],
        "t_final": float(t_final), "steps": int(steps),
        "drive_sea": bool(params["drive_sea"]), "drive_rare": bool(params["drive_rare"]),
        "init_x_sign": int(params["init_x_sign"]),
        "is_spin_three_half": bool(params["is_spin_three_half"]),
        "is_center_rare": bool(params["is_center_rare"]),
    }


def detuning_order(config: dict, seed: int) -> list[float]:
    """The configuration's detunings in the seed's order."""
    det = [float(d) for d in config["detunings_Hz"]]
    perm = np.random.default_rng(seed).permutation(len(det))
    return [det[i] for i in perm]


def timed_record(params: dict, order: list[float], i: int) -> dict:
    """The record of the i-th timed evolution."""
    return params_record(params, order[i % len(order)], params["t_final"], params["steps"])


def warmup_record(params: dict, traffic: dict) -> dict:
    w = traffic["warmup"]
    dt = params["t_final"] / (params["steps"] - 1) / w["dt_divisor"]
    return params_record(params, w["detuning_Hz"], dt * (w["steps"] - 1), w["steps"])
