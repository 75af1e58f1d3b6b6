"""Simulation parameter record and derived frequencies.

:class:`DipolarRareParams` is the single typed configuration record for one
time evolution, field-compatible with the reference dataclass
(dipolar_ensemble_with_rare.py:307-384) so that ``params_{tag}.json``
provenance dumps keep the same keys.  ``get_derived_frequencies`` reproduces
the Larmor/Rabi/detuning arithmetic at :387-450 including the drive-gating
rule (detuning forced to 0 for species whose drive is off).
"""

from __future__ import annotations

from dataclasses import dataclass, field
import math

TWO_PI = 2.0 * math.pi

# Gyromagnetic ratios of the reference's production species (rad/s/T;
# sweep_sea_detuning.py:1205-1209)
GAMMA_71GA = 8.1812e7
GAMMA_27AL = 6.976e7


@dataclass
class DipolarRareParams:
    """Parameters for n_sea spin-1/2 sea spins + one rare spin (last index).

    All angular frequencies are derived:  omega_z = gamma * B0 (Larmor),
    omega_1 = gamma * B1 (Rabi).  ``omega_rf_*`` of None means on-resonance
    (the rotating frame sits exactly at the species' Larmor frequency).
    """

    n_sea: int = 12

    gamma_sea: float = 1.0
    gamma_rare: float = 1.0

    B0_sea: float = 1.0
    B0_rare: float = 1.0

    B1_sea: float = 0.0
    B1_rare: float = 0.0

    omega_rf_sea: float | None = None
    omega_rf_rare: float | None = None

    phi_sea: float = 0.0
    phi_rare: float = 0.0

    dipolar_scale: float = TWO_PI
    shell_scale: float = 0.282393

    t_final: float = 0.02
    steps: int = 2_000

    drive_sea: bool = False
    drive_rare: bool = False

    init_x_sign: int = -1
    # Kept for provenance-dump compatibility with the reference params record;
    # the reference never reads it outside the dataclass (SURVEY.md C8 note).
    init_rare_level: int = 3

    is_spin_three_half: bool = True
    is_center_rare: bool = True

    solver_atol: float | None = None
    solver_rtol: float | None = None
    solver_nsteps: int | None = None
    solver_max_step: float | None = None

    # --- framework extensions (absent from the reference record) -----------
    # Propagation backend: "auto" | "eig" | "expm" | "krylov" | "dopri"
    solver_method: str = field(default="auto")

    def hilbert_dims(self) -> tuple[int, ...]:
        """Per-site local dimensions; rare site last.

        Unlike the reference (whose is_center_rare=True path forces the rare
        slot to dim 2 even when is_spin_three_half=True — an internal
        inconsistency documented in SURVEY.md §2.1), the rare local dimension
        here follows ``is_spin_three_half`` coherently whenever the center
        site is a genuine rare spin.
        """
        rare_dim = 4 if (self.is_spin_three_half and self.is_center_rare) else 2
        return tuple([2] * self.n_sea + [rare_dim])


def get_derived_frequencies(params: DipolarRareParams) -> dict[str, float]:
    """Larmor/Rabi/RF-carrier frequencies and drive-gated detunings.

    Matches dipolar_ensemble_with_rare.py:387-450: detuning is zero whenever
    the corresponding drive flag is off, and the RF carrier defaults to the
    species Larmor frequency.
    """
    omega_Az = params.gamma_sea * params.B0_sea
    omega_Rz = params.gamma_rare * params.B0_rare
    omega1_sea = params.gamma_sea * params.B1_sea
    omega1_rare = params.gamma_rare * params.B1_rare

    omega_rf_sea = params.omega_rf_sea if params.omega_rf_sea is not None else omega_Az
    omega_rf_rare = params.omega_rf_rare if params.omega_rf_rare is not None else omega_Rz

    delta_sea = (omega_Az - omega_rf_sea) if params.drive_sea else 0.0
    delta_rare = (omega_Rz - omega_rf_rare) if params.drive_rare else 0.0

    hz = lambda w: w / TWO_PI
    return {
        "omega_Az": omega_Az,
        "omega_Rz": omega_Rz,
        "omega1_sea": omega1_sea,
        "omega1_rare": omega1_rare,
        "omega_rf_sea": omega_rf_sea,
        "omega_rf_rare": omega_rf_rare,
        "delta_sea": delta_sea,
        "delta_rare": delta_rare,
        "f_Az": hz(omega_Az),
        "f_Rz": hz(omega_Rz),
        "f1_sea": hz(omega1_sea),
        "f1_rare": hz(omega1_rare),
        "f_rf_sea": hz(omega_rf_sea),
        "f_rf_rare": hz(omega_rf_rare),
        "delta_sea_Hz": hz(delta_sea),
        "delta_rare_Hz": hz(delta_rare),
    }
