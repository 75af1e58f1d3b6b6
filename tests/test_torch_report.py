"""Port vs reference: the plotted sweep writes the same PNG/PDF artifact tree."""

import os

import numpy as np

from _torch_parity import F1A, F_AZ, GAMMA_RARE, GAMMA_SEA, no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu.sweep.runner import run_sweep_sea_detuning as jsweep
from quantumsimulations_tpu_torch.sweep.runner import run_sweep_sea_detuning as tsweep

PLOTTED = dict(
    f_Az=F_AZ,
    f1A=F1A,
    target_sea_detuning=F1A,
    gamma_sea=GAMMA_SEA,
    gamma_rare=GAMMA_RARE,
    sea_detunings_Hz=[25_000.0],
    n_sea=3,
    t_final=0.01,
    steps=120,
    phi_sea=np.pi / 2,
    phi_rare=np.pi / 2,
    coarse_window=10,
    make_plots=True,
)


def _tree(base):
    return {
        os.path.relpath(os.path.join(root, f), base)
        for root, _, files in os.walk(base)
        for f in files
    }


def test_plotted_sweep_tree_matches_reference(tmp_path):
    port = tsweep(**PLOTTED, base_dir=str(tmp_path / "port"), device="cpu")
    ref = jsweep(**PLOTTED, base_dir=str(tmp_path / "ref"))
    tree = _tree(port)
    assert tree == _tree(ref)
    for name in (
        "sea_detuning_report.pdf",
        "contrast_rare_center_vs_DeltaOmega_over_geff.png",
        "delta_p25000.0Hz/Iz_sea_off_on_center.png",
        "delta_p25000.0Hz/Iz_sea_detection_envelopes_center.png",
        "delta_p25000.0Hz/Iz_sea_detection_envelopes_sea_center.png",
        "delta_p25000.0Hz/state_norm_off_on_center.png",
    ):
        assert name in tree, name
        assert os.path.getsize(os.path.join(port, name)) > 0, name
