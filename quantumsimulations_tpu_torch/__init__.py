"""quantumsimulations_tpu_torch — the PyTorch/CUDA port of quantumsimulations_tpu.

Exact statevector evolution of a dipolar-coupled nuclear-spin ensemble
(N spin-1/2 "sea" spins on a spherical shell plus one rare spin at the
center) under a rotating-frame Hamiltonian, detuning sweeps with
slope/contrast metric extraction, and the same on-disk artifact contract as
the JAX package ``quantumsimulations_tpu``, which stays beside it as the
reference this port is tested against.

The port imports neither JAX nor the JAX package.  Complex values are torch
complex tensors (the JAX package's (re, im) float planes exist only because
its TPU has no complex type); the hand-written CUDA kernels for NVIDIA
Hopper live in ``csrc/`` and are built with nvcc on first use
(``kernels/_build.py``).  Entry points take ``device=`` and default to
``"cuda"``; pass ``device="cpu"`` to run on the host.

Ported: every ``simulate_rare`` solver, the lab-frame model, the
sea-detuning sweep and the 2D amplitude x detuning grid
(``sweep/grid2d.py``), the re-analysis of saved sweeps (``sweep/reprocess*.py``,
``analysis/{exponential,aggregate,stable_region}.py``), every CLI, the
sharded and multi-process paths on ``torch.distributed`` (``parallel/``:
``mesh=`` and ``--mesh-devices``, one process per device, NCCL on ``cuda``
and gloo on ``cpu``) and the native analysis helpers (``native/``).  The
JAX package's ``ops/cplx.py`` has no counterpart by design (complex tensors
take its place).
"""

from __future__ import annotations

__version__ = "0.1.0"

from .dynamics.evolve import simulate_rare
from .models.params import DipolarRareParams
from .sweep.runner import run_sweep_sea_detuning

__all__ = [
    "DipolarRareParams",
    "simulate_rare",
    "run_sweep_sea_detuning",
    "__version__",
]
