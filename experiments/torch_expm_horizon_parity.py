"""The dense "expm" route over the production horizon, both packages, on the CPU.

    JAX_PLATFORMS=cpu python experiments/torch_expm_horizon_parity.py

Runs ``simulate_rare(solver_method="expm")`` of the JAX package and of the
PyTorch port (device="cpu") on the simulate CLI's production parameters
(n_sea = 6, dim 128, 30 s, 20,000 steps) and prints each one's largest
deviation from the JAX package's "eig" route over the first 51, 2,000 and
20,000 steps, its norm drift, and the two packages' difference.  The
smoke's phase A bars (chip_smoke.py EXPM_ATOL, EXPM_NORM_ATOL) hold the port
to the JAX package's own figures printed here.
"""

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from quantumsimulations_tpu.dynamics.evolve import simulate_rare as jsim  # noqa: E402
from quantumsimulations_tpu.models.params import DipolarRareParams as JParams  # noqa: E402
from quantumsimulations_tpu_torch.cli import simulate as cli  # noqa: E402
from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare as tsim  # noqa: E402


def main() -> None:
    params = cli.params_from_args(cli.build_parser().parse_args(
        ["--n-sea", "6", "--drive-rare", "--solver", "expm"]))
    jparams = JParams(**dataclasses.asdict(params))
    _, jax_expm = jsim(jparams)
    _, jax_eig = jsim(dataclasses.replace(jparams, solver_method="eig"))
    _, port_expm = tsim(params, device="cpu")
    keys = [k for k in jax_eig if k != "state_norm"]

    def dev(a, b, T=None):
        return max(float(np.abs(np.asarray(a[k])[:T] - np.asarray(b[k])[:T]).max()) for k in keys)

    for name, run in (("JAX expm", jax_expm), ("port expm", port_expm)):
        print(f"{name}: vs JAX eig over 51 / 2000 / 20000 steps "
              f"{dev(run, jax_eig, 51)!r} / {dev(run, jax_eig, 2000)!r} / {dev(run, jax_eig)!r}; "
              f"max |norm - 1| {float(np.abs(run['state_norm'] - 1.0).max())!r}")
    print(f"port expm vs JAX expm: {dev(port_expm, jax_expm)!r}")


if __name__ == "__main__":
    main()
