"""The port's single-simulation CLI (cli/simulate.py) on the CPU: it writes
the traces ``simulate_rare`` returns for the same parameters (equal bit for
bit: the same route on the same device), takes the JAX CLI's flags with
``--device`` in place of ``--platform``, and builds the JAX CLI's
parameters."""

import dataclasses
import re

import numpy as np
import pytest

from _torch_parity import no_jax_compile_cache  # noqa: F401
from quantumsimulations_tpu_torch.cli import simulate as tcli
from quantumsimulations_tpu_torch.dynamics.evolve import simulate_rare
from quantumsimulations_tpu_torch.models.labframe import simulate_lab_frame

SMALL = ["--n-sea", "3", "--t-final", "2e-4", "--steps", "21", "--drive-rare", "--device", "cpu"]


@pytest.mark.parametrize("solver", ["expm", "eig", "dopri"])
def test_cli_writes_the_traces_of_simulate_rare(tmp_path, solver):
    out = tmp_path / "trace.npz"
    argv = SMALL + ["--solver", solver, "-o", str(out)]
    tcli.main(argv)
    params = tcli.params_from_args(tcli.build_parser().parse_args(argv))
    t, obs = simulate_rare(params, device="cpu")
    with np.load(out) as z:
        np.testing.assert_array_equal(z["t"], t)
        assert set(z.files) == set(obs) | {"t"}
        for k in obs:
            np.testing.assert_array_equal(z[k], obs[k])


def test_cli_lab_frame(tmp_path):
    out = tmp_path / "lab.npz"
    argv = ["--n-sea", "1", "--gamma-sea", "1e5", "--gamma-rare", "8e4", "--b0", "1",
            "--f1a", "50", "--t-final", "1e-4", "--steps", "5", "--lab-frame",
            "--device", "cpu", "-o", str(out)]
    tcli.main(argv)
    params = tcli.params_from_args(tcli.build_parser().parse_args(argv))
    t, obs = simulate_lab_frame(params, device="cpu")
    with np.load(out) as z:
        for k in obs:
            np.testing.assert_array_equal(z[k], obs[k])


def _flags(main, capsys) -> set[str]:
    """The long options a CLI's --help lists (one per option line)."""
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"^\s+(?:-\w(?: \w+)?, )?(--[\w-]+)", capsys.readouterr().out, re.M))


def test_cli_params_and_flags_match_the_reference_cli(monkeypatch, capsys):
    import quantumsimulations_tpu.dynamics.evolve as jevolve
    from quantumsimulations_tpu.cli import simulate as jcli

    seen = {}

    def capture(params):
        seen["params"] = params
        raise SystemExit(0)

    monkeypatch.setattr(jevolve, "simulate_rare", capture)
    argv = ["--n-sea", "4", "--delta", "1500", "--solver", "expm", "--drive-rare"]
    with pytest.raises(SystemExit):
        jcli.main(argv)
    ours = tcli.params_from_args(tcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(seen["params"])
    assert _flags(tcli.main, capsys) - {"--device"} == _flags(jcli.main, capsys) - {"--platform"}
