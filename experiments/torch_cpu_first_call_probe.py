"""Probe: accuracy of PyTorch's float64 CPU math on its first call in a process.

The port's CPU path (used by its tests) once produced eig traces off by
~1e-9.  This script reproduces the cause in isolation: each trial is a fresh
Python process that first runs numpy LAPACK (39 Hermitian 128x128 eighs, as
a sweep does), then evaluates one operation on a (39, 128, 840) float64
tensor of phases in [-pi, pi] — the shape of one eig time block at the
production size — and compares it with numpy.  A trial is "bad" when the
largest error exceeds 1e-14.

    python experiments/torch_cpu_first_call_probe.py --runs 20

prints one JSON line: for each operation, the number of bad trials, the
number of trials and the largest error seen.  Operations: ``cos_sin``
(torch.cos / torch.sin), ``polar`` (torch.polar, what the port uses),
``sqrt`` (torch.sqrt of a sum of squares) and ``vector_norm``
(torch.linalg.vector_norm, what the port uses).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

OPS = ("cos_sin", "polar", "sqrt", "vector_norm")


def child(op: str) -> float:
    import numpy as np

    rng = np.random.default_rng(0)
    for _ in range(39):
        a = rng.standard_normal((128, 128)) + 1j * rng.standard_normal((128, 128))
        np.linalg.eigh(a + a.conj().T)
    w = np.sort(rng.uniform(-3.2e6, 3.2e6, (39, 128)), axis=1)
    dt = np.longdouble(30.0) / np.longdouble(19_999)
    two_pi = np.longdouble(2) * np.arccos(np.longdouble(-1))
    p = w.astype(np.longdouble) * dt
    r = np.asarray(p - np.rint(p / two_pi) * two_pi, dtype=np.float64)

    import torch

    th = torch.as_tensor(r).unsqueeze(-1) * torch.arange(840, dtype=torch.float64)
    th = th - torch.round(th / (2 * np.pi)) * (2 * np.pi)
    x = th.numpy()
    if op == "cos_sin":
        return float(max(np.abs(torch.cos(th).numpy() - np.cos(x)).max(),
                         np.abs(torch.sin(th).numpy() - np.sin(x)).max()))
    if op == "polar":
        z = torch.polar(torch.ones_like(th), th).numpy()
        return float(max(np.abs(z.real - np.cos(x)).max(), np.abs(z.imag - np.sin(x)).max()))
    states = torch.polar(torch.ones_like(th), th) / np.sqrt(128.0)
    s = states.numpy()
    want = np.sqrt((np.abs(s) ** 2).sum(-2))
    if op == "sqrt":
        got = (states.real * states.real + states.imag * states.imag).sum(dim=-2).sqrt()
    else:
        got = torch.linalg.vector_norm(states, dim=-2)
    return float(np.abs(got.numpy() - want).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20, help="fresh processes per operation")
    ap.add_argument("--child", choices=OPS, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(repr(child(args.child)))
        return
    summary = {}
    for op in OPS:
        errs = []
        for _ in range(args.runs):
            out = subprocess.run([sys.executable, __file__, "--child", op],
                                 capture_output=True, text=True, timeout=300, check=True)
            errs.append(float(out.stdout.strip().splitlines()[-1]))
        summary[op] = {"bad": sum(e > 1e-14 for e in errs), "runs": len(errs),
                       "max_err": max(errs)}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
