"""Bytes that one ext_obs_diagonals_int8 call reads from HBM and from L2, by
the CUPTI profiler counters that torch.profiler can ask for.

    python3 experiments/torch_ext_obs_dram.py [--shape L,dim,T] [--out DIR]

Calls the port's kernel (quantumsimulations_tpu_torch/csrc/ext_obs_diagonals.cu)
and the SIMT design it replaced (experiments/torch_ext_obs_simt.cu) once
each under torch.profiler with the counters dram__bytes_read.sum and
lts__t_bytes.sum, per kernel, writes the Chrome traces to DIR (default
chiprun_out/) and prints every counter value the traces hold beside the
bytes the function must read (2 * n_diag * dim * T), or "no counters in
the trace" where the profiler returns none (the traces then hold the
kernels alone).  Needs a CUDA device; imports no JAX.
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "experiments"))
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from quantumsimulations_tpu_torch.ops import ext_obs as eo  # noqa: E402
from torch_ext_obs_probe import build_other, caller, limbs, pairs  # noqa: E402

METRICS = ["dram__bytes_read.sum", "lts__t_bytes.sum"]


def counters(trace: str) -> list[tuple[str, dict]]:
    """(event name, {counter: value}) for every trace event with a counter."""
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    found = []
    for ev in events:
        args = ev.get("args") or {}
        vals = {k: v for k, v in args.items() if any(m.split(".")[0] in k for m in METRICS)}
        if vals:
            found.append((ev.get("name", "?"), vals))
    return found


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="15,8192,20480")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    args = ap.parse_args()
    L, dim, T = (int(v) for v in args.shape.split(","))
    nd = 11
    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    simt = caller(build_other("simt")[0])
    gen = torch.Generator(device="cuda").manual_seed(11)
    S_re, S_im = limbs((L, dim, T), gen), limbs((L, dim, T), gen)
    jj, ii = pairs(nd)
    fns = {"port": lambda: eo.ext_obs_diagonals_int8(S_re, S_im, jj, ii, nd),
           "simt": lambda: simt(S_re, S_im, nd)}
    need = 2 * nd * dim * T
    print(f"({L}, {dim}, {T}) n_diag {nd}: the function must read {need} bytes", flush=True)
    cfg = torch._C._profiler._ExperimentalConfig(profiler_metrics=METRICS,
                                                  profiler_measure_per_kernel=True)
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], experimental_config=cfg) as prof:
            fn()
            torch.cuda.synchronize()
        trace = os.path.join(args.out, f"ext_obs_dram_{name}.json")
        prof.export_chrome_trace(trace)
        found = counters(trace)
        if not found:
            print(f"{name}: no counters in the trace", flush=True)
        for ev, vals in found:
            shown = ", ".join(f"{k} {v}" for k, v in vals.items())
            print(f"{name}: {ev}: {shown}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
