"""The int8 GEMM kernel (csrc/int8_gemm.cu) on the card, beside torch._int_mm.

Builds the kernel (ptxas register and spill report), then runs the smoke's
row 6b (chip_smoke.check_int8_gemm) at its shapes: bit-equality with
``torch._int_mm`` (two calls), device times per call of the kernel and of
``torch._int_mm`` (CUDA-graph replay), the eager call's, and the bound
beside them.  The card tests hold the other shapes and layouts:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_kernels.py -k int8_gemm``.

    python3 experiments/torch_int8_gemm_probe.py [--out FILE]

Needs a CUDA device; imports no JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from chip_smoke import INT8_GEMM_SHAPES, card_peaks, check_int8_gemm  # noqa: E402
from quantumsimulations_tpu_torch.kernels import _build  # noqa: E402


def run_timings(out):
    peaks = card_peaks(torch.cuda.get_device_name(0))
    for i, shape in enumerate(INT8_GEMM_SHAPES):
        row = check_int8_gemm(shape, peaks, seed=40 + i)
        out["timings"].append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "timings": []}
    print(json.dumps({"card": smi}), flush=True)
    t0 = time.perf_counter()
    log = _build.build("int8_gemm", extra_flags=("-Xptxas", "-v"))
    out["build_s"] = time.perf_counter() - t0
    out["ptxas"] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln
                    or "error" in ln.lower()]
    print(json.dumps({"build_s": out["build_s"], "ptxas": out["ptxas"]}), flush=True)
    run_timings(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"ok": True}), flush=True)


if __name__ == "__main__":
    main()
