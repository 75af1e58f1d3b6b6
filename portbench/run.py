#!/usr/bin/env python3
"""The benchmark of quantumsimulations_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port and ``BENCHMARK.json``, on
a machine with as many CUDA cards as the cell asks for.  Prints the card,
then the result as one JSON line, last on standard output; the numbers that
``correct`` compared, each with its limit, last on standard error.  Exits
with 2 and prints no result without the cards or without the port in the
checkout, and with 3 where the process holds JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout (the
    # port builds its kernels into build/torch_kernels/ itself)
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(1, str(ROOT))

    import torch

    import harness

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False: no result", 2)
    cell = harness.load_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.workload["chips"]:
        return _fail(f"{args.workload} needs {cell.workload['chips']} cards, "
                     f"{torch.cuda.device_count()} visible: no result", 2)
    try:
        import quantumsimulations_tpu_torch as port
    except ImportError as exc:
        return _fail(f"the port is not in this checkout ({exc}): no result", 2)
    if ROOT not in Path(port.__file__).resolve().parents:
        return _fail(f"the port was imported from {port.__file__}, outside {ROOT}: no result", 2)

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        return _fail(f"the process holds {bad} after the window: no result", 3)
    harness.emit(result, cell, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
