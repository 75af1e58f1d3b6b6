"""Bounds of ext_obs_diagonals_int8 (kernel 3) at the rates its products
could run at, from the counts a chip_smoke.py run prints.

chip_smoke.py phase 5 counts the int32 operations the function needs
(``gop``: per limb pair, column and row, the product Rj*Ri + Ij*Ii, its norm
and per-site z sums, and x and y over each site's level pairs; a
multiply-add is two operations) and the bytes it must move (``mbytes``),
and bounds the kernel by int32 multiply-adds on the CUDA cores.  This script
restates that bound at two other rates, for the same operations:

  - ``__dp4a``: four int8 multiply-adds into an int32 per instruction, at
    the INT32 lanes' instruction rate (an assumption: NVIDIA's data sheets
    give no dp4a rate): 4x the CUDA-core int32 rate;
  - int8 tensor cores (dense), if each column's limb-pair sums are cast as
    a product (a Gram of the column's limb vectors, with the site signs and
    level flips folded into the operands).  A Gram computes every limb pair,
    not only the live ones, so this bound is a lower one.

Each bound is the larger of operations over the rate and bytes over the HBM
rate, from chip_smoke's data-sheet table for the card the log names.

    python3 experiments/torch_kernel3_bounds.py chiprun_out/smoke.log

Runs on the CPU; reads the log of a smoke run, measures nothing.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import _INT32_SHARE_OF_F32, card_peaks  # noqa: E402


def main(path: str) -> int:
    lines = open(path).read().splitlines()
    card = lines[lines.index("[1/14] card (nvidia-smi name, power.limit):") + 1]
    kernels = next(json.loads(ln)["kernels"] for ln in lines if ln.startswith('{"kernels"'))
    row = next(k for k in kernels if k["name"] == "ext_obs_diagonals_int8")
    key, f32, int8_tc, hbm, _, _ = card_peaks(card)
    rates = {"int32 CUDA cores": f32 * _INT32_SHARE_OF_F32,
             "__dp4a": 4 * f32 * _INT32_SHARE_OF_F32,
             "int8 tensor cores": int8_tc}
    print(f"{card} ({key} data sheet)")
    for shape, r in row["shapes"].items():
        t_bytes = r["mbytes"] * 1e6 / hbm * 1e3
        for name, rate in rates.items():
            t_ops = r["gop"] * 1e9 / rate * 1e3
            bound = max(t_ops, t_bytes)
            print(f"{shape} {name}: {rate / 1e12:g} TOP/s, bound {bound:.4f} ms "
                  f"({'operations' if t_ops >= t_bytes else 'bytes'}); the kernel's {r['ms']:.4f} ms "
                  f"reaches {bound / r['ms']:.1%} of it")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/smoke.log"))
