"""Where the time of one (8192)^3 ext product goes, on the card.

Times (CUDA events) the pieces of ``ops/extprec.ext_cmatmul`` on random
canonical limb stacks at dim 8192, one 512-column panel at a time: the left
operand's preparation, the right panel's preparation (its limb reversal and
transpose) in several layouts, the 51 int8 GEMMs of one panel, the two carry
cascades, one whole product; then profiles one whole panel product with
``torch.profiler`` and prints the device time by kernel.

    python3 experiments/torch_ext_product_profile.py

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.profiler import ProfilerActivity, profile


def cuda_ms(fn, reps=5, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from quantumsimulations_tpu_torch.ops import extprec as ep
    from quantumsimulations_tpu_torch.ops.limb_kernels import carry_digits

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, D, P = 15, 8192, 512

    def limbs(shape):
        x = torch.randint(-16, 17, shape, generator=gen, device="cuda", dtype=torch.int8)
        x[0] //= 2
        return x

    U_re, U_im = limbs((L, D, D)), limbs((L, D, D))
    res = {}
    res["ext_left (full A)"] = cuda_ms(lambda: ep.ext_left(U_re, U_im), reps=3)
    left = ep.ext_left(U_re, U_im)
    b_re, b_im = U_re[:, :, :P], U_im[:, :, :P]
    res["_right_rev one plane, one panel"] = cuda_ms(lambda: ep._right_rev(b_re))
    bc = b_re.contiguous()
    res["contiguous() of one panel plane"] = cuda_ms(lambda: b_re.contiguous())
    res["per-limb 2-D t().contiguous(), one panel plane"] = cuda_ms(
        lambda: torch.stack([bc[i].t().contiguous() for i in range(L - 1, -1, -1)], dim=1))
    res["transpose via copy_ into (N, L, K), one panel plane"] = cuda_ms(
        lambda: torch.empty((P, L, D), dtype=torch.int8, device="cuda").copy_(
            bc.flip(0).permute(2, 0, 1)))
    res["flip(0) alone, one panel plane"] = cuda_ms(lambda: bc.flip(0))
    res["permute(2, 0, 1).contiguous() alone, one panel plane"] = cuda_ms(
        lambda: bc.permute(2, 0, 1).contiguous())
    r = [ep._right_rev(x) for x in (b_re, b_im, b_re + b_im)]

    def gemms():
        for s in range(L + ep.EXT_GUARD):
            ep.diagonal_mm(left.re, r[0], L, s)
            ep.diagonal_mm(left.im, r[1], L, s)
            ep.diagonal_mm(left.sum, r[2], L, s)

    res["51 int8 GEMMs of one panel"] = cuda_ms(gemms, reps=3)
    d = torch.randint(-2**20, 2**20, (L + 2, D, P), generator=gen, device="cuda", dtype=torch.int32)
    res["carry_digits one plane, one panel"] = cuda_ms(lambda: carry_digits(d, 5, L))
    res["_ext_cpanel_product one panel"] = cuda_ms(
        lambda: ep._ext_cpanel_product(left, b_re, b_im), reps=3)
    res["ext_cmatmul, one whole (8192)^3 product, panel 512"] = cuda_ms(
        lambda: ep.ext_cmatmul(U_re, U_im, U_re, U_im, panel=P), reps=2)
    for k, v in res.items():
        print(f"{k:62s} {v:10.3f} ms", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ep._ext_cpanel_product(left, b_re, b_im)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:15]:
        print(f"{e.key[:90]:90s} {e.self_device_time_total / 1e3:10.3f} ms  x{e.count}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
