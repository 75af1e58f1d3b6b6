"""First check of the tensor-core cmatmul_f32 (3xTF32) and limb_matmul_canon
(int8 mma) kernels on the card.

Builds both CUDA sources (nvcc in parallel, ptxas register and spill
report), holds each kernel against its plain PyTorch version at the main
path's shapes and at ragged ones (cmatmul_f32 within 1e-5 of the output's
largest magnitude, limb_matmul_canon bit for bit, twice, so a split-K
launch is also held to itself), and prints CUDA-event times of each kernel
beside its plain version and, for the limb shapes, the 12 ``torch._int_mm``
digit products (no carry) as a yardstick.

    python3 experiments/torch_tensor_core_probe.py

Needs a CUDA device; imports no JAX.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from chip_smoke import cuda_ms as ms, graph_ms, int_mm_digits  # noqa: E402
from quantumsimulations_tpu_torch.kernels._build import build_all  # noqa: E402
from quantumsimulations_tpu_torch.ops import cmatmul as cm  # noqa: E402
from quantumsimulations_tpu_torch.ops import limb_kernels as lk  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    for k, (out, sec) in build_all(("cmatmul_f32", "limb_matmul_canon"), extra_flags=("-Xptxas", "-v")).items():
        print(k, f"{sec:.1f}s", [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln],
              flush=True)
    print(f"builds {time.perf_counter() - t0:.1f}s", flush=True)
    ok = True
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, M, K, N in [(39, 128, 128, 1680), (1, 2048, 2048, 1024), (2, 64, 200, 96), (1, 300, 513, 130),
                       (1, 5, 1, 3), (2, 9, 7, 12), (1, 15, 9, 6)]:
        ar, ai = (torch.randn(B, M, K, generator=g, device="cuda") for _ in range(2))
        br, bi = (torch.randn(B, K, N, generator=g, device="cuda") for _ in range(2))
        cr, ci = cm.cmatmul_f32(ar, ai, br, bi)
        pr, pi = cm.cmatmul_f32_plain(ar, ai, br, bi)
        torch.cuda.synchronize()
        rel = float(torch.maximum((cr - pr).abs().max(), (ci - pi).abs().max())
                    / torch.maximum(pr.abs().max(), pi.abs().max()))
        ok &= rel <= 1e-5
        line = f"cmatmul {(B, M, K, N)} rel {rel:.3e}"
        if M >= 128:
            ac, bc = torch.complex(ar, ai), torch.complex(br, bi)
            try:
                line += f" graph {graph_ms(lambda: cm.cmatmul_f32(ar, ai, br, bi)):.4f} ms"
            except RuntimeError as exc:
                line += f" graph capture failed: {exc}"
            line += (f" kernel {ms(lambda: cm.cmatmul_f32(ar, ai, br, bi)):.4f} ms"
                     f" plain {ms(lambda: cm.cmatmul_f32_plain(ar, ai, br, bi)):.4f}"
                     f" complex64 matmul {ms(lambda: torch.matmul(ac, bc)):.4f}")
        print(line, flush=True)

    def limbs(shape, lo=-32, hi=33):
        x = torch.randint(lo, hi, (10,) + shape, generator=g, device="cuda", dtype=torch.int32)
        x[0] = torch.randint(-64, 65, shape, generator=g, device="cuda", dtype=torch.int32)
        return x.to(torch.int8).contiguous()

    for M, K, N, tm in [(256, 128, 256, None), (1792, 128, 128, 128), (128, 1792, 128, None),
                        (2048, 2048, 2048, None), (33, 50, 70, None), (96, 37, 24, 32), (7, 45, 5, None),
                        (128, 4096, 64, None), (640, 301, 700, None)]:
        a, b = limbs((M, K)), limbs((K, N))
        kw = dict(tm=tm, transpose_out=True) if tm else {}
        o1 = lk.limb_matmul_canon(a, b, bits=6, **kw)
        o2 = lk.limb_matmul_canon(a, b, bits=6, **kw)
        p = lk.limb_matmul_canon_plain(a, b, 6, **kw)
        torch.cuda.synchronize()
        eq = torch.equal(o1, p) and torch.equal(o2, p)
        ok &= eq
        plan = lk.limb_launch_plan(M, K, N)
        line = f"limb {(M, K, N)} tm={tm} equal {eq} ndiff {int((o1 != p).sum())} plan {plan} blocks {plan.blocks}"
        if eq and M >= 128:
            line += (f" kernel {ms(lambda: lk.limb_matmul_canon(a, b, bits=6, **kw)):.4f} ms"
                     f" graph {graph_ms(lambda: lk.limb_matmul_canon(a, b, bits=6, **kw)):.4f} ms")
            if K % 8 == 0 and N % 8 == 0:
                line += (f" int_mm digits {ms(int_mm_digits(a, b)):.4f}"
                         f" graph {graph_ms(int_mm_digits(a, b)):.4f}")
        print(line, flush=True)
    a = torch.randint(-128, 128, (10, 128, 1792), generator=g, device="cuda").to(torch.int8)
    b = torch.randint(-128, 128, (10, 1792, 128), generator=g, device="cuda").to(torch.int8)
    a[:, 0, :] = -128
    b[:, :, 0] = -128
    eq = torch.equal(lk.limb_matmul_canon(a, b, bits=6), lk.limb_matmul_canon_plain(a, b, 6))
    ok &= eq
    print("limb extreme -128 at K=1792 equal", eq, flush=True)
    print("ALL OK" if ok else "FAILED", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
