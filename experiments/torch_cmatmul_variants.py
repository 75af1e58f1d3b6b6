"""Where cmatmul_f32's time goes: the kernel against text variants of itself.

Each variant is csrc/cmatmul_f32.cu with a few lines replaced (below), or
another source with the same C interface (the mma.sync design), built with
nvcc into a temporary directory and called on the same inputs: the eig32
main-path shape (39, 128, 128, 1680) and (1, 2048, 2048, 1024).  Prints,
for each, the device ms per call (CUDA events around 50 back-to-back
launches, so the host's enqueue stays ahead of the card), the error
relative to the output's largest magnitude against the plain float32
version and ptxas's spill report; then the time of ``torch.matmul`` on
complex64.

    python3 experiments/torch_cmatmul_variants.py

Needs a CUDA device and nvcc; imports no JAX.
"""
import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from quantumsimulations_tpu_torch.kernels._build import CSRC_DIR, NVCC_FLAGS, nvcc_path  # noqa: E402

REPO = CSRC_DIR.parents[1]
from quantumsimulations_tpu_torch.ops.cmatmul import cmatmul_f32_plain  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

VARIANTS = {
    "as committed": [],
    # the first tensor-core design of this kernel, on mma.sync
    "mma.sync design": "experiments/torch_cmatmul_mma_sync.cu",
    # the descriptor's two strides the other way round (a wrong layout
    # must show as a large error)
    "LBO/SBO swapped": [("constexpr int LBO = 128;", "constexpr int LBO = KG * 128;"),
                        ("constexpr int SBO = KG * 128;", "constexpr int SBO = 128;")],
    # 16-deep stages: less shared memory, twice the barriers and flushes
    "BK 16": [("constexpr int BK = 32;", "constexpr int BK = 16;")],
    # one warpgroup (64 rows) per block, 16-deep stages, two blocks per SM
    "1 warpgroup, BK 16": [("constexpr int WG = 2;", "constexpr int WG = 1;"),
                           ("constexpr int BK = 32;", "constexpr int BK = 16;"),
                           ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 2)")],
    # the copy loops unrolled: per-copy addresses held across the K loop
    "copy loops unrolled": [("#pragma unroll 1\n  for (int l = 0; l < A_COPIES", "#pragma unroll\n  for (int l = 0; l < A_COPIES"),
                            ("#pragma unroll 1\n  for (int l = 0; l < B_COPIES", "#pragma unroll\n  for (int l = 0; l < B_COPIES")],
    # the products accumulated in the tensor cores across K (no flush)
    "no flush": [("  float acc_r[32], acc_i[32], pr[32], pi[32];", "  float acc_r[32], acc_i[32];\n  float* pr = acc_r;\n  float* pi = acc_i;"),
                 ("const int acc = ks > 0;", "const int acc = 1;"),
                 ("      acc_r[r] += pr[r];\n      acc_i[r] += pi[r];\n", "")],
    # timing skeleton: no B split pass and no A fragment loads (wrong results)
    "skeleton (no splits)": [("for (int l = 0; l < (2 * BN * BK) / THREADS; ++l) {", "for (int l = 0; l < 0; ++l) {"),
                             ("    split_tf32(raw[idx], f[0][q], f[1][q]);\n    split_tf32(raw[A_PLANE + idx], f[2][q], f[3][q]);",
                              "    f[0][q] = f[1][q] = f[2][q] = f[3][q] = idx;")],
}


def build(name, patches, out_dir):
    src = (CSRC_DIR / "cmatmul_f32.cu").read_text()
    if isinstance(patches, str):  # another source file, relative to the repo
        src, patches = (REPO / patches).read_text(), []
    for old, new in patches:
        if old not in src:
            raise SystemExit(f"variant {name!r}: patch target not found: {old!r}")
        src = src.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cu = os.path.join(out_dir, f"{tag}.cu")
    so = os.path.join(out_dir, f"lib{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", so, cu],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"variant {name!r}: nvcc failed\n{proc.stderr}")
    spill = [ln.strip() for ln in proc.stderr.splitlines() if "spill" in ln or "wgmma" in ln]
    return so, spill


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv, tmp), VARIANTS.items())))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for B, M, K, N in [(39, 128, 128, 1680), (1, 2048, 2048, 1024)]:
            ar, ai = (torch.randn(B, M, K, generator=gen, device="cuda") for _ in range(2))
            br, bi = (torch.randn(B, K, N, generator=gen, device="cuda") for _ in range(2))
            pr, pi = cmatmul_f32_plain(ar, ai, br, bi)
            scale = float(torch.maximum(pr.abs().max(), pi.abs().max()))
            cr, ci = torch.empty_like(pr), torch.empty_like(pr)
            stream = torch.cuda.current_stream().cuda_stream
            for name, (so, spill) in libs.items():
                fn = ctypes.CDLL(so).qst_cmatmul_f32
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
                args = (ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(), cr.data_ptr(), ci.data_ptr(),
                        B, M, K, N, M * K, K, K * N, N, M * N, N, stream)
                assert fn(*args) == 0
                torch.cuda.synchronize()
                err = float(torch.maximum((cr - pr).abs().max(), (ci - pi).abs().max())) / scale
                print(f"{(B, M, K, N)} {name:18s} {ms_loop(lambda: fn(*args)):.4f} ms  rel err {err:.2e}  "
                      f"spills {spill}", flush=True)
            ac, bc = torch.complex(ar, ai), torch.complex(br, bi)
            print(f"{(B, M, K, N)} torch.matmul complex64 {ms_loop(lambda: torch.matmul(ac, bc)):.4f} ms",
                  flush=True)


def ms_loop(fn, n=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        best.append(a.elapsed_time(b) / n)
    return min(best)


if __name__ == "__main__":
    main()
