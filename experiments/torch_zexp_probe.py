"""z_expectations_f32 on the card: the one-launch float64 kernel beside the
earlier compensated float32 design (experiments/torch_zexp_compensated.cu).

Builds both sources (nvcc in parallel, ptxas register and spill report);
holds the current kernel against its plain PyTorch version at the smoke's
four shapes and at ragged ones (T 1, 33, 2049; n 1 and 16; float32 and
float64 sign tables), within 1e-5 of the largest output, with the share of
outputs equal bit for bit and two calls equal; then, at the four shapes,
device times per call (CUDA-graph replay) of the earlier design (its whole
call: the float32 sign conversion, the scratch buffer, two launches; timed
first, before the current kernel's first launch, then again in turns with
it), of the current kernel and of the same-function PyTorch chain, the eager call
times, and at the route's shape the cold-L2 times.

    python3 experiments/torch_zexp_probe.py

Needs a CUDA device; imports no JAX.
"""
import ctypes
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from chip_smoke import card_peaks, cold_ms, cuda_ms, graph_ms, zexp_bound, zexp_chain  # noqa: E402
from quantumsimulations_tpu_torch.kernels import _build  # noqa: E402
from quantumsimulations_tpu_torch.kernels import launch_counts  # noqa: E402
from quantumsimulations_tpu_torch.ops import zexp  # noqa: E402

OLD_SRC = os.path.join(REPO, "experiments", "torch_zexp_compensated.cu")
#: the smoke's phase-6 shapes and the route's (n, dim, T, plane dtype)
MAIN_SHAPES = [(4, 16, 37, torch.float64), (7, 128, 20000, torch.float32),
               (14, 16384, 2048, torch.float64), (14, 16384, 21, torch.float64)]
RAGGED = [(14, 16384, 1, torch.float64), (14, 16384, 33, torch.float64),
          (14, 16384, 2049, torch.float64), (1, 16, 2049, torch.float32),
          (1, 64, 21, torch.float64), (16, 65536, 64, torch.float32),
          (5, 96, 7, torch.float32)]


def build_old() -> tuple[ctypes.CDLL, str]:
    out = os.path.join(tempfile.mkdtemp(prefix="zexp_old_"), "libzexp_compensated.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out, OLD_SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(out), proc.stdout + proc.stderr


def old_caller(lib):
    fn = lib.qst_z_expectations_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(re, im, signs):
        # the earlier wrapper: float32 signs, a scratch per call, 1-2 launches
        dim, T = re.shape
        n = signs.shape[0]
        out = torch.empty((n, T), dtype=torch.float32, device=re.device)
        s32 = signs.to(torch.float32).contiguous()
        rb = max(1, min(-(-264 // -(-T // 32)), dim // 128))
        scratch = torch.empty((rb, 2, n, T), dtype=torch.float32, device=re.device) if rb > 1 else None
        rc = fn(re.data_ptr(), im.data_ptr(), s32.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), n, dim, T, rb,
                int(re.dtype == torch.float64), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old kernel: CUDA error {rc}")
        return out
    return call


def planes(n, dim, T, dtype, seed, sign_dtype=torch.float64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    re, im = (torch.randn(dim, T, generator=g, device="cuda", dtype=dtype) for _ in range(2))
    dims = (2,) * (n - 1) + (dim >> (n - 1),)
    signs = torch.as_tensor(zexp.z_sign_table(dims), device="cuda").to(sign_dtype)
    return re, im, signs


def ptxas(report: str) -> list[str]:
    return [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        new_f = pool.submit(_build.build, "z_expectations_f32", ("-Xptxas", "-v"))
        old_f = pool.submit(build_old)
        new_report = new_f.result()
        old_lib, old_report = old_f.result()
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    print("new ptxas:", *ptxas(new_report), sep="\n  ", flush=True)
    print("old ptxas:", *ptxas(old_report), sep="\n  ", flush=True)
    old = old_caller(old_lib)

    # the earlier design first, before the current kernel's first launch
    for i, (n, dim, T, dtype) in enumerate(MAIN_SHAPES):
        re, im, signs = planes(n, dim, T, dtype, seed=i)
        line = (f"before: {(n, dim, T, str(dtype)[6:])}: old device ms "
                f"{graph_ms(lambda: old(re, im, signs)):.5f}, eager {cuda_ms(lambda: old(re, im, signs)):.5f}")
        if T == 21:
            line += f", cold L2 {cold_ms(lambda: old(re, im, signs)):.5f}"
        print(line, flush=True)

    ok = True
    for i, (n, dim, T, dtype) in enumerate(MAIN_SHAPES + RAGGED):
        for sign_dtype in (torch.float64, torch.float32):
            re, im, signs = planes(n, dim, T, dtype, seed=i, sign_dtype=sign_dtype)
            before = launch_counts["z_expectations_f32"]
            got = zexp.z_expectations_f32(re, im, signs)
            again = zexp.z_expectations_f32(re, im, signs)
            torch.cuda.synchronize()
            launches = launch_counts["z_expectations_f32"] - before
            want = zexp.z_expectations_f32_plain(re, im, signs)
            rel = float((got - want).abs().max() / want.abs().max())
            same = torch.equal(got, again)
            ok &= rel <= 1e-5 and same and launches == 2
            print(f"{(n, dim, T, str(dtype)[6:])} signs {str(sign_dtype)[6:]}: rel err {rel:.3e}, "
                  f"bit-equal {float((got == want).double().mean()):.4f}, two calls equal {same}, "
                  f"launches {launches}, plan {zexp.zexp_launch_plan(n, dim, T, re.element_size())}",
                  flush=True)
    print("correct" if ok else "WRONG", flush=True)
    if not ok:
        return 1

    # alternating shapes on one stream (the counters reset inside each call)
    pairs = [planes(14, 16384, 21, torch.float64, 90), planes(16, 65536, 64, torch.float32, 91)]
    wants = [zexp.z_expectations_f32_plain(*p) for p in pairs]
    for k in range(6):
        got = zexp.z_expectations_f32(*pairs[k % 2])
        if not torch.equal(got, zexp.z_expectations_f32(*pairs[k % 2])):
            ok = False
        ok &= float((got - wants[k % 2]).abs().max() / wants[k % 2].abs().max()) <= 1e-5
    print(f"alternating shapes: {'correct' if ok else 'WRONG'}", flush=True)

    for i, (n, dim, T, dtype) in enumerate(MAIN_SHAPES):
        re, im, signs = planes(n, dim, T, dtype, seed=i)
        new = lambda: zexp.z_expectations_f32(re, im, signs)  # noqa: E731
        rel_old = float((old(re, im, signs) - zexp.z_expectations_f32_plain(re, im, signs)).abs().max()
                        / zexp.z_expectations_f32_plain(re, im, signs).abs().max())
        chain = zexp_chain(re, im, signs)
        line = (f"{(n, dim, T, str(dtype)[6:])}: device ms old {graph_ms(lambda: old(re, im, signs)):.5f}"
                f" (rel err {rel_old:.2e}), new {graph_ms(new):.5f}, new again {graph_ms(new):.5f}, "
                f"old again {graph_ms(lambda: old(re, im, signs)):.5f}, chain {graph_ms(chain):.5f}, "
                f"plain {graph_ms(lambda: zexp.z_expectations_f32_plain(re, im, signs)):.5f}; eager "
                f"old {cuda_ms(lambda: old(re, im, signs)):.5f}, new {cuda_ms(new):.5f}; bound "
                f"{zexp_bound(n, dim, T, re.element_size(), peaks, 8)}")
        if T == 21:
            line += f"; cold L2 old {cold_ms(lambda: old(re, im, signs)):.5f}, new {cold_ms(new):.5f}"
        print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
