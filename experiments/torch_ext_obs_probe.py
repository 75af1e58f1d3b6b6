"""ext_obs_diagonals_int8 on the card: the tensor-core design beside the
SIMT design it replaced.

Builds, one nvcc each and both at once (ptxas register and spill report):
  * the port's kernel, quantumsimulations_tpu_torch/csrc/ext_obs_diagonals.cu
    (int8 mma Grams, one column per block, a cluster stages its columns);
  * the SIMT design it replaced, experiments/torch_ext_obs_simt.cu (one
    int32 multiply-add per limb-pair product; a block per (128 columns, site)).
Holds the port's kernel against the plain PyTorch version bit for bit at
n_sites 1-13 (T 33 and 32: byte and TMA staging), at ragged T (1, 130, 2049), at n_diag < 11 with
L = n_diag and at every limb +-33, with two calls equal and one launch per
call (``ext_obs.launches`` of a tracer); holds the SIMT design against it at
the path's shape.  Then times both at (15, 8192, 1024) and at the n12
path's (15, 8192, 20480), in turns (device time per call from a CUDA-graph
replay, chip_smoke.graph_ms; the eager call for the port's kernel).

    python3 experiments/torch_ext_obs_probe.py

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

from chip_smoke import cuda_ms, graph_ms  # noqa: E402
from quantumsimulations_tpu_torch.kernels import _build, launches  # noqa: E402
from quantumsimulations_tpu_torch.ops import ext_obs as eo  # noqa: E402
from quantumsimulations_tpu_torch.utils.profiling import StageTimer, tracing  # noqa: E402

CANDIDATES = {"simt": "torch_ext_obs_simt.cu"}
PATH = (15, 8192, 20480)


def build_other(name: str) -> tuple[ctypes.CDLL, str]:
    src = os.path.join(REPO, "experiments", CANDIDATES[name])
    out = os.path.join(tempfile.mkdtemp(prefix=f"ext_obs_{name}_"), f"lib{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(out), proc.stdout + proc.stderr


def caller(lib):
    fn = lib.qst_ext_obs_diagonals
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(S_re, S_im, nd):
        L, dim, T = S_re.shape
        n = dim.bit_length() - 1
        R = -(-(3 * n + 1) // 8) * 8
        out = torch.empty((nd, R, T), dtype=torch.int32, device=S_re.device)
        rc = fn(S_re.data_ptr(), S_im.data_ptr(), out.data_ptr(), L, dim, T, n, R, nd,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return out
    return call


def limbs(shape, gen, extreme=False):
    if extreme:  # every limb at +-33: the headroom's worst case
        return (torch.randint(0, 2, shape, generator=gen, device="cuda", dtype=torch.int32) * 66
                - 33).to(torch.int8).contiguous()
    x = torch.randint(-16, 17, shape, generator=gen, device="cuda", dtype=torch.int32)
    x[0] = torch.randint(-33, 34, shape[1:], generator=gen, device="cuda", dtype=torch.int32)
    return x.to(torch.int8).contiguous()


def pairs(nd):
    return zip(*[(j, s - j) for s in range(nd) for j in range(s + 1)])


def ptxas(report: str) -> list[str]:
    return [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        new_f = pool.submit(_build.build, "ext_obs_diagonals", ("-Xptxas", "-v"))
        others = {k: pool.submit(build_other, k) for k in CANDIDATES}
        print("port ptxas:", *ptxas(new_f.result()), sep="\n  ", flush=True)
        calls = {}
        for k, f in others.items():
            lib, report = f.result()
            calls[k] = caller(lib)
            print(f"{k} ptxas:", *ptxas(report), sep="\n  ", flush=True)
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(15, 1 << n, 33, 11, False) for n in range(1, 14)]
    cases += [(15, 1 << n, 32, 11, False) for n in range(1, 14)]  # T % 16 == 0: staged by TMA
    cases += [(15, 8192, T, 11, False) for T in (1, 130, 2049)]
    cases += [(15, 16, 33, 11, False), (15, 64, 200, 11, False), (15, 8192, 1024, 11, False)]
    cases += [(nd, 1 << n, 48, nd, False) for nd, n in ((1, 5), (4, 9), (7, 12))]
    cases += [(15, 1 << n, T, 11, True) for n, T in ((3, 33), (10, 64), (13, 130))]
    ok = True
    for L, dim, T, nd, extreme in cases:
        S_re, S_im = limbs((L, dim, T), gen, extreme), limbs((L, dim, T), gen, extreme)
        jj, ii = pairs(nd)
        timer = StageTimer()
        with tracing(timer):
            got = eo.ext_obs_diagonals_int8(S_re, S_im, jj, ii, nd)
            again = eo.ext_obs_diagonals_int8(S_re, S_im, jj, ii, nd)
        torch.cuda.synchronize()
        n_launch = launches(timer)["ext_obs"]
        want = eo.ext_obs_diagonals_plain(S_re, S_im, jj, ii, nd)
        equal, same = torch.equal(got, want), torch.equal(got, again)
        ok &= equal and same and n_launch == 2
        print(f"({L}, {dim}, {T}) n_diag {nd}{' limbs +-33' if extreme else ''}: equal to plain "
              f"{equal} ({int((got != want).sum())} differ), two calls equal {same}, launches "
              f"{n_launch}", flush=True)
    print("correct" if ok else "WRONG", flush=True)
    if not ok:
        return 1

    jj, ii = pairs(11)
    for shape in ((15, 8192, 1024), PATH):
        S_re, S_im = limbs(shape, gen), limbs(shape, gen)
        port = lambda: eo.ext_obs_diagonals_int8(S_re, S_im, jj, ii, 11)  # noqa: E731
        ref = port()
        for k, call in calls.items():
            same = torch.equal(call(S_re, S_im, 11), ref)
            ok &= same
            print(f"{shape}: {k} equal to the port's kernel: {same}", flush=True)
        fns = {"simt": lambda: calls["simt"](S_re, S_im, 11), "port": port}
        times = {k: [] for k in fns}
        for k in ("simt", "port", "port", "simt"):
            times[k].append(graph_ms(fns[k], n=5 if shape == PATH else 10, reps=3))
        line = ", ".join(f"{k} {' / '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items())
        print(f"{shape}: device ms per call (graph, in turns): {line}; port eager "
              f"{cuda_ms(port, reps=10):.4f}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
