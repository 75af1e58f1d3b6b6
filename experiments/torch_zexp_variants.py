"""Text variants of csrc/z_expectations_f32.cu and of its launch plan, built
side by side and timed on the same card.

Each variant is the package source with a few lines replaced (rows loaded
per step, sign tile height, ...), compiled by nvcc into its own library in a
temporary directory (all builds in parallel, ptxas report printed); each is
held against the plain version (within 1e-5 of the largest output; the
"main_only" variant skips the merges and is timed only) and timed as device
time per call (CUDA-graph replay) at the two n14 shapes, in turns with the
package source, under the plan of ops/zexp.py with each combination of the
values given for its module constants (``--set``).  At the route's shape the cold-L2 time is printed too.

    python3 experiments/torch_zexp_variants.py [--set _MAX_CLUSTER=1,16 ...] [variant ...]

Needs a CUDA device; imports no JAX.
"""
import ctypes
import itertools
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from chip_smoke import cold_ms, graph_ms  # noqa: E402
from quantumsimulations_tpu_torch.kernels import _build  # noqa: E402
from quantumsimulations_tpu_torch.ops import zexp  # noqa: E402

SRC = os.path.join(REPO, "quantumsimulations_tpu_torch", "csrc", "z_expectations_f32.cu")
#: name -> [(text in the source, replacement)]
VARIANTS = {
    "base": [],
    "u8_c1": [("constexpr int U = C == 1 ? 4 : 3;", "constexpr int U = C == 1 ? 8 : 3;")],
    "u2_c2": [("constexpr int U = C == 1 ? 4 : 3;", "constexpr int U = C == 1 ? 4 : 2;")],
    "tile64": [("constexpr int TILE_ROWS = 128;", "constexpr int TILE_ROWS = 64;")],
    "tile256": [("constexpr int TILE_ROWS = 128;", "constexpr int TILE_ROWS = 256;")],
    "ldg": [("__ldcs(reinterpret_cast<const double2*>(p))", "__ldg(reinterpret_cast<const double2*>(p))"),
            ("__ldcs(reinterpret_cast<const float2*>(p))", "__ldg(reinterpret_cast<const float2*>(p))"),
            ("v[0] = __ldcs(p);", "v[0] = __ldg(p);")],
    "no_unroll_stage": [("#pragma unroll 8\n    for (int k = tid;", "    for (int k = tid;")],
    # timed only (their results are not the function's): no merges, no
    # last-cluster merge, no streaming loop, two sites, no float32 rounding
    # of p2, signs staged for a block's first tile only
    "main_only": [("  if (S == 1) return;\n\n  if (cs > 1) {", "  return;\n\n  if (cs > 1) {")],
    "no_global": [("    if (!s_final) return;\n", "    return;\n")],
    "empty_main": [("if (active) {\n      for (int r = rl;", "if (false) {\n      for (int r = rl;")],
    "pairs1": [("if (jp < pairs) {", "if (jp < 1) {")],
    "noconv": [("q[c] = static_cast<double>(square_sum(a[u][c], b[u][c]));",
                "q[c] = static_cast<double>(a[u][c]) * a[u][c] + static_cast<double>(b[u][c]) * b[u][c];")],
    "nostage": [("for (int k = tid; k < 2 * pairs * rows; k += nth) {",
                 "for (int k = tid; base == d0 && k < 2 * pairs * rows; k += nth) {")],
}
#: variants whose results are not the function's
TIMED_ONLY = ("main_only", "no_global", "empty_main", "pairs1", "noconv", "nostage")
SHAPES = [(14, 16384, 2048, torch.float64), (14, 16384, 21, torch.float64),
          (7, 128, 20000, torch.float32), (16, 65536, 64, torch.float32)]


def build(name, edits, tmp):
    text = open(SRC).read()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name}: text not found: {old!r}")
        text = text.replace(old, new)
    src = os.path.join(tmp, f"{name}.cu")
    lib = os.path.join(tmp, f"lib{name}.so")
    open(src, "w").write(text)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: {proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(lib).qst_z_expectations_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    regs = [ln.split("Used")[1].split(",")[0].strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "Used" in ln]
    spills = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    return fn, regs, spills


def caller(fn, re, im, signs, plan):
    n, (dim, T) = signs.shape[0], re.shape

    def call():
        out = torch.empty((n, T), dtype=torch.float32, device=re.device)
        stream = torch.cuda.current_stream().cuda_stream
        ws, counters = zexp._merge_buffers(re.device, stream, plan) if plan.partials > 1 else (None, None)
        rc = fn(re.data_ptr(), im.data_ptr(), signs.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), 0 if ws is None else ws.numel(),
                None if counters is None else counters.data_ptr(),
                0 if counters is None else counters.numel(),
                n, dim, T, plan.cols, plan.groups, plan.row_lanes, plan.col_tiles, plan.row_slices,
                plan.slice_rows, plan.cluster, re.element_size(), signs.element_size(), stream)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return out
    return call


def main(names, knobs) -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp(prefix="zexp_variants_")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        futs = {k: pool.submit(build, k, VARIANTS[k], tmp) for k in names}
        libs = {k: f.result() for k, f in futs.items()}
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    for k, (_, regs, spills) in libs.items():
        print(f"{k}: registers {regs} {spills}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for i, (n, dim, T, dtype) in enumerate(SHAPES):
        g = torch.Generator(device="cuda").manual_seed(i)
        re, im = (torch.randn(dim, T, generator=g, device="cuda", dtype=dtype) for _ in range(2))
        signs = torch.as_tensor(zexp.z_sign_table((2,) * (n - 1) + (dim >> (n - 1),)), device="cuda")
        want = zexp.z_expectations_f32_plain(re, im, signs)
        for setting in itertools.product(*[[(k, v) for v in vs] for k, vs in knobs.items()]):
            for k, v in setting:
                setattr(zexp, k, v)
            zexp.zexp_launch_plan.cache_clear()
            plan = zexp.zexp_launch_plan(n, dim, T, re.element_size(), sms=sms)
            line = [f"{(n, dim, T, str(dtype)[6:])} {dict(setting)} (G {plan.groups}, {plan.blocks} "
                    f"blocks, {plan.row_slices} slices, cluster {plan.cluster}, {plan.partials} "
                    f"partials):"]
            order = ["base"] + [k for k in names if k != "base"] + ["base"]
            for k in order:
                call = caller(libs[k][0], re, im, signs, plan)
                got = call()
                torch.cuda.synchronize()
                rel = float((got - want).abs().max() / want.abs().max())
                if k not in TIMED_ONLY and not rel <= 1e-5:
                    ok = False
                text = f"{k} {graph_ms(call):.5f}"
                if T == 21:
                    text += f" (cold {cold_ms(call):.5f})"
                if k not in TIMED_ONLY:
                    text += f" err {rel:.1e}"
                line.append(text)
            print(" | ".join(line), flush=True)
    print("correct" if ok else "WRONG", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    args = sys.argv[1:]
    knobs = {}
    while args[:1] == ["--set"]:
        name, values = args[1].split("=")
        knobs[name] = [int(x) for x in values.split(",")]
        args = args[2:]
    sys.exit(main(["base"] + [k for k in (args or VARIANTS) if k != "base"], knobs))
