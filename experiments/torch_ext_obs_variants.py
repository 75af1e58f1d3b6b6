"""Text variants of csrc/ext_obs_diagonals.cu, built side by side and timed
on the card at one shape (device time per call, CUDA-graph replay).

    python3 experiments/torch_ext_obs_variants.py [--shape L,dim,T] [variant ...]

Variants are named text substitutions of the source (VARIANTS below); "base"
is the source as it is.  Each is built by its own nvcc (all at once) into a
temporary directory and called through the same C interface.  The script
also prints how many clusters of 16 blocks of the largest shared memory
(dim 8192) the card holds at once (cudaOccupancyMaxActiveClusters).  Outputs of
variants that skip work are not checked; the others are held against the
base variant bit for bit.  Needs a CUDA device; imports no JAX.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from chip_smoke import graph_ms  # noqa: E402
from quantumsimulations_tpu_torch.kernels import _build  # noqa: E402

SRC = os.path.join(REPO, "quantumsimulations_tpu_torch", "csrc", "ext_obs_diagonals.cu")

_MMA = ('"mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "\n'
        '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"\n')

_NO_STAGE = [("  if constexpr (VEC) stage_tma(", "  if constexpr (false) stage_tma("),
             ("  else stage_bytes(", "  else if (false) stage_bytes(")]

#: name -> (list of (old, new) substitutions, outputs checked)
VARIANTS = {
    "base": ([], True),
    # staging only: no mma, no output
    "stage_only": ([("  if (t >= T) return;\n", "  if (t >= T || t >= 0) return;\n")], False),
    # compute only: the shared memory is not filled from HBM
    "compute_only": ([("  if constexpr (VEC) stage_tma(", "  if constexpr (false) stage_tma("),
                      ("  else stage_bytes(", "  else if (false) stage_bytes(")], False),
    # plain shared-memory adds for the fragment flush (racy: the sums are
    # wrong): what do the atomics cost?
    "no_atomics": ([("namespace {\n", "namespace {\n__device__ void plain_add(int* p, int v) { *p += v; }\n"),
                    ("atomicAdd(", "plain_add(")], False),
    # compute only: the sites of stride >= 16 alone / no site units (the norm)
    "pairs_only": (_NO_STAGE + [("    switch (dr) {\n", "    switch (dr >= 16 ? dr : -1) {\n      case -1: break;\n")], False),
    "no_units": (_NO_STAGE + [("    if (lo >= hi) continue;\n", "    if (lo >= hi || true) continue;\n")], False),
    # staging into the block's own shared memory, not through the cluster
    "stage_local": ([("cluster.map_shared_rank(dst, 4 * Q + b)", "(dst)"),
                     ("  if (t >= T) return;\n", "  if (t >= T || t >= 0) return;\n")], False),
}

PROBE_C = r'''
// mma.sync m16n8k32 s8 issue rate: each warp runs `iters` steps of 8
// independent accumulator chains on register operands
__global__ void mma_rate_kernel(int iters, int* sink) {
  int c[8][4] = {};
  uint32_t a = threadIdx.x, b = blockIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) mma(c[k], a, a + k, a ^ k, b, b + k, a + b);
  }
  int v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) v += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (v == 0x12345678) *sink = v;
}

extern "C" float qst_mma_rate(int blocks, int threads, int iters) {
  int* sink;
  cudaMalloc(&sink, 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_rate_kernel<<<blocks, threads>>>(iters, sink);
  cudaEventRecord(e0);
  mma_rate_kernel<<<blocks, threads>>>(iters, sink);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(sink);
  return ms;
}

// clusters of 16 blocks at dim 8192's shared memory that the card holds at once
extern "C" int qst_probe_clusters(void) {
  auto kernel = ext_obs_kernel<false>;
  const int smem = PLANES_OFFSET + SLOTS * plane_stride(1 << MAX_SITES);
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}
'''


def variant_source(name: str) -> str:
    text = open(SRC).read()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    # the probe function needs the kernel's names: put it inside the anonymous
    # namespace's translation unit, after the C interface
    return text + PROBE_C


def build(name: str) -> ctypes.CDLL:
    d = tempfile.mkdtemp(prefix=f"ext_obs_{name}_")
    src = os.path.join(d, f"{name}.cu")
    with open(src, "w") as f:
        f.write(variant_source(name))
    out = os.path.join(d, f"lib{name}.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.qst_ext_obs_diagonals.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.qst_ext_obs_diagonals.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="15,8192,20480")
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    L, dim, T = (int(v) for v in args.shape.split(","))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(args.variants)) as pool:
        libs = dict(zip(args.variants, pool.map(build, args.variants)))
    first = libs[args.variants[0]]
    if os.environ.get("QST_SASS"):
        dump = subprocess.run([os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump"), "-sass",
                               first._name], capture_output=True, text=True).stdout
        with open(os.path.join(REPO, "chiprun_out", "ext_obs_sass.txt"), "w") as f:
            f.write(dump)
        import collections
        ops = collections.Counter(ln.split()[1].split(".")[0] for ln in dump.splitlines()
                                  if ln.strip().startswith("/*") and len(ln.split()) > 2 and "*/" in ln)
        print("sass opcodes:", ops.most_common(25), flush=True)
    print(f"clusters of 16 blocks held at once: {first.qst_probe_clusters()}; SMs "
          f"{torch.cuda.get_device_properties(0).multi_processor_count}", flush=True)
    first.qst_mma_rate.restype = ctypes.c_float
    for threads in (128, 512):
        sms, iters = torch.cuda.get_device_properties(0).multi_processor_count, 4096
        ms = first.qst_mma_rate(sms, threads, iters)
        mmas = sms * threads // 32 * iters * 8
        print(f"mma.sync m16n8k32 s8, {threads} threads a block on every SM: {ms:.3f} ms for "
              f"{mmas} mma, {mmas * 4096 * 2 / ms / 1e9:.1f} TOP/s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    S_re, S_im = (torch.randint(-16, 17, (L, dim, T), generator=gen, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(2))
    n = dim.bit_length() - 1
    R = -(-(3 * n + 1) // 8) * 8
    outs = {}

    def call(lib):
        out = torch.empty((11, R, T), dtype=torch.int32, device="cuda")
        rc = lib.qst_ext_obs_diagonals(S_re.data_ptr(), S_im.data_ptr(), out.data_ptr(), L, dim,
                                       T, n, R, 11, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return out

    for name, lib in libs.items():
        outs[name] = call(lib)
    torch.cuda.synchronize()
    ref = outs.get("base")
    for name, lib in list(libs.items()) + list(reversed(libs.items())):
        checked = VARIANTS[name][1]
        same = "" if ref is None or not checked else f", equal to base {torch.equal(outs[name], ref)}"
        print(f"{name}: device ms per call {graph_ms(lambda: call(lib), n=5, reps=3):.4f}{same}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
