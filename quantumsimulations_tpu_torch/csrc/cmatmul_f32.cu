// Fused complex matmul on float32 (re, im) planes, batched, for Hopper (sm_90a),
// on the TF32 tensor cores (wgmma) with a 3xTF32 split.
//
// Replaces the Pallas TPU kernel quantumsimulations_tpu/ops/pallas_kernels.py
// `_cmatmul_kernel` (driven by `cmatmul_f32`): both output planes
//
//     Cr = Ar Br - Ai Bi,    Ci = Ar Bi + Ai Br
//
// come from ONE pass over the A and B tiles.  The reference asks for
// Precision.HIGHEST, i.e. float32 grade, which one TF32 product (10 mantissa
// bits) misses.  So every float32 operand x is split as
//
//     hi = tf32_rna(x),   lo = tf32_rna(x - hi)
//
// and each real product is hi*hi + hi*lo + lo*hi (lo*lo and the split's
// remainder are ~2^-22 relative, far under the port's 1e-5 bar): 12 TF32
// products per complex product.  The TPU version is vmapped over the batch
// and walks K on a sequential grid axis with the sum carried in its output
// block; here the batch is the grid's z axis and each block loops over K
// itself, so nothing carries over between blocks.
//
// Bound.  On the main path (eig32 sweep) the shape is B=39, M=K=128, N=1680:
// 3 x 8*B*M*K*N = 25.8 GFLOP of TF32 products per launch against ~0.14 GB of
// planes moved, so the kernel is bound by the TF32 tensor cores (495 TFLOP/s
// dense on an H100 SXM at 700 W: 0.052 ms), not by the 3.35 TB/s of HBM
// (0.042 ms).
//
// Design for that bound.  A block of two warpgroups owns a 128x64 output
// tile; each warpgroup issues `wgmma.mma_async.m64n64k8.f32.tf32.tf32` on
// its 64 rows.  The four input planes are staged raw in shared memory 32
// deep in k through a three-stage cp.async ring (16-byte copies when K and N
// are multiples of 4, else 4-byte ones); ragged edges (M, N, K not multiples
// of the tile, K not a multiple of 8) are zero-filled by the copies
// (src-size 0) and masked in the stores, so no padded copies are made.
//   * A (K-contiguous) goes to the tensor cores from registers: each warp
//     reads its m16 x k8 fragment from shared memory and splits it there,
//     into one of two fragment sets, so the split of k8 step ks+1 runs
//     while the tensor cores still work on step ks.
//   * B (N-contiguous in device memory) must reach wgmma K-major for TF32,
//     so each stage is split once per block into hi and lo tiles of both
//     planes, written transposed into 8x4 core matrices (no swizzle); a
//     wgmma reads them through shared-memory descriptors.
//   * The tensor cores' float32 accumulation truncates instead of rounding:
//     summed over K = 2048 that drift reached 3e-5 of the output's largest
//     magnitude (H100 run).  So each stage's products (32 of K) start from a
//     zero accumulator and are added to the running sums with ordinary
//     round-to-nearest float32 adds.
//   * Ai's products enter Cr with the sign bit of Ai's fragment flipped,
//     which is exact.
// Neither the split nor the transposed tiles go to device memory.  The copy
// loops stay rolled: unrolled, their per-copy addresses stayed live across
// the K loop and pushed the kernel past 255 registers into spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG = 2;              // warpgroups per block
constexpr int BM = 64 * WG;        // output rows per block
constexpr int BN = 64;             // output columns per block (the wgmma's N)
constexpr int BK = 32;             // contraction depth per stage
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int THREADS = 128 * WG;
constexpr int SA = BK + 4;         // raw A row stride in words (36: conflict-free fragment reads)
constexpr int SB = BN + 8;         // raw B row stride in words
constexpr int A_PLANE = BM * SA;
constexpr int B_PLANE = BK * SB;
constexpr int STAGE_FLOATS = 2 * A_PLANE + 2 * B_PLANE;
constexpr int KG = BK / 4;         // 16-byte core-matrix columns along K
constexpr int CORE_TILE = BN * BK; // floats of one K-major (plane, hi or lo) B tile
constexpr int LBO = 128;           // bytes between core matrices adjacent in K
constexpr int SBO = KG * 128;      // bytes between core matrices adjacent in N
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4 + 4 * CORE_TILE * 4;  // 198,656 bytes

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The bits of cvt.rna.tf32.f32(x) for finite x below 2^128 (1 - 2^-12):
// adding half of the kept part's last unit to the sign-magnitude pattern and
// clearing the 13 low bits rounds the magnitude to nearest, ties away from
// zero.  Two integer operations instead of one conversion, which the SM runs
// at an eighth of its float32 rate.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both rounded to TF32 (nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// shared-memory matrix descriptor: K-major, no swizzle
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

// d (+)= a * b over one k8 step: a from registers (the m16n8k8 row fragment
// of this warp's 16 rows), b a 64 x 8 K-major tile in shared memory
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of an accumulator across a
// wgmma fence, commit or wait
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One k8 step of this warp's A row fragment (rows wrow + g (+8), columns
// 8*ks + t (+4)) from the raw stage, split into TF32 hi and lo, with Ai's
// parts also negated (exact) for Cr = Ar Br - Ai Bi.
__device__ __forceinline__ void load_a(uint32_t (&f)[6][4], const float* raw, int wrow, int g,
                                       int t, int ks) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = (wrow + g + 8 * (q & 1)) * SA + 8 * ks + t + 4 * (q >> 1);
    split_tf32(raw[idx], f[0][q], f[1][q]);
    split_tf32(raw[A_PLANE + idx], f[2][q], f[3][q]);
    f[4][q] = f[2][q] ^ 0x80000000u;
    f[5][q] = f[3][q] ^ 0x80000000u;
  }
}

// Stage one BK slice of the four planes raw.  VEC: K % 4 == 0, N % 4 == 0
// and 16-byte aligned planes, so every 16-byte chunk lies wholly inside or
// wholly outside the matrix; otherwise 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void load_stage(float* st, const float* ar, const float* ai,
                                           const float* br, const float* bi, int m0, int n0,
                                           int k0, int M, int K, int N, long long lda,
                                           long long ldb, int tid) {
  constexpr int W = VEC ? 4 : 1;  // floats per copy
  constexpr int A_COPIES = 2 * BM * BK / W;
  constexpr int B_COPIES = 2 * BK * BN / W;
  static_assert(A_COPIES % THREADS == 0 && B_COPIES % THREADS == 0, "copies per thread");
#pragma unroll 1
  for (int l = 0; l < A_COPIES / THREADS; ++l) {
    const int v = tid + l * THREADS;
    const int p = v / (BM * BK / W);  // plane: 0 re, 1 im
    const int m = (v / (BK / W)) % BM;
    const int k = (v % (BK / W)) * W;
    const int gm = m0 + m, gk = k0 + k;
    const bool ok = gm < M && gk < K;
    const float* src = (p ? ai : ar) + (ok ? gm * lda + gk : 0);
    float* dst = st + p * A_PLANE + m * SA + k;
    if constexpr (VEC) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
#pragma unroll 1
  for (int l = 0; l < B_COPIES / THREADS; ++l) {
    const int v = tid + l * THREADS;
    const int p = v / (BK * BN / W);
    const int k = (v / (BN / W)) % BK;
    const int n = (v % (BN / W)) * W;
    const int gk = k0 + k, gn = n0 + n;
    const bool ok = gk < K && gn < N;
    const float* src = (p ? bi : br) + (ok ? gk * ldb + gn : 0);
    float* dst = st + 2 * A_PLANE + p * B_PLANE + k * SB + n;
    if constexpr (VEC) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
}

template <bool VEC, bool PAIR_STORE>
__global__ void __launch_bounds__(THREADS, 1)
cmatmul_f32_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   const float* __restrict__ br, const float* __restrict__ bi,
                   float* __restrict__ cr, float* __restrict__ ci,
                   int M, int K, int N,
                   long long sa, long long lda,
                   long long sb, long long ldb,
                   long long sc, long long ldc) {
  extern __shared__ __align__(128) float smem[];
  float* core = smem + STAGES * STAGE_FLOATS;  // [plane][hi, lo][N/8][KG][8][4]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment group (row of A/C)
  const int t = lane & 3;   // thread in group (k of A, column pair of C)
  const int wrow = (tid >> 5) * 16;  // this warp's first row in the block tile
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  ar += z * sa;
  ai += z * sa;
  br += z * sb;
  bi += z * sb;
  cr += z * sc;
  ci += z * sc;

  float acc_r[32], acc_i[32], pr[32], pi[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    acc_r[r] = 0.f;
    acc_i[r] = 0.f;
    pr[r] = 0.f;
    pi[r] = 0.f;
  }

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<VEC>(smem + s * STAGE_FLOATS, ar, ai, br, bi, m0, n0, s * BK, M, K, N, lda,
                      ldb, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... and every thread's; stage kt-1 and the
                                  // core tiles are free (their wgmma waited)
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage<VEC>(smem + (nk % STAGES) * STAGE_FLOATS, ar, ai, br, bi, m0, n0, nk * BK, M,
                      K, N, lda, ldb, tid);
    cp_async_commit();

    const float* raw = smem + (kt % STAGES) * STAGE_FLOATS;
    // B: split once per block into K-major hi/lo core tiles.  Lane (r, e)
    // takes n = 8*ng + r, k = 4*kg + e: conflict-free reads and writes.
#pragma unroll
    for (int l = 0; l < (2 * BN * BK) / THREADS; ++l) {
      const int v = tid + l * THREADS;
      const int e = v & 3;
      const int r = (v >> 2) & 7;
      const int kg = (v >> 5) % KG;
      const int ng = (v >> 5) / KG % (BN / 8);
      const int p = v / (BN * BK);
      uint32_t hi, lo;
      split_tf32(raw[2 * A_PLANE + p * B_PLANE + (4 * kg + e) * SB + 8 * ng + r], hi, lo);
      const int off = ((ng * KG + kg) * 8 + r) * 4 + e;
      core[(2 * p) * CORE_TILE + off] = __uint_as_float(hi);
      core[(2 * p + 1) * CORE_TILE + off] = __uint_as_float(lo);
    }
    // make the generic-proxy writes visible to the tensor cores' reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // A fragments in two sets: the tensor cores may still read set ks % 2
    // while set (ks + 1) % 2 is split for the next k8 step
    uint32_t fa[2][6][4];  // [set][hi re, lo re, hi im, lo im, -hi im, -lo im][q]
    load_a(fa[0], raw, wrow, g, t, 0);
    pin(pr);
    pin(pi);
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const uint32_t(&f)[6][4] = fa[ks & 1];
      const float* kcol = core + 2 * ks * 32;  // k columns 8*ks .. 8*ks+7
      const uint64_t brh = smem_desc(kcol);
      const uint64_t brl = smem_desc(kcol + CORE_TILE);
      const uint64_t bih = smem_desc(kcol + 2 * CORE_TILE);
      const uint64_t bil = smem_desc(kcol + 3 * CORE_TILE);
      const int acc = ks > 0;  // each stage's products start from zero
      wgmma_fence();
      wgmma_tf32(pr, f[1], brh, acc);  // small terms first
      wgmma_tf32(pr, f[0], brl, 1);
      wgmma_tf32(pr, f[5], bih, 1);
      wgmma_tf32(pr, f[4], bil, 1);
      wgmma_tf32(pr, f[0], brh, 1);
      wgmma_tf32(pr, f[4], bih, 1);
      wgmma_tf32(pi, f[1], bih, acc);
      wgmma_tf32(pi, f[0], bil, 1);
      wgmma_tf32(pi, f[3], brh, 1);
      wgmma_tf32(pi, f[2], brl, 1);
      wgmma_tf32(pi, f[0], bih, 1);
      wgmma_tf32(pi, f[2], brh, 1);
      wgmma_commit();
      if (ks + 1 < BK / 8) {
        wgmma_wait<1>();  // step ks-1 is done: its fragment set is free
        load_a(fa[(ks + 1) & 1], raw, wrow, g, t, ks + 1);
      }
    }
    wgmma_wait<0>();
    pin(pr);
    pin(pi);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      acc_r[r] += pr[r];
      acc_i[r] += pi[r];
    }
  }
  cp_async_wait<0>();

  // accumulator: register 4j + (0, 1) at row g, columns 8j + 2t (+1);
  // 4j + (2, 3) at row g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + wrow + g + 8 * h;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gn = n0 + 8 * j + 2 * t;
      const long long off = gm * ldc + gn;
      const float r0 = acc_r[4 * j + 2 * h], r1 = acc_r[4 * j + 2 * h + 1];
      const float i0 = acc_i[4 * j + 2 * h], i1 = acc_i[4 * j + 2 * h + 1];
      if (PAIR_STORE && gn + 1 < N) {
        *reinterpret_cast<float2*>(cr + off) = make_float2(r0, r1);
        *reinterpret_cast<float2*>(ci + off) = make_float2(i0, i1);
      } else {
        if (gn < N) {
          cr[off] = r0;
          ci[off] = i0;
        }
        if (gn + 1 < N) {
          cr[off + 1] = r1;
          ci[off + 1] = i1;
        }
      }
    }
  }
}

template <bool VEC, bool PAIR_STORE>
int launch(const float* ar, const float* ai, const float* br, const float* bi, float* cr,
           float* ci, int batch, int M, int K, int N, long long sa, long long lda, long long sb,
           long long ldb, long long sc, long long ldc, cudaStream_t stream) {
  auto kernel = cmatmul_f32_kernel<VEC, PAIR_STORE>;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device; a refused attribute would make the launch fail, so its code is
  // returned
  static unsigned long long opted_in = 0;  // one bit per device
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (dev >= 64 || !((opted_in >> dev) & 1ull)) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (dev < 64) opted_in |= 1ull << dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(ar, ai, br, bi, cr, ci, M, K, N, sa, lda, sb,
                                                ldb, sc, ldc);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// C interface for ctypes.  Row-major planes with unit stride along the last
// axis; s* are the strides between batch entries, ld* between rows (in
// elements).  Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int qst_cmatmul_f32(const float* ar, const float* ai,
                               const float* br, const float* bi,
                               float* cr, float* ci,
                               int batch, int M, int K, int N,
                               long long sa, long long lda,
                               long long sb, long long ldb,
                               long long sc, long long ldc,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = lda % 4 == 0 && sa % 4 == 0 && ldb % 4 == 0 && sb % 4 == 0 && K % 4 == 0 &&
                   N % 4 == 0 && aligned(ar, 16) && aligned(ai, 16) && aligned(br, 16) &&
                   aligned(bi, 16);
  const bool pair = ldc % 2 == 0 && sc % 2 == 0 && aligned(cr, 8) && aligned(ci, 8);
  if (vec && pair) return launch<true, true>(ar, ai, br, bi, cr, ci, batch, M, K, N, sa, lda, sb, ldb, sc, ldc, st);
  if (vec) return launch<true, false>(ar, ai, br, bi, cr, ci, batch, M, K, N, sa, lda, sb, ldb, sc, ldc, st);
  if (pair) return launch<false, true>(ar, ai, br, bi, cr, ci, batch, M, K, N, sa, lda, sb, ldb, sc, ldc, st);
  return launch<false, false>(ar, ai, br, bi, cr, ci, batch, M, K, N, sa, lda, sb, ldb, sc, ldc, st);
}
